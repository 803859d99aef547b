"""ML classifiers for Rudder's when-to-replace decision (paper §4.4).

Port of the reference's ``core/classifiers.py``. Stateless
discriminative models mapping current buffer statistics to a binary
replace/skip decision, trained **offline** on execution traces collected
in trace-only mode (:func:`repro_torch.gnn.train.collect_traces`).

Labeling per §4.4: for successive minibatches around a replacement
event, S' = Δ%Hits − ΔT_comm > 0 → "good" (label 1), else "bad" (0).

Models (paper Table 2): MLP, Logistic Regression, linear SVM, Random
Forest, XGBoost-style boosted stumps, and a TabNet-style model with a
learned sparse feature mask. The gradient-based models are plain
functions on torch tensors on ``device`` (the card by default;
``torch.autograd`` takes the reference's ``jax.grad``); the tree models
are the reference's numpy, copied. The gradient models support the
optional *online fine-tuning* of the decision head with frozen features
(§4.4).

The reference draws initial weights with ``jax.random``, which torch
cannot reproduce: :meth:`GradientClassifier.init_params` draws from a
``torch.Generator`` seeded by ``seed``, a different stream. Parity runs
carry the reference's arrays across instead: ``fit(X, y, init=...)``
starts from its initial parameters, :func:`params_from_jax` takes its
fitted ones. From the same parameters the fit consumes the reference's
numpy permutation draws and computes its losses, so fitted parameters
agree to float32 rounding (allclose, not bit-equal: 200 SGD steps in
another summation order).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .metrics import Metrics

FEATURE_NAMES = (
    "pct_hits",
    "delta_hits",
    "comm_norm",
    "delta_comm",
    "replaced_pct",
    "occupancy",
    "progress",
    "hits_trend",
)
NUM_FEATURES = len(FEATURE_NAMES)


def featurize(
    metrics: Metrics,
    prev: Metrics | None = None,
    recent_hits: list[float] | None = None,
    recent_comm: list[int] | None = None,
) -> np.ndarray:
    """Map one observation to the classifier feature vector.

    Communication features are normalised by the *running* comm scale
    (scale-free across graph sizes) rather than buffer capacity, so an
    offline-trained classifier transfers across datasets the way the
    paper deploys it.
    """
    comm_scale = max(max(recent_comm) if recent_comm else 0, metrics.comm_volume, 1)
    delta_hits = (metrics.pct_hits - prev.pct_hits) / 100.0 if prev else 0.0
    delta_comm = (
        (metrics.comm_volume - prev.comm_volume) / comm_scale if prev else 0.0
    )
    trend = 0.0
    if recent_hits and len(recent_hits) >= 4:
        k = min(4, len(recent_hits) // 2)
        trend = (
            sum(recent_hits[-k:]) / k - sum(recent_hits[-2 * k : -k]) / k
        ) / 100.0
    return np.array(
        [
            metrics.pct_hits / 100.0,
            delta_hits,
            metrics.comm_volume / comm_scale,
            np.clip(delta_comm, -1.0, 1.0),
            metrics.replaced_pct / 100.0,
            metrics.buffer_occupancy,
            metrics.progress,
            trend,
        ],
        dtype=np.float32,
    )


def label_traces(
    hits: np.ndarray, comm: np.ndarray, replaced: np.ndarray
) -> np.ndarray:
    """Assign labels by comparing key metrics before/after replacement.

    S' = Δ%Hits − ΔT_comm (comm normalised to [0,1] of its own scale);
    label 1 ("good") when S' > 0 at replacement events; non-events are
    labelled by whether *skipping* was good (hits did not fall).
    """
    hits = np.asarray(hits, dtype=np.float64)
    comm = np.asarray(comm, dtype=np.float64)
    d_hits = np.diff(hits, append=hits[-1])
    d_comm = np.diff(comm, append=comm[-1])
    # Standardise both deltas so neither term swamps the other (the
    # paper notes the label integrity is inherently compromised by
    # sampling variance — §4.4(i); z-scoring keeps the signal usable
    # without pretending the noise away).
    zh = d_hits / max(d_hits.std(), 1e-9)
    zc = d_comm / max(d_comm.std(), 1e-9)
    s_prime = zh - 0.5 * zc
    labels = (s_prime > 0).astype(np.float32)
    return labels


# --------------------------------------------------------------------- #
# Gradient-based models (torch)
# --------------------------------------------------------------------- #
def params_from_jax(tree, device="cuda") -> dict:
    """A gradient classifier's parameter dict from the reference's (its
    ``params`` or ``init_params()``, leaves as numpy arrays, e.g.
    ``jax.tree_util.tree_map(np.asarray, clf.params)``): float32 tensors
    on ``device``, in the reference's key order."""
    from ..runtime.engine import resolve_device

    dev = resolve_device(device)
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
        for k, v in tree.items()
    }


def _sgd(loss_fn, params, X, y, *, lr=0.05, epochs=200, seed=0, batch=256):
    """The reference's minibatch SGD: each epoch one step on the first
    ``batch`` rows of a fresh ``np.random.default_rng(seed)``
    permutation (the same draws as the reference's)."""
    rng = np.random.default_rng(seed)
    n = len(X)
    for _ in range(epochs):
        idx = torch.from_numpy(rng.permutation(n)[: min(batch, n)]).to(X.device)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        grads = torch.autograd.grad(loss_fn(leaves, X[idx], y[idx]), list(leaves.values()))
        params = {k: (v - lr * g).detach() for (k, v), g in zip(leaves.items(), grads)}
    return params


@dataclass
class GradientClassifier:
    """Shared scaffolding for MLP / LR / SVM / TabNet-lite."""

    name: str = "mlp"
    latency: float = 0.2          # classifier inference is fast (Table 2 r≈1)
    hidden: tuple[int, ...] = (32, 16)
    threshold: float = 0.5
    seed: int = 0
    params: dict = field(default_factory=dict)
    trained: bool = False
    finetune_buffer: list = field(default_factory=list)
    finetune_every: int = 0       # 0 = disabled
    #: Where the parameters live and the model runs: the card by default
    #: (raises without one), or ``"cpu"``.
    device: object = "cuda"

    def _device(self) -> torch.device:
        from ..runtime.engine import resolve_device

        return resolve_device(self.device)

    # ---- model-specific pieces -------------------------------------- #
    def init_params(self) -> dict:
        """He-normal weights and zero biases, drawn from a
        ``torch.Generator`` seeded by ``seed`` (not the reference's
        ``jax.random`` stream; pass its arrays to ``fit(init=...)``)."""
        gen = torch.Generator().manual_seed(self.seed)
        sizes = (NUM_FEATURES, *self.hidden, 1)
        params = {}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            params[f"w{i}"] = torch.randn((a, b), generator=gen) * (2.0 / a) ** 0.5
            params[f"b{i}"] = torch.zeros((b,))
        return params

    def logits(self, params: dict, X: torch.Tensor) -> torch.Tensor:
        h = X
        n_layers = len([k for k in params if k.startswith("w")])
        for i in range(n_layers):
            h = h @ params[f"w{i}"] + params[f"b{i}"]
            if i < n_layers - 1:
                h = torch.relu(h)
        return h[..., 0]

    def loss(self, params: dict, X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        z = self.logits(params, X)
        bce = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-torch.abs(z)))
        # Class-balanced weighting: traces are small and noisy; without
        # it the net happily collapses to the majority class.
        pos = torch.clamp(torch.mean(y), 0.05, 0.95)
        w = torch.where(y > 0.5, 0.5 / pos, 0.5 / (1.0 - pos))
        return torch.mean(w * bce)

    # ---- lifecycle ---------------------------------------------------- #
    def fit(self, X: np.ndarray, y: np.ndarray, init: dict | None = None) -> "GradientClassifier":
        """Fit on traces from ``init`` (arrays, e.g. the reference's
        ``init_params()``) or, without it, from :meth:`init_params`."""
        dev = self._device()
        X = torch.as_tensor(np.asarray(X, dtype=np.float32)).to(dev)
        y = torch.as_tensor(np.asarray(y, dtype=np.float32)).to(dev)
        start = self.init_params() if init is None else init
        self.params = _sgd(self.loss, params_from_jax(start, dev), X, y, seed=self.seed)
        self.trained = True
        return self

    def predict_proba(self, x: np.ndarray) -> float:
        if not self.trained:
            raise RuntimeError(f"{self.name} must be fit on traces first")
        X = torch.as_tensor(np.asarray(x, dtype=np.float32)).to(self._device())
        with torch.no_grad():
            z = self.logits(self.params, X[None, :])
            return float(torch.sigmoid(z)[0])

    def decide(self, x: np.ndarray) -> bool:
        d = self.predict_proba(x) > self.threshold
        if self.finetune_every:
            self.finetune_buffer.append(np.asarray(x))
            if len(self.finetune_buffer) >= self.finetune_every:
                self._finetune_head()
        return bool(d)

    def _finetune_head(self) -> None:
        """Online fine-tune of the decision head, feature layers frozen.

        Traces are unlabeled online; pseudo-labels come from the same
        S'-style rule applied to the buffered window (§4.4). The head is
        found as the reference finds it, so TabNet's ``"wa"`` key raises
        ``ValueError`` there and here alike.
        """
        Xb = np.stack(self.finetune_buffer)
        self.finetune_buffer.clear()
        d_hits = np.diff(Xb[:, 0], append=Xb[-1, 0])
        d_comm = np.diff(Xb[:, 2], append=Xb[-1, 2])
        yb = (d_hits - d_comm > 0).astype(np.float32)
        head = max(
            int(k[1:]) for k in self.params if k.startswith("w")
        )
        dev = self._device()
        hp = [self.params[f"w{head}"].detach().requires_grad_(True),
              self.params[f"b{head}"].detach().requires_grad_(True)]
        p = dict(self.params)
        p[f"w{head}"], p[f"b{head}"] = hp
        loss = self.loss(p, torch.from_numpy(Xb).to(dev), torch.from_numpy(yb).to(dev))
        g = torch.autograd.grad(loss, hp)
        self.params[f"w{head}"], self.params[f"b{head}"] = (
            (v - 0.01 * gi).detach() for v, gi in zip(hp, g)
        )


@dataclass
class LogisticRegressionClassifier(GradientClassifier):
    name: str = "lr"
    latency: float = 0.1
    hidden: tuple[int, ...] = ()


@dataclass
class SVMClassifier(GradientClassifier):
    """Linear SVM via hinge loss."""

    name: str = "svm"
    latency: float = 0.1
    hidden: tuple[int, ...] = ()

    def loss(self, params, X, y):
        z = self.logits(params, X)
        margins = torch.clamp(1.0 - (2.0 * y - 1.0) * z, min=0.0)
        l2 = sum(torch.sum(v**2) for k, v in params.items() if k.startswith("w"))
        return torch.mean(margins) + 1e-3 * l2


@dataclass
class TabNetLiteClassifier(GradientClassifier):
    """TabNet-style sparse attentive feature selection (single step).

    A learned mask m = softmax(x @ Wa) gates the features before the MLP;
    the sparse gating is what the paper observes discarding useful
    features in synchronous mode (§5.3).
    """

    name: str = "tabnet"
    latency: float = 0.3
    hidden: tuple[int, ...] = (32,)

    def init_params(self) -> dict:
        params = super().init_params()
        gen = torch.Generator().manual_seed(self.seed + 17)
        params["wa"] = torch.randn((NUM_FEATURES, NUM_FEATURES), generator=gen) * 0.3
        return params

    def logits(self, params, X):
        mask = torch.softmax(X @ params["wa"] * 4.0, dim=-1)
        h = X * mask * NUM_FEATURES
        n_layers = len([k for k in params if k.startswith("w") and k != "wa"])
        for i in range(n_layers):
            h = h @ params[f"w{i}"] + params[f"b{i}"]
            if i < n_layers - 1:
                h = torch.relu(h)
        return h[..., 0]


# --------------------------------------------------------------------- #
# Tree models (numpy, the reference's)
# --------------------------------------------------------------------- #
def _best_stump(X, y, w):
    """Weighted decision stump over all features/thresholds."""
    n, d = X.shape
    best = (0, 0.0, 1, np.inf)  # feat, thr, sign, err
    for f in range(d):
        order = np.argsort(X[:, f])
        xs, ys, ws = X[order, f], y[order], w[order]
        cum = np.cumsum(ws * (2 * ys - 1))
        total = cum[-1]
        for i in range(0, n - 1, max(1, n // 32)):
            if xs[i] == xs[i + 1]:
                continue
            thr = 0.5 * (xs[i] + xs[i + 1])
            # predict +1 above thr
            err_pos = np.sum(ws[: i + 1] * ys[: i + 1]) + np.sum(
                ws[i + 1 :] * (1 - ys[i + 1 :])
            )
            for sign, err in ((1, err_pos), (-1, w.sum() - err_pos)):
                if err < best[3]:
                    best = (f, thr, sign, err)
    return best


@dataclass
class ForestClassifier:
    """Random-forest-like bagged stump ensemble.

    The vote fraction is an uncalibrated probability; with the default
    0.1 threshold the forest is the trigger-happy member of the zoo —
    reproducing the paper's Table 2, where RF makes 100% positive
    decisions (the cache-pollution failure mode).
    """

    name: str = "rf"
    latency: float = 0.2
    n_trees: int = 24
    threshold: float = 0.1
    seed: int = 0
    stumps: list = field(default_factory=list)
    trained: bool = False
    finetune_every: int = 0
    finetune_buffer: list = field(default_factory=list)

    def fit(self, X, y):
        rng = np.random.default_rng(self.seed)
        n = len(X)
        self.stumps = []
        for _ in range(self.n_trees):
            idx = rng.integers(0, n, n)
            feats = rng.choice(X.shape[1], max(2, X.shape[1] // 2), replace=False)
            Xb = X[idx][:, feats]
            f, thr, sign, _ = _best_stump(Xb, y[idx], np.ones(n) / n)
            self.stumps.append((feats[f], thr, sign))
        self.trained = True
        return self

    def predict_proba(self, x):
        if not self.trained:
            raise RuntimeError(f"{self.name} must be fit on traces first")
        votes = [
            (1 if (x[f] > thr) == (sign > 0) else 0) for f, thr, sign in self.stumps
        ]
        return float(np.mean(votes))

    def decide(self, x):
        return self.predict_proba(x) > self.threshold


@dataclass
class BoostedStumpsClassifier(ForestClassifier):
    """XGBoost-style additive boosted stumps (AdaBoost weighting)."""

    name: str = "xgb"
    latency: float = 0.2
    n_trees: int = 16
    threshold: float = 0.5

    def fit(self, X, y):
        n = len(X)
        w = np.ones(n) / n
        self.stumps = []
        for _ in range(self.n_trees):
            f, thr, sign, err = _best_stump(X, y, w)
            err = min(max(err, 1e-9), 1 - 1e-9)
            alpha = 0.5 * np.log((1 - err) / err)
            pred = ((X[:, f] > thr) == (sign > 0)).astype(np.float64)
            w = w * np.exp(-alpha * (2 * y - 1) * (2 * pred - 1))
            w /= w.sum()
            self.stumps.append((f, thr, sign, alpha))
        self.trained = True
        return self

    def predict_proba(self, x):
        if not self.trained:
            raise RuntimeError(f"{self.name} must be fit on traces first")
        score = sum(
            alpha * (1 if (x[f] > thr) == (sign > 0) else -1)
            for f, thr, sign, alpha in self.stumps
        )
        return float(1.0 / (1.0 + np.exp(-2.0 * score)))


CLASSIFIERS: dict[str, type] = {
    "mlp": GradientClassifier,
    "lr": LogisticRegressionClassifier,
    "svm": SVMClassifier,
    "tabnet": TabNetLiteClassifier,
    "rf": ForestClassifier,
    "xgb": BoostedStumpsClassifier,
}


def make_classifier(name: str, **kwargs):
    """The classifier ``name`` of :data:`CLASSIFIERS`. ``device`` goes to
    the gradient models; the tree models are numpy on the host and take
    none, so it is dropped for them."""
    if name not in CLASSIFIERS:
        raise KeyError(f"unknown classifier {name!r}; options: {sorted(CLASSIFIERS)}")
    cls = CLASSIFIERS[name]
    if not issubclass(cls, GradientClassifier):
        kwargs.pop("device", None)
    return cls(**kwargs)
