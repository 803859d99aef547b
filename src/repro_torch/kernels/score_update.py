"""The staged engine's scoring round on the card: the Hopper kernel
``csrc/score_update.cu`` behind three PyTorch wrappers.

Port of the reference's Pallas ``score_policy_update_batch`` (the policy
zoo) and its two fixed-policy forms, ``score_update_batch`` (the paper's
constants) and ``score_update`` (one buffer): all three launch the same
kernel, and each counts its own :data:`native.LAUNCHES` entry. Plain
version: :func:`repro_torch.kernels.ref.score_policy_update_batch`,
which they match bit for bit (the kernel rounds as the plain version
does; see the note in the source).

A call is one device operation, the kernel: a cluster of blocks a row
whose stale counts meet in distributed shared memory, so it writes every
output in full and needs no zero-filled count and no scratch. The
constants cross the ctypes boundary as ``float``, which rounds a
Python float exactly as ``np.float32`` does. An empty buffer (``P * N ==
0``) has nothing to score: the wrappers return without a launch and
count none.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core import scoring
from . import native
from .native import check_tensor, ptr

_MODES = {"accumulate": 0, "reset": 1, "capped": 2}

_ARGS = [
    ctypes.c_int, ctypes.c_int64,                   # P, N
    ctypes.c_void_p, ctypes.c_void_p,               # scores, accessed
    ctypes.c_void_p,                                # weights (or null)
    ctypes.c_void_p, ctypes.c_void_p,               # out, stale
    ctypes.c_float, ctypes.c_float,                 # increment, decay
    ctypes.c_float, ctypes.c_float,                 # threshold, score_cap
    ctypes.c_int, ctypes.c_int,                     # mode, vec
    ctypes.c_void_p,                                # stream
]

@functools.cache
def _entry():
    """The bound C entry, resolved once per process (at its first launch)."""
    return native.bind("score_update", "rudder_score_update", _ARGS)


def _launch(name, scores, accessed, weights, increment, decay, threshold,
            score_cap, mode):
    if scores.dim() != 2:
        raise ValueError(f"need scores (P, N), got {tuple(scores.shape)}")
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {tuple(_MODES)}, got {mode!r}")
    P, N = scores.shape
    check_tensor(scores, "scores", torch.float32, (P, N))
    check_tensor(accessed, "accessed", torch.bool, (P, N))
    if weights is not None:
        check_tensor(weights, "weights", torch.float32, (P, N))
    dev = scores.device
    out = torch.empty((P, N), dtype=torch.float32, device=dev)
    stale = torch.empty((P,), dtype=torch.int32, device=dev)
    if P * N == 0:
        stale.zero_()
        return out, stale
    vec = int(
        scores.data_ptr() % 16 == 0 and accessed.data_ptr() % 4 == 0
        and (weights is None or weights.data_ptr() % 16 == 0)
    )
    native.launch(
        _entry(), dev, name, P, N, scores.data_ptr(), accessed.data_ptr(), ptr(weights),
        out.data_ptr(), stale.data_ptr(), float(increment), float(decay),
        float(threshold), float(score_cap), _MODES[mode], vec,
    )
    native.LAUNCHES[name] += 1
    return out, stale


def score_policy_update_batch_cuda(
    scores: torch.Tensor,
    accessed: torch.Tensor,
    weights: torch.Tensor | None = None,
    *,
    increment: float = float(scoring.ACCESS_INCREMENT),
    decay: float = float(scoring.DECAY_FACTOR),
    threshold: float = float(scoring.STALE_THRESHOLD),
    mode: str = "accumulate",
    score_cap: float = 4.0,
):
    """Scores ``(P, N)`` float32, accessed ``(P, N)`` bool [, weights
    ``(P, N)`` float32] → ``(new (P, N) float32, stale_count (P,)
    int32)``, one launch."""
    return _launch(
        "score_policy_update_batch", scores, accessed, weights, increment,
        decay, threshold, score_cap, mode,
    )


def score_update_batch_cuda(scores: torch.Tensor, accessed: torch.Tensor):
    """The paper's round per PE (the default constants), one launch."""
    return _launch(
        "score_update_batch", scores, accessed, None,
        scoring.ACCESS_INCREMENT, scoring.DECAY_FACTOR,
        scoring.STALE_THRESHOLD, 4.0, "accumulate",
    )


def score_update_cuda(scores: torch.Tensor, accessed: torch.Tensor):
    """The paper's round on one buffer ``(N,)`` → ``(new (N,),
    stale_count)`` (a 0-dim int32 tensor): the ``P = 1`` view, one
    launch."""
    if scores.dim() != 1:
        raise ValueError(f"need scores (N,), got {tuple(scores.shape)}")
    new, stale = _launch(
        "score_update", scores[None], accessed[None], None,
        scoring.ACCESS_INCREMENT, scoring.DECAY_FACTOR,
        scoring.STALE_THRESHOLD, 4.0, "accumulate",
    )
    return new[0], stale[0]
