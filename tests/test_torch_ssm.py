"""The port's recurrent mixers (``repro_torch.models.ssm``) and the SSM and
hybrid models' serving entry points against the reference, on the CPU.

The reference's parameters (``init_params`` of the xLSTM-350M and
Zamba2-1.2B smoke configs) are carried across by ``params_from_jax``;
inputs are made with numpy from a seed. Bars: 1e-4 in float32 and 3e-2
in bfloat16 (``tests/test_torch_zoo.py``'s ``TOL``); gradients within
1e-4 x max |reference gradient| + 1e-7. In bfloat16 the reference runs
op by op (``jax.disable_jit()``), as in ``tests/test_torch_zoo.py``.

* each mixer's (``mamba2``, ``mlstm``, ``slstm``) sequence form, its
  decode form over several steps with every state leaf after each step
  (the initial state included: the xLSTM stabiliser ``m`` at -1e30), and
  the gradients of its parameters and input against ``jax.grad``;
* mLSTM at S = 128, two chunks of ``MLSTM_CHUNK`` under the chunk
  checkpoint: forward and gradients against the reference, and the
  gradients bit-identical to the same loop run without the checkpoint;
* the ``shared_attn`` slots' own ``norm1``: drawn, never read, gradient 0
  in both packages;
* the twin of ``tests/test_system.py::test_serving_driver_generates``
  (xLSTM-350M's smoke config through ``serve_batch``, tokens equal to
  the reference's), and ``shape_supported`` on every ported
  architecture and shape against the reference's;
* the training CLI on both smoke configs, and ``init_params``,
  ``serve_batch`` and ``train`` raising ``RuntimeError`` for both on
  ``device="cuda"`` without a card.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch.kernels import native
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import config as tconfig
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
GRAD_TOL = 1e-4
#: mixer: (architecture, layer index of the smoke config)
MIXERS = {"mamba2": ("zamba2-1.2b", 0), "mlstm": ("xlstm-350m", 0),
          "slstm": ("xlstm-350m", 1)}
STEPS = 6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the smoke models are tiny, and under the
    suite's parallel workers torch's default of a thread per core in every
    worker oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(cfg):
    """The same configuration as the port's own dataclass."""

    def conv(v):
        if dataclasses.is_dataclass(v):
            return getattr(tconfig, type(v).__name__)(**dataclasses.asdict(v))
        return v

    return tconfig.ModelConfig(
        **{f.name: conv(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    )


def f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def reference(dtype):
    return jax.disable_jit() if dtype == "bfloat16" else contextlib.nullcontext()


def dtypes(dtype):
    return (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                       torch.float32)


@functools.cache
def model_pair(arch, dtype):
    cfg = jconfigs.get_smoke_config(arch).with_overrides(dtype=dtype)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    port = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return cfg, params, port


def mixer_params(mixer, dtype):
    """The reference's mixer parameters of the mixer's layer, and the
    port's copy."""
    arch, index = MIXERS[mixer]
    cfg, params, _ = model_pair(arch, dtype)
    unit, _ = jmodel.scan_groups(cfg)[0]
    assert unit[index] == mixer
    jp = jax.tree_util.tree_map(lambda a: a[0], params["groups"][0][f"b{index}"]["mixer"])
    tp = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return cfg, jp, tp


def fns(mixer):
    return tuple(getattr(mod, f"{mixer}_{what}") for what in ("forward", "init_state", "decode")
                 for mod in (jssm, tssm))


def inputs(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def assert_state(got: dict, want: dict, tol, what):
    assert got.keys() == want.keys(), what
    for k in want:
        assert got[k].dtype == getattr(torch, str(want[k].dtype)), (what, k)
        np.testing.assert_allclose(f32(got[k]), f32(want[k]), rtol=tol, atol=tol,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", MIXERS)
def test_mixer_forward_matches_the_reference(mixer, dtype):
    cfg, jp, tp = mixer_params(mixer, dtype)
    jfwd, tfwd = fns(mixer)[:2]
    jdt, tdt = dtypes(dtype)
    x = inputs(cfg, 2, 12, 3)
    with reference(dtype):
        want = jfwd(cfg, jp, jnp.asarray(x).astype(jdt))
    with torch.no_grad():
        got = tfwd(port_cfg(cfg), tp, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_allclose(f32(got), f32(want), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", MIXERS)
def test_mixer_decode_and_state_match_the_reference(mixer, dtype):
    """``STEPS`` decode steps from the initial state, each package carrying
    its own; the port's state is written in place into the same tensors."""
    cfg, jp, tp = mixer_params(mixer, dtype)
    _, _, jinit, tinit, jdec, tdec = fns(mixer)
    jdt, tdt = dtypes(dtype)
    jstate = jinit(cfg, 2)
    tstate = tinit(port_cfg(cfg), 2, device="cpu")
    assert_state(tstate, jstate, 0, "initial state")
    if mixer != "mamba2":
        assert (tstate["m"] == -1e30).all()
    held = dict(tstate)
    xs = inputs(cfg, STEPS, 2, 4)
    for t in range(STEPS):
        x = xs[t][:, None]
        with reference(dtype):
            want, jstate = jdec(cfg, jp, jnp.asarray(x).astype(jdt), jstate)
        with torch.no_grad():
            got, tstate = tdec(port_cfg(cfg), tp, torch.from_numpy(x).to(tdt), tstate)
        assert all(tstate[k] is held[k] for k in held)
        np.testing.assert_allclose(f32(got), f32(want), rtol=TOL[dtype], atol=TOL[dtype],
                                   err_msg=f"step {t}")
        assert_state(tstate, jstate, TOL[dtype], f"step {t}")


def grads_pair(mixer, s):
    """The gradients of ``sum(forward(x) * w)`` with respect to the mixer's
    parameters and ``x`` (float32): the reference's by ``jax.grad`` and the
    port's by autograd, each as ``{name: array}``."""
    cfg, jp, tp = mixer_params(mixer, "float32")
    jfwd, tfwd = fns(mixer)[:2]
    x = inputs(cfg, 2, s, 5)
    w = np.random.default_rng(6).standard_normal((2, s, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jfwd(cfg, p, xx) * w)

    gp, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    want = {**{k: np.asarray(v) for k, v in gp.items()}, "x": np.asarray(gx)}
    live = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    loss = (tfwd(port_cfg(cfg), live, xt) * torch.from_numpy(w)).sum()
    names = list(live) + ["x"]
    got = torch.autograd.grad(loss, [*live.values(), xt], allow_unused=True)
    got = {k: torch.zeros_like(xt if k == "x" else live[k]) if g is None else g
           for k, g in zip(names, got)}
    return got, want


def assert_grads(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape, k
        tol = GRAD_TOL * np.abs(w).max() + 1e-7
        assert np.abs(g - w).max() <= tol, (k, np.abs(g - w).max(), tol)


@pytest.mark.parametrize("mixer", MIXERS)
def test_mixer_grads_match_the_reference(mixer):
    assert_grads(*grads_pair(mixer, 12))


def test_mlstm_chunk_path_matches_the_reference_and_the_plain_loop(monkeypatch):
    """S = 128: two chunks of ``MLSTM_CHUNK`` steps, each checkpointed
    (S = 12 takes chunks of 1). Forward and gradients against the
    reference's; gradients bit-identical to the loop without the chunk
    checkpoint."""
    s = 2 * tssm.MLSTM_CHUNK
    cfg, jp, tp = mixer_params("mlstm", "float32")
    x = inputs(cfg, 2, s, 7)
    want = jssm.mlstm_forward(cfg, jp, jnp.asarray(x))
    with torch.no_grad():
        got = tssm.mlstm_forward(port_cfg(cfg), tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    got, want = grads_pair("mlstm", s)
    assert_grads(got, want)
    monkeypatch.setattr(tssm, "checkpoint", lambda fn, *args, **kw: fn(*args))
    plain, _ = grads_pair("mlstm", s)
    for k in got:
        assert torch.equal(got[k], plain[k]), k


def test_shared_attn_slot_norm_gradient_is_zero():
    """Zamba2's ``shared_attn`` slot draws its own ``norm1`` and never
    reads it: its gradient is exactly 0 in both packages, while the shared
    block's own norms have gradients."""
    cfg, params, port = model_pair("zamba2-1.2b", "float32")
    unit, _ = jmodel.scan_groups(cfg)[0]
    slot = f"b{unit.index('shared_attn')}"
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, size=(2, 10)).astype(np.int32)
    jgrads = jax.grad(lambda p: jmodel.lm_loss(cfg, p, {"tokens": jnp.asarray(toks)})[0])(params)
    _, _, tgrads = tsteps.loss_and_grads(port_cfg(cfg), port,
                                         {"tokens": torch.from_numpy(toks)}, remat=False)
    for grads in (jgrads, tgrads):
        assert not np.asarray(grads["groups"][0][slot]["norm1"]["scale"]).any()
        assert np.asarray(grads["shared_block"]["norm1"]["scale"]).any()
        assert np.asarray(grads["shared_block"]["norm2"]["scale"]).any()


def test_serving_driver_generates():
    """Twin of ``tests/test_system.py::test_serving_driver_generates``:
    xLSTM-350M's smoke config (bf16) through ``serve_batch`` on the CPU,
    from the reference's parameters of the same seed; tokens equal to the
    reference's, no native kernel launched."""
    kw = dict(requests=2, prompt_len=4, gen_len=6)
    want = jserve.serve_batch("xlstm-350m", smoke=True, **kw)
    _, params, port = model_pair("xlstm-350m", "bfloat16")
    assert jconfigs.get_smoke_config("xlstm-350m").dtype == "bfloat16"
    native.reset_launches()
    got = tserve.serve_batch("xlstm-350m", smoke=True, params=port, device="cpu", **kw)
    assert got["tokens"].shape == (2, 6)
    assert got["tokens"].dtype.kind == "i"
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert not any(native.LAUNCHES.values())


@pytest.mark.parametrize("shape", list(tsteps.SHAPES))
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "phi3.5-moe-42b-a6.6b", "qwen3-8b",
                                  "phi3-mini-3.8b", "minitron-4b", "gemma2-2b", "xlstm-350m",
                                  "zamba2-1.2b"])
def test_shape_supported_matches_the_reference(arch, shape):
    assert tsteps.SHAPES[shape] == jsteps.SHAPES[shape]
    assert tsteps.shape_supported(tconfigs.get_config(arch), shape) == jsteps.shape_supported(
        jconfigs.get_config(arch), shape)


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-1.2b"])
def test_train_cli_runs_the_smoke_config(arch, capsys):
    from repro_torch.launch import train as ttrain

    ttrain.main(["--arch", arch, "--steps", "2", "--batch", "2", "--seq", "8",
                 "--device", "cpu"])
    assert "loss " in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-1.2b"])
def test_cuda_without_a_card_raises(arch, monkeypatch):
    from repro_torch.launch import train as ttrain

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tmodel.init_params(tconfigs.get_smoke_config(arch), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve_batch(arch, requests=1, prompt_len=2, gen_len=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train(arch, steps=1)
