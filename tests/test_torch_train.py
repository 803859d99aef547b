"""The port's training path against the reference, on the CPU: the six
decoder-only attention architectures (DeepSeek-V3, Phi-3.5-MoE,
Qwen3-8B, Phi-3-mini, Minitron-4B, Gemma2-2B), xLSTM-350M and
Zamba2-1.2B at their smoke configs.

The reference's ``init_params`` (``jax.random``) are carried across by
``params_from_jax`` in float32, the tokens are made with numpy from a
seed, and both packages run them:

* ``lm_loss``'s ``total``, ``ce``, ``aux`` and (DeepSeek-V3's MTP head)
  ``mtp_ce`` within 1e-5 relative; the gradient of every leaf within
  1e-4 x max |reference gradient| + 1e-7 of ``jax.value_and_grad``'s;
* ``remat=True`` against ``remat=False`` in the port: loss and every
  gradient bit-identical;
* the mirrors of the reference's ``test_train_step_reduces_loss`` and
  ``test_lm_training_driver_learns`` (``train(..., device="cpu")``);
* ``device="cuda"`` without a card raises ``RuntimeError``, and a state
  larger than the device raises ``MemoryError`` naming its bytes.

The bf16 loss and the three-step trajectories are in
``tests/test_torch_train_steps.py``; Whisper-large-v3's and
Phi-3-vision-4.2B's training tests are in ``tests/test_torch_whisper.py``
and ``test_torch_vision.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.data import TokenPipeline
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import config as tconfig
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw_init
from repro_torch.tree import flatten

ARCHES = ("deepseek-v3-671b", "phi3.5-moe-42b-a6.6b", "qwen3-8b", "phi3-mini-3.8b",
          "minitron-4b", "gemma2-2b", "xlstm-350m", "zamba2-1.2b")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the smoke models are tiny, and under the
    suite's parallel workers torch's default of a thread per core in every
    worker oversubscribes the machine (bf16 steps ran 40x slower so)."""
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


@functools.cache
def model_pair(arch):
    cfg = jconfigs.get_smoke_config(arch).with_overrides(dtype="float32")
    params = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params


def port_params(arch):
    _, params = model_pair(arch)
    return tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")


@functools.cache
def tokens(vocab, batch=2, seq=14, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(batch, seq)).astype(np.int32)


@functools.cache
def reference_loss_and_grads(arch):
    cfg, params = model_pair(arch)
    batch = {"tokens": jnp.asarray(tokens(cfg.vocab_size))}
    fn = jax.jit(jax.value_and_grad(lambda p: jmodel.lm_loss(cfg, p, batch), has_aux=True))
    (loss, metrics), grads = fn(params)
    return float(loss), {k: float(v) for k, v in metrics.items()}, [
        np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


@functools.cache
def port_loss_and_grads(arch, remat):
    cfg, _ = model_pair(arch)
    batch = {"tokens": torch.from_numpy(tokens(cfg.vocab_size))}
    return tsteps.loss_and_grads(port_cfg(cfg), port_params(arch), batch, remat=remat)


@pytest.mark.parametrize("arch", ARCHES)
def test_lm_loss_matches_the_reference(arch):
    want_loss, want_metrics, _ = reference_loss_and_grads(arch)
    loss, metrics, _ = port_loss_and_grads(arch, False)
    assert set(metrics) == set(want_metrics)
    assert ("mtp_ce" in metrics) == (arch == "deepseek-v3-671b")
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL, atol=0)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=LOSS_RTOL, atol=0, err_msg=k)


@pytest.mark.parametrize("arch", ARCHES)
def test_grads_match_the_reference(arch):
    """Every leaf, in the reference's ``tree_leaves`` order (dict keys
    sorted), the port's ``tree.flatten`` order."""
    _, _, want = reference_loss_and_grads(arch)
    _, _, grads = port_loss_and_grads(arch, False)
    got, _ = flatten(grads)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, i
        tol = GRAD_TOL * np.abs(w).max() + 1e-7
        assert np.abs(g.numpy() - w).max() <= tol, (i, np.abs(g.numpy() - w).max(), tol)


@pytest.mark.parametrize("arch", ARCHES)
def test_remat_is_bit_identical(arch):
    loss, metrics, grads = port_loss_and_grads(arch, False)
    loss_r, metrics_r, grads_r = port_loss_and_grads(arch, True)
    assert torch.equal(loss, loss_r)
    assert all(torch.equal(metrics[k], metrics_r[k]) for k in metrics)
    assert all(torch.equal(a, b) for a, b in zip(flatten(grads)[0], flatten(grads_r)[0]))


@pytest.mark.parametrize("arch", ARCHES)
def test_train_step_reduces_loss(arch):
    """The twin of ``tests/test_models_smoke.py``'s: the port's smoke
    config (bf16), its own ``init_params``, 5 steps at lr 3e-3."""
    cfg = tconfigs.get_smoke_config(arch)
    params = tmodel.init_params(cfg, 0, device="cpu")
    opt = adamw_init(params, cfg.opt_dtype)
    step = tsteps.make_train_step(cfg, lr=3e-3, remat=False)
    pipe = TokenPipeline(cfg, batch_size=4, seq_len=16, seed=1)
    batch = {k: torch.from_numpy(v) for k, v in pipe.next_batch().items()}
    losses = []
    for _ in range(5):
        params, opt, metrics = step(params, opt, batch)
        assert metrics["loss"].dim() == 0
        losses.append(float(metrics["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0]
    assert int(opt.step) == 5


def test_lm_training_driver_learns():
    """The twin of ``tests/test_system.py``'s, through the port's driver."""
    res = ttrain.train("gemma2-2b", smoke=True, steps=8, batch=4, seq=32, lr=3e-3,
                       log_every=100, device="cpu")
    assert res["last_loss"] < res["first_loss"]
    assert len(res["losses"]) == 8


def test_driver_cli_and_checkpoint(tmp_path, capsys):
    from repro_torch.ckpt import load_checkpoint

    path = str(tmp_path / "params.msgpack")
    ttrain.main(["--arch", "qwen3-8b", "--steps", "2", "--batch", "2", "--seq", "8",
                 "--device", "cpu", "--ckpt", path])
    out = capsys.readouterr().out
    assert "saved checkpoint" in out and "loss " in out
    template = tmodel.init_params(tconfigs.get_smoke_config("qwen3-8b"), 1, device="cpu")
    loaded = load_checkpoint(path, template)
    assert [t.shape for t in flatten(loaded)[0]] == [t.shape for t in flatten(template)[0]]


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train("gemma2-2b", steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "gemma2-2b", "--steps", "1"])


def test_a_state_larger_than_the_device_names_its_bytes(monkeypatch):
    """DeepSeek-V3 whole: parameters and gradients at the parameters'
    dtypes, two bf16 moments (``opt_dtype``). The host's memory is made 1
    GiB so that the refusal comes before anything is drawn."""
    for arch, moment in (("deepseek-v3-671b", 2), ("gemma2-2b", 4)):
        cfg = tconfigs.get_config(arch)
        n = sum(t.numel() for t in tmodel._leaves(tmodel._draw_params(cfg, tmodel.SHAPES_ONLY)))
        assert tmodel.train_state_bytes(cfg) == 2 * tmodel.param_bytes(cfg) + 2 * moment * n
    need = tmodel.train_state_bytes(tconfigs.get_config("deepseek-v3-671b"))
    monkeypatch.setattr(tmodel.os, "sysconf", lambda name: 1 << 15)
    with pytest.raises(MemoryError, match=f"needs {need} bytes of training state"):
        ttrain.train("deepseek-v3-671b", smoke=False, steps=1, device="cpu")


@pytest.mark.parametrize("arch", ARCHES)
def test_chip_smoke_train_flops_counts_the_step(arch):
    """``chip_smoke.train_flops`` (phase 14's model FLOPs) equals
    ``FlopCounterMode``'s count of a gradient pass, with ``addmm_`` (the
    unembedding's backward) and ``torch._grouped_mm`` (the MoE experts)
    counted, which it leaves out. Three layers of DeepSeek-V3's smoke
    config hold one dense and two MoE layers."""
    import importlib.util
    from pathlib import Path

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.roofline import FLOP_FORMULAS

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = tconfigs.get_smoke_config(arch).with_overrides(dtype="float32", num_layers=3)
    params = tmodel.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(tokens(cfg.vocab_size, batch=2, seq=16))
    with FlopCounterMode(display=False, custom_mapping=FLOP_FORMULAS) as fc:
        tsteps.loss_and_grads(cfg, params, {"tokens": toks}, remat=False)
    assert fc.get_total_flops() == cs.train_flops(cfg, 2, 16)
