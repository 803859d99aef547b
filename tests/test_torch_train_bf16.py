"""``lm_loss`` in bf16 against the reference's, on the CPU, for the six
decoder-only attention architectures', xLSTM-350M's and Zamba2-1.2B's
smoke configs: the reference run
op by op (``jax.disable_jit()``, as ``tests/test_torch_zoo.py`` runs it:
its jitted layer scan keeps some bf16 intermediates in float32, and a MoE
router near-tie then flips), from the same parameters
(``params_from_jax``) on the same tokens. The total and every metric
within 1e-2 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro_torch.models import config as tconfig
from repro_torch.models import model as tmodel

ARCHES = ("deepseek-v3-671b", "phi3.5-moe-42b-a6.6b", "qwen3-8b", "phi3-mini-3.8b",
          "minitron-4b", "gemma2-2b", "xlstm-350m", "zamba2-1.2b")
BF16_RTOL = 1e-2


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


@pytest.mark.parametrize("arch", ARCHES)
def test_bf16_loss_matches_the_reference_op_by_op(arch):
    cfg = jconfigs.get_smoke_config(arch).with_overrides(dtype="bfloat16")
    params = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    with jax.disable_jit():
        want, want_m = jmodel.lm_loss(cfg, params, {"tokens": jnp.asarray(toks)})
    port = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    with torch.no_grad():
        got, got_m = tmodel.lm_loss(port_cfg(cfg), port, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(got), float(want), rtol=BF16_RTOL, atol=0)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), rtol=BF16_RTOL,
                                   atol=0, err_msg=k)
