"""The port's train step against the reference's, on the CPU, for the six
decoder-only attention architectures' smoke configs: three
``make_train_step`` steps (float32, ``remat=False``) against the
reference's jitted ``make_train_step(remat=False)`` from the same
parameters (``params_from_jax``) on the same ``TokenPipeline`` batches,
every step's loss within 1e-4 relative. The trajectories are held in
float32 only: in bf16 a MoE router near-tie flips between the
reference's jitted and op-by-op runs (see ``tests/test_torch_zoo.py``).
The bf16 loss is in ``tests/test_torch_train_bf16.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.optim import adamw_init as jadamw_init
from repro_torch.data import TokenPipeline
from repro_torch.launch import steps as tsteps
from repro_torch.models import config as tconfig
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw_init

ARCHES = ("deepseek-v3-671b", "phi3.5-moe-42b-a6.6b", "qwen3-8b", "phi3-mini-3.8b",
          "minitron-4b", "gemma2-2b")
STEPS = 3
TRAJECTORY_RTOL = 1e-4


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
def model_pair(arch, dtype):
    cfg = jconfigs.get_smoke_config(arch).with_overrides(dtype=dtype)
    return cfg, jmodel.init_params(cfg, jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ARCHES)
def test_three_steps_follow_the_reference(arch):
    cfg, params = model_pair(arch, "float32")
    step = jax.jit(jsteps.make_train_step(cfg, lr=3e-3, remat=False))
    opt = jadamw_init(params, cfg.opt_dtype)
    pipe = JPipeline(cfg, 2, 16, seed=3)
    want = []
    for _ in range(STEPS):
        params, opt, metrics = step(params, opt, {k: jnp.asarray(v) for k, v in
                                                  pipe.next_batch().items()})
        want.append(float(metrics["loss"]))

    pc = port_cfg(cfg)
    _, params0 = model_pair(arch, "float32")
    port = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, params0), "cpu")
    t_opt = adamw_init(port, pc.opt_dtype)
    t_step = tsteps.make_train_step(pc, lr=3e-3, remat=False)
    t_pipe = TokenPipeline(pc, 2, 16, seed=3)
    got = []
    for _ in range(STEPS):
        port, t_opt, metrics = t_step(port, t_opt, {k: torch.from_numpy(v) for k, v in
                                                    t_pipe.next_batch().items()})
        got.append(float(metrics["loss"]))
    np.testing.assert_allclose(got, want, rtol=TRAJECTORY_RTOL, atol=0)
