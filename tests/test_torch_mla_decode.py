"""The MLA flash-decode's plain version and dispatcher against the
reference, on the CPU.

``repro_torch.kernels.ref.mla_latent_attention`` (the spec of
``csrc/mla_decode.cu``) against the reference's jnp oracle
(``repro.kernels.ref.mla_latent_attention``) and its interpret-mode Pallas
kernel (``repro.kernels.ops.mla_flash_decode``), on the reference test's
shape and dtype sweep and a ``hypothesis`` twin of its masking property.
Tolerances are the reference's own (``tests/test_mla_decode_kernel.py``):
``1e-4`` in float32, ``3e-2`` in bfloat16 (the Pallas kernel's online
softmax sums in another order). Inputs come from a numpy seed and reach
both packages as the same bits. The dispatcher sends CPU tensors to the
plain version (no launch counted), and the CUDA wrapper refuses a CPU
tensor rather than fall back. The kernel itself runs on the card only:
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import mla_decode as md
from repro_torch.kernels import native, ops, ref

SHAPES = [
    (1, 4, 32, 8, 64),
    (2, 8, 64, 16, 700),     # S not a multiple of the Pallas tile
    (1, 16, 128, 64, 512),   # DeepSeek-like widths (scaled)
]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def make_inputs(b, h, r, rr, s, seed=0):
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal(shape) * 0.3).astype(np.float32)
        for shape in ((b, h, r), (b, h, rr), (b, s, r), (b, s, rr))
    ]


def as_jax(arrays, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def as_torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def assert_close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,r,rr,s", SHAPES)
def test_plain_matches_jnp_oracle(b, h, r, rr, s, dtype):
    arrays = make_inputs(b, h, r, rr, s)
    scale = 1.0 / (r + rr) ** 0.5
    for pos in (0, s // 2, s - 1):
        got = ref.mla_latent_attention(*as_torch(arrays, dtype), pos, scale)
        want = jref.mla_latent_attention(*as_jax(arrays, dtype), pos, scale)
        assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (b, h, r)
        assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,r,rr,s", SHAPES)
def test_plain_matches_interpret_pallas(b, h, r, rr, s, dtype):
    arrays = make_inputs(b, h, r, rr, s, seed=1)
    scale = 1.0 / (r + rr) ** 0.5
    pos = s - 1
    got = ops.mla_flash_decode(*as_torch(arrays, dtype), pos, scale=scale)
    want = jops.mla_flash_decode(*as_jax(arrays, dtype), jnp.int32(pos), scale=scale)
    assert_close(got, want, dtype)


@given(pos=st.integers(0, 699))
@settings(max_examples=12, deadline=None)
def test_plain_masking_property(pos):
    """Masking at arbitrary positions, tile edges included: the plain
    version against interpret-mode Pallas and the jnp oracle."""
    arrays = make_inputs(1, 4, 32, 8, 700)
    scale = 1.0 / 40 ** 0.5
    got = ref.mla_latent_attention(*as_torch(arrays, "float32"), pos, scale)
    want = jops.mla_flash_decode(*as_jax(arrays, "float32"), jnp.int32(pos), scale=scale)
    oracle = jref.mla_latent_attention(*as_jax(arrays, "float32"), pos, scale)
    assert_close(got, want, "float32")
    assert_close(got, oracle, "float32")


def test_rows_past_pos_do_not_count():
    arrays = make_inputs(2, 4, 32, 8, 40, seed=2)
    t = as_torch(arrays, "float32")
    pos = 17
    want = ref.mla_latent_attention(*t, pos, 0.3)
    t[2][:, pos + 1 :] = 1e3
    t[3][:, pos + 1 :] = -1e3
    torch.testing.assert_close(ref.mla_latent_attention(*t, pos, 0.3), want, rtol=0, atol=0)


def test_dispatcher_routes_cpu_tensors_to_the_plain_version():
    arrays = make_inputs(2, 8, 64, 16, 50, seed=3)
    t = as_torch(arrays, "float32")
    native.reset_launches()
    got = ops.mla_flash_decode(*t, 20)  # scale defaults to 1/sqrt(r + rr)
    want = ref.mla_latent_attention(*t, 20, 1.0 / 80 ** 0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # pos as a 0-dim tensor, as the reference's scalar
    torch.testing.assert_close(ops.mla_flash_decode(*t, torch.tensor(20)), want, rtol=0, atol=0)
    assert native.LAUNCHES["mla_flash_decode"] == 0
    assert "mla_flash_decode" in native.KERNELS
    assert native.SOURCES["mla_decode"] == "mla_decode.cu"


def test_cuda_wrapper_refuses_cpu_tensors():
    t = as_torch(make_inputs(1, 4, 32, 8, 16), "float32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        md.mla_flash_decode_cuda(*t, 3, 0.1)
    with pytest.raises(ValueError, match="R in"):
        md.mla_flash_decode_cuda(*as_torch(make_inputs(1, 4, 24, 8, 16), "float32"), 3, 0.1)
    with pytest.raises(ValueError, match="pos"):
        md.mla_flash_decode_cuda(*t, -1, 0.1)


@pytest.mark.parametrize(
    "B,H,n_valid",
    [(1, 4, 1), (1, 4, 64), (2, 8, 700), (1, 16, 512), (4, 128, 1), (4, 128, 289),
     (4, 128, 33), (128, 128, 32768), (1, 1, 100_000)],
)
def test_split_plan_covers_the_rows(B, H, n_valid):
    """Every split holds at least one valid row, the splits cover
    ``0..n_valid-1`` in whole tiles, and the grid gets about two blocks
    per SM where the rows allow it (what the kernel's entry checks)."""
    sms = 132
    n_split, chunk = md.split_plan(B, H, n_valid, sms)
    assert chunk % md.TILE_ROWS == 0 and 1 <= n_split <= md.MAX_SPLITS
    assert (n_split - 1) * chunk < n_valid <= n_split * chunk
    blocks = B * -(-H // md.HEADS_PER_BLOCK)
    tiles = -(-n_valid // md.TILE_ROWS)
    if blocks >= 2 * sms:
        assert n_split == 1
    elif tiles >= -(-2 * sms // blocks):
        assert blocks * n_split >= sms
