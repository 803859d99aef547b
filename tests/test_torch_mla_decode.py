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


PLAN_CASES = [(1, 4, 1), (1, 4, 64), (2, 8, 700), (1, 16, 512), (4, 128, 1), (4, 128, 289),
              (4, 128, 33), (128, 128, 32768), (1, 1, 100_000),
              (1, 64, 300), (3, 64, 32768), (2, 72, 1000), (128, 72, 4096)]


def _check_plan(B, H, n_valid, geom, slack=0):
    """Every split holds at least one valid row, the splits cover
    ``0..n_valid-1`` in whole tiles (what the kernel's entry checks), and
    the grid gives every SM a block, to within ``slack`` splits of each
    head block, where the rows allow it."""
    sms = 132
    n_split, chunk = md.split_plan(B, H, n_valid, sms, geom)
    assert chunk % geom.rows == 0 and 1 <= n_split <= md.MAX_SPLITS
    assert (n_split - 1) * chunk < n_valid <= n_split * chunk
    blocks = B * -(-H // geom.heads)
    tiles = -(-n_valid // geom.rows)
    resident = geom.blocks_per_sm * sms
    if blocks >= resident:
        assert n_split == 1
    elif tiles >= -(-resident // blocks):
        assert blocks * (n_split + slack) >= sms
    else:
        assert n_split == tiles  # one tile a split: the least work a block can have


@pytest.mark.parametrize("B,H,n_valid", PLAN_CASES)
def test_split_plan_covers_the_rows(B, H, n_valid):
    """The tensor-core kernel's plan (the default): 64-head blocks, 64-row
    tiles, one block an SM; its few, large blocks round the splits to whole
    64-row tiles, which may leave one split a head block short."""
    _check_plan(B, H, n_valid, md.TENSOR_CORES, slack=1)
    assert md.split_plan(B, H, n_valid, 132) == md.split_plan(B, H, n_valid, 132,
                                                               md.TENSOR_CORES)


@pytest.mark.parametrize("B,H,n_valid", PLAN_CASES)
def test_split_plan_cuda_cores(B, H, n_valid):
    """The float32 kernel's plan: 16-head blocks, 32-row tiles, two blocks
    an SM."""
    _check_plan(B, H, n_valid, md.CUDA_CORES)


def test_geometry_by_dtype():
    assert md.geometry(torch.bfloat16) == md.TENSOR_CORES == (64, 64, 1)
    assert md.geometry(torch.float32) == md.CUDA_CORES == (16, 32, 2)
    assert md.kernel_name(torch.bfloat16) == "tensor_cores"
    assert md.kernel_name(torch.float32) == "cuda_cores"
    # DeepSeek-V3 at decode_32k: 2 head blocks a request, 256 blocks, one split.
    assert md.split_plan(128, 128, 32768, 132) == (1, 32768)
    # The serve shape: 8 blocks, one 64-row tile a split.
    assert md.split_plan(4, 128, 289, 132) == (5, 64)


@pytest.mark.parametrize(
    "R,RR,width",
    [(512, 64, 576),    # DeepSeek-V3: 36 k-steps of 16
     (256, 64, 320), (128, 64, 192), (64, 16, 128),
     (32, 8, 128),      # r 32 reads one 64-wide chunk; r + rr = 40 pads K to 128
     (32, 4, 128),      # rr 4: 8-byte kr rows (staged by plain loads)
     (128, 0, 128), (512, 128, 640),
     (512, 672, 1216),  # r + rr = 1184, the widest row either kernel takes
     (32, 1152, 1216)],
)
def test_padded_width(R, RR, width):
    """K padded to whole 64-column chunks of the bfloat16 row tile."""
    assert md.padded_width(R, RR) == width and width % md.CHUNK == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_rows_reach_the_kernel(dtype):
    """Rows up to r + rr = 1184 are taken in both dtypes (the bfloat16
    kernel streams the queries where they do not fit beside a row tile):
    on CPU tensors the wrapper gets as far as the device check."""
    t = as_torch(make_inputs(1, 4, 512, 672, 8), dtype)
    with pytest.raises(ValueError, match="CUDA tensor"):
        md.mla_flash_decode_cuda(*t, 3, 0.1)


def test_sm_count_is_read_once(monkeypatch):
    calls = []

    class Props:
        multi_processor_count = 132

    def props(index):
        calls.append(index)
        return Props()

    monkeypatch.setattr(md, "_SM_COUNT", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    dev = torch.device("cuda", 0)
    assert md.sm_count(dev) == 132 and md.sm_count(dev) == 132
    assert calls == [0]
