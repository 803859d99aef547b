"""MLA latent flash-decode on the card: the Hopper kernels of
``csrc/mla_decode.cu`` behind a PyTorch wrapper.

Port of the reference's Pallas ``mla_flash_decode``: for one new token per
request, the softmax over the latent cache rows ``0..pos`` of
``(q_lat·c + q_rope·kr)·scale`` and the context ``probs @ c`` in latent
coordinates, in float32, written in the cache's dtype. Plain version:
:func:`repro_torch.kernels.ref.mla_latent_attention`, which it matches to
allclose (1e-4 in float32, 3e-2 in bfloat16; the online softmax adds in
another order, and the bfloat16 kernel rounds the probabilities to bfloat16
before the context product, as the reference's XLA decode does).

The wrapper picks the kernel by dtype: bfloat16 runs the tensor-core kernel
(``wgmma`` on TMA-fed row tiles, 64 heads a block), float32 the CUDA-core
kernel (float32 products, 16 heads a block). The rows are split over the
grid (flash-decoding) so that a small batch still fills the card:
:func:`split_plan` picks the splits for each kernel's geometry, and a merge
pass of the same call combines them. One wrapper call is one count in
``native.LAUNCHES["mla_flash_decode"]`` and one in :data:`KERNEL_LAUNCHES`
under the kernel that ran.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import native
from .native import check_tensor, ptr

_ARGS = [
    ctypes.c_int, ctypes.c_int, ctypes.c_int,    # B, H, S
    ctypes.c_int, ctypes.c_int,                  # R, RR
    ctypes.c_int, ctypes.c_int, ctypes.c_int,    # n_valid, n_split, chunk
    ctypes.c_float,                              # scale
    ctypes.c_void_p, ctypes.c_void_p,            # q_lat, q_rope
    ctypes.c_void_p, ctypes.c_void_p,            # cache_c, cache_kr
    ctypes.c_void_p, ctypes.c_void_p,            # part_acc, part_ml
    ctypes.c_void_p,                             # out
    ctypes.c_void_p,                             # stream
]

DTYPES = (torch.float32, torch.bfloat16)
#: Latent widths the kernels are built for (a template argument each).
LATENT_DIMS = (32, 64, 128, 256, 512)
MAX_SPLITS = 1024


class Geometry(NamedTuple):
    """How one kernel cuts the work: heads a block, cache rows a tile
    (the split granularity) and blocks an SM."""

    heads: int
    rows: int
    blocks_per_sm: int


#: The tensor-core kernel (bfloat16): 64 heads a block (wgmma's M), tiles of
#: 64 rows, one block an SM (its shared memory holds the queries and the
#: ring of row tiles; the kernel's ``tc_layout`` sizes the ring).
TENSOR_CORES = Geometry(heads=64, rows=64, blocks_per_sm=1)
#: The CUDA-core kernel (float32): 16 heads a block, tiles of 32 rows.
CUDA_CORES = Geometry(heads=16, rows=32, blocks_per_sm=2)
#: Columns of one 128-byte swizzle chunk of a bfloat16 row tile.
CHUNK = 64

#: Launches of each kernel behind :func:`mla_flash_decode_cuda`.
KERNEL_LAUNCHES = {"tensor_cores": 0, "cuda_cores": 0}

_SM_COUNT: dict[int, int] = {}


def geometry(dtype: torch.dtype) -> Geometry:
    return TENSOR_CORES if dtype == torch.bfloat16 else CUDA_CORES


def kernel_name(dtype: torch.dtype) -> str:
    """The :data:`KERNEL_LAUNCHES` key of the kernel that runs ``dtype``."""
    return "tensor_cores" if dtype == torch.bfloat16 else "cuda_cores"


def padded_width(R: int, RR: int) -> int:
    """Columns of a bfloat16 row tile: ``[c | kr]`` with each part padded
    to whole 64-column chunks (``R`` 32 reads one 64-wide chunk)."""
    return max(R, CHUNK) + -(-RR // CHUNK) * CHUNK


def split_plan(B: int, H: int, n_valid: int, sm_count: int,
               geom: Geometry = TENSOR_CORES) -> tuple[int, int]:
    """``(n_split, chunk)``: the rows ``0..n_valid-1`` cut into ``n_split``
    non-empty splits of ``chunk`` rows (a multiple of ``geom.rows``). One
    split when the blocks of whole requests fill the card's resident
    blocks; else as few as give about one wave (at most one split a tile)."""
    tiles = -(-n_valid // geom.rows)
    blocks = B * -(-H // geom.heads)
    want = max(1, min(tiles, -(-geom.blocks_per_sm * sm_count // blocks), MAX_SPLITS))
    chunk_tiles = -(-tiles // want)
    return -(-tiles // chunk_tiles), chunk_tiles * geom.rows


def sm_count(dev: torch.device) -> int:
    """The card's SM count, read once per device."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    count = _SM_COUNT.get(index)
    if count is None:
        count = _SM_COUNT[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return count


def mla_flash_decode_cuda(
    q_lat: torch.Tensor,
    q_rope: torch.Tensor,
    cache_c: torch.Tensor,
    cache_kr: torch.Tensor,
    pos: int,
    scale: float,
) -> torch.Tensor:
    """``q_lat (B, H, R)``, ``q_rope (B, H, RR)``, ``cache_c (B, S, R)``,
    ``cache_kr (B, S, RR)``, all float32 or all bfloat16, and the host int
    ``pos >= 0`` (rows ``0..pos`` attend; ``pos >= S`` means all) →
    the latent context ``(B, H, R)`` in the cache's dtype, one wrapper call
    (a split pass and a merge pass; none for ``B == 0`` or ``H == 0``)."""
    if q_lat.dim() != 3 or cache_c.dim() != 3:
        raise ValueError(
            f"need q_lat (B, H, R) and cache_c (B, S, R), got {tuple(q_lat.shape)} "
            f"and {tuple(cache_c.shape)}"
        )
    B, H, R = q_lat.shape
    S = cache_c.shape[1]
    RR = q_rope.shape[-1]
    dtype = cache_c.dtype
    if dtype not in DTYPES:
        raise ValueError(f"need float32 or bfloat16 tensors, got {dtype}")
    if R not in LATENT_DIMS or RR % 4:
        raise ValueError(
            f"the kernel takes R in {LATENT_DIMS} and RR a multiple of 4, got "
            f"R={R}, RR={RR}"
        )
    pos = int(pos)
    if pos < 0:
        raise ValueError(f"pos must be >= 0, got {pos}")
    check_tensor(q_lat, "q_lat", dtype, (B, H, R))
    check_tensor(q_rope, "q_rope", dtype, (B, H, RR))
    check_tensor(cache_c, "cache_c", dtype, (B, S, R))
    check_tensor(cache_kr, "cache_kr", dtype, (B, S, RR))
    if S == 0:
        raise ValueError("mla_flash_decode needs a cache of at least one row")
    dev = cache_c.device
    out = torch.empty((B, H, R), dtype=dtype, device=dev)
    if B == 0 or H == 0:
        return out
    n_valid = min(pos, S - 1) + 1
    n_split, chunk = split_plan(B, H, n_valid, sm_count(dev), geometry(dtype))
    part_acc = torch.empty((B, H, n_split, R), dtype=torch.float32, device=dev)
    part_ml = torch.empty((B, H, n_split, 2), dtype=torch.float32, device=dev)
    tensors = (ptr(q_lat), ptr(q_rope), ptr(cache_c), ptr(cache_kr), ptr(part_acc),
               ptr(part_ml), ptr(out))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry = ("rudder_mla_flash_decode_bf16" if dtype == torch.bfloat16
                 else "rudder_mla_flash_decode_f32")
        err = native.bind("mla_decode", entry, _ARGS)(
            B, H, S, R, RR, n_valid, n_split, chunk, float(scale), *tensors, stream)
        native.check(err, "mla_flash_decode")
    native.LAUNCHES["mla_flash_decode"] += 1
    KERNEL_LAUNCHES[kernel_name(dtype)] += 1
    return out
