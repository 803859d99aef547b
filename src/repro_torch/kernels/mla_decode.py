"""MLA latent flash-decode on the card: the Hopper kernel
``csrc/mla_decode.cu`` behind a PyTorch wrapper.

Port of the reference's Pallas ``mla_flash_decode``: for one new token per
request, the softmax over the latent cache rows ``0..pos`` of
``(q_lat·c + q_rope·kr)·scale`` and the context ``probs @ c`` in latent
coordinates, in float32, written in the cache's dtype. Plain version:
:func:`repro_torch.kernels.ref.mla_latent_attention`, which it matches to
allclose (1e-4 in float32, 3e-2 in bfloat16; the online softmax adds in
another order).

The rows are split over the grid (flash-decoding) so that a small batch
still fills the card: :func:`split_plan` picks the splits, and the kernel
merges them in a second pass of the same call. One wrapper call is one
count in ``native.LAUNCHES["mla_flash_decode"]``.
"""

from __future__ import annotations

import ctypes

import torch

from . import native
from .native import check_tensor, ptr

_ARGS = [
    ctypes.c_int, ctypes.c_int, ctypes.c_int,    # B, H, S
    ctypes.c_int, ctypes.c_int,                  # R, RR
    ctypes.c_int, ctypes.c_int, ctypes.c_int,    # n_valid, n_split, chunk
    ctypes.c_float, ctypes.c_int,                # scale, bf16
    ctypes.c_void_p, ctypes.c_void_p,            # q_lat, q_rope
    ctypes.c_void_p, ctypes.c_void_p,            # cache_c, cache_kr
    ctypes.c_void_p, ctypes.c_void_p,            # part_acc, part_ml
    ctypes.c_void_p,                             # out
    ctypes.c_void_p,                             # stream
]

DTYPES = (torch.float32, torch.bfloat16)
#: Latent widths the kernel is built for (a template argument each).
LATENT_DIMS = (32, 64, 128, 256, 512)
#: Rows per shared-memory tile and heads per block (``kRows``, ``kHeads``).
TILE_ROWS = 32
HEADS_PER_BLOCK = 16
MAX_SPLITS = 1024


def split_plan(B: int, H: int, n_valid: int, sm_count: int) -> tuple[int, int]:
    """``(n_split, chunk)``: the rows ``0..n_valid-1`` cut into ``n_split``
    non-empty splits of ``chunk`` rows (a multiple of :data:`TILE_ROWS`),
    as few as give the grid about two blocks per SM."""
    tiles = -(-n_valid // TILE_ROWS)
    blocks = B * -(-H // HEADS_PER_BLOCK)
    want = max(1, min(tiles, -(-2 * sm_count // blocks), MAX_SPLITS))
    chunk_tiles = -(-tiles // want)
    return -(-tiles // chunk_tiles), chunk_tiles * TILE_ROWS


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
    n_split, chunk = split_plan(
        B, H, n_valid, torch.cuda.get_device_properties(dev).multi_processor_count
    )
    part_acc = torch.empty((B, H, n_split, R), dtype=torch.float32, device=dev)
    part_ml = torch.empty((B, H, n_split, 2), dtype=torch.float32, device=dev)
    fn = native.bind("mla_decode", "rudder_mla_flash_decode", _ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        native.check(
            fn(B, H, S, R, RR, n_valid, n_split, chunk, float(scale),
               int(dtype == torch.bfloat16), ptr(q_lat), ptr(q_rope), ptr(cache_c),
               ptr(cache_kr), ptr(part_acc), ptr(part_ml), ptr(out), stream),
            "mla_flash_decode",
        )
    native.LAUNCHES["mla_flash_decode"] += 1
    return out
