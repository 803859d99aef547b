"""The sampler plane's frontier dedup on the card: the Hopper kernel
``csrc/frontier_unique.cu`` behind two PyTorch wrappers.

Port of the reference's Pallas ``frontier_unique_batch`` (int32 keys)
and ``frontier_unique_batch_wide`` (64-bit keys as ``(hi, lo)`` word
planes): one kernel, instantiated for int32 and int64 keys. Plain
version: :func:`repro_torch.kernels.ref.frontier_unique_batch`, which
they match bit for bit (the masks are comparisons, the counts integer
sums).

``M == 0`` has nothing to mark: the wrappers return empty masks and zero
counts without a launch and count none.
"""

from __future__ import annotations

import ctypes

import torch

from . import native
from .native import check_tensor, ptr

_ARGS = [
    ctypes.c_int, ctypes.c_int64,                   # P, M
    ctypes.c_void_p, ctypes.c_void_p,               # keys, is_remote
    ctypes.c_void_p, ctypes.c_void_p,               # first, remote
    ctypes.c_void_p, ctypes.c_void_p,               # ucount, rcount
    ctypes.c_void_p,                                # stream
]


def _run(name: str, entry: str, keys: torch.Tensor, is_remote: torch.Tensor, dtype):
    if keys.dim() != 2:
        raise ValueError(f"need keys (P, M), got {tuple(keys.shape)}")
    P, M = keys.shape
    check_tensor(keys, "keys", dtype, (P, M))
    check_tensor(is_remote, "is_remote", torch.bool, (P, M))
    dev = keys.device
    first = torch.empty((P, M), dtype=torch.bool, device=dev)
    remote = torch.empty((P, M), dtype=torch.bool, device=dev)
    ucount = torch.zeros((P,), dtype=torch.int32, device=dev)
    rcount = torch.zeros((P,), dtype=torch.int32, device=dev)
    if P * M == 0:
        return first, remote, ucount, rcount
    fn = native.bind("frontier_unique", entry, _ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        native.check(
            fn(P, M, ptr(keys), ptr(is_remote), ptr(first), ptr(remote),
               ptr(ucount), ptr(rcount), stream),
            name,
        )
    native.LAUNCHES[name] += 1
    return first, remote, ucount, rcount


def frontier_unique_batch_cuda(keys: torch.Tensor, is_remote: torch.Tensor):
    """Row-sorted int32 keys ``(P, M)`` and bool flags ``(P, M)`` →
    ``(first, remote, unique_count, remote_count)``: two ``(P, M)`` bool
    masks and two ``(P,)`` int32 counts, one launch."""
    return _run(
        "frontier_unique_batch", "rudder_frontier_unique", keys, is_remote,
        torch.int32,
    )


def frontier_unique_batch_wide_cuda(keys: torch.Tensor, is_remote: torch.Tensor):
    """:func:`frontier_unique_batch_cuda` over int64 keys (the reference's
    wide twin), one launch of the int64 instantiation."""
    return _run(
        "frontier_unique_batch_wide", "rudder_frontier_unique_wide", keys,
        is_remote, torch.int64,
    )
