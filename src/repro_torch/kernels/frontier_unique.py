"""The sampler plane's frontier dedup on the card: the Hopper kernel
``csrc/frontier_unique.cu`` behind PyTorch wrappers.

Port of the reference's Pallas ``frontier_unique_batch`` (int32 keys)
and ``frontier_unique_batch_wide`` (64-bit keys as ``(hi, lo)`` word
planes): one kernel, instantiated for int32 and int64 keys, in two forms.

- The reference's form (:func:`frontier_unique_batch_cuda`,
  :func:`frontier_unique_batch_wide_cuda`): the two ``(P, M)`` masks and
  the counts. Plain version:
  :func:`repro_torch.kernels.ref.frontier_unique_batch`.
- The sampler's form (:func:`frontier_unique_compact_cuda`): the remote
  flags from ``part_of`` inside the kernel and the compacted ids in flat
  row order in place of the masks. Plain version:
  :func:`repro_torch.kernels.ref.frontier_unique_compact`.

Both match their plain versions bit for bit (the masks are comparisons,
the counts integer sums, the compaction offsets exact prefix sums). A
call is one device operation: the kernel keeps its counts, its
completion ticket and its scan states in a scratch block of each device
and stream
(:data:`_SCRATCH`), zero between launches, and writes its outputs in
full. Launches are counted under ``frontier_unique_batch`` (int32 keys)
or ``frontier_unique_batch_wide`` (int64), in both forms.

``M == 0`` has nothing to mark: the wrappers return empty outputs and
zero counts without a launch and count none.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import native

_REF_ARGS = [
    ctypes.c_int, ctypes.c_int64,                   # P, M
    ctypes.c_void_p, ctypes.c_void_p,               # keys, is_remote
    ctypes.c_void_p, ctypes.c_void_p,               # first, remote
    ctypes.c_void_p, ctypes.c_void_p,               # counts, ctl
    ctypes.c_int,                                   # vec
    ctypes.c_void_p,                                # stream
]

_COMPACT_ARGS = [
    ctypes.c_int, ctypes.c_int64,                   # P, M
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # keys, part_of, n_part
    ctypes.c_void_p, ctypes.c_void_p,               # uniq, rem
    ctypes.c_void_p, ctypes.c_void_p,               # counts, ctl
    ctypes.c_void_p,                                # tiles
    ctypes.c_int,                                   # vec
    ctypes.c_void_p,                                # stream
]

#: Positions a block of the kernel takes (its look-back tile).
TILE = 4096

#: The kernel's scratch of each (device, stream): int32 ``ctl`` words
#: (a spare word, the completion ticket, then the per-row unique and
#: remote counts) and int64 look-back tile states, zero between launches
#: (every launch's last block puts them back), grown zeroed when too
#: small; a launch that fails drops them.
_SCRATCH: dict = {}

_ENTRIES = {
    # (compact, wide) -> (C entry, argtypes, launch counter)
    (False, False): ("rudder_frontier_unique", _REF_ARGS, "frontier_unique_batch"),
    (False, True): ("rudder_frontier_unique_wide", _REF_ARGS, "frontier_unique_batch_wide"),
    (True, False): ("rudder_frontier_unique_compact", _COMPACT_ARGS, "frontier_unique_batch"),
    (True, True): (
        "rudder_frontier_unique_compact_wide", _COMPACT_ARGS, "frontier_unique_batch_wide"),
}


@functools.cache
def _entry(compact: bool, wide: bool):
    """The bound C entry of a form, resolved once per process."""
    name, argtypes, _ = _ENTRIES[(compact, wide)]
    return native.bind("frontier_unique", name, argtypes)


def _scratch(dev, P: int, n_tiles: int):
    """The (device, current stream)'s kept ``(ctl, tiles)``, grown (zeroed,
    to at least twice the old size) when smaller than this launch needs."""
    key = (dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    ctl, tiles = _SCRATCH.get(key, (None, None))
    if ctl is None or ctl.numel() < 2 + 2 * P:
        old = 0 if ctl is None else ctl.numel()
        ctl = torch.zeros(max(2 + 2 * P, 2 * old), dtype=torch.int32, device=dev)
    if tiles is None or tiles.numel() < n_tiles:
        old = 0 if tiles is None else tiles.numel()
        tiles = torch.zeros(max(n_tiles, 2 * old, 1), dtype=torch.int64, device=dev)
    _SCRATCH[key] = (ctl, tiles)
    return key, ctl, tiles


def _aligned(*tensors) -> int:
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


def _launch(compact: bool, wide: bool, dev, args, P: int, n_tiles: int):
    key, ctl, tiles = _scratch(dev, P, n_tiles)
    name = _ENTRIES[(compact, wide)][2]
    err = native.launch_status(_entry(compact, wide), dev, *args(ctl, tiles))
    if err:
        _SCRATCH.pop(key, None)  # a failed launch may leave it dirty
    native.check(err, name)
    native.LAUNCHES[name] += 1


def _check_keys(keys: torch.Tensor, dtype):
    if keys.dim() != 2:
        raise ValueError(f"need keys (P, M), got {tuple(keys.shape)}")
    P, M = keys.shape
    native.check_tensor(keys, "keys", dtype, (P, M))
    return P, M


def _run(wide: bool, keys: torch.Tensor, is_remote: torch.Tensor):
    P, M = _check_keys(keys, torch.int64 if wide else torch.int32)
    native.check_tensor(is_remote, "is_remote", torch.bool, (P, M))
    dev = keys.device
    first = torch.empty((P, M), dtype=torch.bool, device=dev)
    remote = torch.empty((P, M), dtype=torch.bool, device=dev)
    counts = torch.empty((2, P), dtype=torch.int32, device=dev)
    if P * M == 0:
        counts.zero_()
        return first, remote, counts[0], counts[1]
    vec = _aligned(keys, is_remote)
    _launch(False, wide, dev, lambda ctl, tiles: (
        P, M, keys.data_ptr(), is_remote.data_ptr(), first.data_ptr(),
        remote.data_ptr(), counts.data_ptr(), ctl.data_ptr(), vec,
    ), P, 0)
    return first, remote, counts[0], counts[1]


def frontier_unique_batch_cuda(keys: torch.Tensor, is_remote: torch.Tensor):
    """Row-sorted int32 keys ``(P, M)`` and bool flags ``(P, M)`` →
    ``(first, remote, unique_count, remote_count)``: two ``(P, M)`` bool
    masks and two ``(P,)`` int32 counts, one launch."""
    return _run(False, keys, is_remote)


def frontier_unique_batch_wide_cuda(keys: torch.Tensor, is_remote: torch.Tensor):
    """:func:`frontier_unique_batch_cuda` over int64 keys (the reference's
    wide twin), one launch of the int64 instantiation."""
    return _run(True, keys, is_remote)


def frontier_unique_compact_cuda(keys: torch.Tensor, part_of: torch.Tensor | None = None):
    """The sampler's form: row-sorted keys ``(P, M)`` (int32, or int64 on
    the int64 instantiation; each key an index of ``part_of``) and
    ``part_of`` (int32, or None) → ``(uniq, rem, unique_count,
    remote_count)``, one launch. ``uniq`` and ``rem`` are ``(P * M,)``
    buffers of the keys' dtype whose first ``unique_count.sum()`` /
    ``remote_count.sum()`` entries are ``keys.ravel()[first.ravel()]`` and
    ``keys.ravel()[remote.ravel()]`` (remote: ``part_of[key] != row``);
    ``rem`` is None without ``part_of``."""
    if keys.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"keys must be int32 or int64, got {keys.dtype}")
    wide = keys.dtype == torch.int64
    P, M = _check_keys(keys, keys.dtype)
    if P * M >= 2**31:
        raise ValueError(f"the compact form takes fewer than 2^31 positions, got {P * M}")
    dev = keys.device
    if part_of is not None:
        if part_of.dim() != 1:
            raise ValueError(f"need part_of (N,), got {tuple(part_of.shape)}")
        native.check_tensor(part_of, "part_of", torch.int32, tuple(part_of.shape))
        if part_of.device != dev:
            raise ValueError(f"part_of is on {part_of.device}, the keys on {dev}")
    uniq = torch.empty((P * M,), dtype=keys.dtype, device=dev)
    rem = None if part_of is None else torch.empty((P * M,), dtype=keys.dtype, device=dev)
    counts = torch.empty((2, P), dtype=torch.int32, device=dev)
    if P * M == 0:
        counts.zero_()
        return uniq, rem, counts[0], counts[1]
    n_part = 0 if part_of is None else part_of.numel()
    _launch(True, wide, dev, lambda ctl, tiles: (
        P, M, keys.data_ptr(), native.ptr(part_of), n_part, uniq.data_ptr(),
        native.ptr(rem), counts.data_ptr(), ctl.data_ptr(), tiles.data_ptr(),
        _aligned(keys),
    ), P, -(-(P * M) // TILE))
    return uniq, rem, counts[0], counts[1]
