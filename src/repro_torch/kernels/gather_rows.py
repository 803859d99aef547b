"""The feature-row gather on the card: the Hopper kernel
``csrc/gather_rows.cu`` behind two PyTorch wrappers.

Port of the reference's Pallas ``gather_rows_batch`` (the feature
store's per-home gather from the stacked ``(K, N_max, F)`` shard view)
and ``gather_rows`` (the single-table form, the ``P = 1`` view of the
same launch, which may also take an int32 node -> row map and read
``table[map[idx]]``: the feature store's training gather on its flat
table). Plain versions: :func:`repro_torch.kernels.ref.gather_rows_batch`
and :func:`repro_torch.kernels.ref.gather_rows`, which they match bit
for bit (a gather copies rows; it never rounds).

An empty gather (no rows, or ``F == 0``) has nothing to copy: the
wrappers return the empty output without a launch and count none.
"""

from __future__ import annotations

import ctypes

import torch

from . import native
from .native import check_tensor, ptr

_ARGS = [
    ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,  # P, N, M, F
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,         # tables, idx, map
    ctypes.c_void_p, ctypes.c_void_p,                          # out, stream
]


def _launch(tables: torch.Tensor, idx: torch.Tensor, out: torch.Tensor,
            loc: torch.Tensor | None = None) -> bool:
    """Launch the kernel unless the gather is empty; True if it ran."""
    P, N, F = tables.shape
    M = idx.shape[1]
    if P * M == 0 or F == 0:
        return False
    fn = native.bind("gather_rows", "rudder_gather_rows", _ARGS)
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream(tables.device).cuda_stream
        native.check(
            fn(P, N, M, F, ptr(tables), ptr(idx), ptr(loc), ptr(out), stream),
            "gather_rows",
        )
    return True


def gather_rows_batch_cuda(tables: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tables (P, N, F)`` float32, ``idx (P, M)`` int32 → ``(P, M, F)``,
    one launch. Indices must lie in ``[0, N)``."""
    if tables.dim() != 3 or idx.dim() != 2:
        raise ValueError(
            f"need tables (P, N, F) and idx (P, M), got {tuple(tables.shape)} "
            f"and {tuple(idx.shape)}"
        )
    P, N, F = tables.shape
    check_tensor(tables, "tables", torch.float32, (P, N, F))
    check_tensor(idx, "idx", torch.int32, (P, idx.shape[1]))
    out = torch.empty((P, idx.shape[1], F), dtype=torch.float32, device=tables.device)
    if _launch(tables, idx, out):
        native.LAUNCHES["gather_rows_batch"] += 1
    return out


def gather_rows_cuda(table: torch.Tensor, idx: torch.Tensor,
                     loc: torch.Tensor | None = None) -> torch.Tensor:
    """``table (N, F)`` float32, ``idx (M,)`` int32 → ``(M, F)``, one
    launch of the same kernel on the ``P = 1`` view. With ``loc (L,)``
    int32, row ``i`` is ``table[loc[idx[i]]]``: ``idx`` must lie in ``[0,
    L)`` and ``loc``'s entries in ``[0, N)``."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(
            f"need table (N, F) and idx (M,), got {tuple(table.shape)} and "
            f"{tuple(idx.shape)}"
        )
    N, F = table.shape
    check_tensor(table, "table", torch.float32, (N, F))
    check_tensor(idx, "idx", torch.int32, (idx.shape[0],))
    if loc is not None:
        check_tensor(loc, "loc", torch.int32, (loc.shape[0],))
        if loc.device != table.device:
            raise ValueError(f"loc is on {loc.device}, the table on {table.device}")
    out = torch.empty((idx.shape[0], F), dtype=torch.float32, device=table.device)
    if _launch(table[None], idx[None], out[None], loc):
        native.LAUNCHES["gather_rows"] += 1
    return out
