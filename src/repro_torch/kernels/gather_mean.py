"""The GraphSAGE neighbour mean on the card: the Hopper kernel
``csrc/gather_mean.cu`` behind a PyTorch wrapper.

Port of the reference's Pallas ``gather_mean`` (gather each destination's
K sampled neighbour rows from the feature table and average them, with
no ``(B, K, F)`` block in between). Plain version:
:func:`repro_torch.kernels.ref.gather_mean`, which it matches bit for bit
(both add the rows in neighbour order in float32 and multiply by the
float32 ``1 / K``).

The table is float32 or bfloat16, the indices int32 or int64. An empty
launch (``B == 0`` or ``F == 0``) has nothing to compute: the wrapper
returns the empty output without a launch and counts none.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import native
from .native import check_tensor, ptr

_ARGS = [
    ctypes.c_int64, ctypes.c_int, ctypes.c_int,  # B, K, F
    ctypes.c_float,                              # inv_k
    ctypes.c_int, ctypes.c_int,                  # bf16, idx64
    ctypes.c_void_p, ctypes.c_void_p,            # table, idx
    ctypes.c_void_p,                             # out
    ctypes.c_void_p,                             # stream
]

DTYPES = (torch.float32, torch.bfloat16)
INDEX_DTYPES = (torch.int32, torch.int64)


def gather_mean_cuda(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``table (N, F)`` float32 or bfloat16, ``indices (B, K)`` int32 or
    int64 (``K >= 1``, every index in ``[0, N)``) → ``(B, F)`` in the
    table's dtype, one launch."""
    if table.dim() != 2 or indices.dim() != 2:
        raise ValueError(
            f"need table (N, F) and indices (B, K), got {tuple(table.shape)} "
            f"and {tuple(indices.shape)}"
        )
    if table.dtype not in DTYPES or indices.dtype not in INDEX_DTYPES:
        raise ValueError(
            f"need a float32 or bfloat16 table and int32 or int64 indices, got "
            f"{table.dtype} and {indices.dtype}"
        )
    N, F = table.shape
    B, K = indices.shape
    if K < 1:
        raise ValueError("gather_mean needs K >= 1 neighbours per row")
    check_tensor(table, "table", table.dtype, (N, F))
    check_tensor(indices, "indices", indices.dtype, (B, K))
    out = torch.empty((B, F), dtype=table.dtype, device=table.device)
    if B == 0 or F == 0:
        return out
    fn = native.bind("gather_mean", "rudder_gather_mean", _ARGS)
    inv_k = float(np.float32(1.0 / K))
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        native.check(
            fn(B, K, F, inv_k, int(table.dtype == torch.bfloat16),
               int(indices.dtype == torch.int64), ptr(table), ptr(indices),
               ptr(out), stream),
            "gather_mean",
        )
    native.LAUNCHES["gather_mean"] += 1
    return out
