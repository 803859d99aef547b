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
import functools

import torch

from . import native

_ARGS = [
    ctypes.c_int64, ctypes.c_int, ctypes.c_int,  # B, K, F
    ctypes.c_float,                              # inv_k
    ctypes.c_int,                                # flags: bf16 | idx64 << 1
    ctypes.c_void_p, ctypes.c_void_p,            # table, idx
    ctypes.c_void_p,                             # out
    ctypes.c_void_p,                             # stream
]

DTYPES = (torch.float32, torch.bfloat16)
INDEX_DTYPES = (torch.int32, torch.int64)


@functools.cache
def _entry():
    """The bound C entry, resolved once per process (at its first launch)."""
    return native.bind("gather_mean", "rudder_gather_mean", _ARGS)


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
    B, K = indices.shape
    if K < 1:
        raise ValueError("gather_mean needs K >= 1 neighbours per row")
    device = native.check_inputs(table=table, indices=indices)
    F = table.shape[1]
    out = table.new_empty((B, F))
    if B == 0 or F == 0:
        return out
    flags = (table.dtype == torch.bfloat16) | (indices.dtype == torch.int64) << 1
    # ctypes rounds the double 1 / K to the nearest float32, as np.float32 does.
    native.launch(_entry(), device, "gather_mean", B, K, F, 1.0 / K, flags,
                  table.data_ptr(), indices.data_ptr(), out.data_ptr())
    native.LAUNCHES["gather_mean"] += 1
    return out
