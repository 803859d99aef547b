"""The equal-length segment sum on the card: the Hopper kernel
``csrc/segment_sum.cu`` behind a PyTorch wrapper.

Port of the reference's Pallas ``segment_sum_equal`` (every k
consecutive rows of a segment-sorted block summed: the GraphSAGE fanout
sum). Plain version: :func:`repro_torch.kernels.ref.segment_sum_equal`,
which it matches bit for bit (both add the k rows in order in float32).

The data is float32 or bfloat16. An empty launch (``S == 0`` or ``F ==
0``) has nothing to compute: the wrapper returns the empty output
without a launch and counts none.
"""

from __future__ import annotations

import ctypes

import torch

from . import native
from .native import check_tensor, ptr

_ARGS = [
    ctypes.c_int64, ctypes.c_int, ctypes.c_int,  # S, k, F
    ctypes.c_int,                                # bf16
    ctypes.c_void_p, ctypes.c_void_p,            # data, out
    ctypes.c_void_p,                             # stream
]

DTYPES = (torch.float32, torch.bfloat16)


def segment_sum_equal_cuda(data: torch.Tensor, k: int) -> torch.Tensor:
    """``data (S*k, F)`` float32 or bfloat16, ``k >= 1`` rows per segment
    → ``(S, F)`` in the data's dtype, one launch."""
    if data.dim() != 2:
        raise ValueError(f"need data (S*k, F), got {tuple(data.shape)}")
    if data.dtype not in DTYPES:
        raise ValueError(f"need float32 or bfloat16 data, got {data.dtype}")
    E, F = data.shape
    k = int(k)
    if k < 1 or E % k:
        raise ValueError(f"segment_sum_equal needs k >= 1 dividing {E} rows, got {k}")
    check_tensor(data, "data", data.dtype, (E, F))
    S = E // k
    out = torch.empty((S, F), dtype=data.dtype, device=data.device)
    if S == 0 or F == 0:
        return out
    fn = native.bind("segment_sum", "rudder_segment_sum", _ARGS)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        native.check(
            fn(S, k, F, int(data.dtype == torch.bfloat16), ptr(data), ptr(out), stream),
            "segment_sum_equal",
        )
    native.LAUNCHES["segment_sum_equal"] += 1
    return out
