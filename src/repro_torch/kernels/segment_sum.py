"""The equal-length segment sum on the card: the Hopper kernel
``csrc/segment_sum.cu`` behind a PyTorch wrapper.

Port of the reference's Pallas ``segment_sum_equal`` (every k
consecutive rows of a segment-sorted block summed: the GraphSAGE fanout
sum), with an optional float32 ``scale`` applied to the rounded sums in
the same launch (the fanout mean, ``scale = 1 / k``). Plain version:
:func:`repro_torch.kernels.ref.segment_sum_equal`, which it matches bit
for bit (both add the k rows in order in float32, and round the scaled
form alike).

The data is float32 or bfloat16. An empty launch (``S == 0`` or ``F ==
0``) has nothing to compute: the wrapper returns the empty output
without a launch and counts none.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import native

_ARGS = [
    ctypes.c_int64, ctypes.c_int, ctypes.c_int,  # S, k, F
    ctypes.c_float,                              # scale
    ctypes.c_int,                                # flags: bf16 | scaled << 1
    ctypes.c_void_p, ctypes.c_void_p,            # data, out
    ctypes.c_void_p,                             # stream
]

DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _entry():
    """The bound C entry, resolved once per process (at its first launch)."""
    return native.bind("segment_sum", "rudder_segment_sum", _ARGS)


def segment_sum_equal_cuda(
    data: torch.Tensor, k: int, scale: float | None = None
) -> torch.Tensor:
    """``data (S*k, F)`` float32 or bfloat16, ``k >= 1`` rows per segment
    → ``(S, F)`` in the data's dtype, one launch; with ``scale``, each
    rounded sum times the float32 ``scale``, rounded again (see
    :func:`repro_torch.kernels.ref.segment_sum_equal`)."""
    if data.dim() != 2:
        raise ValueError(f"need data (S*k, F), got {tuple(data.shape)}")
    if data.dtype not in DTYPES:
        raise ValueError(f"need float32 or bfloat16 data, got {data.dtype}")
    E, F = data.shape
    k = int(k)
    if k < 1 or E % k:
        raise ValueError(f"segment_sum_equal needs k >= 1 dividing {E} rows, got {k}")
    device = native.check_inputs(data=data)
    S = E // k
    out = data.new_empty((S, F))
    if S == 0 or F == 0:
        return out
    flags = (data.dtype == torch.bfloat16) | (scale is not None) << 1
    native.launch(_entry(), device, "segment_sum_equal", S, k, F,
                  0.0 if scale is None else scale, flags, data.data_ptr(),
                  out.data_ptr())
    native.LAUNCHES["segment_sum_equal"] += 1
    return out
