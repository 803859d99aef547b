"""Device meshes over a ``torch.distributed`` world.

Counterpart of the reference's ``repro.launch.mesh``. Single pod: (data=16,
model=16) = 256 ranks; multi-pod: (pod=2, data=16, model=16) = 512 ranks,
one rank per device. A mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` over the process group
the caller has started (``torch.distributed.init_process_group``): the
functions here start none, so importing this module touches no device
and no process group, and a world of the wrong size raises instead of
building a smaller mesh.

The hardware constants keep the reference's names (its TPU v5e values
become one NVIDIA H100's) for the roofline of the sharded programs.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..runtime.engine import resolve_device

PRODUCTION_SHAPE = {False: (16, 16), True: (2, 16, 16)}
PRODUCTION_AXES = {False: ("data", "model"), True: ("pod", "data", "model")}


def _mesh(device_type: str, shape: tuple[int, ...], axes: tuple[str, ...], what: str) -> DeviceMesh:
    size = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != size:
        have = f"a world of {world}" if world is not None else "no process group"
        raise RuntimeError(
            f"{what} {dict(zip(axes, shape))} needs a torch.distributed world of "
            f"{size} ranks, one per device, and there is {have}: start one with "
            "torch.distributed.init_process_group(..., world_size=...)"
        )
    if device_type != "cpu":
        resolve_device(device_type)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The (data=16, model=16) mesh, or (pod=2, data=16, model=16) with
    ``multi_pod``, over a world of 256 (512) ranks, one card each; the
    dry-run passes ``device_type="cpu"`` over its fake world."""
    return _mesh(device_type, PRODUCTION_SHAPE[multi_pod], PRODUCTION_AXES[multi_pod],
                 "the production mesh")


def make_test_mesh(data: int = 1, model: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the current world (``data * model`` ranks),
    on the card unless ``device_type="cpu"``."""
    return _mesh(device_type, (data, model), ("data", "model"), "the test mesh")


# One NVIDIA H100 80GB HBM3, 700 W, spec sheet (dense rates), under the
# reference's names for the roofline analysis.
PEAK_FLOPS_BF16 = 989e12        # NVIDIA H100 80GB HBM3, 700 W, spec sheet: bf16 tensor cores, dense
PEAK_FLOPS_FP32 = 67e12         # NVIDIA H100 80GB HBM3, 700 W, spec sheet: float32 outside the tensor cores
HBM_BW = 3.35e12                # NVIDIA H100 80GB HBM3, 700 W, spec sheet: bytes/s
NVLINK_BW = 450e9               # NVIDIA H100 80GB HBM3, 700 W, spec sheet: bytes/s per direction
ICI_BW = NVLINK_BW              # the reference's name for the chip-to-chip rate
HBM_PER_CHIP = 80e9             # NVIDIA H100 80GB HBM3, 700 W, spec sheet: 80 GB
