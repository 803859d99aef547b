"""Build, load and count the port's hand-written CUDA kernels.

Each source under ``kernels/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, at first
use, into ``kernels/_build/`` (listed in ``.gitignore``; one file per
hash of the source and of every shared header under ``csrc/``, so an
edited source or header never loads a stale library).
The wrappers bind the C functions with :mod:`ctypes`, passing tensor
``data_ptr()`` s and PyTorch's current stream.

:data:`LAUNCHES` counts, per kernel, the wrapper calls that launched it
on the card. Nothing here runs at import time: the CPU tests import
every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: kernel library name -> source file under ``csrc/``.
SOURCES = {
    "fused_frontier_step": "fused_frontier_step.cu",
    "fused_step": "fused_step.cu",
    "gather_rows": "gather_rows.cu",
    "frontier_unique": "frontier_unique.cu",
    "score_update": "score_update.cu",
    "gather_mean": "gather_mean.cu",
    "segment_sum": "segment_sum.cu",
    "mla_decode": "mla_decode.cu",
}

#: The wrappers that launch a kernel. A ``_wide`` kernel (int64 ids) is
#: the second entry of its narrow twin's library; ``gather_rows`` and
#: ``gather_rows_batch`` share the ``gather_rows`` library, and the three
#: score entries the ``score_update`` library; ``segment_sum_equal`` is the
#: ``segment_sum`` library's one entry, ``mla_flash_decode`` the
#: ``mla_decode`` library's.
KERNELS = (
    "fused_frontier_step", "fused_step", "gather_rows_batch", "gather_rows",
    "fused_frontier_step_wide", "fused_step_wide",
    "frontier_unique_batch", "frontier_unique_batch_wide",
    "score_update", "score_update_batch", "score_policy_update_batch",
    "gather_mean", "segment_sum_equal", "mla_flash_decode",
)

#: kernel name -> launches on the card (each wrapper adds one per launch).
LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # No FMA contraction: the score update and the neighbour means must
    # round like the plain versions (see the note at the top of
    # prefetch_state.cuh).
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME/bin/nvcc``, ``PATH``, or
    ``/usr/local/cuda/bin/nvcc``); raises if there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def nvcc_command(source: Path, out: Path, verbose: bool = False) -> list[str]:
    """The ``nvcc`` command that builds the kernel source ``source`` (which
    may include the shared headers of ``csrc/``) into the library ``out``;
    with ``-Xptxas -v`` when ``verbose``."""
    cmd = [nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    return cmd + ["-I", str(CSRC), "-o", str(out), str(source)]


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=None, verbose: bool = False) -> dict[str, str]:
    """Compile every kernel library not built yet, one ``nvcc`` process
    per source, all started together. Returns ``{name: ptxas report}``
    (``-Xptxas -v`` output when ``verbose``) for the libraries built."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                nvcc_command(CSRC / SOURCES[name], tmp, verbose),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp,
            out,
        )
    reports = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
        reports[name] = log
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def bind(name: str, fn_name: str, argtypes: list):
    """The C entry ``fn_name`` of kernel library ``name``, its argument
    types set at first use; every entry returns a ``cudaError_t``."""
    fn = getattr(library(name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def check_tensor(t, name: str, dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape``: what every kernel of the port takes."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t):
    """The device pointer of tensor ``t`` for a C entry (None for None)."""
    return None if t is None else t.data_ptr()


def check_inputs(**tensors):
    """Raise unless every tensor is a contiguous CUDA tensor and all lie on
    one device (dtype and shape are the caller's checks); returns that
    device. One pass for a wrapper's inputs, cheaper on the host than a
    :func:`check_tensor` each."""
    device = None
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name} is on {t.device}, the other inputs on {device}")
    return device


def launch_status(fn, device, *args) -> int:
    """Call the bound C entry ``fn`` with ``args`` and PyTorch's current
    stream on ``device`` last; returns its ``cudaError_t``. The
    ``torch.cuda.device`` guard is entered only when ``device`` is not the
    current device (the launch goes to the caller's current device). The
    device and stream come from the raw getters that ``torch.cuda``'s own
    ``current_device`` and ``current_stream`` wrap, without building a
    ``Stream`` object a call."""
    index = device.index
    if index == torch._C._cuda_getDevice():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def launch(fn, device, what: str, *args) -> None:
    """:func:`launch_status`, raising on a nonzero ``cudaError_t``."""
    check(launch_status(fn, device, *args), what)
