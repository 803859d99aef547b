"""Checkpoints in the reference's format, byte for byte.

The reference (``repro.ckpt.checkpoint``) writes a msgpack array with one
map ``{"dtype": str, "shape": [int, ...], "data": bin}`` per leaf, in
``jax.tree_util`` order (dict keys sorted, lists and ``NamedTuple``
fields in order), bf16 leaves as their uint16 bits, through a temporary
file and an atomic rename. This module writes and reads exactly that
with a minimal msgpack encoder and decoder of its own (array, map, str,
bin and non-negative int, each in the width msgpack picks for it), so
that a checkpoint moves between the two packages in both directions.
The structure comes back from a template (the same API shape as flax's
``from_bytes``), and each loaded tensor lands on its template leaf's
device.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from ..tree import flatten, unflatten

_NUMPY_NAME = {
    torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
    torch.int8: "int8", torch.int16: "int16", torch.int32: "int32", torch.int64: "int64",
    torch.uint8: "uint8", torch.bool: "bool",
}
_TORCH_DTYPE = {name: dt for dt, name in _NUMPY_NAME.items()}


# --------------------------------------------------------------------- #
# msgpack, the subset the format uses
# --------------------------------------------------------------------- #
def _uint(n: int) -> bytes:
    if n < 0:
        raise ValueError(f"negative int {n} is outside the checkpoint format")
    if n < 0x80:
        return bytes([n])
    for tag, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                          (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
        if n < top:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"int {n} does not fit 64 bits")


def _head(n: int, fix: int | None, fix_max: int, tags: tuple) -> bytes:
    """The header of a sized msgpack object: a fix form for ``n <
    fix_max`` (where the type has one), else the first of its 8-, 16- and
    32-bit forms ``tags`` (``None`` where there is none) that holds ``n``."""
    if fix is not None and n < fix_max:
        return bytes([fix | n])
    for tag, fmt, top in zip(tags, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < top:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"object of {n} entries or bytes exceeds msgpack's 32-bit sizes")


def _array_head(n: int) -> bytes:
    return _head(n, 0x90, 16, (None, 0xDC, 0xDD))


def _map_head(n: int) -> bytes:
    return _head(n, 0x80, 16, (None, 0xDE, 0xDF))


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _head(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + b


def _bin_head(n: int) -> bytes:
    return _head(n, None, 0, (0xC4, 0xC5, 0xC6))


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int):
        if self.pos + n > len(self.buf):
            raise ValueError("checkpoint ends inside an object")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def number(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        tag = self.take(1)[0]
        if tag < 0x80:
            return tag
        if 0x80 <= tag <= 0x8F:
            return self.map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return [self.read() for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:
            return str(self.take(tag & 0x1F), "utf-8")
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
        if tag in (0xCC, 0xCD, 0xCE, 0xCF):
            return self.number({0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}[tag])
        if tag in sized:
            n = self.number(sized[tag])
            if tag <= 0xC6:
                return self.take(n)
            if tag <= 0xDB:
                return str(self.take(n), "utf-8")
            if tag <= 0xDD:
                return [self.read() for _ in range(n)]
            return self.map(n)
        raise ValueError(f"msgpack type 0x{tag:02x} is outside the checkpoint format")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(buf):
    """Decode one msgpack object of the checkpoint format (bins come back
    as ``memoryview`` slices of ``buf``)."""
    r = _Reader(buf)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError("bytes after the checkpoint's object")
    return out


# --------------------------------------------------------------------- #
# leaves
# --------------------------------------------------------------------- #
def _leaf_array(x) -> tuple[str, np.ndarray]:
    """``(dtype name, numpy array whose bytes are the leaf's)``."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().view(np.uint16)
        if t.dtype not in _NUMPY_NAME:
            raise ValueError(f"dtype {t.dtype} is outside the checkpoint format")
        return _NUMPY_NAME[t.dtype], t.numpy()
    arr = np.asarray(x)
    return str(arr.dtype), arr


def _pack_head(name: str, arr: np.ndarray) -> bytes:
    shape = b"".join(_uint(int(s)) for s in arr.shape)
    return (_map_head(3) + _str("dtype") + _str(name) + _str("shape") + _array_head(arr.ndim)
            + shape + _str("data") + _bin_head(arr.nbytes))


def _unpack_leaf(d: dict, like) -> torch.Tensor:
    shape = tuple(d["shape"])
    name = d["dtype"]
    if name == "bfloat16":
        arr = np.frombuffer(d["data"], np.int16).reshape(shape)
        t = torch.from_numpy(arr.copy()).view(torch.bfloat16)
    else:
        if name not in _TORCH_DTYPE:
            raise ValueError(f"dtype {name!r} is outside the checkpoint format")
        t = torch.from_numpy(np.frombuffer(d["data"], name).reshape(shape).copy())
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(device)


def save_checkpoint(path: str, tree) -> None:
    """Write ``tree``'s leaves (tensors, or anything ``np.asarray`` takes)
    to ``path`` in the reference's format; the bytes go to ``path +
    ".tmp"`` first and are renamed into place."""
    leaves, _ = flatten(tree)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_array_head(len(leaves)))
        for leaf in leaves:
            name, arr = _leaf_array(leaf)
            f.write(_pack_head(name, arr))
            f.write(memoryview(np.ascontiguousarray(arr)).cast("B"))
    os.replace(tmp, path)


def load_checkpoint(path: str, template):
    """The tree of ``template`` holding the checkpoint's leaves, each on
    its template leaf's device (the CPU for a leaf that is no tensor).
    A checkpoint with another number of leaves raises ``ValueError``."""
    with open(path, "rb") as f:
        packed = unpackb(f.read())
    leaves, spec = flatten(template)
    if len(packed) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(packed)} leaves, template has {len(leaves)}"
        )
    return unflatten(spec, [_unpack_leaf(d, like) for d, like in zip(packed, leaves)])
