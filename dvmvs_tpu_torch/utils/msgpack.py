"""The msgpack subset of Flax checkpoints, without flax or msgpack
(counterpart of ``flax.serialization.to_bytes`` / ``msgpack_restore`` as
dvmvs_tpu/utils/checkpoint.py writes and reads them).

A Flax checkpoint is one msgpack object: nested maps with str keys whose
leaves are arrays (ext type 1: the packed triple ``(shape, dtype name,
C-order bytes)``), numpy scalars (ext type 3, the same triple with shape
``()``), or plain str, bin, int, float, bool and nil. An array over
``MAX_CHUNK_SIZE`` bytes is stored as a map ``{"__msgpack_chunked_array__":
True, "shape": {"0": d0, ...}, "chunks": {"0": flat chunk, ...}}``.

``unpackb`` returns the tree with array leaves as torch tensors (built with
``torch.frombuffer``, so bfloat16 and float16 need no ml_dtypes) and numpy
scalars as 0-d tensors. ``packb`` writes the bytes Flax writes for a tree of
dicts, lists, tuples, Python scalars and numpy or torch arrays: the same
smallest encodings, the same key order, the same chunking. Any other type
byte or ext type raises ``ValueError`` naming it.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

NDARRAY, NPSCALAR = 1, 3  # flax.serialization._MsgpackExtType
CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE

# numpy dtype name -> torch dtype (the names Flax writes)
DTYPES = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
DTYPE_NAMES = {v: k for k, v in DTYPES.items()}

# fixed-size heads: type byte -> (struct format, kind)
_FIXED = {
    0xcc: (">B", "int"), 0xcd: (">H", "int"), 0xce: (">I", "int"), 0xcf: (">Q", "int"),
    0xd0: (">b", "int"), 0xd1: (">h", "int"), 0xd2: (">i", "int"), 0xd3: (">q", "int"),
    0xca: (">f", "float"), 0xcb: (">d", "float"),
    0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
    0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
    0xdc: (">H", "array"), 0xdd: (">I", "array"),
    0xde: (">H", "map"), 0xdf: (">I", "map"),
    0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext"),
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


# ------------------------------------------------------------------ decoding

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at offset {self.pos} (want {n} bytes)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def object(self) -> Any:
        at = self.pos
        b = self.unpack(">B")
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.object() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        if b in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[b]
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b], at)
        if b not in _FIXED:
            raise ValueError(f"msgpack: type byte 0x{b:02x} at offset {at} is not supported")
        fmt, kind = _FIXED[b]
        value = self.unpack(fmt)
        if kind in ("int", "float"):
            return value
        if kind == "str":
            return self.str(value)
        if kind == "bin":
            return bytes(self.take(value))
        if kind == "array":
            return [self.object() for _ in range(value)]
        if kind == "map":
            return self.map(value)
        return self.ext(value, at)

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.object()
            out[key] = self.object()
        return out

    def ext(self, n: int, at: int):
        code = self.unpack(">b")
        body = self.take(n)
        if code not in (NDARRAY, NPSCALAR):
            raise ValueError(f"msgpack: ext type {code} at offset {at} is not supported "
                             f"(only {NDARRAY}, ndarray, and {NPSCALAR}, numpy scalar)")
        inner = _Reader(body)
        triple = inner.object()
        if not (isinstance(triple, list) and len(triple) == 3 and inner.pos == len(body)):
            raise ValueError(f"msgpack: malformed array at offset {at}")
        shape, name, buffer = triple
        if name not in DTYPES:
            raise ValueError(f"msgpack: array dtype {name!r} at offset {at} is not supported")
        dtype = DTYPES[name]
        if not buffer:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(bytearray(buffer), dtype=dtype).reshape(shape)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return torch.cat(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object (a Flax checkpoint's bytes) into a tree with
    tensor leaves; chunked arrays are joined."""
    reader = _Reader(data)
    tree = reader.object()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes after the object")
    return _unchunk(tree)


# ------------------------------------------------------------------ encoding

def _sized(out: bytearray, n: int, small: Tuple[int, int], heads: Tuple[int, int, int]):
    """Append the head of a str, bin, array or map of length n: the fix form
    (base byte | n) for n < ``small[1]`` when ``small[0]`` is set, else the
    8-, 16- or 32-bit length form (``heads``; None where it does not exist)."""
    fix, limit = small
    if fix is not None and n < limit:
        out.append(fix | n)
    elif heads[0] is not None and n <= 0xff:
        out += bytes((heads[0], n))
    elif n <= 0xffff:
        out.append(heads[1])
        out += struct.pack(">H", n)
    else:
        out.append(heads[2])
        out += struct.pack(">I", n)


def _int(out: bytearray, v: int):
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xff)
    elif v > 0:
        for fmt, head, top in ((">B", 0xcc, 0xff), (">H", 0xcd, 0xffff),
                               (">I", 0xce, 0xffffffff), (">Q", 0xcf, 2 ** 64 - 1)):
            if v <= top:
                out.append(head)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"msgpack: integer {v} does not fit in 64 bits")
    else:
        for fmt, head, low in ((">b", 0xd0, -0x80), (">h", 0xd1, -0x8000),
                               (">i", 0xd2, -2 ** 31), (">q", 0xd3, -2 ** 63)):
            if v >= low:
                out.append(head)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"msgpack: integer {v} does not fit in 64 bits")


def _array_triple(shape, name: str, raw: bytes) -> bytes:
    out = bytearray()
    _sized(out, 3, (0x90, 16), (None, 0xdc, 0xdd))
    _sized(out, len(shape), (0x90, 16), (None, 0xdc, 0xdd))
    for d in shape:
        _int(out, int(d))
    _sized(out, len(name), (0xa0, 32), (0xd9, 0xda, 0xdb))
    out += name.encode()
    _sized(out, len(raw), (None, 0), (0xc4, 0xc5, 0xc6))
    out += raw
    return bytes(out)


def _ext(out: bytearray, code: int, body: bytes):
    fix = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}.get(len(body))
    if fix is not None:
        out.append(fix)
    else:
        _sized(out, len(body), (None, 0), (0xc7, 0xc8, 0xc9))
    out += struct.pack(">b", code)
    out += body


def _array_bytes(x) -> Tuple[tuple, str, bytes]:
    """(shape, dtype name, C-order bytes) of a torch tensor or numpy array."""
    if isinstance(x, torch.Tensor):
        if x.dtype not in DTYPE_NAMES:
            raise ValueError(f"msgpack: tensor dtype {x.dtype} is not supported")
        t = x.detach().cpu().contiguous()
        return tuple(t.shape), DTYPE_NAMES[x.dtype], t.reshape(-1).view(torch.uint8).numpy().tobytes()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes are not supported")
    return x.shape, x.dtype.name, x.tobytes("C")


def _chunk(x):
    """Flax's chunked form of an array over MAX_CHUNK_SIZE bytes, else x."""
    if isinstance(x, torch.Tensor):
        itemsize, n = x.element_size(), x.numel()
    else:
        itemsize, n = x.dtype.itemsize, x.size
    if n * itemsize <= MAX_CHUNK_SIZE:
        return x
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in enumerate(range(0, n, size))}}


def _pack(out: bytearray, x):
    if x is None:
        out.append(0xc0)
    elif x is True or x is False:
        out.append(0xc3 if x else 0xc2)
    elif type(x) is int:
        _int(out, x)
    elif type(x) is float:
        out.append(0xcb)
        out += struct.pack(">d", x)
    elif type(x) is str:
        raw = x.encode("utf-8")
        _sized(out, len(raw), (0xa0, 32), (0xd9, 0xda, 0xdb))
        out += raw
    elif type(x) is bytes:
        _sized(out, len(x), (None, 0), (0xc4, 0xc5, 0xc6))
        out += x
    elif type(x) is dict:
        _sized(out, len(x), (0x80, 16), (None, 0xde, 0xdf))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif type(x) in (list, tuple):
        _sized(out, len(x), (0x90, 16), (None, 0xdc, 0xdd))
        for v in x:
            _pack(out, v)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _ext(out, NDARRAY, _array_triple(*_array_bytes(x)))
    elif isinstance(x, np.generic):
        _ext(out, NPSCALAR, _array_triple(*_array_bytes(np.asarray(x))))
    else:
        raise ValueError(f"msgpack: cannot pack {type(x).__name__}")


def _state_dict(x):
    """flax.serialization.to_state_dict for the types a checkpoint holds:
    dict keys become str, lists and tuples become {"0": ..., "1": ...}, and
    large arrays in a dict (or at the top) are chunked."""
    if isinstance(x, dict):
        return {str(k): _state_dict(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(x)}
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return _chunk(x)
    return x


def packb(tree) -> bytes:
    """The bytes ``flax.serialization.to_bytes(tree)`` writes."""
    out = bytearray()
    _pack(out, _state_dict(tree))
    return bytes(out)
