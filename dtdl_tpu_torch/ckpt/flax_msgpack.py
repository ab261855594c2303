"""Flax's msgpack checkpoint layout, read and written by the port.

The JAX package writes weights with ``flax.serialization.to_bytes``:
msgpack of the nested state dict, every array leaf an **ext type 1**
whose payload is msgpack of ``(shape, dtype name, C-order bytes)``
(ext 2 a Python complex as ``(real, imag)``, ext 3 a numpy scalar as a
0-d array), keys sorted at every level (flax copies the tree through
``jax.tree_util.tree_map``, which sorts dict keys), and an array above
:data:`MAX_CHUNK_SIZE` bytes split into ``{"__msgpack_chunked_array__":
True, "shape": {"0": ...}, "chunks": {"0": <1-d array>, ...}}``.

This module is that codec with the standard library, numpy and torch,
because the card's machine has neither ``msgpack`` nor ``flax``:

* :func:`msgpack_serialize` gives the bytes ``flax.serialization.
  msgpack_serialize`` gives for the same tree: msgpack's smallest
  encoding for ints, strings, bins, maps, arrays and ext headers, floats
  as float64, and the strict types flax packs with (a tuple is refused, a
  numpy scalar is ext 3 even where it subclasses ``float``).  Leaves may
  be torch tensors (any device) or numpy arrays; a ``bfloat16`` or fp8
  leaf is stored under its numpy (ml_dtypes) name.
* :func:`msgpack_restore` decodes such bytes into nested dicts whose
  arrays are CPU tensors.  An array's tensor is a view of the blob when
  its offset is aligned to its item size (``torch.frombuffer``) and one
  copy otherwise; pass a ``bytearray`` to get writable views without a
  copy of the whole blob.  A blob that is truncated, has trailing bytes
  or holds an unknown format or dtype raises ``ValueError``.
"""

from __future__ import annotations

import struct
import warnings

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: msgpack's 2**31 - 1 bytes per object,
# less a margin for the encoding
MAX_CHUNK_SIZE = 2 ** 30

_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3

# numpy / ml_dtypes names -> torch dtypes (the names torch spells alike)
_TORCH_DTYPES = {
    name: getattr(torch, name) for name in (
        "float64", "float32", "float16", "bfloat16", "complex64",
        "complex128", "int8", "int16", "int32", "int64", "uint8", "uint16",
        "uint32", "uint64", "bool", "float8_e4m3fn", "float8_e5m2",
        "float8_e4m3fnuz", "float8_e5m2fnuz", "float8_e8m0fnu")
    if hasattr(torch, name)}


def dtype_name(dtype) -> str:
    """The numpy (ml_dtypes) name of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


# ---- encoding ----------------------------------------------------------------

def _int(x: int) -> bytes:
    """msgpack's smallest encoding of ``x`` (unsigned forms above 0)."""
    if -(1 << 5) <= x < (1 << 7):
        return struct.pack(">b", x)
    if x < 0:
        for code, char, low in ((0xd0, "b", -(1 << 7)),
                                (0xd1, "h", -(1 << 15)),
                                (0xd2, "i", -(1 << 31))):
            if x >= low:
                return struct.pack(">B" + char, code, x)
        return struct.pack(">Bq", 0xd3, x)
    for code, char, limit in ((0xcc, "B", 1 << 8), (0xcd, "H", 1 << 16),
                              (0xce, "I", 1 << 32)):
        if x < limit:
            return struct.pack(">B" + char, code, x)
    return struct.pack(">BQ", 0xcf, x)


def _sized(n: int, fix: int | None, fix_max: int, formats) -> bytes:
    """The header of a string, bin, map or array of ``n`` items: the fix
    form below ``fix_max``, else the first of ``formats`` ((code, struct
    char, limit), ...) that holds ``n``."""
    if fix is not None and n < fix_max:
        return bytes((fix | n,))
    for code, char, limit in formats:
        if n < limit:
            return struct.pack(">B" + char, code, n)
    raise ValueError(f"msgpack object of {n} items/bytes is too large")


_STR = (0xa0, 32, ((0xd9, "B", 1 << 8), (0xda, "H", 1 << 16),
                   (0xdb, "I", 1 << 32)))
_BIN = (None, 0, ((0xc4, "B", 1 << 8), (0xc5, "H", 1 << 16),
                  (0xc6, "I", 1 << 32)))
_MAP = (0x80, 16, ((0xde, "H", 1 << 16), (0xdf, "I", 1 << 32)))
_ARRAY = (0x90, 16, ((0xdc, "H", 1 << 16), (0xdd, "I", 1 << 32)))
_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}


def _ext_header(code: int, n: int) -> bytes:
    if n in _FIXEXT:
        return struct.pack(">Bb", _FIXEXT[n], code)
    for head, char, limit in ((0xc7, "B", 1 << 8), (0xc8, "H", 1 << 16),
                              (0xc9, "I", 1 << 32)):
        if n < limit:
            return struct.pack(">B" + char + "b", head, n, code)
    raise ValueError(f"msgpack ext of {n} bytes is too large")


def _str(s: str) -> bytes:
    data = s.encode("utf-8")
    return _sized(len(data), *_STR) + data


def _array_bytes(x):
    """(shape, dtype name, C-order bytes as a buffer) of a tensor or
    numpy array, without copying a contiguous CPU array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy()
        return tuple(t.shape), dtype_name(t.dtype), memoryview(raw)
    a = np.asarray(x)
    if not a.flags.c_contiguous:     # (ascontiguousarray makes 0-d 1-d)
        a = a.copy(order="C")
    if a.dtype.hasobject or a.dtype.isalignedstruct or a.dtype.names:
        raise ValueError("object and structured dtypes are not supported "
                         "for serialization of arrays")
    return a.shape, a.dtype.name, memoryview(a.reshape(-1).view(np.uint8))


def _pack_array(code: int, x, out: list) -> None:
    shape, name, raw = _array_bytes(x)
    head = [_sized(3, *_ARRAY), _sized(len(shape), *_ARRAY),
            *(_int(int(d)) for d in shape), _str(name),
            _sized(raw.nbytes, *_BIN)]
    size = sum(map(len, head)) + raw.nbytes
    out.append(_ext_header(code, size))
    out.extend(head)
    out.append(raw)


def _pack(x, out: list) -> None:
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        out.append(_int(x))
    elif t is float:
        out.append(struct.pack(">Bd", 0xcb, x))
    elif t is str:
        out.append(_str(x))
    elif t in (bytes, bytearray):
        out.append(_sized(len(x), *_BIN))
        out.append(bytes(x))
    elif t is dict:
        out.append(_sized(len(x), *_MAP))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif t is list:
        out.append(_sized(len(x), *_ARRAY))
        for v in x:
            _pack(v, out)
    elif isinstance(x, (torch.Tensor, np.ndarray)):
        _pack_array(_EXT_NDARRAY, x, out)
    elif isinstance(x, np.generic):
        _pack_array(_EXT_NPSCALAR, np.asarray(x), out)
    elif isinstance(x, complex):
        body = b"\x92" + struct.pack(">BdBd", 0xcb, x.real, 0xcb, x.imag)
        out.append(_ext_header(_EXT_COMPLEX, len(body)))
        out.append(body)
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _chunk(x) -> dict:
    """flax's ``_chunk``: a canonical dict of 1-d chunks of ``x``."""
    itemsize = (x.element_size() if isinstance(x, torch.Tensor)
                else x.dtype.itemsize)
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _prepare(x):
    """The tree as flax packs it: dict keys sorted at every level (its
    ``tree_map`` copy), then every array leaf of a dict (or the root)
    above :data:`MAX_CHUNK_SIZE` bytes chunked."""
    if type(x) is dict:
        out = {}
        for k in sorted(x):
            v = _prepare(x[k])
            out[k] = (_chunk(v) if _is_array(v)
                      and _nbytes(v) > MAX_CHUNK_SIZE else v)
        return out
    if type(x) in (list, tuple):
        return type(x)(_prepare(v) for v in x)
    return x


def serialize_parts(tree) -> list:
    """The blob of :func:`msgpack_serialize` as a list of bytes-like
    parts (array data as views, not copies), to write or hash in turn."""
    root = _prepare(tree)
    if _is_array(root) and _nbytes(root) > MAX_CHUNK_SIZE:
        root = _chunk(root)
    out: list = []
    _pack(root, out)
    return out


def msgpack_serialize(tree) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``, byte for byte."""
    return b"".join(serialize_parts(tree))


# ---- decoding ----------------------------------------------------------------

class _Reader:
    def __init__(self, blob):
        self.mv = memoryview(blob).cast("B")
        self.blob = blob
        self._u8 = None

    def take(self, pos: int, n: int) -> int:
        end = pos + n
        if n < 0 or end > len(self.mv):
            raise ValueError(f"truncated msgpack: {n} bytes wanted at "
                             f"offset {pos} of {len(self.mv)}")
        return end

    def unpack_from(self, fmt: str, pos: int):
        end = self.take(pos, struct.calcsize(fmt))
        return struct.unpack_from(fmt, self.mv, pos), end

    def tensor(self, pos: int, n: int, name: str, shape) -> torch.Tensor:
        """The bytes ``[pos, pos + n)`` as a tensor of dtype ``name``:
        a view of the blob where aligned, else one copy."""
        dtype = _TORCH_DTYPES.get(name)
        if dtype is None:
            raise ValueError(f"array dtype {name!r} is not supported")
        if self._u8 is None:
            with warnings.catch_warnings():
                # a read-only blob (bytes) gives read-only views
                warnings.simplefilter("ignore", UserWarning)
                self._u8 = torch.frombuffer(self.blob, dtype=torch.uint8)
        raw = self._u8[pos:pos + n]
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = 1
        for d in shape:
            count *= d
        if count * itemsize != n:
            raise ValueError(f"array of shape {tuple(shape)} and dtype "
                             f"{name} needs {count * itemsize} bytes, has {n}")
        if pos % itemsize:
            raw = raw.clone()
        return raw.view(dtype).reshape(tuple(shape))

    def obj(self, pos: int):
        """(object, next offset) of the msgpack object at ``pos``."""
        (b,), pos = self.unpack_from(">B", pos)
        if b <= 0x7f:
            return b, pos
        if b >= 0xe0:
            return b - 0x100, pos
        if 0xa0 <= b <= 0xbf:
            return self.str(pos, b & 0x1f)
        if 0x90 <= b <= 0x9f:
            return self.list(pos, b & 0x0f)
        if 0x80 <= b <= 0x8f:
            return self.map(pos, b & 0x0f)
        if b == 0xc0:
            return None, pos
        if b in (0xc2, 0xc3):
            return b == 0xc3, pos
        fixed = _FIXED.get(b)
        if fixed is not None:
            (v,), pos = self.unpack_from(fixed, pos)
            return v, pos
        sized = _SIZED.get(b)
        if sized is None:
            raise ValueError(f"unknown msgpack format byte 0x{b:02x}")
        kind, char = sized
        if kind == "fixext":
            n = int(char)
        else:
            (n,), pos = self.unpack_from(">" + char, pos)
        if kind == "str":
            return self.str(pos, n)
        if kind == "bin":
            end = self.take(pos, n)
            return bytes(self.mv[pos:end]), end
        if kind == "array":
            return self.list(pos, n)
        if kind == "map":
            return self.map(pos, n)
        (code,), pos = self.unpack_from(">b", pos)
        end = self.take(pos, n)
        return self.ext(code, pos, end), end

    def str(self, pos: int, n: int):
        end = self.take(pos, n)
        return str(self.mv[pos:end], "utf-8"), end

    def list(self, pos: int, n: int):
        out = []
        for _ in range(n):
            v, pos = self.obj(pos)
            out.append(v)
        return out, pos

    def map(self, pos: int, n: int):
        out = {}
        for _ in range(n):
            k, pos = self.obj(pos)
            v, pos = self.obj(pos)
            out[k] = v
        return out, pos

    def ndarray(self, pos: int, end: int) -> torch.Tensor:
        """An ext-1 payload ``(shape, dtype name, bytes)``, its bytes
        located rather than copied."""
        (b,), pos = self.unpack_from(">B", pos)
        if b != 0x93:
            raise ValueError("array payload is not a 3-item msgpack array")
        shape, pos = self.obj(pos)
        name, pos = self.obj(pos)
        (b,), pos = self.unpack_from(">B", pos)
        if b not in (0xc4, 0xc5, 0xc6):
            raise ValueError("array payload's data is not a msgpack bin")
        (n,), pos = self.unpack_from(">" + "BHI"[b - 0xc4], pos)
        if pos + n != end:
            raise ValueError("array payload does not fill its ext")
        if isinstance(name, bytes):
            name = name.decode("utf-8")
        if not (isinstance(shape, list) and isinstance(name, str)
                and all(type(d) is int and d >= 0 for d in shape)):
            raise ValueError("array payload's shape or dtype is malformed")
        return self.tensor(pos, n, name, shape)

    def ext(self, code: int, pos: int, end: int):
        if code == _EXT_NDARRAY:
            return self.ndarray(pos, end)
        if code == _EXT_NPSCALAR:
            t = self.ndarray(pos, end)
            name = dtype_name(t.dtype)
            if name == "bfloat16" or name.startswith("float8"):
                return t          # numpy has no such scalar
            return t.numpy()[()]
        if code == _EXT_COMPLEX:
            v, at = self.obj(pos)
            if at != end or not isinstance(v, list) or len(v) != 2:
                raise ValueError("malformed complex ext")
            return complex(v[0], v[1])
        raise ValueError(f"unknown msgpack ext type {code}")


_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
          0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_SIZED = {0xc4: ("bin", "B"), 0xc5: ("bin", "H"), 0xc6: ("bin", "I"),
          0xc7: ("ext", "B"), 0xc8: ("ext", "H"), 0xc9: ("ext", "I"),
          0xd4: ("fixext", "1"), 0xd5: ("fixext", "2"),
          0xd6: ("fixext", "4"), 0xd7: ("fixext", "8"),
          0xd8: ("fixext", "16"), 0xd9: ("str", "B"), 0xda: ("str", "H"),
          0xdb: ("str", "I"), 0xdc: ("array", "H"), 0xdd: ("array", "I"),
          0xde: ("map", "H"), 0xdf: ("map", "I")}


def _unchunk(x):
    """flax's ``_unchunk_array_leaves_in_place``, on a decoded tree."""
    if type(x) is not dict:
        return x
    if _CHUNKED in x:
        shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
        chunks = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
        return torch.cat(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in x.items()}


def msgpack_restore(blob):
    """The tree that ``flax.serialization.msgpack_restore`` decodes from
    ``blob``, its arrays as CPU tensors (``ValueError`` if malformed)."""
    r = _Reader(blob)
    tree, end = r.obj(0)
    if end != len(r.mv):
        raise ValueError(f"{len(r.mv) - end} trailing bytes after the "
                         f"msgpack object")
    return _unchunk(tree)
