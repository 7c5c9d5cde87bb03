"""The flax msgpack format of the JAX package's ``.ckpt`` files, in plain Python.

``flax.serialization.to_bytes``/``msgpack_restore`` write and read a tree of
maps with string keys whose leaves are Python scalars, ``None`` and numpy
arrays; an array is msgpack ext type 1 holding the msgpack of ``(shape,
dtype name, C-order bytes)``.  This module reads and writes that format with
no ``msgpack`` and no ``flax``, so one reader runs on every machine (the
card's has neither).

* ``loads(blob)``: the tree, maps as ``dict``, arrays as numpy arrays, except
  ``bfloat16`` arrays, which numpy lacks: they come back as
  ``torch.bfloat16`` tensors made from their uint16 bits.  Ext types 2
  (complex) and 3 (numpy scalar) and flax's chunked-array maps (arrays
  above 1 GiB, which no array of this model reaches) raise ``ValueError``.
* ``dumps(tree)``: the bytes ``flax.serialization.to_bytes`` gives for the
  same tree: map keys in the tree's order, integers in their shortest form,
  floats as float64, numpy arrays and the reader's ``torch.bfloat16``
  tensors as ext type 1.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
DTYPES = ("float32", "float16", "bfloat16", "int32", "uint32", "int64", "bool")


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
                 0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
                 0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
                 0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
                 0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            return getattr(self, kind)(n)
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack type byte 0x{b:02x} at offset {self.pos - 1} is not valid")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED in out:
            raise ValueError("a flax chunked array (a leaf above 1 GiB): not supported")
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        body = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(body)
        if code == EXT_COMPLEX:
            raise ValueError("flax ext type 2 (a complex number): not supported")
        if code == EXT_NPSCALAR:
            raise ValueError("flax ext type 3 (a numpy scalar): not supported")
        raise ValueError(f"msgpack ext type {code}: not a flax type")


def _ndarray(body: bytes):
    r = _Reader(body)
    tpl = r.value()
    if r.pos != len(body) or not isinstance(tpl, list) or len(tpl) != 3:
        raise ValueError("malformed flax ndarray")
    shape, name, buf = tpl
    name = name.decode() if isinstance(name, bytes) else name
    if name not in DTYPES:
        raise ValueError(f"flax ndarray of dtype {name!r}: not one of {DTYPES}")
    if name == "bfloat16":
        import torch

        bits = np.frombuffer(buf, np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def loads(blob: bytes):
    """The tree of a flax msgpack blob (see the module)."""
    r = _Reader(blob)
    out = r.value()
    if r.pos != len(blob):
        raise ValueError(f"{len(blob) - r.pos} bytes after the msgpack value")
    return out


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return bytes([v & 0xFF])
    if v >= 0:
        for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")):
            if v < 1 << (8 * struct.calcsize(fmt)):
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")):
            if v >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"{v} does not fit msgpack's 64-bit integers")


def _sized(n: int, fix: int | None, fix_max: int, codes, what: str) -> bytes:
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"{what} of {n} is too long for msgpack")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), 0xA0, 31, ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")), "str") + b


def _bin(b: bytes) -> bytes:
    return _sized(len(b), None, 0, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")), "bin") + b


def _ext(code: int, body: bytes) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(body) in fixext:
        head = bytes([fixext[len(body)]])
    else:
        head = _sized(len(body), None, 0, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")), "ext")
    return head + struct.pack(">b", code) + body


def _array_body(x) -> bytes:
    """The msgpack of (shape, dtype name, bytes) of a numpy array, or of a
    ``torch.bfloat16`` tensor (the reader's form of a ``bfloat16`` leaf)."""
    if isinstance(x, np.ndarray):
        name = x.dtype.name
        if name not in DTYPES:
            raise ValueError(f"array of dtype {name}: not one of {DTYPES}")
    else:
        import torch

        if x.dtype != torch.bfloat16:
            raise TypeError(f"a torch tensor of {x.dtype}: write it as a numpy array")
        name, x = "bfloat16", x.detach().cpu().contiguous().view(torch.int16).numpy()
    return _list([_int(int(d)) for d in x.shape]) + _str(name) + _bin(x.tobytes("C"))


def _list(items: list[bytes]) -> bytes:
    return _sized(len(items), 0x90, 15, ((0xDC, ">H"), (0xDD, ">I")), "array") + b"".join(items)


def _pack(v) -> bytes:
    if v is None:
        return b"\xc0"
    if isinstance(v, bool):
        return b"\xc3" if v else b"\xc2"
    if isinstance(v, int):
        return _int(v)
    if isinstance(v, float):
        return b"\xcb" + struct.pack(">d", v)
    if isinstance(v, str):
        return _str(v)
    if isinstance(v, bytes):
        return _bin(v)
    if isinstance(v, dict):
        if not all(isinstance(k, str) for k in v):
            raise TypeError("flax msgpack maps have string keys")
        head = _sized(len(v), 0x80, 15, ((0xDE, ">H"), (0xDF, ">I")), "map")
        return head + b"".join(_str(k) + _pack(x) for k, x in v.items())
    if isinstance(v, (list, tuple)):
        return _list([_pack(x) for x in v])
    if isinstance(v, np.ndarray) or type(v).__name__ == "Tensor":
        return _ext(EXT_NDARRAY, bytes([0x93]) + _array_body(v))
    raise TypeError(f"cannot write a {type(v).__name__} as flax msgpack")


def dumps(tree) -> bytes:
    """The flax msgpack bytes of ``tree`` (see the module)."""
    return _pack(tree)
