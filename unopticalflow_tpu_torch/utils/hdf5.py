"""A reader of the HDF5 files that MATLAB v7.3 and h5py's default write.

NYUv2's labeled set (``nyu_depth_v2_labeled.mat``) is a MATLAB v7.3 file,
that is, HDF5.  This module reads the part of the format such files use,
in plain Python and numpy with ``zlib``'s inflate, so the port needs no
h5py:

* a user block of 512 * 2**n bytes before the signature (MATLAB writes 512);
* superblock version 0 or 1;
* version-1 object headers, with continuation blocks;
* old-style groups: a symbol table (version-1 B-tree of group nodes and the
  local heap that holds the names), walked by path;
* the dataspace, datatype, fill value and layout messages: fixed-point and
  IEEE floating-point numbers in either byte order, and object references;
  layout version 3, compact, contiguous, or chunked with the version-1
  B-tree chunk index;
* the filter pipeline: deflate, shuffle and fletcher32 (the sum is checked,
  then dropped);
* object references, resolved to the dataset or group they name.

The interface is the part of h5py's that the port's callers use:
``File(path)``, ``f[name]`` and ``f[ref]``, ``Group.keys()``,
``Dataset.shape``, ``.dtype``, ``np.asarray(ds)``, ``ds[i]``,
``ds[index_array]`` and ``ds[:]`` (a selection on the first axis reads only
the chunks that hold those rows, and the rest of a key is applied to them
with numpy).  A reference array reads as an object array of ``Reference``.

Anything else raises ``ValueError`` naming the structure and its version:
superblock 2 or later (h5py's ``libver='latest'``), a version-2 object
header, new-style (compact or dense) link storage, layout version 4 (its
chunk indexes), a filter other than the three, a shared message, a scalar
dataspace, and, in a dataset that is read, a string, variable-length,
compound or other type.
It never returns data it did not decode.
"""

from __future__ import annotations

import mmap
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF

# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL = 0x01, 0x02, 0x03, 0x05
_LINK, _LAYOUT, _PIPELINE, _CONTINUATION, _SYMBOL_TABLE = 0x06, 0x08, 0x0B, 0x10, 0x11

_FILTERS = (1, 2, 3)  # deflate, shuffle, fletcher32
_TYPE_CLASSES = {0: "fixed-point", 1: "floating-point", 2: "time", 3: "string",
                 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference", 8: "enumerated",
                 9: "variable-length", 10: "array"}


class Reference:
    """An object reference: the address of the object it names."""

    __slots__ = ("addr",)

    def __init__(self, addr: int):
        self.addr = addr


class File:
    """An HDF5 file opened for reading (as ``h5py.File(path, "r")``)."""

    def __init__(self, path: str):
        self.filename = path
        self._f = open(path, "rb")
        try:
            self._m = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
            self._superblock()
        except BaseException:
            self.close()
            raise
        self._root = Group(self, self._root_addr, "/")

    # -- the superblock and the raw reads ---------------------------------

    def _superblock(self):
        m, base = self._m, 0
        while m[base:base + 8] != _SIGNATURE:  # after a user block of 512 * 2**n bytes
            base = 512 if base == 0 else base * 2
            if base + 8 > len(m):
                raise ValueError(f"{self.filename}: not an HDF5 file (no signature)")
        self.base = base
        version = m[base + 8]
        if version > 1:
            raise ValueError(f"{self.filename}: HDF5 superblock version {version} is not "
                             "supported (the reader takes versions 0 and 1: h5py's "
                             "libver='earliest' and MATLAB v7.3)")
        self.osize, self.lsize = m[base + 13], m[base + 14]
        if self.osize not in (2, 4, 8) or self.lsize not in (2, 4, 8):
            raise ValueError(f"{self.filename}: offsets of {self.osize} and lengths of "
                             f"{self.lsize} bytes")
        pos = base + 24 + (4 if version == 1 else 0)
        pos += 4 * self.osize  # four addresses: base, free space, end of file, VFD info
        # the root group's symbol table entry: name offset, object header address
        self._root_addr = self._uint(pos + self.osize, self.osize)

    def _bytes(self, addr: int, n: int) -> bytes:
        """``n`` bytes at a file address (relative to the superblock)."""
        start = self.base + addr
        if addr == _UNDEF or start + n > len(self._m):
            raise ValueError(f"{self.filename}: address {addr:#x} + {n} lies outside the file")
        return self._m[start:start + n]

    def _uint(self, pos: int, n: int) -> int:
        return int.from_bytes(self._m[pos:pos + n], "little")

    # -- h5py's interface ---------------------------------------------------

    def __getitem__(self, key):
        if isinstance(key, Reference):
            return _open_object(self, key.addr, f"<reference {key.addr:#x}>")
        return self._root[key]

    def keys(self):
        return self._root.keys()

    def close(self):
        m = getattr(self, "_m", None)
        if m is not None:
            m.close()
            self._m = None
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Reader:
    """Little-endian fields of one byte string, read in order."""

    def __init__(self, data: bytes, osize: int, lsize: int, pos: int = 0):
        self.data, self.osize, self.lsize, self.pos = data, osize, lsize, pos

    def u(self, n: int) -> int:
        v = int.from_bytes(self.data[self.pos:self.pos + n], "little")
        self.pos += n
        return v

    def addr(self) -> int:
        return self.u(self.osize)

    def length(self) -> int:
        return self.u(self.lsize)


def _messages(f: File, addr: int, what: str) -> list:
    """The (type, flags, body) messages of the object header at ``addr``."""
    head = f._bytes(addr, 16)
    if head[:4] == b"OHDR":
        raise ValueError(f"{what}: object header version 2 is not supported (the reader "
                         "takes version 1, as h5py's libver='earliest' writes)")
    if head[0] != 1:
        raise ValueError(f"{what}: object header version {head[0]} is not supported")
    n_msgs = struct.unpack_from("<H", head, 2)[0]
    size = struct.unpack_from("<I", head, 8)[0]
    blocks, msgs = [(addr + 16, size)], []
    while blocks and len(msgs) < n_msgs:
        start, length = blocks.pop(0)
        data, pos = f._bytes(start, length), 0
        while pos + 8 <= length and len(msgs) < n_msgs:
            kind, n, flags = struct.unpack_from("<HHB", data, pos)
            body = data[pos + 8:pos + 8 + n]
            pos += 8 + n
            if kind == _CONTINUATION:
                r = _Reader(body, f.osize, f.lsize)
                blocks.append((r.addr(), r.length()))
            msgs.append((kind, flags, body))
    return msgs


def _open_object(f: File, addr: int, name: str):
    msgs = _messages(f, addr, name)
    kinds = {k for k, _, _ in msgs}
    if _SYMBOL_TABLE in kinds:
        return Group(f, addr, name, msgs)
    if _LINK_INFO in kinds or _LINK in kinds:
        dense = False
        for kind, _, body in msgs:
            if kind == _LINK_INFO:
                r = _Reader(body, f.osize, f.lsize, 2 + (8 if body[1] & 1 else 0))
                dense = r.addr() != _UNDEF
        storage = "dense link storage (a fractal heap)" if dense else "compact link storage"
        raise ValueError(f"{name}: a new-style group with {storage} is not supported (the "
                         "reader takes old-style groups: a symbol table)")
    if _LAYOUT in kinds:
        return Dataset(f, addr, name, msgs)
    raise ValueError(f"{name}: an object that is neither a group nor a dataset")


class Group:
    """An old-style group: its members' names from the local heap, their
    object headers through the version-1 B-tree of symbol table nodes."""

    def __init__(self, f: File, addr: int, name: str, msgs=None):
        self.file, self.name = f, name
        msgs = _messages(f, addr, name) if msgs is None else msgs
        table = [body for kind, _, body in msgs if kind == _SYMBOL_TABLE]
        if not table:
            _open_object(f, addr, name)  # raises, naming what it is
            raise ValueError(f"{name}: not a group")
        r = _Reader(table[0], f.osize, f.lsize)
        self._btree, heap = r.addr(), r.addr()
        hh = f._bytes(heap, 8 + 2 * f.lsize + f.osize)
        if hh[:4] != b"HEAP":
            raise ValueError(f"{name}: local heap signature missing")
        r = _Reader(hh, f.osize, f.lsize, 8)
        seg_size, _free = r.length(), r.length()
        self._heap = f._bytes(r.addr(), seg_size)
        self._members = None

    def _name_at(self, off: int) -> str:
        end = self._heap.index(b"\0", off)
        return self._heap[off:end].decode("utf-8")

    def _load(self) -> dict:
        if self._members is None:
            members = {}
            self._walk(self._btree, members)
            self._members = members
        return self._members

    def _walk(self, addr: int, members: dict):
        f = self.file
        o, l_ = f.osize, f.lsize
        head = f._bytes(addr, 8 + 2 * o)
        if head[:4] != b"TREE" or head[4] != 0:
            raise ValueError(f"{self.name}: a group B-tree node of the wrong kind")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        body = f._bytes(addr + 8 + 2 * o, (used + 1) * l_ + used * o)
        r = _Reader(body, o, l_)
        children = []
        for _ in range(used):
            r.length()  # key: a heap offset
            children.append(r.addr())
        for child in children:
            if level > 0:
                self._walk(child, members)
                continue
            sh = f._bytes(child, 8)
            if sh[:4] != b"SNOD":
                raise ValueError(f"{self.name}: symbol table node signature missing")
            n = struct.unpack_from("<H", sh, 6)[0]
            entry = 2 * o + 24
            table = f._bytes(child + 8, n * entry)
            for k in range(n):
                er = _Reader(table, o, l_, k * entry)
                name_off, obj = er.addr(), er.addr()
                members[self._name_at(name_off)] = obj

    def keys(self):
        return list(self._load())

    def __getitem__(self, path: str):
        node = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group):
                raise KeyError(f"{path}: {node.name} is not a group")
            members = node._load()
            if part not in members:
                raise KeyError(f"{path}: no member {part!r} in {node.name}")
            sub = node.name.rstrip("/") + "/" + part
            node = _open_object(self.file, members[part], sub)
        return node


def _datatype(body: bytes):
    """(numpy dtype or None, description) of a datatype message."""
    cls, version = body[0] & 15, body[0] >> 4
    bits = int.from_bytes(body[1:4], "little")
    size = struct.unpack_from("<I", body, 4)[0]
    order = ">" if bits & 1 else "<"
    if cls == 0:  # fixed-point: byte order, sign; bit offset and precision
        offset, precision = struct.unpack_from("<HH", body, 8)
        if size in (1, 2, 4, 8) and offset == 0 and precision == 8 * size:
            return np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}"), "fixed-point"
    elif cls == 1:  # IEEE floats only (bit 6 marks VAX order)
        offset, precision = struct.unpack_from("<HH", body, 8)
        if size in (2, 4, 8) and not bits & 0x40 and offset == 0 and precision == 8 * size:
            return np.dtype(f"{order}f{size}"), "floating-point"
    elif cls == 7 and (bits & 15) == 0:
        return np.dtype(object), "object reference"
    name = _TYPE_CLASSES.get(cls, f"class {cls}")
    return None, f"{name} datatype (version {version}, {size} bytes)"


def _pipeline(body: bytes, what: str) -> list:
    """[(filter id, client data)] of a filter pipeline message, in write order."""
    version, n = body[0], body[1]
    pos, out = (8 if version == 1 else 2), []
    if version not in (1, 2):
        raise ValueError(f"{what}: filter pipeline message version {version}")
    for _ in range(n):
        fid = struct.unpack_from("<H", body, pos)[0]
        pos += 2
        name_len = 0
        if version == 1 or fid >= 256:
            name_len = struct.unpack_from("<H", body, pos)[0]
            pos += 2
        _flags, ncd = struct.unpack_from("<HH", body, pos)
        pos += 4
        if version == 1:
            name_len = (name_len + 7) // 8 * 8
        pos += name_len
        cd = struct.unpack_from(f"<{ncd}I", body, pos)
        pos += 4 * ncd
        if version == 1 and ncd % 2:
            pos += 4
        if fid not in _FILTERS:
            raise ValueError(f"{what}: filter {fid} is not supported (the reader takes "
                             "deflate, shuffle and fletcher32)")
        out.append((fid, cd))
    return out


def parse_layout(body: bytes, osize: int, lsize: int, what: str = "dataset") -> dict:
    """The layout message: {"class": compact/contiguous/chunked, ...}."""
    version = body[0]
    if version != 3:
        detail = (" (its chunk indexes: single chunk, implicit, fixed array, extensible "
                  "array, version-2 B-tree)" if version == 4 else "")
        raise ValueError(f"{what}: data layout message version {version} is not supported"
                         f"{detail}; the reader takes version 3, as h5py's "
                         "libver='earliest' writes")
    r = _Reader(body, osize, lsize, 2)
    cls = body[1]
    if cls == 0:
        n = r.u(2)
        return {"class": "compact", "data": body[4:4 + n]}
    if cls == 1:
        return {"class": "contiguous", "addr": r.addr(), "size": r.length()}
    if cls == 2:
        rank = r.u(1)
        addr = r.addr()
        dims = [r.u(4) for _ in range(rank)]
        return {"class": "chunked", "addr": addr, "chunk": tuple(dims[:-1])}
    raise ValueError(f"{what}: data layout class {cls} is not supported")


def _fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 of ``data``: 16-bit big-endian words, sums folded
    to 16 bits every 360 words, as ``H5_checksum_fletcher32``."""
    words = np.frombuffer(data[:len(data) // 2 * 2], ">u2").astype(np.int64)
    s1 = s2 = 0
    for k in range(0, len(words), 360):
        w = words[k:k + 360]
        t = len(w)
        s2 += t * s1 + int(np.dot(np.arange(t, 0, -1, dtype=np.int64), w))
        s1 += int(w.sum())
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if len(data) % 2:
        s1 += data[-1] << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return (s2 << 16) | s1


class Dataset:
    """A dataset: its shape, numpy dtype, and reads of rows of its first axis."""

    def __init__(self, f: File, addr: int, name: str, msgs):
        self.file, self.name = f, name
        self._filters, self._fill = [], None
        for kind, flags, body in msgs:
            if flags & 2 and kind in (_DATASPACE, _DATATYPE, _LAYOUT, _PIPELINE, _FILL):
                raise ValueError(f"{name}: shared message of type {kind:#x} is not supported")
            if kind == _DATASPACE:
                self.shape = self._dataspace(body)
                if not self.shape:
                    raise ValueError(f"{name}: a scalar or null dataspace is not supported")
            elif kind == _DATATYPE:
                self._dtype, self._type_name = _datatype(body)
                self._itemsize = struct.unpack_from("<I", body, 4)[0]
            elif kind == _LAYOUT:
                self._layout = parse_layout(body, f.osize, f.lsize, name)
            elif kind == _PIPELINE:
                self._filters = _pipeline(body, name)
            elif kind == _FILL and body[0] in (1, 2) and body[3]:
                n = struct.unpack_from("<I", body, 4)[0]
                self._fill = body[8:8 + n] if n else None
        self._chunks = None

    def _dataspace(self, body: bytes) -> tuple:
        version, rank, flags = body[0], body[1], body[2]
        if version not in (1, 2):
            raise ValueError(f"{self.name}: dataspace message version {version}")
        pos = 8 if version == 1 else 4
        ls = self.file.lsize
        return tuple(int.from_bytes(body[pos + k * ls:pos + (k + 1) * ls], "little")
                     for k in range(rank))

    # -- h5py's interface ---------------------------------------------------

    @property
    def dtype(self) -> np.dtype:
        if self._dtype is None:
            raise ValueError(f"{self.name}: {self._type_name} is not supported")
        return self._dtype  # in the file's byte order, as h5py gives it

    def __array__(self, dtype=None, copy=None):
        a = self[()]
        return a if dtype is None else a.astype(dtype)

    def __getitem__(self, key):
        if self._dtype is None:
            raise ValueError(f"{self.name}: reading a {self._type_name} is not supported")
        if not isinstance(key, tuple):
            key = (key,)
        if key == ():
            return self._rows(np.arange(self.shape[0]))
        first, rest = key[0], key[1:]
        if isinstance(first, (int, np.integer)):
            i = int(first) + (self.shape[0] if first < 0 else 0)
            if not 0 <= i < self.shape[0]:
                raise IndexError(f"index {first} out of range for {self.shape[0]} rows")
            return self._rows(np.array([i]))[(0,) + rest]
        if isinstance(first, slice):
            return self._rows(np.arange(self.shape[0])[first])[(slice(None),) + rest]
        idx = np.asarray(first).astype(np.int64)
        idx = np.where(idx < 0, idx + self.shape[0], idx)
        if idx.size and (idx.min() < 0 or idx.max() >= self.shape[0]):
            raise IndexError(f"index out of range for {self.shape[0]} rows")
        uniq, inv = np.unique(idx, return_inverse=True)
        return self._rows(uniq)[(inv.reshape(idx.shape),) + rest]

    # -- reading ------------------------------------------------------------

    def _to_numpy(self, raw: bytes, shape) -> np.ndarray:
        dt = self._dtype
        if dt.kind == "O":  # object references: file addresses
            o = self.file.osize
            addrs = np.frombuffer(raw, f"<u{o}", int(np.prod(shape, dtype=np.int64)))
            out = np.empty(addrs.shape, object)
            out[:] = [Reference(int(a)) for a in addrs]
            return out.reshape(shape)
        return np.frombuffer(raw, dt, int(np.prod(shape, dtype=np.int64))).reshape(shape)

    def _filled(self, shape) -> np.ndarray:
        """The fill value (zero unless the dataset defines one) in ``shape``."""
        n = int(np.prod(shape, dtype=np.int64))
        if self._fill is None or not any(self._fill):
            raw = bytes(n * self._itemsize)
        else:
            raw = self._fill * n
        return self._to_numpy(raw, shape)

    def _rows(self, rows) -> np.ndarray:
        """The rows ``rows`` (sorted, distinct) of the first axis, in the
        file's byte order."""
        lay = self._layout
        out_shape = (len(rows),) + tuple(self.shape[1:])
        if lay["class"] == "chunked":
            return self._chunked_rows(rows)
        if lay["class"] == "contiguous" and lay["addr"] == _UNDEF:  # never written
            return self._filled(out_shape)
        row_bytes = int(np.prod(self.shape[1:], dtype=np.int64)) * self._itemsize
        parts = []
        for r in rows:
            if lay["class"] == "compact":
                parts.append(lay["data"][r * row_bytes:(r + 1) * row_bytes])
            else:
                parts.append(self.file._bytes(lay["addr"] + int(r) * row_bytes, row_bytes))
        return self._native(self._to_numpy(b"".join(parts), out_shape))

    @staticmethod
    def _native(a: np.ndarray) -> np.ndarray:
        """A writeable array (a view of the file's bytes is not)."""
        return a if a.flags.writeable else a.copy()

    def _chunk_index(self) -> list:
        """[(offsets, stored size, filter mask, address)] of every chunk."""
        if self._chunks is None:
            chunks = []
            if self._layout["addr"] != _UNDEF:
                self._walk(self._layout["addr"], chunks)
            self._chunks = chunks
        return self._chunks

    def _walk(self, addr: int, chunks: list):
        f = self.file
        o, rank = f.osize, len(self.shape) + 1
        head = f._bytes(addr, 8 + 2 * o)
        if head[:4] != b"TREE" or head[4] != 1:
            raise ValueError(f"{self.name}: a chunk B-tree node of the wrong kind")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        key = 8 + 8 * rank
        body = f._bytes(addr + 8 + 2 * o, (used + 1) * key + used * o)
        pos = 0
        for _ in range(used):
            size, mask = struct.unpack_from("<II", body, pos)
            offs = struct.unpack_from(f"<{rank}Q", body, pos + 8)[:-1]
            child = int.from_bytes(body[pos + key:pos + key + o], "little")
            pos += key + o
            if level > 0:
                self._walk(child, chunks)
            else:
                chunks.append((offs, size, mask, child))

    def _decode_chunk(self, raw: bytes, mask: int) -> bytes:
        for k in range(len(self._filters) - 1, -1, -1):  # read: the pipeline backwards
            if mask & (1 << k):
                continue
            fid, cd = self._filters[k]
            if fid == 1:
                raw = zlib.decompress(raw)
            elif fid == 2:
                es = cd[0] if cd else self._itemsize
                n = len(raw) // es
                body = np.frombuffer(raw, np.uint8, n * es).reshape(es, n).T.tobytes()
                raw = body + raw[n * es:]
            elif fid == 3:
                stored = int.from_bytes(raw[-4:], "little")
                want = _fletcher32(raw[:-4])
                swapped = ((want & 0xFF) << 24 | (want & 0xFF00) << 8 | (want >> 8) & 0xFF00
                           | want >> 24)
                if stored not in (want, swapped):
                    raise ValueError(f"{self.name}: a chunk fails its fletcher32 checksum")
                raw = raw[:-4]
        return raw

    def _chunked_rows(self, rows) -> np.ndarray:
        cdims = self._layout["chunk"]
        shape = self.shape
        chunk_bytes = int(np.prod(cdims, dtype=np.int64)) * self._itemsize
        out = self._filled((len(rows),) + tuple(shape[1:])).copy()
        for offs, size, mask, addr in self._chunk_index():
            lo = offs[0]
            sel = np.flatnonzero((rows >= lo) & (rows < lo + cdims[0]))
            if not sel.size:
                continue
            raw = self._decode_chunk(self.file._bytes(addr, size), mask)
            if len(raw) != chunk_bytes:
                raise ValueError(f"{self.name}: a chunk holds {len(raw)} bytes, "
                                 f"expected {chunk_bytes}")
            chunk = self._to_numpy(raw, cdims)
            # the part of the chunk inside the dataset (edge chunks overhang)
            inner = tuple(slice(o, min(o + c, s)) for o, c, s in
                          zip(offs[1:], cdims[1:], shape[1:]))
            src = (rows[sel] - lo,) + tuple(slice(0, s.stop - s.start) for s in inner)
            out[(sel,) + inner] = chunk[src]
        return out
