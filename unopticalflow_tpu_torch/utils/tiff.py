"""TIFF, read as ``cv2.imdecode`` (OpenCV 5.0 with libtiff 4.7) reads it,
every value equal.

The first page (IFD 0) of a classic or BigTIFF file in either byte order:
strips or tiles, PlanarConfiguration 1 (samples interleaved) or 2 (one
plane a sample), 1-, 8- and 16-bit samples, Photometric 0 (white is
zero), 1 (black is zero), 2 (RGB) and 3 (palette, a 16-bit colormap), and
6 (YCbCr) where the data is JPEG; ExtraSamples for alpha.  Compression 1
(none), 32773 (PackBits) and 5 (LZW) are undone by ``csrc/tiff.c``, 8 and
32946 (Deflate) by ``zlib``, 7 (JPEG, its ``JPEGTables`` put before each
strip or tile) by ``csrc/jpeg.c``; Predictor 2 (horizontal differencing)
at 8 and 16 bits.

OpenCV hands an 8-bit read (``IMREAD_COLOR``, ``IMREAD_GRAYSCALE``, and
``IMREAD_UNCHANGED`` of a 1- or 8-bit file) to libtiff's RGBA interface,
whose conversions this module repeats: grey and palette samples through
libtiff's maps (16-bit grey keeps its high byte, a colormap its high byte
unless every entry is below 256, white-is-zero inverted), 16-bit RGB
rounded to 8 bits as ``(v + 128) // 257``, colour premultiplied by an
unassociated alpha as ``(a * v + 127) // 255``; then BGR, BGRA (a 4-sample
file under ``IMREAD_UNCHANGED``) or grey as ``(B * 1868 + G * 9617 + R *
4899 + 8192) >> 14``.  ``IMREAD_UNCHANGED`` of a 16-bit file gives the
samples as stored (RGB turned to BGR).  The Orientation tag is applied to
every read, as cv2 applies it to TIFF.

An uncompressed tile read through the RGBA interface gives None, as cv2
gives it: libtiff keeps a raw tile in a buffer of its byte count rounded up
to 1024 bytes, and refuses the tile ("Invalid tile byte count") unless that
is the tile's size, so a tile of 16x16 RGB samples (768 bytes) never
decodes there, one of 32x32 (3072 bytes) does.  A file the port cannot
decode raises ``ValueError`` naming the fault.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from unopticalflow_tpu_torch.utils.imageio import (IMREAD_COLOR, IMREAD_GRAYSCALE,
                                                   IMREAD_UNCHANGED, _channels, _check_flags,
                                                   _jpeg_raw, _orient)
from unopticalflow_tpu_torch.utils.rasters import grey

# TIFF field types: struct code and size
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8),
          13: ("I", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
_COMPRESSIONS = {1: "none", 5: "LZW", 7: "JPEG", 8: "Deflate", 32773: "PackBits",
                 32946: "Deflate"}
_FAULT = {1: "data ends before the strip or tile is full",
          2: "an LZW code past the table", 3: "old-style (LSB-first) LZW"}


def _lib():
    """``csrc/tiff.c``, built with the host's C compiler at first use."""
    import ctypes

    from unopticalflow_tpu_torch.ops import _build

    i64, p = ctypes.c_int64, _build.P
    return _build.load("tiff", {
        "packbits_decode": [p, i64, p, i64],
        "lzw_decode": [p, i64, p, i64],
    })


def _ifd(data: bytes) -> dict:
    """IFD 0's tags: {tag: tuple of values}."""
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None or len(data) < 8:
        raise ValueError("truncated TIFF header")
    big = struct.unpack_from(order + "H", data, 2)[0] == 43
    if big:
        if len(data) < 16:
            raise ValueError("truncated BigTIFF header")
        pos = struct.unpack_from(order + "Q", data, 8)[0]
        count_fmt, entry, inline = "Q", 20, 8
    else:
        pos = struct.unpack_from(order + "I", data, 4)[0]
        count_fmt, entry, inline = "H", 12, 4
    head = struct.calcsize(order + count_fmt)
    if pos + head > len(data):
        raise ValueError("TIFF: the first IFD lies past the end of the file")
    n = struct.unpack_from(order + count_fmt, data, pos)[0]
    if pos + head + n * entry > len(data):
        raise ValueError("truncated TIFF IFD")
    tags = {}
    for k in range(n):
        e = pos + head + k * entry
        tag, kind = struct.unpack_from(order + "HH", data, e)
        count = struct.unpack_from(order + ("Q" if big else "I"), data, e + 4)[0]
        if kind not in _TYPES:
            continue
        code, size = _TYPES[kind]
        nbytes = size * count
        at = e + (12 if big else 8)
        if nbytes > inline:
            at = struct.unpack_from(order + ("Q" if big else "I"), data, at)[0]
        if at + nbytes > len(data):
            raise ValueError(f"TIFF tag {tag}: its values lie past the end of the file")
        if kind in (2, 7):
            tags[tag] = data[at:at + nbytes]
        else:
            fmt = order + code[0] * (count * len(code))
            tags[tag] = struct.unpack_from(fmt, data, at)
    return tags, order


def _one(tags: dict, tag: int, default=None):
    v = tags.get(tag)
    return default if v is None else v[0]


def _chunk(raw: bytes, compression: int, need: int, tables: bytes | None, jpeg_mode: int):
    """One strip or tile, decompressed to at least ``need`` bytes."""
    if compression == 1:
        if len(raw) < need:
            raise ValueError(f"TIFF strip or tile holds {len(raw)} bytes, {need} needed")
        return np.frombuffer(raw, np.uint8, need)
    if compression in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, need)
        except zlib.error as e:
            raise ValueError(f"TIFF Deflate data: {e}") from None
        if len(out) < need:
            raise ValueError(f"TIFF Deflate data: {len(out)} bytes of {need}")
        return np.frombuffer(out, np.uint8)
    if compression == 7:
        if tables is not None and len(tables) > 4:  # the tables' SOI ... EOI around the data
            raw = tables[:-2] + raw[2:]
        return _jpeg_raw(raw, jpeg_mode)
    out = np.empty(need, np.uint8)
    src = np.frombuffer(raw, np.uint8)
    fn = _lib().lzw_decode if compression == 5 else _lib().packbits_decode
    fault = fn(src.ctypes.data, src.size, out.ctypes.data, need)
    if fault:
        raise ValueError(f"TIFF {_COMPRESSIONS[compression]} data: {_FAULT[fault]}")
    return out


def decode_tiff(data: bytes, flags: int = IMREAD_COLOR) -> np.ndarray | None:
    """TIFF bytes -> the array ``cv2.imdecode(data, flags)`` gives, None
    included (see the module)."""
    _check_flags(flags)
    tags, order = _ifd(data)
    w, h = _one(tags, 256, 0), _one(tags, 257, 0)
    if w <= 0 or h <= 0:
        raise ValueError(f"TIFF of {w}x{h} pixels")
    if w * h >= 1 << 30:
        raise ValueError(f"TIFF of {w}x{h} pixels is larger than 2**30 pixels")
    photometric = _one(tags, 262)
    if photometric is None:
        raise ValueError("TIFF without a Photometric tag")
    spp = _one(tags, 277, 1)
    bps = _one(tags, 258, 1)
    if any(b != bps for b in tags.get(258, (bps,))):
        raise ValueError(f"TIFF with samples of several sizes {tags[258]}")
    compression = _one(tags, 259, 1)
    planar = _one(tags, 284, 1)
    predictor = _one(tags, 317, 1)
    extra = tags.get(338, ())
    fmt = _one(tags, 339, 1)
    if bps not in (1, 8, 16) or fmt not in (1,):
        raise ValueError(f"TIFF of {bps}-bit samples (format {fmt}) is not supported: the port "
                         "reads 1-, 8- and 16-bit unsigned samples")
    if compression not in _COMPRESSIONS:
        raise ValueError(f"TIFF compression {compression} is not supported: the port reads "
                         "none, PackBits, LZW, Deflate and JPEG")
    if photometric not in (0, 1, 2, 3) and not (photometric == 6 and compression == 7):
        raise ValueError(f"TIFF Photometric {photometric} is not supported: the port reads 0, "
                         "1, 2, 3, and 6 with JPEG")
    if not 1 <= spp <= 4 or planar not in (1, 2) or predictor not in (1, 2):
        raise ValueError(f"TIFF with {spp} samples a pixel, planar {planar}, predictor "
                         f"{predictor} is not supported")
    if bps == 1 and (spp != 1 or photometric not in (0, 1, 3)):
        raise ValueError("TIFF of 1-bit samples: the port reads one grey or palette sample")
    if predictor == 2 and bps == 1:
        raise ValueError("TIFF Predictor 2 on 1-bit samples is not supported")

    tiled = 322 in tags
    if tiled:
        cw, ch = _one(tags, 322, 0), _one(tags, 323, 0)
        offsets, counts = tags.get(324), tags.get(325)
    else:
        cw, ch = w, min(_one(tags, 278, h) or h, h)
        offsets, counts = tags.get(273), tags.get(279)
    if not cw or not ch or offsets is None or counts is None or len(offsets) != len(counts):
        raise ValueError("TIFF without its strip or tile offsets and byte counts")
    planes = spp if planar == 2 else 1
    per = 1 if planar == 2 else spp  # samples a pixel in each chunk
    row_bytes = (cw * per * bps + 7) // 8
    rgba_read = not (flags == IMREAD_UNCHANGED and bps == 16)
    if tiled and compression == 1 and rgba_read and any(
            -(-n // 1024) * 1024 != ch * row_bytes for n in counts):
        return None  # libtiff's refusal of the tile (see the module)
    # where OpenCV's output is wrong: raise rather than match it
    if tiled and bps == 16 and photometric in (0, 1) and flags != IMREAD_UNCHANGED and (
            w % cw or h % ch):
        raise ValueError("TIFF of 16-bit grey tiles that overhang the image, read as 8-bit, is "
                         "not supported: libtiff's RGBA reader misplaces their rows")
    if flags == IMREAD_UNCHANGED and bps == 16 and (spp == 2 or (planar == 2 and spp > 1)):
        raise ValueError("TIFF of 16-bit grey and alpha, or of 16-bit samples in separate "
                         "planes, read under IMREAD_UNCHANGED is not supported: OpenCV reads "
                         "them wrongly")

    # the stored samples, (h, w, spp) uint8 / uint16 (1-bit samples as 0/1)
    across, down = -(-w // cw), -(-h // ch)
    if len(offsets) < across * down * planes:
        raise ValueError(f"TIFF holds {len(offsets)} strips or tiles, "
                         f"{across * down * planes} needed")
    dtype = np.dtype(order + "u2") if bps == 16 else np.dtype(np.uint8)
    tables = tags.get(347)
    jpeg_mode = 2 if photometric in (2, 3) else (1 if photometric in (0, 1) else 0)
    img = np.empty((h, w, spp), np.uint16 if bps == 16 else np.uint8)
    k = 0
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                y0, x0 = ty * ch, tx * cw
                rows = ch if tiled else min(ch, h - y0)  # the last strip may be short
                off, n = offsets[k], counts[k]
                k += 1
                if off + n > len(data):
                    raise ValueError(f"truncated TIFF (strip or tile {k - 1} runs past the end)")
                raw = data[off:off + n]
                if compression == 7:
                    px = _chunk(raw, 7, 0, tables, jpeg_mode)
                    if px.ndim == 2:
                        px = px[:, :, None]
                    if px.shape[0] < rows or px.shape[1] < cw or px.shape[2] != per:
                        raise ValueError(f"TIFF JPEG strip or tile of {px.shape}, expected "
                                         f"({rows}, {cw}, {per})")
                    px = px[:rows, :cw]
                    if photometric == 6:
                        px = px[:, :, ::-1]  # BGR -> RGB
                else:
                    buf = _chunk(raw, compression, rows * row_bytes, None, 0)[:rows * row_bytes]
                    buf = buf.reshape(rows, row_bytes)
                    if bps == 1:
                        px = np.unpackbits(buf, axis=1)[:, :cw, None]
                    else:
                        px = buf.view(dtype).reshape(rows, cw, per)
                        if predictor == 2:  # horizontal differencing, per sample, mod 2**bps
                            px = np.cumsum(px, axis=1, dtype=px.dtype)
                yh, xw = min(rows, h - y0), min(cw, w - x0)
                img[y0:y0 + yh, x0:x0 + xw, p:p + per] = px[:yh, :xw]
    if photometric == 6:
        photometric = 2

    alpha_kind = extra[0] if extra else 0
    if not rgba_read:
        out = img[:, :, 0] if spp == 1 else _channels(img, [2, 1, 0, 3][:spp])
    else:
        rgba = _rgba(img, photometric, bps, spp, alpha_kind, tags)
        if flags == IMREAD_GRAYSCALE or (flags == IMREAD_UNCHANGED and _own_channels(
                photometric, bps, spp) == 1):
            out = grey(rgba[:, :, 2::-1])
        elif flags == IMREAD_UNCHANGED and _own_channels(photometric, bps, spp) == 4:
            out = _channels(rgba, [2, 1, 0, 3])
        else:
            out = _channels(rgba, [2, 1, 0])
    return _orient(out, _one(tags, 274, 1))



def _own_channels(photometric: int, bps: int, spp: int) -> int:
    """The channels of cv2's own type for an 8-bit file."""
    if photometric == 3:
        return 1 if bps == 1 else 3
    return 1 if spp == 2 else spp  # grey and alpha: grey


def _rgba(img: np.ndarray, photometric: int, bps: int, spp: int, alpha_kind: int,
          tags: dict) -> np.ndarray:
    """libtiff's TIFFReadRGBA* conversion of the stored samples: (h, w, 4) uint8 RGBA."""
    h, w = img.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    out[:, :, 3] = 255
    if photometric in (0, 1):
        v = img[:, :, 0]
        if bps == 1:
            g = (v * 255).astype(np.uint8)
        elif bps == 16:
            g = (v >> 8).astype(np.uint8)
        else:
            g = v
        if photometric == 0:
            g = 255 - g
        out[:, :, 0] = out[:, :, 1] = out[:, :, 2] = g
        if spp >= 2 and bps == 8:
            out[:, :, 3] = img[:, :, 1]
        return out
    if photometric == 3:
        cmap = tags.get(320)
        if cmap is None or len(cmap) != 3 << bps:
            raise ValueError("palette TIFF without a colormap of 3 * 2**bps entries")
        cmap = np.asarray(cmap, np.int64).reshape(3, 1 << bps)
        if (cmap >= 256).any():  # libtiff's checkcmap: else an 8-bit colormap
            cmap = cmap >> 8
        idx = img[:, :, 0]
        out[:, :, :3] = cmap.T.astype(np.uint8)[idx]
        return out
    # RGB
    if spp < 3:
        raise ValueError(f"RGB TIFF of {spp} samples a pixel")
    px = img[:, :, :spp]
    if bps == 16:
        px = ((px.astype(np.int32) + 128) // 257).astype(np.uint8)
    for k in range(spp):
        out[:, :, k] = px[:, :, k]
    if spp == 4 and alpha_kind == 2:  # unassociated alpha: premultiplied
        a = px[:, :, 3:4].astype(np.int32)
        out[:, :, :3] = ((a * px[:, :, :3] + 127) // 255).astype(np.uint8)
    return out

