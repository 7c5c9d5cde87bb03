"""BMP, PNM (P1-P6), PAM (P7), PFM, Sun raster and Radiance HDR, read as
``cv2.imdecode`` (OpenCV 5.0) reads them, every value equal.

Headers are parsed here, rows expanded with numpy, and the run-length
loops of BMP and HDR run in ``csrc/rle.c``.  Each reader follows OpenCV's
decoder for its format, quirks included, since the port must hand its
callers the arrays cv2 hands the JAX package:

* BMP (``grfmt_bmp.cpp``): headers of 12 (OS/2), 40, 108 and 124 bytes;
  1-, 4- and 8-bit palettes (entries past a short palette are black),
  RLE8 and RLE4 (skipped pixels take palette entry 0), 16-bit 555 and
  ``BI_BITFIELDS`` 565 (each field shifted up, low bits zero), 24- and
  32-bit.  A palette of greys, and every OS/2 file, is a one-channel image
  under ``IMREAD_UNCHANGED``; a 32-bit ``BI_BITFIELDS`` file keeps its
  fourth byte as alpha, a 32-bit ``BI_RGB`` file drops it.  A 32-bit
  ``BI_BITFIELDS`` file with a header of 56 bytes or more goes through its
  masks (see ``_masked``); a 16-bit one has its masks read from after the
  header, where a 40-byte header puts them.
* PNM (``grfmt_pxm.cpp``): binary samples are taken as stored whatever the
  maxval, ASCII samples of an 8-bit file are rescaled by ``v * 255 //
  maxval``; 16-bit samples (maxval above 255) keep their value under
  ``IMREAD_UNCHANGED`` and their high byte otherwise.
* PAM (``grfmt_pam.cpp``): a missing tuple type is guessed from the depth
  and maxval; ``BLACKANDWHITE`` rows of ``width`` bytes are read as packed
  bits (from their first bytes),
  a tuple type whose channels match the request is copied as stored (RGB
  stays in RGB order), ``RGB`` to grey is converted, and another grey read
  of several channels gives pixel x the first sample of pixel x // 3 (the
  row's first ceil(w / depth) pixels, each written three times).  Where
  that, or a colour read of 2 or 4 channels, leaves part of OpenCV's output
  unset, the read raises here.
* PFM (``grfmt_pfm.cpp``): samples divided by the scale's magnitude (a
  float32 product), rows bottom-up, RGB turned to BGR; an 8-bit read rounds
  and saturates without scaling by 255, and keeps the file's channels.
* Sun raster (``grfmt_sunras.cpp``): ``RT_OLD`` and ``RT_STANDARD`` files of
  1, 8, 24 and 32 bits, with or without a colour map; OpenCV refuses
  ``RT_BYTE_ENCODED`` and ``RT_FORMAT_RGB`` files, and so does the port.  A
  grey read of a file without a colour map is all zeros, as in OpenCV.
* Radiance HDR (``grfmt_hdr.cpp``, ``rgbe.c``): ``FORMAT=32-bit_rle_rgbe``
  with a ``-Y h +X w`` line, flat or new-style scanline RLE (rgbe.c reads
  the old-style repeat pixels as pixels); float32 BGR, times 255 rounded
  and saturated for an 8-bit read, grey from those 8-bit values.

Grey conversions are OpenCV's ``(B * 1868 + G * 9617 + R * 4899 + 8192) >>
14``.  A file the port cannot decode raises ``ValueError`` naming the
format and the fault.
"""

from __future__ import annotations

import re
import struct

import numpy as np

from unopticalflow_tpu_torch.utils.imageio import (IMREAD_COLOR, IMREAD_GRAYSCALE,
                                                   IMREAD_UNCHANGED, _check_flags)


def grey(bgr: np.ndarray) -> np.ndarray:
    """(..., >=3) uint8 B, G, R -> uint8 grey as OpenCV's icvCvt_BGR2Gray."""
    b, g, r = (bgr[..., k].astype(np.int32) for k in range(3))
    return ((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14).astype(np.uint8)


def _as_flags(img: np.ndarray, flags: int, channels: int) -> np.ndarray:
    """A BGR, BGRA or grey uint8 image as a read of ``flags`` gives it when
    the decoder's own type has ``channels`` channels."""
    if flags == IMREAD_GRAYSCALE:
        return img if img.ndim == 2 else grey(img)
    if flags == IMREAD_COLOR or channels == 3:
        if img.ndim == 2:
            return np.repeat(img[:, :, None], 3, axis=2)
        return np.ascontiguousarray(img[:, :, :3])
    return img if channels == 4 or img.ndim == 2 else grey(img)


def _lib():
    """``csrc/rle.c``, built with the host's C compiler at first use."""
    import ctypes

    from unopticalflow_tpu_torch.ops import _build

    i64, p = ctypes.c_int64, _build.P
    return _build.load("rle", {
        "bmp_rle": [p, i64, i64, _build.I, i64, i64, p],
        "hdr_rle": [p, i64, i64, i64, i64, p],
    })


_RLE_FAULT = {1: "truncated", 2: "a run passes the end of its row", 3: "bad scanline data"}


def _bits(rows: np.ndarray, bpp: int, w: int) -> np.ndarray:
    """(h, pitch) bytes -> (h, w) samples of 1, 4 or 8 bits, high bits first."""
    if bpp == 8:
        return rows[:, :w]
    if bpp == 4:
        return np.stack([rows >> 4, rows & 15], axis=2).reshape(len(rows), -1)[:, :w]
    return np.unpackbits(rows, axis=1)[:, :w]


def _rows(data: bytes, pos: int, h: int, pitch: int, what: str) -> np.ndarray:
    if pos + h * pitch > len(data):
        raise ValueError(f"truncated {what} ({len(data) - pos} bytes of pixel data, "
                         f"{h * pitch} needed)")
    return np.frombuffer(data, np.uint8, h * pitch, pos).reshape(h, pitch)


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


def decode_bmp(data: bytes, flags: int = IMREAD_COLOR) -> np.ndarray:
    """BMP bytes -> the array ``cv2.imdecode(data, flags)`` gives (see the module)."""
    _check_flags(flags)
    if len(data) < 26:
        raise ValueError("truncated BMP header")
    offset, size = struct.unpack_from("<II", data, 10)
    palette = np.zeros((256, 3), np.uint8)  # B, G, R; entries past the file's are black
    colour, alpha, masks = False, False, None
    if size >= 36:
        if len(data) < 14 + size:
            raise ValueError("truncated BMP header")
        w, h, _, bpp, rle, clrused = struct.unpack_from("<iiHHI12xI", data, 18)
        pos = 14 + size
        if rle > 3:
            raise ValueError(f"BMP compression {rle} is not supported")
        ok = w > 0 and h != 0 and (
            (bpp in (1, 4, 8, 24, 32) and rle == 0) or (bpp in (16, 32) and rle in (0, 3))
            or (bpp == 4 and rle == 2) or (bpp == 8 and rle == 1))
        if not ok:
            raise ValueError(f"BMP of {bpp} bits with compression {rle} is not supported")
        colour = True
        if bpp <= 8:
            if clrused > 256:
                raise ValueError(f"BMP palette of {clrused} entries")
            n = clrused or 1 << bpp
            if pos + 4 * n > len(data):
                raise ValueError("truncated BMP palette")
            palette[:n] = np.frombuffer(data, np.uint8, 4 * n, pos).reshape(n, 4)[:, :3]
            used = palette[:1 << bpp]
            colour = bool(((used[:, 0] != used[:, 1]) | (used[:, 0] != used[:, 2])).any())
        elif bpp == 16 and rle == 3:
            if pos + 12 > len(data):
                raise ValueError("truncated BMP colour masks")
            rgb_masks = struct.unpack_from("<III", data, pos)
            if rgb_masks == (0x7C00, 0x3E0, 0x1F):
                bpp = 15
            elif rgb_masks != (0xF800, 0x7E0, 0x1F):
                raise ValueError(f"BMP 16-bit colour masks {[hex(m) for m in rgb_masks]} are "
                                 "neither 555 nor 565")
        elif bpp == 16:
            bpp = 15
        alpha = bpp == 32 and rle != 0
        if alpha and size >= 56:  # a V3+ header: the masks inside it, alpha's too
            masks = struct.unpack_from("<IIII", data, 54)
    elif size == 12:
        w, h, planes, bpp = struct.unpack_from("<HHHH", data, 18)
        if not (planes == 1 and w > 0 and h > 0 and bpp in (1, 4, 8, 24, 32)):
            raise ValueError(f"OS/2 BMP of {bpp} bits, {planes} planes is not supported")
        rle = 0
        if bpp <= 8:
            n = 1 << bpp
            if 26 + 3 * n > len(data):
                raise ValueError("truncated BMP palette")
            palette[:n] = np.frombuffer(data, np.uint8, 3 * n, 26).reshape(n, 3)
    else:
        raise ValueError(f"BMP header of {size} bytes is not supported")
    bottom_up = h > 0
    h = abs(h)
    if h * w * 3 >= 1 << 30:
        raise ValueError(f"BMP of {w}x{h} pixels is too large")
    channels = (4 if alpha else 3) if colour else 1
    if offset > len(data):
        raise ValueError("truncated BMP (pixel data offset past the end)")

    coded = rle in (1, 2)  # RLE8, RLE4
    if coded:
        idx = np.empty((h, w), np.uint8)
        fault = _lib().bmp_rle(np.frombuffer(data, np.uint8).ctypes.data, len(data), offset,
                               int(rle == 2), w, h, idx.ctypes.data)
        if fault:
            raise ValueError(f"BMP RLE{8 if rle == 1 else 4} data: {_RLE_FAULT[fault]}")
    else:
        pitch = ((w * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
        rows = _rows(data, offset, h, pitch, "BMP")
    if bottom_up:
        flip = (slice(None, None, -1),)
    else:
        flip = (slice(None),)
    if bpp <= 8:
        if not coded:
            idx = _bits(rows, bpp, w)
        idx = idx[flip]
        if flags == IMREAD_GRAYSCALE or (channels == 1 and flags == IMREAD_UNCHANGED):
            return grey(palette)[idx]
        return palette[idx]
    if bpp in (15, 16):
        v = rows[:, :2 * w].copy().view("<u2")[flip].astype(np.uint16)
        if bpp == 15:
            bgr = np.stack([(v << 3) & 0xF8, (v >> 2) & 0xF8, (v >> 7) & 0xF8], axis=2)
        else:
            bgr = np.stack([(v << 3) & 0xF8, (v >> 3) & 0xFC, (v >> 8) & 0xF8], axis=2)
        return _as_flags(bgr.astype(np.uint8), flags, channels)
    px = rows[:, :w * bpp // 8].reshape(h, w, bpp // 8)[flip]
    if masks is not None:
        return _masked(px, masks, flags)
    if flags == IMREAD_UNCHANGED and channels == 1:  # OS/2: cv2 gives grey
        return grey(px)
    return _as_flags(np.ascontiguousarray(px), flags, channels)


def _masked(px: np.ndarray, masks, flags: int) -> np.ndarray:
    """32-bit pixels through a V3+ header's red, green, blue and alpha masks,
    as OpenCV 5 reads them: each field scaled to 8 bits by ``v * 255 //
    field_max`` (alpha 255 where its mask is 0), grey as the float32 sum
    ``(0.299 R + 0.587 G) + 0.114 B`` truncated."""
    v = np.ascontiguousarray(px).view("<u4")[:, :, 0].astype(np.int64)
    out = []
    for m in masks:
        if m == 0:
            out.append(np.full(v.shape, 255, np.int64))
            continue
        shift = (m & -m).bit_length() - 1
        out.append(((v & m) >> shift) * 255 // (m >> shift))
    r, g, b, a = out
    if flags == IMREAD_GRAYSCALE:
        f = np.float32
        y = (f(0.299) * r.astype(f) + f(0.587) * g.astype(f)) + f(0.114) * b.astype(f)
        return np.floor(y).astype(np.uint8)
    return np.stack([b, g, r, a][:4 if flags == IMREAD_UNCHANGED else 3], axis=2).astype(np.uint8)


# ---------------------------------------------------------------------------
# PNM, PAM, PFM
# ---------------------------------------------------------------------------


class _Text:
    """OpenCV's ReadNumber over a PNM header or ASCII body."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError("truncated PNM file")
        self.pos += 1
        return self.data[self.pos - 1]

    def number(self) -> int:
        c = self.byte()
        while not 48 <= c <= 57:
            if c == 35:  # '#': a comment to the end of the line
                while c not in (10, 13):
                    c = self.byte()
                c = self.byte()
            elif c in b" \t\n\v\f\r":
                while c in b" \t\n\v\f\r":
                    c = self.byte()
            else:
                raise ValueError(f"PNM: unexpected byte 0x{c:02x} where a number belongs")
        val = 0
        while True:
            val = val * 10 + c - 48
            if val > 0x7FFFFFFF:
                raise ValueError("PNM: a number larger than 2**31 - 1")
            c = self.byte()
            if not 48 <= c <= 57:
                break
        return val


def _ascii_numbers(data: bytes, pos: int, count: int, maxdigits: int) -> np.ndarray:
    """``count`` numbers of an ASCII PNM body from ``pos`` on, read as
    OpenCV's ReadNumber reads them (one digit each for P1)."""
    body = data[pos:]
    if maxdigits == 1:
        tokens = re.findall(rb"#[^\r\n]*[\r\n]|[0-9]|[^\s#0-9]", body)
    else:
        tokens = re.findall(rb"#[^\r\n]*[\r\n]|[0-9]+|[^\s#0-9]", body)
    out, n = np.empty(count, np.int64), 0
    for t in tokens:
        if n == count:
            break
        if t[:1] == b"#":
            continue
        if not t.isdigit():
            raise ValueError(f"PNM: unexpected byte 0x{t[0]:02x} where a number belongs")
        if len(t) > 10 or int(t) > 0x7FFFFFFF:
            raise ValueError("PNM: a number larger than 2**31 - 1")
        out[n] = int(t)
        n += 1
    if n < count:
        raise ValueError(f"truncated PNM file ({n} of {count} samples)")
    return out


def decode_pnm(data: bytes, flags: int = IMREAD_COLOR) -> np.ndarray:
    """P1-P6 bytes -> the array ``cv2.imdecode(data, flags)`` gives (see the module)."""
    _check_flags(flags)
    kind = data[1] - 48
    bpp = {1: 1, 4: 1, 2: 8, 5: 8, 3: 24, 6: 24}[kind]
    text = _Text(data, 2)
    w, h = text.number(), text.number()
    maxval = text.number() if bpp > 1 else 1
    if maxval > 65535 or not (w > 0 and h > 0 and maxval > 0):
        raise ValueError(f"PNM header: {w}x{h}, maxval {maxval}")
    wide = maxval > 255
    ch = 3 if bpp == 24 else 1
    count = w * h * ch
    if kind in (1, 2, 3):
        vals = _ascii_numbers(data, text.pos, count, 1 if kind == 1 else 0)
        if kind == 1:
            img = np.where(vals != 0, 0, 255).astype(np.uint8)
        else:
            vals = np.minimum(vals, maxval)
            img = (vals.astype(np.uint16) if wide
                   else (vals * 255 // maxval).astype(np.uint8))
    elif kind == 4:
        pitch = (w + 7) // 8
        img = np.where(_bits(_rows(data, text.pos, h, pitch, "PBM"), 1, w), 0, 255)
        img = img.astype(np.uint8)
    else:
        size = count * (2 if wide else 1)
        if text.pos + size > len(data):
            raise ValueError(f"truncated PNM file ({len(data) - text.pos} of {size} bytes)")
        img = np.frombuffer(data, ">u2" if wide else np.uint8, count, text.pos)
        img = img.astype(np.uint16) if wide else img.copy()
    img = img.reshape(h, w, ch) if ch == 3 else img.reshape(h, w)
    if wide and flags != IMREAD_UNCHANGED:
        img = (img >> 8).astype(np.uint8)
    if ch == 3:
        bgr = img[:, :, ::-1]
        return grey(bgr) if flags == IMREAD_GRAYSCALE else np.ascontiguousarray(bgr)
    if flags == IMREAD_COLOR:
        return np.repeat(img[:, :, None], 3, axis=2)
    return img


_PAM_TYPES = ("BLACKANDWHITE", "GRAYSCALE", "GRAYSCALE_ALPHA", "RGB", "RGB_ALPHA")


def decode_pam(data: bytes, flags: int = IMREAD_COLOR) -> np.ndarray:
    """P7 bytes -> the array ``cv2.imdecode(data, flags)`` gives (see the module)."""
    _check_flags(flags)
    end = data.find(b"ENDHDR")
    if end < 0:
        raise ValueError("PAM header without ENDHDR")
    nl = data.find(b"\n", end)
    if nl < 0:
        raise ValueError("truncated PAM header")
    fields = {}
    for line in data[3:end].split(b"\n"):
        parts = line.split(b"#", 1)[0].split()
        if len(parts) >= 2:
            fields[parts[0].decode("latin-1")] = parts[1].decode("latin-1")
    try:
        w, h, depth, maxval = (int(fields[k]) for k in ("WIDTH", "HEIGHT", "DEPTH", "MAXVAL"))
    except (KeyError, ValueError):
        raise ValueError("PAM header lacks WIDTH, HEIGHT, DEPTH or MAXVAL") from None
    tupl = fields.get("TUPLTYPE", "")
    if tupl and tupl not in _PAM_TYPES:
        raise ValueError(f"PAM tuple type {tupl} is not supported")
    if not (w > 0 and h > 0 and 1 <= depth <= 4 and 0 < maxval <= 65535):
        raise ValueError(f"PAM header: {w}x{h}, depth {depth}, maxval {maxval}")
    if not tupl:  # OpenCV's guess from the depth and maxval
        if maxval > 255 or depth not in (1, 3):
            raise ValueError(f"PAM without a tuple type, of depth {depth} and maxval {maxval}: "
                             "OpenCV cannot tell its format")
        tupl = "RGB" if depth == 3 else ("BLACKANDWHITE" if maxval == 1 else "GRAYSCALE")
    pos = nl + 1
    if tupl == "BLACKANDWHITE":  # w * depth bytes a row, of which OpenCV unpacks the bits
        rows = _rows(data, pos, h, w * depth, "PAM")
        img = np.where(_bits(rows, 1, w), 255, 0).astype(np.uint8)
        return np.repeat(img[:, :, None], 3, axis=2) if flags == IMREAD_COLOR else img
    wide = maxval > 255
    size = w * h * depth * (2 if wide else 1)
    if pos + size > len(data):
        raise ValueError(f"truncated PAM file ({len(data) - pos} of {size} bytes)")
    img = np.frombuffer(data, ">u2" if wide else np.uint8, w * h * depth, pos)
    img = img.astype(np.uint16) if wide else img.copy()
    img = img.reshape(h, w, depth)
    want = {IMREAD_COLOR: 3, IMREAD_GRAYSCALE: 1}.get(flags, depth)
    if wide and flags != IMREAD_UNCHANGED:
        img = (img >> 8).astype(np.uint8)
    if want == depth:  # copied as stored
        return img[:, :, 0] if depth == 1 else img
    if depth == 3 and tupl == "RGB":
        return grey(img[:, :, ::-1])
    if depth == 1 and want == 3:
        return np.repeat(img, 3, axis=2)
    if want == 1 and 3 * -(-w // depth) >= w:
        # OpenCV's basic_conversion: a row's first ceil(w / depth) pixels,
        # each its first sample written three times over
        return np.ascontiguousarray(img[:, np.arange(w) // 3, 0])
    raise ValueError(f"PAM of {depth} channels ({tupl}) read as {want}: "
                     "OpenCV converts only part of each row and leaves the rest unset")


def decode_pfm(data: bytes, flags: int = IMREAD_COLOR) -> np.ndarray:
    """PFM bytes -> the array ``cv2.imdecode(data, flags)`` gives (see the module)."""
    _check_flags(flags)
    ch = 3 if data[1:2] == b"F" else 1
    m = re.match(rb"P[fF]\s+(\d+)\s+(\d+)\s+(\S+)\s", data[:256])
    if m is None:
        raise ValueError("PFM header is not 'P[fF] width height scale'")
    w, h = int(m.group(1)), int(m.group(2))
    try:
        scale = float(m.group(3))
    except ValueError:
        raise ValueError(f"PFM scale {m.group(3)!r} is not a number") from None
    if scale == 0 or w <= 0 or h <= 0:
        raise ValueError(f"PFM header: {w}x{h}, scale {scale}")
    pos, size = m.end(), w * h * ch * 4
    if pos + size > len(data):
        raise ValueError(f"truncated PFM file ({len(data) - pos} of {size} bytes)")
    img = np.frombuffer(data, ">f4" if scale > 0 else "<f4", w * h * ch, pos)
    img = img.astype(np.float32).reshape(h, w, ch)[::-1]
    if ch == 3:
        img = img[:, :, ::-1]
    img = img * np.float32(1.0 / abs(scale))
    if flags != IMREAD_UNCHANGED:
        img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(img[:, :, 0] if ch == 1 else img)


# ---------------------------------------------------------------------------
# Sun raster
# ---------------------------------------------------------------------------


def decode_sun(data: bytes, flags: int = IMREAD_COLOR) -> np.ndarray:
    """Sun raster bytes -> the array ``cv2.imdecode(data, flags)`` gives (see the module)."""
    _check_flags(flags)
    if len(data) < 32:
        raise ValueError("truncated Sun raster header")
    _, w, h, bpp, _, kind, maptype, maplength = struct.unpack_from(">8I", data)
    if kind not in (0, 1):
        name = {2: "RT_BYTE_ENCODED", 3: "RT_FORMAT_RGB"}.get(kind, f"type {kind}")
        raise ValueError(f"Sun raster {name} is not supported: OpenCV does not read it either")
    pal_size = (1 << bpp) * 3 if 0 < bpp <= 8 else 0
    if not (0 < w < 1 << 31 and 0 < h < 1 << 31 and bpp in (1, 8, 24, 32) and (
            (maptype == 0 and maplength == 0)
            or (maptype == 1 and 0 < maplength <= pal_size and bpp <= 8))):
        raise ValueError(f"Sun raster of {bpp} bits, colour map type {maptype} of "
                         f"{maplength} bytes is not supported")
    palette = np.zeros((256, 3), np.uint8)
    if maplength:
        if 32 + maplength > len(data):
            raise ValueError("truncated Sun raster colour map")
        n = maplength // 3
        cmap = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n)  # R, G, B planes
        palette[:n] = cmap[::-1].T
        used = palette[:1 << bpp]
        channels = 3 if ((used[:, 0] != used[:, 1]) | (used[:, 0] != used[:, 2])).any() else 1
        grey_palette = grey(palette)
    else:
        channels = 3 if bpp > 8 else 1
        if bpp <= 8:  # OpenCV's FillGrayPalette; its grey reads see zeros
            palette[:1 << bpp] = (np.arange(1 << bpp) * (255 // ((1 << bpp) - 1)))[:, None]
        grey_palette = np.zeros(256, np.uint8)
    pitch = ((w * bpp + 7) // 8 + 1) & -2
    rows = _rows(data, 32 + maplength, h, pitch, "Sun raster")
    colour = flags == IMREAD_COLOR or (flags == IMREAD_UNCHANGED and channels == 3)
    if bpp <= 8:
        idx = _bits(rows, bpp, w)
        return palette[idx] if colour else grey_palette[idx]
    k = bpp // 8
    bgr = rows[:, :w * k].reshape(h, w, k)[:, :, k - 3:]  # 32 bits: X, B, G, R
    return np.ascontiguousarray(bgr) if colour else grey(bgr)


# ---------------------------------------------------------------------------
# Radiance HDR
# ---------------------------------------------------------------------------


def decode_hdr(data: bytes, flags: int = IMREAD_COLOR) -> np.ndarray:
    """Radiance HDR bytes -> the array ``cv2.imdecode(data, flags)`` gives (see the module)."""
    _check_flags(flags)
    pos, lines = 0, []

    def line():  # rgbe.c's fgets into 128 bytes
        nonlocal pos
        if pos >= len(data):
            raise ValueError("truncated Radiance HDR header")
        nl = data.find(b"\n", pos, pos + 127)
        end = nl + 1 if nl >= 0 else min(pos + 127, len(data))
        text, pos = data[pos:end], end
        return text

    text = line()
    while True:
        if text[:1] in (b"", b"\n"):
            raise ValueError("Radiance HDR header without FORMAT=32-bit_rle_rgbe")
        if text == b"FORMAT=32-bit_rle_rgbe\n":
            break
        lines.append(text)
        text = line()
    if line() != b"\n":
        raise ValueError("Radiance HDR: no blank line after the FORMAT line")
    m = re.match(rb"-Y\s*(-?\d+)\s+\+X\s*(-?\d+)", line())
    if m is None:
        raise ValueError("Radiance HDR: the size line is not '-Y height +X width'")
    h, w = int(m.group(1)), int(m.group(2))
    if h <= 0 or w <= 0:
        raise ValueError(f"Radiance HDR of {w}x{h} pixels")
    rgbe = np.empty((h, w, 4), np.uint8)
    fault = _lib().hdr_rle(np.frombuffer(data, np.uint8).ctypes.data, len(data), pos, w, h,
                           rgbe.ctypes.data)
    if fault:
        raise ValueError(f"Radiance HDR pixel data: {_RLE_FAULT[fault]}")
    e = rgbe[:, :, 3:].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)
    img = (rgbe[:, :, 2::-1] * scale).astype(np.float32)  # R, G, B -> B, G, R
    if flags == IMREAD_UNCHANGED:
        return img
    bgr = np.clip(np.rint(img * np.float32(255)), 0, 255).astype(np.uint8)
    return grey(bgr) if flags == IMREAD_GRAYSCALE else bgr
