"""GIF, read as ``cv2.imdecode`` (OpenCV 5.0's own GIF reader,
``grfmt_gif.cpp``, not giflib) reads it, every value equal.

GIF87a and GIF89a files: the first image on the logical screen, its LZW
data decoded by ``csrc/gif.c``.  The screen starts as the global colour
table's background colour (black without a global table) with alpha 0;
the image's pixels take its colours, alpha 255, except the transparent
index of the last Graphic Control Extension before it, which leaves the
screen as it was.  A local colour table is read over the global one's
first entries (an index past the local table and inside the global one
takes the global colour), and a drawn index past both tables gives None.
Interlaced images put their rows back in order (every 8th from 0, every
8th from 4, every 4th from 2, every 2nd from 1).

``IMREAD_COLOR`` gives the screen as BGR, ``IMREAD_GRAYSCALE`` that through
``cvtColor``'s BGR -> GRAY, ``IMREAD_UNCHANGED`` BGRA when the last Graphic
Control Extension anywhere in the file sets the transparency flag, else
BGR, as cv2 picks its type from its walk over the whole file.

cv2 gives None, and so does the port, for: a signature other than
GIF87a/GIF89a, a screen or image of no pixels, a background index past the
global table, a block of unknown kind or a file that ends before the
trailer (the walk), a Graphic Control Extension of another length than 4
or with a disposal method past 3 before the first image, an image past
the screen, an LZW minimum code size outside 2-11, LZW data that ends
early, holds a bad code or a string that runs past the image, or a data
byte after a code read once the image is full, and a drawn colour index
past the tables.  An image without any colour table, and LZW codes after
an end code before the image is full (cv2 reads them from a table it has
freed), leave cv2's output undefined: they raise ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

from unopticalflow_tpu_torch.utils.imageio import (IMREAD_COLOR, IMREAD_GRAYSCALE,
                                                   IMREAD_UNCHANGED, _check_flags, _cvt_grey)

SIGNATURES = (b"GIF87a", b"GIF89a")
_TRAILER, _IMAGE, _EXTENSION, _GCE, _APPLICATION = 0x3B, 0x2C, 0x21, 0xF9, 0xFF
_AFTER_END = 5  # csrc/gif.c's GIF_AFTER_END


def _lib():
    """``csrc/gif.c``, built with the host's C compiler at first use."""
    import ctypes

    from unopticalflow_tpu_torch.ops import _build

    i64, p = ctypes.c_int64, _build.P
    return _build.load("gif", {"gif_lzw": [p, i64, p, _build.I, p, i64]})


def _skip_blocks(data: bytes, pos: int):
    """The position after a chain of sub-blocks (its zero length
    included), or None when the file ends first."""
    while pos < len(data):
        n = data[pos]
        pos += 1 + n
        if n == 0:
            return pos if pos <= len(data) else None
    return None


def _walk(data: bytes, pos: int):
    """cv2's walk over the blocks after the header: whether the last
    Graphic Control Extension's sub-block of 4 bytes sets the transparency
    flag, or None where the walk fails (an unknown block, the end of the
    file before the trailer, no image)."""
    alpha, images = False, 0
    while pos < len(data):
        kind = data[pos]
        if kind == _TRAILER:
            return alpha if images else None
        if kind == _IMAGE:
            if pos + 10 > len(data):
                return None
            flags = data[pos + 9]
            pos += 10 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0) + 1  # min code size
            images += 1
        elif kind == _EXTENSION:
            if pos + 2 > len(data):
                return None
            label, pos = data[pos + 1], pos + 2
            if label == _APPLICATION:
                pos = _skip_application(data, pos)
                continue
            if label == _GCE:
                start = pos
                while pos < len(data) and data[pos]:
                    if data[pos] == 4 and pos + 1 < len(data):
                        alpha = bool(data[pos + 1] & 1)
                    pos += 1 + data[pos]
                pos = start
        else:
            return None
        pos = _skip_blocks(data, pos)
        if pos is None:
            return None
    return None


def _skip_application(data: bytes, pos: int) -> int:
    """The position after an Application Extension's sub-blocks as cv2's
    walk reads them: a sub-block of 3 bytes after an application name other
    than NETSCAPE2.0 is stepped over by 2 bytes only, so the walk reads on
    from its last byte."""
    netscape = False
    while pos < len(data) and data[pos]:
        n = data[pos]
        if n == 11:
            netscape = data[pos + 1:pos + 12] == b"NETSCAPE2.0"
        pos += 1 + (n if n != 3 or netscape else 2)
    return pos + 1


def decode_gif(data: bytes, flags: int = IMREAD_COLOR):
    """GIF bytes -> the array ``cv2.imdecode(data, flags)`` gives, or None
    where it gives None (see the module)."""
    _check_flags(flags)
    if data[:6] not in SIGNATURES:
        raise ValueError("not a GIF file")
    if len(data) < 13:
        return None
    width, height, packed, bg = struct.unpack("<HHBB", data[6:12])
    pos, gct = 13, np.zeros((0, 3), np.uint8)
    if packed & 0x80:
        n = 2 << (packed & 7)
        if pos + 3 * n > len(data) or bg >= n:
            return None
        gct = np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3)
        pos += 3 * n
    if width == 0 or height == 0:
        return None
    alpha_out = _walk(data, pos)
    if alpha_out is None:
        return None
    # the first image, and the extensions before it
    transparent = None
    while data[pos] == _EXTENSION:
        label, pos = data[pos + 1], pos + 2
        if label == _GCE:
            if data[pos] != 4 or (data[pos + 1] >> 2) & 7 > 3:
                return None  # another length, or a disposal method past 3
            transparent = data[pos + 4] if data[pos + 1] & 1 else None
        pos = _skip_blocks(data, pos)
    x0, y0, w, h, iflags = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
    pos += 10
    if w == 0 or h == 0 or x0 + w > width or y0 + h > height:
        return None
    table = np.zeros((256, 3), np.uint8)
    table[:len(gct)] = gct
    size = len(gct)
    if iflags & 0x80:
        n = 2 << (iflags & 7)
        table[:n] = np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3)
        size = max(size, n)
        pos += 3 * n
    if size == 0:
        raise ValueError("GIF: an image without a colour table, whose colours cv2 leaves "
                         "undefined")
    min_code = data[pos]
    if not 2 <= min_code <= 11:
        return None
    idx = _lzw(data, pos + 1, min_code, w * h)
    if idx is None:
        return None
    idx = idx.reshape(h, w)
    if iflags & 0x40:  # interlaced: the rows of the four passes, in order
        rows = np.concatenate([np.arange(start, h, step)
                               for start, step in ((0, 8), (4, 8), (2, 4), (1, 2))])
        idx = idx[np.argsort(rows, kind="stable")]
    lut = np.ascontiguousarray(table[:, ::-1])  # BGR
    bgr = np.empty((height, width, 3), np.uint8)
    bgr[:] = gct[bg][::-1] if len(gct) else 0
    alpha = np.zeros((height, width), np.uint8)
    if transparent is None:
        if size < 256 and idx.max() >= size:
            return None  # a colour index past the tables
        bgr[y0:y0 + h, x0:x0 + w] = lut[idx]
        alpha[y0:y0 + h, x0:x0 + w] = 255
    else:
        drawn = idx != transparent
        if (idx[drawn] >= size).any():
            return None
        bgr[y0:y0 + h, x0:x0 + w][drawn] = lut[idx[drawn]]
        alpha[y0:y0 + h, x0:x0 + w][drawn] = 255
    if flags == IMREAD_UNCHANGED and alpha_out:
        return np.dstack([bgr, alpha])
    return _cvt_grey(bgr) if flags == IMREAD_GRAYSCALE else bgr


def _lzw(data: bytes, pos: int, min_code: int, npix: int):
    """The colour indices of an image's LZW sub-blocks, or None where cv2's
    decoder fails (``csrc/gif.c``)."""
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(npix, np.uint8)
    at = np.array([pos], np.int64)
    err = _lib().gif_lzw(buf.ctypes.data, buf.size, at.ctypes.data, min_code, out.ctypes.data,
                         npix)
    if err == _AFTER_END:
        raise ValueError("GIF: LZW codes after an end code before the image is full, which cv2 "
                         "decodes from a table it has freed (its output is undefined)")
    return None if err else out
