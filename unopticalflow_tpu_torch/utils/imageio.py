"""Image reading, writing and resizing for the port's entry points.

The port reads frames, request bodies and KITTI ground truth with its own
codecs, each written to give what cv2 gives (and PIL, for the JPEG it
writes), so the entry points read and write the same data on every
machine, with or without opencv: PNG (``zlib``, numpy, and the row
unfiltering of ``csrc/imageio.c``), JPEG (the decoder of ``csrc/jpeg.c``
and the encoder of ``csrc/jpeg_enc.c``), and BMP, PNM/PAM/PFM, Sun raster
and Radiance HDR (``utils/rasters.py``), TIFF (``utils/tiff.py``) and WebP
(``utils/webp.py``, its codecs in ``csrc/webp.c``).  It
resizes with its own copy of OpenCV's ``INTER_LINEAR`` (uint8: the taps in
numpy, the sums in ``csrc/imageio.c``; float32: numpy).  Nothing here
imports cv2 or PIL.

* ``imdecode(data, flags)`` and ``imread(path, flags)`` as cv2's: the
  format from the first bytes, as cv2 tells them apart.  A JPEG 2000 or
  AVIF body raises ``ValueError`` naming the format as one the port does
  not read yet; bytes of no format the port knows give None (and
  ``imread`` raises, naming the formats it reads).
* ``decode_png(data, flags)`` as ``cv2.imdecode``: ``IMREAD_COLOR`` gives BGR
  uint8 (H, W, 3) (16-bit samples keep their high byte, alpha is dropped,
  grey is repeated); ``IMREAD_UNCHANGED`` (-1) the file's own channels in
  BGR(A) order, uint8 or uint16, grey as (H, W), a palette expanded to BGR
  (BGRA with a ``tRNS`` chunk); ``IMREAD_GRAYSCALE`` (0) (H, W) uint8, a
  colour or palette file converted as libpng converts it for cv2 (alpha
  dropped, (9797 R + 19234 G + 3737 B) >> 15, on 16-bit samples rounded
  before the high byte is kept).  Colour types 0, 2, 3, 4 and 6 at 8 bits
  and 0 and 2 at 16 bits; all five row filters; plain and interlaced
  (Adam7) files.  A grey read of a colour file with a ``gAMA``, ``cHRM``,
  ``sRGB`` or ``iCCP`` chunk, where libpng's conversion goes through gamma
  tables, raises.
* ``decode_jpeg(data, flags)`` as ``cv2.imdecode`` with libjpeg-turbo, bit
  for bit: sequential and progressive (Huffman, 8-bit) grey, YCbCr or CMYK
  (Adobe's inverted CMYK, as PIL writes it) files of any size and
  sampling, with restart intervals, and a progressive file cut short of
  its last scans through libjpeg's block smoothing.  ``IMREAD_COLOR`` gives
  BGR (a grey file repeated), ``IMREAD_GRAYSCALE`` libjpeg's Y plane (a
  CMYK file's BGR weighted), ``IMREAD_UNCHANGED`` the file's own channels
  (BGR for CMYK); the first two apply an Exif ``Orientation`` tag, as cv2
  does.  Lossless, hierarchical, arithmetic-coded, 12-bit, YCCK, RGB-coded
  and truncated files raise ``ValueError``, naming the mode or the fault.
* ``encode_png(img)`` as ``cv2.imencode(".png")`` writes it, each row's
  filter chosen as libpng chooses it: (H, W) grey or (H, W, 3) BGR /
  (H, W, 4) BGRA, uint8 or uint16.
* ``encode_jpeg(img, quality)`` as ``cv2.imencode(".jpg")`` writes a BGR
  image, byte for byte (at quality 75 also PIL's default ``save(f,
  "JPEG")`` of the RGB image).
* ``read_ppm(path)``: a binary (P6, 8-bit) PPM as RGB (NYUv2's raw frames).
* ``resize(img, (w, h))`` as ``cv2.resize(img, (w, h))``.  On uint8:
  weights with 11 fractional bits from single-precision source positions
  (borders clamped), an integer horizontal pass, then the vertical pass as
  cv2's vector code rounds it: ((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16),
  plus 2, shifted right by 2.  On float32: as cv2's Intel IPP path computes
  it, to within 2 float32 ulps (see ``_resize_f32``).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

IMREAD_UNCHANGED = -1
IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_JPEG_MAGIC = b"\xff\xd8"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples per pixel
# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
# chunks that make libpng convert colour to grey through gamma tables
_COLOUR_MANAGED = (b"gAMA", b"cHRM", b"sRGB", b"iCCP")
_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS


# ---------------------------------------------------------------------------
# the functions the port calls
# ---------------------------------------------------------------------------


def imread(path: str, flags: int = IMREAD_COLOR):
    """The image in a file of a format ``imdecode`` reads, or None when the
    file is missing.

    The format is read from the file's first bytes; another format raises,
    saying so.
    """
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    img = imdecode(data, flags)
    if img is None:
        raise ValueError(f"{path}: " + ("cv2 reads no image from it" if _decoder(data) else
                                        f"not an image format the port reads ({READS})"))
    if flags == IMREAD_GRAYSCALE and img.ndim == 3:
        # cv2.imread refuses the colour image cv2.imdecode hands back (a PFM's)
        raise ValueError(f"{path}: an IMREAD_GRAYSCALE read of a colour PFM, which cv2.imread "
                         "refuses")
    return img


READS = "PNG, JPEG, BMP, PNM/PAM/PFM, Sun raster, Radiance HDR, TIFF, WebP"
# formats cv2 reads that the port does not read yet: (name, test of the first bytes)
_NOT_YET = (
    ("JPEG 2000", lambda d: d.startswith((b"\x00\x00\x00\x0cjP  \r\n\x87\n",  # JP2 box
                                          b"\xff\x4f\xff\x51"))),  # a J2K codestream
    ("AVIF", lambda d: d[4:8] == b"ftyp" and d[8:12] in (b"avif", b"avis")),
)


def _decoder(data: bytes):
    """The decoder of the format ``data`` opens with (as cv2 tells formats
    apart), or None."""
    from unopticalflow_tpu_torch.utils import rasters, tiff, webp

    if data.startswith(_PNG_MAGIC):
        return decode_png
    if data.startswith(_JPEG_MAGIC):
        return decode_jpeg
    if data.startswith(b"BM"):
        return rasters.decode_bmp
    if data[:1] == b"P" and data[2:3].isspace():  # P1-P6, P7, Pf, PF
        kind = data[1:2]
        if b"1" <= kind <= b"6":
            return rasters.decode_pnm
        if kind == b"7":
            return rasters.decode_pam
        if kind in (b"f", b"F"):
            return rasters.decode_pfm
    if data.startswith(b"\x59\xa6\x6a\x95"):
        return rasters.decode_sun
    if data.startswith((b"#?RADIANCE", b"#?RGBE")):
        return rasters.decode_hdr
    if data[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):
        return tiff.decode_tiff
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP" or webp.is_bitstream(data):
        return webp.decode_webp
    return None


def imdecode(data: bytes, flags: int = IMREAD_COLOR):
    """The image in a request body: None when its first bytes name no
    format the port knows, or where ``cv2.imdecode`` gives None for a format
    it reads (uncompressed TIFF tiles that libtiff refuses, ``utils/tiff.py``).

    A body of a format the port reads but cannot decode (truncated,
    corrupt, a mode it does not support), and a JPEG 2000 or AVIF body,
    raise ``ValueError`` saying why.
    """
    decode = _decoder(data)
    if decode is not None:
        img = decode(data, flags)  # None where cv2 gives None (a TIFF's refused tile)
        # a reader may hand back a view of the body's bytes: the caller owns a copy
        return img if img is None or img.flags.writeable else img.copy()
    for name, test in _NOT_YET:
        if test(data):
            raise ValueError(f"{name} is not a format the port reads yet ({READS})")
    return None


def _check_flags(flags: int) -> None:
    if flags not in (IMREAD_COLOR, IMREAD_UNCHANGED, IMREAD_GRAYSCALE):
        raise ValueError(f"imread flags {flags}: the port reads IMREAD_COLOR, "
                         "IMREAD_GRAYSCALE or IMREAD_UNCHANGED")


def imwrite(path: str, img: np.ndarray) -> None:
    """``cv2.imwrite`` of a PNG: (H, W) grey, or BGR(A), uint8 or uint16."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: the port writes PNG only")
    with open(path, "wb") as f:
        f.write(encode_png(img))


def saturate_u8(img: np.ndarray) -> np.ndarray:
    """A float array as ``cv2.imwrite`` stores it in an 8-bit PNG: each value
    rounded half to even and saturated to 0..255 (NaN to 0)."""
    a = np.rint(np.nan_to_num(np.asarray(img, np.float64), nan=0.0))
    return np.clip(a, 0, 255).astype(np.uint8)


def read_ppm(path: str) -> np.ndarray:
    """A binary PPM (P6, maxval 255: NYUv2's raw Kinect frames) -> (H, W, 3)
    uint8 in the file's RGB order, as ``imageio.v2.imread`` gives it.  A
    truncated or other file raises ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:  # magic, width, height, maxval; '#' comments between
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.find(b"\n", pos) + 1 or len(data)
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        if end == pos:
            raise ValueError(f"{path}: truncated PPM header")
        fields.append(data[pos:end])
        pos = end
    if fields[0] != b"P6" or not all(f.isdigit() for f in fields[1:]):
        raise ValueError(f"{path}: not a binary PPM (P6)")
    w, h, maxval = (int(f) for f in fields[1:])
    if maxval != 255:
        raise ValueError(f"{path}: PPM maxval {maxval}; the port reads 8-bit PPM only")
    pos += 1  # the single whitespace byte after maxval
    if len(data) - pos < w * h * 3:
        raise ValueError(f"{path}: truncated PPM ({len(data) - pos} of {w * h * 3} bytes)")
    return np.frombuffer(data, np.uint8, w * h * 3, pos).reshape(h, w, 3).copy()


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _chunks(data: bytes):
    if not data.startswith(_PNG_MAGIC):
        raise ValueError("not a PNG file")
    pos = len(_PNG_MAGIC)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        yield kind, data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("truncated PNG file (no IEND chunk)")


def _paeth(a, b, c):
    """The Paeth predictor of int16 arrays: whichever of a, b, c is nearest a + b - c."""
    da, db = a - c, b - c
    pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _lib():
    """``csrc/imageio.c``, built with the host's C compiler at first use."""
    import ctypes

    from unopticalflow_tpu_torch.ops import _build

    i64, p = ctypes.c_int64, _build.P
    return _build.load("imageio", {
        "png_unfilter": [p, p, i64, i64, _build.I],
        "resize_linear_u8": [p, i64, _build.I, p, i64, i64] + [p] * 8,
    })


def _unfilter(raw: np.ndarray, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: (h, 1 + row_bytes) bytes -> (h, row_bytes) uint8.

    In C: each pixel of a Sub, Average or Paeth row needs its left
    neighbour's result, a chain numpy can only take a step at a time.
    """
    lib = _lib()
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty((h, row_bytes), np.uint8)
    bad = lib.png_unfilter(raw.ctypes.data, out.ctypes.data, h, row_bytes, bpp)
    if bad < 0:
        raise MemoryError("png_unfilter: out of memory")
    if bad:
        raise ValueError(f"PNG row filter {int(raw[bad - 1, 0])} does not exist")
    return out


def decode_png(data: bytes, flags: int = IMREAD_COLOR) -> np.ndarray:
    """PNG bytes -> the array ``cv2.imdecode(data, flags)`` gives (see the module)."""
    _check_flags(flags)
    head, palette, trns, idat, managed = None, None, None, [], []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind in _COLOUR_MANAGED:
            managed.append(kind.decode())
    if head is None:
        raise ValueError("PNG file without IHDR")
    w, h, depth, ctype, _, _, interlace = head
    if interlace > 1:
        raise ValueError(f"PNG interlace method {interlace} does not exist")
    if ctype not in _CHANNELS or depth not in (8, 16) or (depth == 16 and ctype not in (0, 2)):
        raise ValueError(f"PNG colour type {ctype} at {depth} bits is not supported")
    if flags == IMREAD_GRAYSCALE and ctype in (2, 3, 6) and managed:
        raise ValueError(f"IMREAD_GRAYSCALE of a colour PNG with a {managed[0]} chunk is not "
                         "supported: libpng converts it through gamma tables")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _deinterlace(raw, w, h, bpp) if interlace else _passes(raw, w, h, bpp)
    if depth == 16:
        img = px.view(">u2").astype(np.uint16).reshape(h, w, ch)
    else:
        img = px.reshape(h, w, ch)

    if ctype == 3:  # palette: expand, with alpha where tRNS gives it
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        idx = img[:, :, 0]
        rgb = palette[idx]
        if flags == IMREAD_GRAYSCALE:
            return _grey(rgb, 8)
        if trns is not None and flags == IMREAD_UNCHANGED:
            alpha = np.full(len(palette), 255, np.uint8)
            alpha[: len(trns)] = np.frombuffer(trns, np.uint8)[: len(palette)]
            return _channels(np.dstack([rgb, alpha[idx]]), [2, 1, 0, 3])
        return _channels(rgb, [2, 1, 0])
    if flags == IMREAD_GRAYSCALE and ch >= 3:
        return _grey(img, depth)
    if flags != IMREAD_UNCHANGED and depth == 16:
        img = (img >> 8).astype(np.uint8)
    if flags == IMREAD_GRAYSCALE:
        return np.ascontiguousarray(img[:, :, 0])
    if flags == IMREAD_COLOR:
        return _channels(img, [0, 0, 0] if ch <= 2 else [2, 1, 0])  # grey repeated
    if ch == 1:
        return np.ascontiguousarray(img[:, :, 0])
    return _channels(img, {2: [0, 0, 0, 1], 3: [2, 1, 0], 4: [2, 1, 0, 3]}[ch])


def _passes(raw: np.ndarray, w: int, h: int, bpp: int) -> np.ndarray:
    """A plain PNG's inflated data -> its (h, w * bpp) unfiltered bytes."""
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected {h * (1 + w * bpp)}")
    return _unfilter(raw.reshape(h, 1 + w * bpp), h, w * bpp, bpp)


def _deinterlace(raw: np.ndarray, w: int, h: int, bpp: int) -> np.ndarray:
    """An Adam7 PNG's inflated data -> its (h, w * bpp) unfiltered bytes.

    Each of the seven passes is a small image of its own, filtered over its
    own rows (the first row's "previous row" is zeros); a pass with no
    column or no row has no bytes, not even filter bytes."""
    out = np.empty((h, w, bpp), np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
        if pw == 0 or ph == 0:
            continue
        n = ph * (1 + pw * bpp)
        if pos + n > raw.size:
            raise ValueError(f"interlaced PNG data holds {raw.size} bytes, fewer than its "
                             "passes need")
        rows = _unfilter(raw[pos:pos + n].reshape(ph, 1 + pw * bpp), ph, pw * bpp, bpp)
        out[y0::dy, x0::dx] = rows.reshape(ph, pw, bpp)
        pos += n
    if pos != raw.size:
        raise ValueError(f"interlaced PNG data holds {raw.size} bytes, expected {pos}")
    return out.reshape(h, w * bpp)


def _grey(rgb: np.ndarray, depth: int) -> np.ndarray:
    """(H, W, >=3) RGB(A) samples -> (H, W) uint8 as libpng's
    ``png_set_rgb_to_gray(0.299, 0.587)`` and ``png_set_strip_16`` give
    them to cv2: weights of 15 bits (9797, 19234, 32768 less both), alpha
    ignored, an 8-bit sum truncated, a 16-bit one rounded and then cut to
    its high byte."""
    r, g, b = (rgb[:, :, k].astype(np.uint32) for k in range(3))
    y = 9797 * r + 19234 * g + 3737 * b
    if depth == 16:
        return ((y + 16384) >> 23).astype(np.uint8)
    return (y >> 15).astype(np.uint8)


def _channels(img: np.ndarray, order) -> np.ndarray:
    """``img[:, :, order]`` as a new array, copied a channel at a time: numpy
    copies a whole plane in one strided loop, where a copy of all channels
    at once loops over each pixel's few bytes."""
    out = np.empty(img.shape[:2] + (len(order),), img.dtype)
    for k, c in enumerate(order):
        out[:, :, k] = img[:, :, c]
    return out


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(h, row_bytes) uint8 -> (h, 1 + row_bytes): each row's filter type and bytes.

    Each row's filter is the one libpng (and so ``cv2.imwrite``) picks: the
    least sum of the residuals taken as signed bytes, the first on a tie.
    """
    x = rows.astype(np.int16)
    a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    b[1:] = x[:-1]
    a[:, bpp:], c[:, bpp:] = x[:, :-bpp], b[:, :-bpp]
    res = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - _paeth(a, b, c)]) & 255
    kinds = np.minimum(res, 256 - res).sum(axis=2).argmin(axis=0)
    filtered = res[kinds, np.arange(len(x))]
    return np.concatenate([kinds[:, None], filtered], axis=1).astype(np.uint8)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W) grey, (H, W, 3) BGR or (H, W, 4) BGRA, uint8 or uint16 -> PNG bytes.

    Each row filtered as libpng filters it, so Average and Paeth rows are
    as common as in the files cv2 writes.
    """
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"PNG holds uint8 or uint16 samples, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"PNG needs (H, W), (H, W, 3) or (H, W, 4), got {img.shape}")
    h, w, ch = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    if ch >= 3:
        img = img[:, :, [2, 1, 0, 3][:ch]]  # BGR(A) -> RGB(A)
    depth = 16 if img.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).view(np.uint8)
    raw = _filter_rows(rows.reshape(h, w * ch * depth // 8), ch * depth // 8)
    return (_PNG_MAGIC
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------


def _jpeg_lib():
    """``csrc/jpeg.c``, built with the host's C compiler at first use."""
    import ctypes

    from unopticalflow_tpu_torch.ops import _build

    i64, p = ctypes.c_int64, _build.P
    return _build.load("jpeg", {
        "jpeg_info": [p, i64, p, p, _build.I],
        "jpeg_decode": [p, i64, _build.I, p, p, _build.I],
    })


def _exif_orientation(data: bytes) -> int:
    """The ``Orientation`` tag (1-8) of the first Exif APP1 segment, else 1."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        kind, n = data[pos + 1], int.from_bytes(data[pos + 2:pos + 4], "big")
        if kind == 0xDA or kind == 0xD9:  # the image data: no more header segments
            break
        body = data[pos + 4:pos + 2 + n]
        pos += 2 + n
        if kind != 0xE1 or not body.startswith(b"Exif\0\0"):
            continue
        tiff = body[6:]
        order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
        if order is None or len(tiff) < 8:
            return 1
        ifd = struct.unpack(order + "I", tiff[4:8])[0]
        if ifd + 2 > len(tiff):
            return 1
        count = struct.unpack(order + "H", tiff[ifd:ifd + 2])[0]
        for k in range(count):
            e = ifd + 2 + 12 * k
            if e + 12 > len(tiff):
                break
            tag, kind_, _ = struct.unpack(order + "HHI", tiff[e:e + 8])
            if tag == 0x0112 and kind_ == 3:  # Orientation, SHORT
                return struct.unpack(order + "H", tiff[e + 8:e + 10])[0]
        return 1
    return 1


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's ``ApplyExifOrientation``: the flips and transposes of tags 2-8."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for axis in flip:
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def decode_jpeg(data: bytes, flags: int = IMREAD_COLOR) -> np.ndarray:
    """JPEG bytes -> the array ``cv2.imdecode(data, flags)`` gives (see the module)."""
    import ctypes

    _check_flags(flags)
    lib = _jpeg_lib()
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(3, np.int64)
    err = ctypes.create_string_buffer(256)
    if lib.jpeg_info(buf.ctypes.data, buf.size, info.ctypes.data, err, len(err)):
        raise ValueError(err.value.decode())
    w, h, ncomp = (int(v) for v in info)
    grey = flags == IMREAD_GRAYSCALE or (flags == IMREAD_UNCHANGED and ncomp == 1)
    out = np.empty((h, w) if grey else (h, w, 3), np.uint8)
    if lib.jpeg_decode(buf.ctypes.data, buf.size, int(grey), out.ctypes.data, err, len(err)):
        raise ValueError(err.value.decode())
    if flags == IMREAD_UNCHANGED:
        return out
    return _orient(out, _exif_orientation(data))


def _jpeg_raw(data: bytes, mode: int) -> np.ndarray:
    """A JPEG stream of a TIFF strip or tile as libjpeg hands it to libtiff:
    mode 0 BGR (YCbCr converted), 1 grey, 2 the stored components (H, W, n)."""
    import ctypes

    lib = _jpeg_lib()
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(3, np.int64)
    err = ctypes.create_string_buffer(256)
    if lib.jpeg_info(buf.ctypes.data, buf.size, info.ctypes.data, err, len(err)):
        raise ValueError(f"TIFF JPEG data: {err.value.decode()}")
    w, h, ncomp = (int(v) for v in info)
    out = np.empty((h, w) if mode == 1 else (h, w, 3 if mode == 0 else ncomp), np.uint8)
    if lib.jpeg_decode(buf.ctypes.data, buf.size, mode, out.ctypes.data, err, len(err)):
        raise ValueError(f"TIFF JPEG data: {err.value.decode()}")
    return out


def encode_jpeg(img: np.ndarray, quality: int = 75) -> bytes:
    """(H, W, 3) uint8 BGR -> the baseline JPEG libjpeg writes with its
    defaults, byte for byte: ``cv2.imencode(".jpg", img,
    [IMWRITE_JPEG_QUALITY, quality])``, which at quality 75 is also
    ``Image.fromarray(img[:, :, ::-1]).save(f, "JPEG")`` (4:2:0, standard
    Huffman tables, JFIF 1.01; see ``csrc/jpeg_enc.c``)."""
    import ctypes

    from unopticalflow_tpu_torch.ops import _build

    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    if not (0 < h <= 65535 and 0 < w <= 65535):
        raise ValueError(f"a JPEG of {w}x{h} pixels: each side must be 1 to 65535")
    i64, p = ctypes.c_int64, _build.P
    lib = _build.load("jpeg_enc", {"jpeg_encode": [p, i64, i64, _build.I, p, i64, p]})
    # at most ~420 bytes an 8x8 block (every code 16 bits long, every byte
    # stuffed), 6 blocks a 16x16 MCU
    cap = 1024 + 10 * ((h + 15) // 16) * ((w + 15) // 16) * 256
    out = np.empty(cap, np.uint8)
    size = np.zeros(1, np.int64)
    rc = lib.jpeg_encode(img.ctypes.data, h, w, int(quality), out.ctypes.data, cap,
                         size.ctypes.data)
    if rc < 0:
        raise MemoryError("jpeg_encode: out of memory")
    if rc:
        raise RuntimeError(f"jpeg_encode needed {int(size[0])} bytes of {cap}")
    return out[: int(size[0])].tobytes()


# ---------------------------------------------------------------------------
# cv2's INTER_LINEAR resize of uint8 images: the taps here, the sums in C
# ---------------------------------------------------------------------------


def _linear_taps(src: int, dst: int):
    """cv2's source position of each output index: (index, weight of the next)."""
    scale = 1.0 / (dst / src)  # cv2 keeps the inverse scale and inverts it
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(np.float32)).astype(np.float32)


def _coef(f: np.ndarray):
    """The two weights, rounded to 11 fractional bits from single precision."""
    one = np.float32(1 << _COEF_BITS)
    return (np.rint((np.float32(1) - f) * one).astype(np.int64),
            np.rint(f * one).astype(np.int64))


def _resize_f32(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """float32 (H, W[, C]) -> (dh, dw[, C]) as ``cv2.resize`` with Intel IPP
    (the default where cv2 is built with it): source positions in double
    precision, borders clamped, a horizontal then a vertical pass, each a sum
    of two products in double precision rounded to float32.  IPP's own order
    of operations is not public: on [0, 255] images this lands within 2
    float32 ulps of the image's largest magnitude of what cv2 5.0 gives
    (tests/test_torch_depth.py holds it there)."""
    sh, sw = img.shape[:2]

    def taps(src, dst):
        f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
        s = np.floor(f).astype(np.int64)
        return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), (f - s)

    x0, x1, fx = taps(sw, dw)
    y0, y1, fy = taps(sh, dh)
    src = img.astype(np.float64)
    ex = (slice(None),) + (None,) * (img.ndim - 2)  # weights broadcast over channels
    hx = (src[:, x0] * (1.0 - fx)[ex] + src[:, x1] * fx[ex]).astype(np.float32)
    hx = hx.astype(np.float64)
    ey = (slice(None), None) + (None,) * (img.ndim - 2)
    return (hx[y0] * (1.0 - fy)[ey] + hx[y1] * fy[ey]).astype(np.float32)


def resize(img: np.ndarray, wh) -> np.ndarray:
    """uint8 or float32 (H, W) or (H, W, C) -> (h, w[, C]), as
    ``cv2.resize(img, (w, h))`` (``INTER_LINEAR``; see the module)."""
    dw, dh = int(wh[0]), int(wh[1])
    if img.dtype == np.float32:
        return _resize_f32(img, dw, dh)
    if img.dtype != np.uint8:
        raise TypeError(f"the port resizes uint8 and float32 images, got {img.dtype}")
    sh, sw = img.shape[:2]
    src = np.ascontiguousarray(img).reshape(sh, sw, -1)
    sx, fx = _linear_taps(sw, dw)
    left, right = sx < 0, sx >= sw - 1  # columns clamp to the edge with weight 0
    fx[left | right] = 0
    sx = np.clip(sx, 0, sw - 1)
    sy, fy = _linear_taps(sh, dh)  # rows clamp their index only, keeping the weights
    tables = [np.ascontiguousarray(t, np.int32) for t in (
        sx, np.minimum(sx + 1, sw - 1), *_coef(fx),
        np.clip(sy, 0, sh - 1), np.clip(sy + 1, 0, sh - 1), *_coef(fy))]
    out = np.empty((dh, dw, src.shape[2]), np.uint8)
    _lib().resize_linear_u8(src.ctypes.data, sw, src.shape[2], out.ctypes.data, dh, dw,
                            *(t.ctypes.data for t in tables))
    return out.reshape((dh, dw) + img.shape[2:])
