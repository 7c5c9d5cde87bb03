"""Image reading, writing and resizing for the port's entry points.

The port reads frames, request bodies and KITTI ground truth as PNG or JPEG
with its own codecs (PNG: ``zlib``, numpy, and the row unfiltering of
``csrc/imageio.c``; JPEG: the baseline decoder of ``csrc/jpeg.c``) and
resizes with its own copy of OpenCV's ``INTER_LINEAR`` (uint8: the taps in
numpy, the sums in ``csrc/imageio.c``; float32: numpy), each written to give
what cv2 gives, so the entry points read the same data on every machine,
with or without opencv.  Nothing here imports cv2.

* ``decode_png(data, flags)`` as ``cv2.imdecode``: ``IMREAD_COLOR`` gives BGR
  uint8 (H, W, 3) (16-bit samples keep their high byte, alpha is dropped,
  grey is repeated); ``IMREAD_UNCHANGED`` (-1) the file's own channels in
  BGR(A) order, uint8 or uint16, grey as (H, W), a palette expanded to BGR
  (BGRA with a ``tRNS`` chunk).  Colour types 0, 2, 3, 4 and 6 at 8 bits and
  0 and 2 at 16 bits; all five row filters; interlaced (Adam7) files raise.
  ``IMREAD_GRAYSCALE`` (0) reads grey files only, as (H, W) uint8 (16-bit
  samples keep their high byte): cv2's conversion of a colour file to grey
  is not reproduced, and such a file raises.
* ``decode_jpeg(data, flags)`` as ``cv2.imdecode`` with libjpeg-turbo, bit
  for bit: baseline (sequential, Huffman, 8-bit) grey or YCbCr files of any
  size and sampling, with restart intervals.  ``IMREAD_COLOR`` gives BGR
  (a grey file repeated), ``IMREAD_GRAYSCALE`` libjpeg's Y plane,
  ``IMREAD_UNCHANGED`` the file's own channels; the first two apply an
  Exif ``Orientation`` tag, as cv2 does.  Progressive, lossless,
  arithmetic-coded, 12-bit, CMYK and truncated files raise ``ValueError``,
  naming the mode or the fault.
* ``encode_png(img)`` as ``cv2.imencode(".png")`` writes it, each row's
  filter chosen as libpng chooses it: (H, W) grey or (H, W, 3) BGR /
  (H, W, 4) BGRA, uint8 or uint16.
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
_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS


# ---------------------------------------------------------------------------
# the functions the port calls
# ---------------------------------------------------------------------------


def imread(path: str, flags: int = IMREAD_COLOR):
    """The image in a PNG or JPEG file, or None when the file is missing.

    The format is read from the file's first bytes; another format raises,
    saying so.
    """
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    img = imdecode(data, flags)
    if img is None:
        raise ValueError(f"{path}: neither PNG nor JPEG; the port reads those two")
    return img


def imdecode(data: bytes, flags: int = IMREAD_COLOR):
    """The image in a request body: None when it is neither PNG nor JPEG.

    A PNG or JPEG body that the port cannot decode raises ``ValueError``.
    """
    if data.startswith(_PNG_MAGIC):
        return decode_png(data, flags)
    if data.startswith(_JPEG_MAGIC):
        return decode_jpeg(data, flags)
    return None


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
    if flags not in (IMREAD_COLOR, IMREAD_UNCHANGED, IMREAD_GRAYSCALE):
        raise ValueError(f"imread flags {flags}: the port reads IMREAD_COLOR, "
                         "IMREAD_GRAYSCALE or IMREAD_UNCHANGED")
    head, palette, trns, idat = None, None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if head is None:
        raise ValueError("PNG file without IHDR")
    w, h, depth, ctype, _, _, interlace = head
    if interlace:
        raise ValueError("interlaced (Adam7) PNG files are not supported")
    if ctype not in _CHANNELS or depth not in (8, 16) or (depth == 16 and ctype not in (0, 2)):
        raise ValueError(f"PNG colour type {ctype} at {depth} bits is not supported")
    if flags == IMREAD_GRAYSCALE and ctype != 0:
        raise ValueError(f"IMREAD_GRAYSCALE of a PNG of colour type {ctype}: the port "
                         "reads grey files only in grey")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected {h * (1 + w * bpp)}")
    px = _unfilter(raw.reshape(h, 1 + w * bpp), h, w * bpp, bpp)
    if depth == 16:
        img = px.view(">u2").astype(np.uint16).reshape(h, w, ch)
    else:
        img = px.reshape(h, w, ch)

    if ctype == 3:  # palette: expand, with alpha where tRNS gives it
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        idx = img[:, :, 0]
        rgb = palette[idx]
        if trns is not None and flags == IMREAD_UNCHANGED:
            alpha = np.full(len(palette), 255, np.uint8)
            alpha[: len(trns)] = np.frombuffer(trns, np.uint8)[: len(palette)]
            return _channels(np.dstack([rgb, alpha[idx]]), [2, 1, 0, 3])
        return _channels(rgb, [2, 1, 0])
    if flags != IMREAD_UNCHANGED and depth == 16:
        img = (img >> 8).astype(np.uint8)
    if flags == IMREAD_GRAYSCALE:
        return np.ascontiguousarray(img[:, :, 0])
    if flags == IMREAD_COLOR:
        return _channels(img, [0, 0, 0] if ch <= 2 else [2, 1, 0])  # grey repeated
    if ch == 1:
        return np.ascontiguousarray(img[:, :, 0])
    return _channels(img, {2: [0, 0, 0, 1], 3: [2, 1, 0], 4: [2, 1, 0, 3]}[ch])


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

    if flags not in (IMREAD_COLOR, IMREAD_UNCHANGED, IMREAD_GRAYSCALE):
        raise ValueError(f"imread flags {flags}: the port reads IMREAD_COLOR, "
                         "IMREAD_GRAYSCALE or IMREAD_UNCHANGED")
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
