"""Image reading, writing and resizing for the port's entry points.

The port reads frames, request bodies and KITTI ground truth with its own
codecs, each written to give what cv2 gives (and PIL, for the JPEG it
writes), so the entry points read and write the same data on every
machine, with or without opencv: PNG and APNG (``zlib``, numpy, and the row
unfiltering of ``csrc/imageio.c``), JPEG (the decoder of ``csrc/jpeg.c``
and the encoder of ``csrc/jpeg_enc.c``), and BMP, PNM/PAM/PFM, Sun raster
and Radiance HDR (``utils/rasters.py``), TIFF (``utils/tiff.py``), WebP
(``utils/webp.py``, its codecs in ``csrc/webp.c``), JPEG 2000
(``utils/jpeg2000.py``, its codestream decoder in ``csrc/jpeg2000.c``) and
GIF (``utils/gif.py``, its LZW in ``csrc/gif.c``).  It resizes with its own
copy of OpenCV's ``INTER_LINEAR`` (uint8: the taps in numpy, the sums in
``csrc/imageio.c``; float32: numpy).  Nothing here imports cv2 or PIL.

* ``imdecode(data, flags)`` and ``imread(path, flags)`` as cv2's: the
  format from the first bytes, as cv2 tells them apart.  An AVIF body
  raises ``ValueError`` naming the format as one the port does not read
  yet; bytes of no format the port knows give None (and ``imread`` raises,
  naming the formats it reads).
* ``decode_png(data, flags)`` as ``cv2.imdecode`` (libpng 1.6):
  ``IMREAD_COLOR`` gives BGR uint8 (H, W, 3) (16-bit samples keep their high
  byte, alpha is dropped, grey is repeated); ``IMREAD_UNCHANGED`` (-1) the
  file's own channels in BGR(A) order, uint8 or uint16, grey as (H, W),
  grey and alpha as BGRA, a palette expanded to BGR, and BGRA for a palette
  or RGB file with a ``tRNS`` chunk (alpha 0 where an RGB sample equals its
  key); ``IMREAD_GRAYSCALE`` (0) (H, W) uint8, a colour or palette file
  converted as libpng converts it for cv2 (alpha dropped, (9797 R + 19234 G
  + 3737 B) >> 15, on 16-bit samples rounded before the high byte is kept).
  Every colour type at every depth libpng reads: grey at 1, 2, 4, 8 and 16
  bits (1, 2 and 4 scaled to 8 bits: 255, 85 and 17 a step), RGB, grey and
  alpha and RGBA at 8 and 16, palettes at 1, 2, 4 and 8 (an index past the
  palette is black); all five row filters; plain and interlaced (Adam7)
  files.  A grey read of a colour file whose gamma (``gAMA``, or sRGB's for
  an ``sRGB`` chunk) is not within 5% of 1.0 goes through libpng's gamma
  tables in linear light, as libpng converts it for cv2 (``_grey_gamma``);
  ``cHRM`` and ``iCCP`` leave it plain, except an ``iCCP`` profile as long
  as one libpng knows as sRGB by its checksum, which raises.  The first
  ``eXIf`` chunk's Orientation (before or after IDAT) turns the
  ``IMREAD_COLOR`` and ``IMREAD_GRAYSCALE`` reads, as for JPEG.  An
  ancillary chunk that fails its CRC is dropped, as libpng drops it; a
  critical one, an unknown critical chunk, and a colour type and depth
  libpng refuses (RGB at 4 bits, say) raise, where cv2 gives None.  An APNG
  (an ``acTL`` of more than one frame) gives the animation's first frame as
  cv2 5.0's own frame code gives it (``_apng``), None where cv2 gives None.
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

import functools
import math
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
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}  # libpng's
# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
# the lengths of the ICC sRGB profiles libpng recognises by their checksums
# (it then reads the file as sRGB, with sRGB's gamma)
_LIBPNG_SRGB_PROFILE_LENGTHS = (3024, 3048, 3052, 3144, 60960, 60988)
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


READS = "PNG, JPEG, BMP, PNM/PAM/PFM, Sun raster, Radiance HDR, TIFF, WebP, JPEG 2000, GIF"
# formats cv2 reads that the port does not read yet: (name, test of the first bytes)
_NOT_YET = (
    ("AVIF", lambda d: d[4:8] == b"ftyp" and d[8:12] in (b"avif", b"avis")),
)


def _decoder(data: bytes):
    """The decoder of the format ``data`` opens with (as cv2 tells formats
    apart), or None."""
    from unopticalflow_tpu_torch.utils import gif, jpeg2000, rasters, tiff, webp

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
    if jpeg2000.is_jpeg2000(data):
        return jpeg2000.decode_jpeg2000
    if data[:6] in gif.SIGNATURES:
        return gif.decode_gif
    return None


def imdecode(data: bytes, flags: int = IMREAD_COLOR):
    """The image in a request body: None when its first bytes name no
    format the port knows, or where ``cv2.imdecode`` gives None for a format
    it reads (uncompressed TIFF tiles that libtiff refuses, ``utils/tiff.py``).

    A body of a format the port reads but cannot decode (truncated,
    corrupt, a mode it does not support), and an AVIF body, raise
    ``ValueError`` saying why; a JPEG 2000 body gives None or raises where
    cv2 gives None (``utils/jpeg2000.py``).
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


def _png_chunks(data: bytes):
    """A PNG's whole chunks as [(kind, body, crc_ok)] up to IEND, and
    whether IEND came."""
    if not data.startswith(_PNG_MAGIC):
        raise ValueError("not a PNG file")
    chunks, pos = [], len(_PNG_MAGIC)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        if pos + 12 + n > len(data):
            break  # a chunk cut short: the file ends here
        body = data[pos + 8 : pos + 8 + n]
        crc = int.from_bytes(data[pos + 8 + n : pos + 12 + n], "big")
        chunks.append((kind, body, zlib.crc32(body, zlib.crc32(kind)) == crc))
        pos += 12 + n
        if kind == b"IEND":
            return chunks, True
    return chunks, False


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


class _Refused(ValueError):
    """A PNG fault for which cv2 gives None: raised by the plain read, None
    from an APNG's."""


class _PngInfo:
    """What a PNG's chunks say besides its pixels, as libpng keeps it:
    ``palette`` (256 entries, zeros past the file's), ``alpha`` (the
    palette's ``tRNS`` alphas, 255 past them) or ``key`` (a grey or RGB
    ``tRNS`` sample), each None where the file has none libpng takes;
    ``gamma``, ``srgb``, ``icc`` (read before PLTE and IDAT); ``orientation``
    (the first ``eXIf`` chunk's, before or after IDAT)."""

    def __init__(self, chunks, ctype: int, depth: int, apng: bool):
        self.palette = self.alpha = self.key = self.gamma = self.icc = None
        self.srgb, self.orientation, self.entries = False, None, 0
        idat = False
        for kind, body, ok in chunks[1:]:
            if not kind.isalpha() or kind[2] & 0x20:
                raise _Refused(f"PNG chunk type {kind!r} is not four letters, the third "
                               "uppercase, which libpng refuses (cv2 gives None)")
            if not kind[0] & 0x20 and kind not in (b"IHDR", b"PLTE", b"IDAT", b"IEND"):
                raise _Refused(f"PNG critical chunk {kind!r} is unknown to libpng (cv2 gives "
                               "None)")
            # cv2 hands an APNG's frame chunks to libpng without their CRCs
            if not ok and not (apng and kind in (b"IDAT", b"fdAT", b"fcTL", b"acTL")):
                if kind[0] & 0x20 or kind == b"IEND":
                    continue  # an ancillary chunk of a bad CRC: libpng drops it
                raise _Refused(f"PNG {kind.decode('latin-1')} chunk fails its CRC, which "
                               "libpng refuses (cv2 gives None)")
            early = self.palette is None and not idat
            if kind == b"IDAT":
                idat = True
            elif kind == b"PLTE" and self.palette is None and not idat:
                if ctype == 3 and (not body or len(body) % 3 or len(body) > 768):
                    raise ValueError(f"PNG palette of {len(body)} bytes, which libpng refuses")
                self.palette = np.zeros((256, 3), np.uint8)
                self.palette[:len(body) // 3] = np.frombuffer(body, np.uint8).reshape(-1, 3)
                self.entries = len(body) // 3
            elif kind == b"tRNS" and not idat and self.alpha is None and self.key is None:
                if ctype == 3 and self.palette is not None and 0 < len(body) <= self.entries:
                    self.alpha = np.full(256, 255, np.uint8)
                    self.alpha[:len(body)] = np.frombuffer(body, np.uint8)
                elif ctype in (0, 2) and len(body) == (2 if ctype == 0 else 6):
                    key = np.frombuffer(body, ">u2").astype(np.uint16)
                    # libpng compares the low byte with an 8-bit sample, the
                    # low bits with a 1-, 2- or 4-bit one
                    self.key = key & ((1 << depth) - 1)
            elif kind == b"eXIf" and self.orientation is None:
                self.orientation = _tiff_orientation(body)
            elif kind == b"gAMA" and early and self.gamma is None and len(body) == 4:
                self.gamma = struct.unpack(">I", body)[0]
                if not 16 <= self.gamma <= 625000000:  # libpng ignores a gamma out of range
                    self.gamma = None
            elif kind == b"sRGB" and early and len(body) == 1:
                self.srgb = True
            elif kind == b"iCCP" and early and self.icc is None:
                self.icc = body
        if self.srgb:
            self.gamma = _SRGB_GAMMA  # libpng's sRGB gamma, whatever gAMA says


def _inflate(parts) -> np.ndarray:
    """The first zlib stream of an image's data chunks (libpng ignores what
    follows it)."""
    try:
        return np.frombuffer(zlib.decompressobj().decompress(b"".join(parts)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from None


def decode_png(data: bytes, flags: int = IMREAD_COLOR):
    """PNG bytes -> the array ``cv2.imdecode(data, flags)`` gives (see the
    module); an APNG body cv2 gives None for gives None."""
    _check_flags(flags)
    chunks, ended = _png_chunks(data)
    if not chunks or chunks[0][0] != b"IHDR" or len(chunks[0][1]) != 13:
        raise ValueError("PNG file without IHDR")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    if interlace > 1:
        raise ValueError(f"PNG interlace method {interlace} does not exist")
    if depth not in _DEPTHS.get(ctype, ()):
        raise ValueError(f"PNG colour type {ctype} at {depth} bits, which libpng refuses "
                         "(cv2 gives None)")
    if not chunks[0][2]:
        raise ValueError("PNG IHDR chunk fails its CRC, which libpng refuses (cv2 gives None)")
    head = (w, h, depth, ctype, interlace)
    frames = _actl_frames(chunks)
    if frames == 0:
        return None  # cv2 refuses an acTL of another length, or of no frames
    if frames is not None and frames > 1:
        try:
            return _apng(chunks, head, flags)
        except _Refused:
            return None
    info = _PngInfo(chunks, ctype, depth, apng=False)
    if not ended:
        raise ValueError("truncated PNG file (no IEND chunk)")
    img = _png_plain(chunks, head, info, flags)
    if flags == IMREAD_UNCHANGED or info.orientation is None:
        return img
    return _orient(img, info.orientation)


def _actl_frames(chunks):
    """The number of frames of the first ``acTL`` before IDAT (0 for one
    of another length than 8 bytes), or None; cv2 checks no CRC here."""
    for kind, body, _ in chunks:
        if kind == b"IDAT":
            break
        if kind == b"acTL":
            return struct.unpack(">I", body[:4])[0] if len(body) == 8 else 0
    return None


def _png_plain(chunks, head, info: _PngInfo, flags: int) -> np.ndarray:
    """A PNG without an animation (or with a one-frame ``acTL``), as cv2
    reads it through libpng's transformations."""
    w, h, depth, ctype, interlace = head
    if flags == IMREAD_GRAYSCALE and ctype in (2, 3, 6) and not info.srgb \
            and info.icc is not None:
        profile = _icc_length(info.icc)
        if profile in _LIBPNG_SRGB_PROFILE_LENGTHS:
            raise ValueError(f"IMREAD_GRAYSCALE of a colour PNG with an iCCP profile of {profile} "
                             "bytes, the length of an sRGB profile libpng recognises by its "
                             "checksum (and then converts with sRGB's gamma): not supported")
    if ctype == 3 and info.palette is None:
        raise ValueError("palette PNG without PLTE")
    img = _png_pixels([b for k, b, _ in chunks if k == b"IDAT"], w, h, ctype, depth, interlace)
    if ctype == 0 and depth < 8:  # libpng's expansion to 8 bits: 1 -> 255, 3 -> 255 at 2 bits
        img, depth = img * np.uint8(255 // ((1 << depth) - 1)), 8
    if ctype == 3:  # palette: expand, with alpha where tRNS gives it
        idx = img[:, :, 0]
        rgb = info.palette[idx]
        if flags == IMREAD_GRAYSCALE:
            return _grey(rgb, 8, info.gamma)
        if info.alpha is not None and flags == IMREAD_UNCHANGED:
            return _channels(np.dstack([rgb, info.alpha[idx]]), [2, 1, 0, 3])
        return _channels(rgb, [2, 1, 0])
    ch = img.shape[2]
    if flags == IMREAD_GRAYSCALE and ch >= 3:
        return _grey(img, depth, info.gamma)
    if flags == IMREAD_UNCHANGED and ctype == 2 and info.key is not None:
        alpha = np.where((img == info.key).all(axis=2), 0, (1 << depth) - 1)
        return _channels(np.dstack([img, alpha.astype(img.dtype)]), [2, 1, 0, 3])
    if flags != IMREAD_UNCHANGED and depth == 16:
        img = (img >> 8).astype(np.uint8)
    if flags == IMREAD_GRAYSCALE:
        return np.ascontiguousarray(img[:, :, 0])
    if flags == IMREAD_COLOR:
        return _channels(img, [0, 0, 0] if ch <= 2 else [2, 1, 0])  # grey repeated
    if ch == 1:
        return np.ascontiguousarray(img[:, :, 0])
    return _channels(img, {2: [0, 0, 0, 1], 3: [2, 1, 0], 4: [2, 1, 0, 3]}[ch])


def _png_pixels(parts, w: int, h: int, ctype: int, depth: int, interlace: int) -> np.ndarray:
    """An image's zlib data -> its (h, w, samples) samples: uint8 (1-, 2-
    and 4-bit samples unpacked, not scaled) or uint16."""
    raw = _inflate(parts)
    ch = _CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)  # the filters' byte distance
    if not interlace:
        row = (w * ch * depth + 7) // 8
        if raw.size != h * (1 + row):
            raise ValueError(f"PNG data holds {raw.size} bytes, expected {h * (1 + row)}")
        return _samples(_unfilter(raw.reshape(h, 1 + row), h, row, bpp), w, ch, depth)
    # Adam7: each of the seven passes is a small image of its own, filtered
    # over its own rows (the first row's "previous row" is zeros); a pass
    # with no column or no row has no bytes, not even filter bytes
    out = np.empty((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
        if pw == 0 or ph == 0:
            continue
        row = (pw * ch * depth + 7) // 8
        n = ph * (1 + row)
        if pos + n > raw.size:
            raise ValueError(f"interlaced PNG data holds {raw.size} bytes, fewer than its "
                             "passes need")
        rows = _unfilter(raw[pos:pos + n].reshape(ph, 1 + row), ph, row, bpp)
        out[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
        pos += n
    if pos != raw.size:
        raise ValueError(f"interlaced PNG data holds {raw.size} bytes, expected {pos}")
    return out


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """(h, row_bytes) unfiltered bytes -> (h, w, ch) samples."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth == 8:
        return rows.reshape(h, w, ch)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)  # the first sample is the high bits
    s = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return np.ascontiguousarray(s.reshape(h, -1)[:, :w]).reshape(h, w, 1)


def _apng(chunks, head, flags: int):
    """An animated PNG (an ``acTL`` of more than one frame before IDAT) as
    cv2 5.0 reads it through its own frame code: the animation's first
    frame, copied onto a canvas of zeros (RGBA at the file's depth) at its
    ``fcTL`` offset, whatever its blend op; an IDAT before any ``fcTL`` is
    a default image outside the animation, skipped.  The frame's data is
    the first zlib stream of the IDAT and fdAT chunks after its ``fcTL``; it
    ends at the next ``fcTL`` or at IEND.  A file that ends before either,
    an ``fcTL`` past the canvas or of an unknown dispose or blend op up to
    there, an IDAT row of no filter type, and a fault libpng refuses
    (``_Refused``) in the chunks cv2 hands it up to there (between a
    default image and the first ``fcTL``, only a critical chunk) give None,
    as from cv2; the frame chunks' CRCs and sequence numbers are not
    checked.
    ``IMREAD_COLOR`` gives the canvas as BGR (16-bit samples v as
    round(v / 255), saturated), ``IMREAD_GRAYSCALE`` that through
    ``cvtColor``'s BGR -> GRAY, ``IMREAD_UNCHANGED`` the channels libpng's
    plain read gives (BGR, or BGRA for an alpha channel or ``tRNS``) at the
    file's depth.  No Exif orientation is applied.  A grey (colour type 0)
    APNG raises: cv2 overruns a buffer on it."""
    w, h, depth, ctype, interlace = head
    if ctype == 0:
        raise ValueError("APNG of grey samples (colour type 0): cv2 5.0 writes such a frame's "
                         "expanded rows past the end of its buffer, so its output is undefined")
    frame, parts, in_idat, seen_idat, handed = None, [], False, False, []
    for kind, body, ok in chunks:
        if frame is not None or not seen_idat or kind == b"IDAT":
            handed.append((kind, body, ok))
        elif not kind[0] & 0x20 and kind != b"IEND":
            return None  # after a default image cv2 passes over all but critical chunks
        if kind == b"fcTL":
            fc = _fctl(body, w, h)
            if fc is None:
                return None
            if parts:
                break  # the next frame's control ends the first frame
            if frame is not None:
                raise ValueError("APNG: two fcTL chunks before the first frame's data, where "
                                 "cv2's frame is undefined")
            frame, in_idat = fc, not seen_idat
        elif kind == b"IDAT":
            seen_idat = True
            if frame is not None:  # else the default image, outside the animation
                parts.append(body)
        elif kind == b"fdAT" and frame is not None:
            parts.append(body[4:])  # after the sequence number
        elif kind == b"IEND":
            break
    else:
        return None  # the file ends before the first frame does
    idat = [body for kind, body, _ in chunks if kind == b"IDAT"]
    if not idat or not _filters_known(idat, w, h, ctype, depth, interlace):
        return None  # libpng refuses a file without IDAT, or an IDAT row of no filter
    info = _PngInfo(handed, ctype, depth, apng=True)  # what libpng reads of the file
    if ctype == 3 and info.palette is None:
        raise ValueError("palette PNG without PLTE")
    canvas = np.zeros((h, w, 4), np.uint16 if depth == 16 else np.uint8)
    if frame is not None:
        fw, fh, x0, y0 = frame
        if not parts:
            raise ValueError("APNG: a first frame without data, where cv2's frame is undefined")
        try:  # an IDAT frame is decoded at the IHDR's size, its top left placed
            px = _png_pixels(parts, *((w, h) if in_idat else (fw, fh)), ctype, depth, interlace)
        except ValueError as e:
            raise ValueError(f"APNG: the first frame's data is corrupt ({e}); cv2 returns the "
                             "rows libpng decoded before the fault, uninitialised rows or "
                             "crashes: undefined") from None
        canvas[y0:y0 + fh, x0:x0 + fw] = _png_rgba(px, ctype, depth, info)[:fh, :fw]
    if flags == IMREAD_UNCHANGED:
        alpha = ctype in (4, 6) or info.alpha is not None or info.key is not None
        return _channels(canvas, [2, 1, 0, 3] if alpha else [2, 1, 0])
    bgr = _channels(canvas, [2, 1, 0])
    if depth == 16:
        bgr = np.minimum(np.rint(bgr.astype(np.float32) * np.float32(1 / 255)), 255).astype(
            np.uint8)
    return _cvt_grey(bgr) if flags == IMREAD_GRAYSCALE else bgr


def _filters_known(parts, w: int, h: int, ctype: int, depth: int, interlace: int) -> bool:
    """Whether every row libpng unfilters of an IDAT image (a default
    image or an IDAT frame) has a filter type below 5.  From data that
    fails to inflate, libpng unfilters the whole rows before the one its
    failing inflate call was filling (the last whole row when the fault
    comes at a row's end, as a bad checksum does)."""
    try:
        raw, faulty = _inflate(parts), False
    except ValueError:  # the output up to the fault, a byte at a time
        data, d, out, faulty = b"".join(parts), zlib.decompressobj(), [], True
        try:
            for k in range(len(data)):
                out.append(d.decompress(data[k:k + 1]))
        except zlib.error:
            pass
        raw = np.frombuffer(b"".join(out), np.uint8)
    ch = _CHANNELS[ctype]
    starts = []  # each row's first byte, in the order libpng reads them
    pos = 0
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
        if pw and ph:
            row = 1 + (pw * ch * depth + 7) // 8
            starts.append(pos + row * np.arange(ph))
            pos += row * ph
    starts = np.concatenate(starts)
    ends = np.append(starts[1:], pos)
    whole = int(np.searchsorted(ends, raw.size, side="right"))  # rows whole in raw
    if faulty:
        whole = max(0, int(np.searchsorted(ends, raw.size, side="left")))  # not the one filling
    return whole == 0 or raw[starts[:whole]].max() <= 4


def _fctl(body: bytes, w: int, h: int):
    """An ``fcTL``'s (width, height, x, y), or None where cv2
    refuses it (another length, a frame past the canvas, an unknown dispose
    or blend op); a frame of no pixels raises."""
    if len(body) != 26:
        return None
    fw, fh, x0, y0 = struct.unpack(">IIII", body[4:20])
    dispose, blend = body[24], body[25]
    if x0 + fw > w or y0 + fh > h or dispose > 2 or blend > 1:
        return None
    if fw == 0 or fh == 0:
        raise ValueError("APNG: a frame of no pixels, where cv2's frame is undefined")
    return fw, fh, x0, y0


def _png_rgba(img: np.ndarray, ctype: int, depth: int, info: _PngInfo) -> np.ndarray:
    """(h, w, samples) of colour type 2, 3, 4 or 6 -> (h, w, 4) RGBA at the
    file's depth (8 bits for a palette), as libpng expands a frame for
    cv2: a palette looked up, grey repeated, alpha from the file's channel
    or ``tRNS`` (0 where an RGB sample equals the key), else opaque."""
    if ctype == 3:
        idx = img[:, :, 0]
        alpha = info.alpha[idx] if info.alpha is not None else np.full(idx.shape, 255, np.uint8)
        return np.dstack([info.palette[idx], alpha])
    colour = img[:, :, :3] if ctype != 4 else img[:, :, [0, 0, 0]]
    if ctype in (4, 6):
        alpha = img[:, :, -1]
    elif info.key is not None:
        alpha = np.where((img == info.key).all(axis=2), 0, (1 << depth) - 1).astype(img.dtype)
    else:
        alpha = np.full(img.shape[:2], (1 << depth) - 1, img.dtype)
    return np.dstack([colour, alpha])


def _grey(rgb: np.ndarray, depth: int, gamma=None) -> np.ndarray:
    """(H, W, >=3) RGB(A) samples -> (H, W) uint8 as libpng's
    ``png_set_rgb_to_gray(0.299, 0.587)`` and ``png_set_strip_16`` give
    them to cv2: weights of 15 bits (9797, 19234, 32768 less both), alpha
    ignored, an 8-bit sum truncated, a 16-bit one rounded and then cut to
    its high byte.  With a file gamma (``gAMA``, or sRGB's) other than 1.0,
    libpng converts in linear light instead (``_grey_gamma``)."""
    if gamma is not None and (_gamma_significant(gamma) or
                              _gamma_significant(_reciprocal(gamma))):
        return _grey_gamma(rgb, depth, gamma)
    r, g, b = (rgb[:, :, k].astype(np.uint32) for k in range(3))
    y = 9797 * r + 19234 * g + 3737 * b
    if depth == 16:
        return ((y + 16384) >> 23).astype(np.uint8)
    return (y >> 15).astype(np.uint8)


def _cvt_grey(bgr: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(bgr, COLOR_BGR2GRAY)`` of uint8 BGR(A), alpha ignored:
    its 15-bit weights, rounded (not libpng's conversion, ``_grey``)."""
    b, g, r = (bgr[..., k].astype(np.int32) for k in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + 16384) >> 15).astype(np.uint8)


# libpng's gamma arithmetic (png.c, with floating point): gammas in units of
# 1e-5, tables built with pow() and rounded
_SRGB_GAMMA = 45455
_GAMMA_SHIFT_16 = 5  # 16 - PNG_MAX_GAMMA_8: a 16-bit sample indexes its tables by 11 bits


def _reciprocal(a: int) -> int:
    return int(math.floor(1e10 / a + .5))


def _product(a: int, b: int) -> int:
    return int(math.floor(a * 1e-5 * b + .5))


def _gamma_significant(g: int) -> bool:
    return g < 95000 or g > 105000  # PNG_GAMMA_THRESHOLD_FIXED


@functools.lru_cache(maxsize=16)
def _gamma_tables(gamma: int):
    """libpng's tables for the grey conversion of a file of this gamma, the
    screen gamma left unset (so taken as the file's reciprocal): 8-bit
    to-linear and from-linear; 16-bit to-linear and from-linear
    (``png_build_16bit_table``) and the table of grey pixels
    (``png_build_16to8_table``), each [low bits][high byte] of 11 bits."""
    screen = _reciprocal(gamma)

    def table8(g):
        if not _gamma_significant(g):
            return np.arange(256, dtype=np.int64)
        return np.array([v if v in (0, 255) else
                         int(math.floor(255 * math.pow(v / 255., g * .00001) + .5))
                         for v in range(256)], np.int64)

    shift = _GAMMA_SHIFT_16
    num, top = 1 << (8 - shift), (1 << (16 - shift)) - 1

    def table16(g):
        t = np.empty((num, 256), np.int64)
        for i in range(num):
            for j in range(256):
                ig = (j << (8 - shift)) + i
                t[i, j] = (int(math.floor(65535. * math.pow(ig / top, g * .00001) + .5))
                           if _gamma_significant(g) else (ig * 65535 + (top + 1) // 2) // top)
        return t

    def correct16(v, g):
        if 0 < v < 65535:
            return int(math.floor(65535 * math.pow(v / 65535., g * .00001) + .5))
        return v

    g16to8 = np.empty((num, 256), np.int64)
    last, prod = 0, _product(gamma, screen)
    for i in range(255):
        bound = (correct16(i * 257 + 128, prod) * top + 32768) // 65535 + 1
        while last < bound:
            g16to8[last & (0xFF >> shift), last >> (8 - shift)] = i * 257
            last += 1
    while last < num << 8:
        g16to8[last & (0xFF >> shift), last >> (8 - shift)] = 65535
        last += 1
    return (table8(_reciprocal(gamma)), table8(_reciprocal(screen)),
            table16(_reciprocal(gamma)), table16(_reciprocal(screen)), g16to8)


def _grey_gamma(rgb: np.ndarray, depth: int, gamma: int) -> np.ndarray:
    """libpng's ``png_do_rgb_to_gray`` through its gamma tables: a pixel of
    three equal samples keeps its value (16-bit: through the grey table),
    another is taken to linear light, weighted (rounded) and taken back."""
    to1, from1, to1_16, from1_16, grey16 = _gamma_tables(gamma)
    r, g, b = (rgb[:, :, k].astype(np.int64) for k in range(3))
    same = (r == g) & (r == b)
    if depth == 8:
        y = from1[(9797 * to1[r] + 19234 * to1[g] + 3737 * to1[b] + 16384) >> 15]
        return np.where(same, r, y).astype(np.uint8)
    shift = _GAMMA_SHIFT_16

    def look(t, v):
        return t[(v & 0xFF) >> shift, v >> 8]

    y = (9797 * look(to1_16, r) + 19234 * look(to1_16, g) + 3737 * look(to1_16, b)
         + 16384) >> 15
    return (np.where(same, look(grey16, r), look(from1_16, y)) >> 8).astype(np.uint8)


def _icc_length(body: bytes):
    """The length of the profile in an ``iCCP`` chunk, or None where it
    does not inflate."""
    name_end = body.find(b"\0")
    try:
        return len(zlib.decompress(body[name_end + 2:])) if name_end >= 0 else None
    except zlib.error:
        return None


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
    """The ``Orientation`` tag of a JPEG's first Exif APP1 segment, else 1."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        kind, n = data[pos + 1], int.from_bytes(data[pos + 2:pos + 4], "big")
        if kind == 0xDA or kind == 0xD9:  # the image data: no more header segments
            break
        body = data[pos + 4:pos + 2 + n]
        pos += 2 + n
        if kind == 0xE1 and body.startswith(b"Exif\0\0"):
            return _tiff_orientation(body[6:])
    return 1


def _tiff_orientation(tiff: bytes) -> int:
    """cv2's ``Orientation`` of an Exif TIFF structure (a JPEG's APP1 after
    its "Exif" prefix, a PNG's ``eXIf`` chunk, a WebP's ``EXIF`` chunk): tag
    0x0112's first 16 bits in the first IFD, whatever its type; 1 when
    there is none or the header is not TIFF's."""
    order = {b"II": "little", b"MM": "big"}.get(tiff[:2])
    if order is None or len(tiff) < 8 or int.from_bytes(tiff[2:4], order) != 42:
        return 1
    ifd = int.from_bytes(tiff[4:8], order)
    count = int.from_bytes(tiff[ifd:ifd + 2], order)
    for k in range(count):
        e = ifd + 2 + 12 * k
        if e + 10 > len(tiff):
            break
        if int.from_bytes(tiff[e:e + 2], order) == 0x0112:
            return int.from_bytes(tiff[e + 8:e + 10], order)
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
