"""WebP, read as ``cv2.imdecode`` (OpenCV 5.0 with libwebp) reads it, every
value equal.

The RIFF container is read here as libwebp's ``WebPDecode`` reads it for
cv2: a simple file (``VP8 `` or ``VP8L``) or an extended one (``VP8X``,
then any chunks, ``ALPH`` among them, before the image chunk); chunk
payloads padded to an even size; a RIFF size past the end of the file
refused, one shorter than the image chunk refused, trailing bytes ignored;
a bare VP8L or VP8 bitstream, inside RIFF or without it, read as libwebp
reads it (``is_bitstream``: what cv2 takes for WebP without RIFF).
``csrc/webp.c`` decodes the image (the lossy VP8 frame with libwebp's
upsampling and colour conversion, the lossless VP8L image, the ``ALPH``
plane).  An animation (``VP8X`` with its animation flag) reads as its first
frame, composed onto a transparent black canvas, as cv2 5.0's WebP reader
(libwebp's animation decoder) gives it.

cv2 reads the image as BGRA when the file has alpha, else as BGR: it asks
libwebp for the file's features from its first 32 bytes, so an extended
file has alpha when its ``VP8X`` flag says so (whatever chunks follow) and
a simple file when it is VP8L with the alpha bit of its header.  ``IMREAD_UNCHANGED`` gives that image,
``IMREAD_COLOR`` drops the alpha and ``IMREAD_GRAYSCALE`` takes
``cv2.cvtColor``'s BGR2GRAY of it (``(B * 3735 + G * 19235 + R * 9798 +
16384) >> 15``, not the 14-bit weights of the BMP and TIFF readers); the
two apply the orientation of the first ``EXIF`` chunk of an extended file
whose ``VP8X`` sets the Exif flag, as cv2 does.  A file the port cannot
decode raises ``ValueError`` naming the fault.
"""

from __future__ import annotations

import numpy as np

from unopticalflow_tpu_torch.utils.imageio import (IMREAD_COLOR, IMREAD_GRAYSCALE,
                                                   IMREAD_UNCHANGED, _channels, _check_flags,
                                                   _cvt_grey, _orient, _tiff_orientation)

# csrc/webp.c's fault codes, in its order (0 is success)
_FAULTS = (
    None, "out of memory", "truncated VP8 frame header", "VP8 profile above 3",
    "VP8 frame not to be shown", "VP8 frame is not a key frame", "bad VP8 start code",
    "VP8 first partition past the end of the data", "cannot parse the VP8 segment header",
    "cannot parse the VP8 filter header", "cannot parse the VP8 partitions",
    "premature end of the VP8 first partition", "premature end of a VP8 token partition",
    "VP8 frame size differs from the container's", "bad VP8L header",
    "VP8L image size differs from the container's", "truncated VP8L data",
    "a VP8L transform repeated", "bad VP8L colour cache size", "bad VP8L prefix code",
    "VP8L backward reference out of range", "bad ALPH header", "truncated raw ALPH data",
)
_MAX_PAYLOAD = 0xFFFFFFFF - 8 - 1
_ALPHA_FLAG, _ANIMATION_FLAG, _EXIF_FLAG = 0x10, 0x02, 0x08


def _lib():
    """``csrc/webp.c``, built with the host's C compiler at first use."""
    import ctypes

    from unopticalflow_tpu_torch.ops import _build

    i64, i, p = ctypes.c_int64, _build.I, _build.P
    return _build.load("webp", {
        "vp8_decode": [p, i64, i, i, p, i],
        "vp8l_decode": [p, i64, i, i, p],
        "alpha_decode": [p, i64, i, i, p],
    })


def _check(err: int) -> None:
    if err:
        reason = _FAULTS[err] if err < len(_FAULTS) else f"fault {err}"
        raise ValueError(f"WebP: {reason}")


def _le(data: bytes, pos: int, n: int) -> int:
    return int.from_bytes(data[pos:pos + n], "little")


def _truncated(what: str):
    return ValueError(f"truncated WebP: {what}")


def _image_chunk(data: bytes, pos: int, end: int, riff_size: int, extended: bool):
    """libwebp's walk from ``pos`` to the image chunk: (tag, payload start,
    payload size, ALPH payload or None).  ``extended``: the chunks after
    ``VP8X`` (or a frame's) come first, ``ALPH`` among them."""
    alpha = None
    total = 4 + 8 + 10  # "WEBP", the VP8X chunk
    while extended:
        if end - pos < 8:
            raise _truncated("no image chunk")
        size = _le(data, pos + 4, 4)
        if size > _MAX_PAYLOAD:
            raise ValueError(f"WebP: chunk size {size}")
        disk = (8 + size + 1) & ~1
        total += disk
        if riff_size and total > riff_size:
            raise ValueError("WebP: a chunk runs past the RIFF size")
        if data[pos:pos + 4] in (b"VP8 ", b"VP8L"):
            break
        if end - pos < disk:
            raise _truncated(f"{data[pos:pos + 4]!r} chunk")
        if data[pos:pos + 4] == b"ALPH":
            alpha = data[pos + 8:pos + 8 + size]
        pos += disk
    if end - pos < 8:
        raise _truncated("no image chunk")
    tag = data[pos:pos + 4]
    if tag not in (b"VP8 ", b"VP8L"):  # a bare bitstream, which libwebp reads too
        return (b"VP8L" if _vp8l_signature(data[pos:end]) else b"VP8 "), pos, end - pos, None
    size = _le(data, pos + 4, 4)
    if riff_size >= 12 and size > riff_size - 12:
        raise ValueError("WebP: the image chunk runs past the RIFF size")
    if size > end - pos - 8:
        raise _truncated(f"the {tag.decode().strip()} chunk holds {size} bytes, "
                         f"the file {end - pos - 8}")
    return tag, pos + 8, size, alpha


def _vp8l_signature(head: bytes) -> bool:
    return len(head) >= 5 and head[0] == 0x2F and head[4] >> 5 == 0


def is_bitstream(data: bytes) -> bool:
    """Whether ``data`` is a bare VP8L or VP8 bitstream (no RIFF) that cv2
    reads as WebP: libwebp finds its size in the first 32 bytes, the most
    cv2 hands it to tell formats apart (so a VP8 frame's first partition
    must end within them)."""
    if len(data) < 32:
        return False
    if _vp8l_signature(data):
        return True
    bits = _le(data, 0, 3)
    return (data[3:6] == b"\x9d\x01\x2a" and not bits & 1 and (bits >> 1) & 7 <= 3
            and bool((bits >> 4) & 1) and bits >> 5 < 32 and _le(data, 6, 2) & 0x3FFF > 0
            and _le(data, 8, 2) & 0x3FFF > 0)


def _frame_size(data: bytes, tag: bytes, start: int, size: int, end: int):
    """(width, height, alpha bit) of the image chunk, checked as libwebp's
    ``VP8GetInfo`` / ``VP8LGetInfo`` check it."""
    head = data[start:end]
    if tag == b"VP8 ":
        if len(head) < 10:
            raise _truncated("VP8 frame header")
        bits = _le(head, 0, 3)
        if head[3:6] != b"\x9d\x01\x2a":
            raise ValueError("WebP: bad VP8 start code")
        if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or bits >> 5 >= size:
            raise ValueError("WebP: not a VP8 key frame, or inconsistent sizes in its header")
        w, h = _le(head, 6, 2) & 0x3FFF, _le(head, 8, 2) & 0x3FFF
        if not w or not h:
            raise ValueError("WebP: VP8 frame of size zero")
        return w, h, 0
    if len(head) < 5:
        raise _truncated("VP8L header")
    if head[0] != 0x2F or head[4] >> 5:
        raise ValueError("WebP: bad VP8L signature or version")
    bits = _le(head, 1, 4)
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, (bits >> 28) & 1


def _decode_image(data: bytes, tag: bytes, start: int, end: int, w: int, h: int, alpha,
                  channels: int) -> np.ndarray:
    """The image chunk's pixels, (h, w, channels) BGR or BGRA: the decoder
    reads from ``start`` to ``end`` (libwebp hands a still image's decoder
    the rest of the file)."""
    lib = _lib()
    body = np.frombuffer(data, np.uint8, end - start, start)
    if tag == b"VP8L":
        argb = np.empty((h, w), np.uint32)
        _check(lib.vp8l_decode(body.ctypes.data, body.size, w, h, argb.ctypes.data))
        bgra = argb.view(np.uint8).reshape(h, w, 4)  # little-endian ARGB: B, G, R, A
        return bgra if channels == 4 else _channels(bgra, (0, 1, 2))
    out = np.empty((h, w, channels), np.uint8)
    _check(lib.vp8_decode(body.ctypes.data, body.size, w, h, out.ctypes.data, channels))
    if channels == 4 and alpha is not None:
        plane = np.empty((h, w), np.uint8)
        a = np.frombuffer(alpha, np.uint8)
        _check(lib.alpha_decode(a.ctypes.data, a.size, w, h, plane.ctypes.data))
        out[:, :, 3] = plane
    return out


def _exif_orientation(data: bytes, pos: int, end: int) -> int:
    """cv2's orientation of an extended file: the first ``EXIF`` chunk's
    TIFF (its own byte order marks, no "Exif" prefix), tag 0x0112's first
    16 bits whatever its type; 1 when there is none."""
    while end - pos >= 8:
        size = _le(data, pos + 4, 4)
        if data[pos:pos + 4] == b"EXIF":
            return _tiff_orientation(data[pos + 8:pos + 8 + size])
        pos += (8 + size + 1) & ~1
    return 1


def _first_frame(data: bytes, pos: int, end: int, canvas) -> np.ndarray:
    """An animation's first frame on its canvas as BGRA: the canvas
    transparent black, the frame's pixels at its offset."""
    while end - pos >= 8 and data[pos:pos + 4] != b"ANMF":
        pos += (8 + _le(data, pos + 4, 4) + 1) & ~1
    if end - pos < 8 + 16:
        raise _truncated("no animation frame")
    size = _le(data, pos + 4, 4)
    frame_end = pos + 8 + size
    if frame_end > end:
        raise _truncated("the first animation frame")
    x0, y0 = 2 * _le(data, pos + 8, 3), 2 * _le(data, pos + 11, 3)
    fw, fh = _le(data, pos + 14, 3) + 1, _le(data, pos + 17, 3) + 1
    if x0 + fw > canvas[0] or y0 + fh > canvas[1]:
        raise ValueError("WebP: the first animation frame lies outside the canvas")
    start = pos + 24
    # a frame's payload: ALPH (optional) and the image chunk, no RIFF size to check
    tag, img_start, img_size, alpha = _image_chunk(data, start, frame_end, 0,
                                                   data[start:start + 4] == b"ALPH")
    if alpha is not None and tag == b"VP8L":
        raise ValueError("WebP: an animation frame with ALPH and a VP8L image")
    w, h, _ = _frame_size(data, tag, img_start, img_size, img_start + img_size)
    if (w, h) != (fw, fh):
        raise ValueError("WebP: the frame's image differs from its ANMF size")
    frame = _decode_image(data, tag, img_start, img_start + img_size, w, h, alpha, 4)
    out = np.zeros((canvas[1], canvas[0], 4), np.uint8)
    out[y0:y0 + h, x0:x0 + w] = frame
    return out


def decode_webp(data: bytes, flags: int = IMREAD_COLOR) -> np.ndarray:
    """A WebP file as ``cv2.imdecode`` gives it (see the module)."""
    _check_flags(flags)
    end = len(data)
    if end < 32:
        raise _truncated(f"{end} bytes, fewer than the 32 cv2 reads to tell formats apart")
    pos, riff_size, vp8x_flags, canvas = 0, 0, None, None
    if data[:4] == b"RIFF":
        if end < 12 or data[8:12] != b"WEBP":
            raise ValueError("not a WebP (RIFF ... WEBP) file")
        riff_size = _le(data, 4, 4)
        if riff_size < 12 or riff_size > _MAX_PAYLOAD:
            raise ValueError(f"WebP: RIFF size {riff_size}")
        if riff_size > end - 8:
            raise _truncated(f"the RIFF header gives {riff_size} bytes, the file holds {end - 8}")
        pos = 12
    elif not is_bitstream(data):
        raise ValueError("not a WebP file or bitstream")
    if end - pos < 8:
        raise _truncated("no chunk")
    if data[pos:pos + 4] == b"VP8X":
        if not riff_size:
            raise ValueError("WebP: a VP8X chunk outside a RIFF container")
        if _le(data, pos + 4, 4) != 10:
            raise ValueError("WebP: VP8X chunk not of 10 bytes")
        if end - pos < 18:
            raise _truncated("VP8X chunk")
        vp8x_flags = _le(data, pos + 8, 4)
        canvas = (_le(data, pos + 12, 3) + 1, _le(data, pos + 15, 3) + 1)
        if max(canvas) > 1 << 20 or canvas[0] * canvas[1] > 1 << 30:
            raise ValueError(f"WebP: canvas {canvas} past cv2's image size limits")
        pos += 18
    orientation = 1
    if vp8x_flags is not None and vp8x_flags & _EXIF_FLAG and flags != IMREAD_UNCHANGED:
        orientation = _exif_orientation(data, pos, end)
    if vp8x_flags is not None and vp8x_flags & _ANIMATION_FLAG:
        has_alpha = bool(vp8x_flags & _ALPHA_FLAG)
        img = _first_frame(data, pos, end, canvas)
    else:
        tag, start, size, alpha = _image_chunk(data, pos, end, riff_size, vp8x_flags is not None)
        w, h, alpha_bit = _frame_size(data, tag, start, size, end)
        if start == pos and tag == b"VP8 " and _le(data, pos, 3) >> 5 >= 32 - pos:
            # a bare VP8 frame: cv2 takes it for WebP when its first 32 bytes
            # hold the first partition (as is_bitstream)
            raise ValueError("WebP: a bare VP8 frame whose first partition runs past the first "
                             "32 bytes, which cv2 does not take for WebP")
        if canvas is not None and canvas != (w, h):
            raise ValueError(f"WebP: the VP8X canvas {canvas} differs from the image's {(w, h)}")
        if vp8x_flags is not None:
            has_alpha = bool(vp8x_flags & _ALPHA_FLAG)
        else:
            has_alpha = bool(alpha_bit)
        img = _decode_image(data, tag, start, end, w, h, alpha, 4 if has_alpha else 3)
    if flags == IMREAD_UNCHANGED:
        return img if has_alpha or img.shape[2] == 3 else _channels(img, (0, 1, 2))
    bgr = img if img.shape[2] == 3 else _channels(img, (0, 1, 2))
    return _orient(_cvt_grey(bgr) if flags == IMREAD_GRAYSCALE else bgr, orientation)
