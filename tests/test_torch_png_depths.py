"""The port's PNG reader (``utils/imageio.py``) against ``cv2.imdecode``
(OpenCV 5.0 with libpng 1.6), every value equal, under ``IMREAD_COLOR``,
``IMREAD_GRAYSCALE`` and ``IMREAD_UNCHANGED``: every colour type at every
depth libpng reads, plain and Adam7; ``tRNS`` on grey, RGB and palette
files; an ``eXIf`` chunk's orientation; chunks that fail their CRC; APNG
(the first frame of the animation, with or without a default image, on its
canvas) and the APNG faults cv2 gives None for; the committed fixtures of
``tests/torch_fixtures/png/`` against cv2 live and against their digests;
and a short fuzz of generated files on fixed seeds.

No grey (colour type 0) APNG goes to cv2 here: cv2 5.0 writes such a
frame past its buffer and may crash the process (the port raises)."""

import hashlib
import json
import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from chip_smoke import write_apng
from unopticalflow_tpu_torch.utils import imageio

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures", "png")
with open(os.path.join(FIXTURES, "expected.json")) as _f:
    EXPECTED = json.load(_f)
FLAGS = (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED)
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def digest(a) -> str:
    h = hashlib.sha256()
    a = np.ascontiguousarray(a)
    h.update(str(a.dtype.str).encode() + str(a.shape).encode() + a.tobytes())
    return h.hexdigest()


def chunk(kind: bytes, body: bytes) -> bytes:
    return imageio._chunk(kind, body)


def _cv2(data, flags):
    return cv2.imdecode(np.frombuffer(data, np.uint8), flags)


def _same(data, flags) -> bool:
    want, got = _cv2(data, flags), imageio.decode_png(data, flags)
    if want is None:
        return got is None
    return got is not None and got.dtype == want.dtype and got.shape == want.shape \
        and np.array_equal(got, want)


def _rows(s: np.ndarray, depth: int, rng) -> bytes:
    """(h, w, samples) -> the rows packed at ``depth`` bits, each with a
    random filter of None, Sub and Up."""
    h, w, ch = s.shape
    if depth == 16:
        rows = s.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        rows = s.reshape(h, -1).astype(np.uint8)
    else:
        per = 8 // depth
        pad = np.zeros((h, -(-w // per) * per), np.int64)
        pad[:, :w] = s[:, :, 0]
        pad = pad.reshape(h, -1, per)
        rows = sum(pad[:, :, k] << (depth * (per - 1 - k)) for k in range(per)).astype(np.uint8)
    bpp = max(1, ch * depth // 8)
    out, prev = b"", np.zeros(rows.shape[1], np.int32)
    for r in rows.astype(np.int32):
        f = int(rng.randint(0, 3))
        left = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
        res = (r, r - left, r - prev)[f]
        out += bytes([f]) + (res & 255).astype(np.uint8).tobytes()
        prev = r
    return out


def image_data(s, depth, interlace, rng) -> bytes:
    if not interlace:
        return zlib.compress(_rows(s, depth, rng))
    passes = [s[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7]
    return zlib.compress(b"".join(_rows(p, depth, rng) for p in passes if p.size))


def png(w, h, depth, ctype, s, rng, interlace=0, pre=b"", post=b"") -> bytes:
    return (imageio._PNG_MAGIC
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
            + pre + chunk(b"IDAT", image_data(s, depth, interlace, rng)) + post
            + chunk(b"IEND", b""))


def samples(rng, h, w, ctype, depth, top=None):
    top = (1 << depth) if top is None else top
    return rng.randint(0, top, (h, w, SAMPLES[ctype])).astype(
        np.uint16 if depth == 16 else np.uint8)


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth", [(c, d) for c in DEPTHS for d in DEPTHS[c]])
def test_every_colour_type_and_depth_decodes_as_cv2(ctype, depth, interlace):
    rng = np.random.RandomState(ctype * 100 + depth * 2 + interlace)
    h, w = 13, 11  # odd: partial bytes at 1, 2 and 4 bits, every Adam7 pass
    pre = chunk(b"PLTE", rng.randint(0, 256, 3 * 200).astype(np.uint8).tobytes()) \
        if ctype == 3 else b""
    s = samples(rng, h, w, ctype, depth, top=min(1 << depth, 200) if ctype == 3 else None)
    data = png(w, h, depth, ctype, s, rng, interlace, pre)
    for flags in FLAGS:
        assert _same(data, flags), flags
    if ctype == 0 and depth < 8:  # libpng scales the samples to 8 bits
        scale = 255 // ((1 << depth) - 1)
        assert np.array_equal(imageio.decode_png(data, cv2.IMREAD_UNCHANGED),
                              s[:, :, 0] * scale)


def test_refused_depths_raise_where_cv2_gives_none():
    for ctype, depth in ((2, 4), (6, 1), (4, 4), (3, 16), (0, 3), (0, 32)):
        data = (imageio._PNG_MAGIC
                + chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 2, depth, ctype, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(2 * 17))) + chunk(b"IEND", b""))
        assert _cv2(data, cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match="libpng refuses"):
            imageio.decode_png(data)


@pytest.mark.parametrize("case", ["grey", "rgb8", "rgb16", "palette", "palette_long",
                                  "palette_before_plte", "after_idat", "bad_length", "bad_crc",
                                  "rgba_ignored", "palette_past"])
def test_trns_as_cv2(case):
    """Alpha from ``tRNS`` under ``IMREAD_UNCHANGED`` exactly where cv2 gives
    one: RGB (the 8-bit key's low byte) and palette files; a grey file keeps
    one channel; a tRNS longer than the palette, before PLTE, after IDAT, of
    another length or failing its CRC is dropped; an index past the palette
    is black and opaque."""
    rng = np.random.RandomState(len(case))
    h, w = 9, 10
    plte = chunk(b"PLTE", rng.randint(0, 256, 3 * 6).astype(np.uint8).tobytes())
    depth, ctype = {"grey": (4, 0), "rgb16": (16, 2), "rgba_ignored": (8, 6)}.get(
        case, (8, 3) if case.startswith("palette") or case in ("after_idat", "bad_crc")
        else (8, 2))
    top = 6 if ctype == 3 else None
    s = samples(rng, h, w, ctype, depth, top=9 if case == "palette_past" else top)
    if ctype == 3:
        body, key = rng.randint(0, 256, 4).astype(np.uint8).tobytes(), None
    else:
        key = s[0, 0, :min(3, s.shape[2])]
        s[rng.rand(h, w) < 0.3, :key.size] = key  # pixels that match the key
        body = struct.pack(">" + "H" * key.size, *(int(v) for v in key))
        if case == "rgb8":
            body = struct.pack(">HHH", *(int(v) | 0x300 for v in key))  # high bytes ignored
    trns = chunk(b"tRNS", body)
    pre, post = (plte if ctype == 3 else b""), b""
    if case == "palette_long":
        trns = chunk(b"tRNS", bytes(7))
    if case == "palette_before_plte":
        pre = trns + plte
    elif case == "after_idat":
        post = trns
    elif case == "bad_length":
        pre += chunk(b"tRNS", body[:4])
    elif case == "bad_crc":
        pre += trns[:-1] + bytes([trns[-1] ^ 1])
    else:
        pre += trns
    data = png(w, h, depth, ctype, s, rng, 0, pre, post)
    for flags in FLAGS:
        assert _same(data, flags), flags
    got = imageio.decode_png(data, cv2.IMREAD_UNCHANGED)
    alpha = case in ("rgb8", "rgb16", "palette", "palette_past", "rgba_ignored")
    assert got.shape[2:] == ((4,) if alpha else () if ctype == 0 else (3,))


def _exif(orientation, order="<", kind=3) -> bytes:
    mark = b"II" if order == "<" else b"MM"
    value = struct.pack(order + ("HH" if kind == 3 else "I"), orientation, *(
        (0,) if kind == 3 else ()))
    return (mark + struct.pack(order + "HIH", 42, 8, 1)
            + struct.pack(order + "HHI", 0x0112, kind, 1) + value + struct.pack(order + "I", 0))


@pytest.mark.parametrize("where", ["before", "after", "mm", "long", "two", "bad_crc",
                                   "exif_prefix"])
def test_exif_orientation_as_cv2(where):
    """cv2 turns a PNG by its first ``eXIf`` chunk (before or after IDAT, a
    tag of any type read by its first 16 bits) under COLOR and GRAYSCALE;
    a chunk failing its CRC, or one with JPEG's "Exif" prefix, does not."""
    rng = np.random.RandomState(7)
    s = samples(rng, 12, 20, 2, 8)
    for orientation in range(1, 9):
        body = {"mm": _exif(orientation, ">"), "long": _exif(orientation, "<", 4),
                "exif_prefix": b"Exif\0\0" + _exif(orientation)}.get(where, _exif(orientation))
        exif = chunk(b"eXIf", body)
        if where == "two":
            exif += chunk(b"eXIf", _exif(9 - orientation))
        if where == "bad_crc":
            exif = exif[:-1] + bytes([exif[-1] ^ 1])
        data = png(20, 12, 8, 2, s, rng, 0, *((b"", exif) if where == "after" else (exif, b"")))
        for flags in FLAGS:
            assert _same(data, flags), (orientation, flags)
        turned = imageio.decode_png(data).shape[0] == 20
        assert turned == (orientation >= 5 and where not in ("bad_crc", "exif_prefix")), \
            orientation


def test_jpeg_exif_orientation_of_any_type_as_cv2():
    """The Exif reader the PNG path now shares: a JPEG's Orientation of type
    LONG is read by its first 16 bits, as cv2 reads it (little-endian: the
    value; big-endian: 0, no turn)."""
    img = np.random.RandomState(3).randint(0, 256, (16, 24, 3)).astype(np.uint8)
    jpg = cv2.imencode(".jpg", img)[1].tobytes()
    for order in ("<", ">"):
        tiff = _exif(6, order, 4)
        data = jpg[:2] + b"\xff\xe1" + struct.pack(">H", len(tiff) + 8) + b"Exif\0\0" + tiff \
            + jpg[2:]
        for flags in FLAGS:
            want, got = _cv2(data, flags), imageio.decode_jpeg(data, flags)
            assert got.shape == want.shape and np.array_equal(got, want), (order, flags)


def test_chunk_crcs_and_unknown_critical_chunks_as_libpng():
    """libpng drops an ancillary chunk that fails its CRC (here a gAMA: the
    grey read stays plain) and refuses a critical one, or an unknown
    critical chunk, where cv2 gives None: the port raises."""
    rng = np.random.RandomState(2)
    s = samples(rng, 6, 7, 2, 8)
    gama = chunk(b"gAMA", struct.pack(">I", 45455))
    plain = png(7, 6, 8, 2, s, rng)
    bad_gama = png(7, 6, 8, 2, s, rng, 0, gama[:-1] + bytes([gama[-1] ^ 1]))
    for flags in FLAGS:
        assert _same(bad_gama, flags)
        assert np.array_equal(imageio.decode_png(bad_gama, flags), imageio.decode_png(plain, flags))
    iend = plain[:-1] + bytes([plain[-1] ^ 1])  # cv2 reads on past a bad IEND CRC
    assert _same(iend, cv2.IMREAD_COLOR)
    for kind in (b"IHDR", b"IDAT"):
        pos = plain.index(kind) + 4 + struct.unpack(">I", plain[plain.index(kind) - 4:
                                                              plain.index(kind)])[0]
        bad = plain[:pos] + bytes([plain[pos] ^ 1]) + plain[pos + 1:]
        assert _cv2(bad, cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match="CRC"):
            imageio.decode_png(bad)
    unknown = png(7, 6, 8, 2, s, rng, 0, chunk(b"ABCD", b"xy"))
    assert _cv2(unknown, cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match="unknown to libpng"):
        imageio.decode_png(unknown)
    for kind in (b"ab\xf0d", b"abcd"):  # not letters; the reserved bit set
        refused = png(7, 6, 8, 2, s, rng, 0, chunk(kind, b"xy"))
        assert _cv2(refused, cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match="not four letters, the third uppercase"):
            imageio.decode_png(refused)


def _fctl(seq, w, h, x=0, y=0, dispose=0, blend=0) -> bytes:
    return chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, x, y, 1, 10, dispose, blend))


def apng(head, frames, rng, default=None, extra=b"", interlace=0, frames_count=None):
    """An APNG: ``head`` (w, h, depth, ctype), ``frames`` [(samples, x, y,
    dispose, blend)], the first in IDAT unless a ``default`` image (samples)
    goes there."""
    w, h, depth, ctype = head
    out = (imageio._PNG_MAGIC
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
           + chunk(b"acTL", struct.pack(">II", frames_count or len(frames), 0)) + extra)
    if default is not None:
        out += chunk(b"IDAT", image_data(default, depth, interlace, rng))
    seq = 0
    for k, (s, x, y, dispose, blend) in enumerate(frames):
        fh, fw = s.shape[:2]
        out += _fctl(seq, fw, fh, x, y, dispose, blend)
        seq += 1
        if k == 0 and default is None:
            out += chunk(b"IDAT", image_data(s, depth, interlace, rng))
        else:
            out += chunk(b"fdAT", struct.pack(">I", seq) + image_data(s, depth, interlace, rng))
            seq += 1
    return out + chunk(b"IEND", b"")


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth,trns", [(2, 8, False), (2, 16, True), (3, 4, True),
                                              (3, 8, False), (4, 16, False), (6, 8, False),
                                              (6, 16, False), (2, 8, True)])
@pytest.mark.parametrize("default", [False, True], ids=["idat_frame", "default_image"])
def test_apng_first_frame_as_cv2(ctype, depth, trns, default, interlace):
    """The first frame of the animation on a canvas of zeros at its offset
    (an IDAT frame smaller than the canvas placed from its top left; with a
    default image, the first fdAT frame), whatever its blend op; the grey
    read through cvtColor; 16-bit samples as round(v / 255)."""
    rng = np.random.RandomState(ctype * 50 + depth + 7 * trns + 3 * default + interlace)
    w, h = 17, 13
    extra = b""
    top = None
    if ctype == 3:
        extra += chunk(b"PLTE", rng.randint(0, 256, 3 * 12).astype(np.uint8).tobytes())
        top = 12
        if trns:
            extra += chunk(b"tRNS", rng.randint(0, 256, 5).astype(np.uint8).tobytes())
    elif trns:
        key = samples(rng, 1, 1, ctype, depth)[0, 0]
        extra += chunk(b"tRNS", struct.pack(">HHH", *(int(v) for v in key)))
    fw, fh, x0, y0 = (11, 7, 4, 5) if default else (17, 13, 0, 0)
    first = samples(rng, fh, fw, ctype, depth, top)
    if ctype == 2 and trns:
        first[rng.rand(fh, fw) < 0.3] = key
    frames = [(first, x0, y0, int(rng.randint(0, 3)), 1),
              (samples(rng, 5, 6, ctype, depth, top), 3, 2, 0, 0)]
    data = apng((w, h, depth, ctype), frames, rng,
                default=samples(rng, h, w, ctype, depth, top) if default else None,
                extra=extra, interlace=interlace)
    for flags in FLAGS:
        assert _same(data, flags), flags
    colour = imageio.decode_png(data)
    assert not colour[:y0].any() and not colour[:, :x0].any()  # the canvas outside the frame
    if not default:  # the IDAT frame at a smaller size and an offset: its top left placed
        small = data.replace(_fctl(0, 17, 13), _fctl(0, 9, 6, 5, 4))
        for flags in FLAGS:
            assert _same(small, flags), flags


def test_apng_branch_and_faults_as_cv2():
    """cv2's frame code runs for an ``acTL`` of more than one frame before
    IDAT only: one frame, or an acTL after IDAT, reads as a plain PNG (its
    grey read through libpng's weights), none or an acTL of another length
    give None.  A frame control past the canvas, an unknown dispose or blend
    op up to the frame's end, a file ending before the frame does, and no
    IDAT give None; sequence numbers and the frame chunks' CRCs are not
    checked; a grey APNG raises (cv2 overruns a buffer on it)."""
    rng = np.random.RandomState(11)
    w, h = 10, 8
    f0, f1 = samples(rng, h, w, 2, 8), samples(rng, h, w, 2, 8)
    good = apng((w, h, 8, 2), [(f0, 0, 0, 0, 0), (f1, 0, 0, 0, 0)], rng)
    plain = png(w, h, 8, 2, f0, rng)
    assert not np.array_equal(_cv2(good, 0), _cv2(plain, 0))  # the two grey reads differ
    for flags in FLAGS:
        assert _same(good, flags)
    actl = good.index(b"acTL") - 4
    one = good[:actl] + chunk(b"acTL", struct.pack(">II", 1, 0)) + good[actl + 20:]
    late = good[:actl] + good[actl + 20:]
    late = late[:-12] + chunk(b"acTL", struct.pack(">II", 2, 0)) + late[-12:]
    for data in (one, late):
        assert np.array_equal(imageio.decode_png(data, 0), _cv2(plain, 0))
        for flags in FLAGS:
            assert _same(data, flags)
    nones = {
        "no frames": good[:actl] + chunk(b"acTL", struct.pack(">II", 0, 0)) + good[actl + 20:],
        "short acTL": good[:actl] + chunk(b"acTL", bytes(4)) + good[actl + 20:],
        "next frame past the canvas": good.replace(_fctl(1, w, h), _fctl(1, w, h, 1, 0)),
        "next blend op 2": good.replace(_fctl(1, w, h), _fctl(1, w, h, blend=2)),
        "first dispose op 3": good.replace(_fctl(0, w, h), _fctl(0, w, h, dispose=3)),
        "ends after IDAT": good[:good.index(b"fcTL", good.index(b"IDAT")) - 4],
    }
    default = apng((w, h, 8, 2), [(f1, 0, 0, 0, 0), (f0, 0, 0, 0, 0)], rng, default=f0)
    idat = default.index(b"IDAT") - 4
    nones["no IDAT"] = default[:idat] + default[idat + 12 + struct.unpack(
        ">I", default[idat:idat + 4])[0]:]
    for name, data in nones.items():
        for flags in FLAGS:
            assert _cv2(data, flags) is None, name
            assert imageio.decode_png(data, flags) is None, name
    # a chunk libpng refuses gives None before the first frame ends, and is
    # not read after it
    bad_name = chunk(b"ab\xf0d", b"xy")
    early_name = good[:actl + 20] + bad_name + good[actl + 20:]
    for flags in FLAGS:
        assert _cv2(early_name, flags) is None
        assert imageio.decode_png(early_name, flags) is None
    late_name = good[:-12] + bad_name + good[-12:]
    for flags in FLAGS:
        assert _same(late_name, flags)
    fdat = good.index(b"fdAT") - 4
    faults = [good.replace(_fctl(1, w, h), _fctl(9, w, h)),  # sequence numbers
              good[:fdat] + good[fdat:fdat + 8] + bytes(4) + good[fdat + 12:],
              good.replace(_fctl(0, w, h), _fctl(0, w, h)[:-1] + b"\0")]  # an fcTL's CRC
    for data in faults:
        for flags in FLAGS:
            assert _same(data, flags)
    grey = apng((w, h, 8, 0), [(samples(rng, h, w, 0, 8), 0, 0, 0, 0)] * 2, rng)
    with pytest.raises(ValueError, match="APNG of grey samples"):
        imageio.decode_png(grey)


def test_write_apng_and_pil_apngs_as_cv2():
    """``chip_smoke.write_apng`` (with and without a default image) and
    PIL's APNG writer (``default_image=True`` puts the first image outside
    the animation)."""
    import io

    from PIL import Image

    rng = np.random.RandomState(5)
    a, b = (rng.randint(0, 256, (14, 18, 3)).astype(np.uint8) for _ in range(2))
    bodies = [write_apng([(a, 0, 0), (b[:5, :6], 2, 3)]),
              write_apng([(b[:9, :11], 3, 2), (a, 0, 0)], default=a)]
    for mode, kw in (("RGB", {}), ("RGBA", {}), ("RGB", {"default_image": True}),
                     ("P", {"default_image": True})):
        frames = [Image.fromarray(x[:, :, ::-1]).convert(mode) for x in (a, b, a[::-1])]
        buf = io.BytesIO()
        frames[0].save(buf, "PNG", save_all=True, append_images=frames[1:], **kw)
        bodies.append(buf.getvalue())
    for data in bodies:
        for flags in FLAGS:
            assert _same(data, flags), flags
    assert np.array_equal(imageio.decode_png(bodies[0]), a)
    canvas = np.zeros_like(a)
    canvas[2:11, 3:14] = b[:9, :11]
    assert np.array_equal(imageio.decode_png(bodies[1]), canvas)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_fixture_decodes_as_cv2(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    for flags in FLAGS:
        want = EXPECTED[name][str(flags)]
        if want.startswith("raises: "):  # cv2's output is undefined (no cv2 call)
            with pytest.raises(ValueError, match=want[len("raises: "):]):
                imageio.decode_png(data, flags)
            continue
        cv2_out = _cv2(data, flags)
        assert (digest(cv2_out) if cv2_out is not None else "none") == want  # still cv2's
        got = imageio.decode_png(data, flags)
        assert (digest(got) if got is not None else "none") == want, flags


def _fuzz_file(rng):
    """A random PNG or APNG (no grey APNG) of every colour type and depth,
    interlaced or not, with tRNS and eXIf chunks at random."""
    ctype = int(rng.choice([0, 2, 3, 4, 6]))
    depth = int(rng.choice(DEPTHS[ctype]))
    interlace = int(rng.rand() < 0.3)
    w, h = int(rng.randint(1, 20)), int(rng.randint(1, 16))
    pre, top = b"", None
    if ctype == 3:
        n = int(rng.randint(1, (1 << depth) + 1))
        pre += chunk(b"PLTE", rng.randint(0, 256, 3 * n).astype(np.uint8).tobytes())
        top = min(1 << depth, n + 2)
        if rng.rand() < 0.4:
            pre += chunk(b"tRNS", rng.randint(0, 256, int(rng.randint(1, n + 2))).astype(
                np.uint8).tobytes())
    elif ctype in (0, 2) and rng.rand() < 0.4:
        pre += chunk(b"tRNS", struct.pack(">" + "H" * SAMPLES[ctype], *(
            int(v) for v in rng.randint(0, 1 << depth, SAMPLES[ctype]))))
    if rng.rand() < 0.2:
        pre += chunk(b"eXIf", _exif(int(rng.randint(1, 9))))
    s = samples(rng, h, w, ctype, depth, top)
    if ctype == 0 or rng.rand() < 0.5:
        return png(w, h, depth, ctype, s, rng, interlace, pre)
    frames = []
    for _ in range(int(rng.randint(2, 4))):
        fw, fh = int(rng.randint(1, w + 1)), int(rng.randint(1, h + 1))
        frames.append((samples(rng, fh, fw, ctype, depth, top), int(rng.randint(0, w - fw + 1)),
                       int(rng.randint(0, h - fh + 1)), int(rng.randint(0, 3)),
                       int(rng.randint(0, 2))))
    default = rng.rand() < 0.5
    if not default:
        frames[0] = (s, 0, 0) + frames[0][3:]
    return apng((w, h, depth, ctype), frames, rng, default=s if default else None, extra=pre,
                interlace=interlace)


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_png_and_apng_as_cv2(seed):
    """Generated files on fixed seeds, cut at random places a third of the
    time: equal to cv2's decode, None where cv2 gives None for an APNG; a
    plain PNG cv2 gives None for raises."""
    rng = np.random.RandomState(100 + seed)
    for _ in range(200):
        data = _fuzz_file(rng)
        if rng.rand() < 0.3:
            data = data[:int(rng.randint(8, len(data)))]
        for flags in FLAGS:
            want = _cv2(data, flags)
            try:
                got = imageio.decode_png(data, flags)
            except ValueError:
                got = None
            if want is None:
                assert got is None
            else:
                assert got is not None and got.dtype == want.dtype and np.array_equal(got, want)
