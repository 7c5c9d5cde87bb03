"""The port's WebP reader (``utils/webp.py``, ``csrc/webp.c``) against
``cv2.imdecode`` (OpenCV 5.0 with libwebp), every value equal, under
``IMREAD_COLOR``, ``IMREAD_GRAYSCALE`` and ``IMREAD_UNCHANGED``: the
committed fixtures of ``tests/torch_fixtures/webp/`` (against cv2 live and
against the digests of cv2's decodes committed beside them; the bodies cv2
refuses raise); files cv2 and PIL write at odd sizes with each of their
options; hand-built ``ALPH`` chunks (raw, every filter), Exif orientations,
animations, and lossy frames whose loop filter (simple or normal, level,
sharpness, deltas) and segment fields are rewritten; every prefix of a lossy, a lossless and an alpha file, and
files with corrupted bytes, where cv2 giving no image and the port raising
go together; and ``imread`` of a ``.webp`` file."""

import hashlib
import io
import json
import os
import struct

import cv2
import numpy as np
import pytest

from tests.torch_fixtures.make_fixtures import (BoolDecoder, vp8_with_headers, vp8x_chunk,
                                                webp_animation, webp_chunk, webp_riff,
                                                webp_with_raw_alpha)
from unopticalflow_tpu_torch.utils import imageio

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures", "webp")
with open(os.path.join(FIXTURES, "expected.json")) as _f:
    EXPECTED = json.load(_f)
FLAGS = (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED)


def digest(a) -> str:
    h = hashlib.sha256()
    a = np.ascontiguousarray(a)
    h.update(str(a.dtype.str).encode() + str(a.shape).encode() + a.tobytes())
    return h.hexdigest()


def _cv2(data, flags):
    """cv2's decode, or None where it refuses the body (an error or an
    exception: a canvas past its size limits)"""
    try:
        return cv2.imdecode(np.frombuffer(data, np.uint8), flags)
    except cv2.error:
        return None


def _as_cv2(data, flags=FLAGS):
    """The port decodes ``data`` as cv2 does under each of ``flags``, or
    raises ``ValueError`` where cv2 gives no image."""
    for f in flags:
        want = _cv2(data, f)
        if want is None:
            with pytest.raises(ValueError, match="WebP"):
                imageio.imdecode(data, f)
            continue
        got = imageio.imdecode(data, f)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert np.array_equal(got, want), f
        assert got.flags.writeable


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_fixture_decodes_as_cv2(name):
    data = _read(name)
    for flags in FLAGS:
        want = EXPECTED[name][str(flags)]
        if want == "none":  # cv2 refuses the body: the port raises, naming why
            assert _cv2(data, flags) is None
            with pytest.raises(ValueError, match="WebP"):
                imageio.imdecode(data, flags)
            continue
        assert digest(_cv2(data, flags)) == want, flags  # still cv2's decode
        assert digest(imageio.imdecode(data, flags)) == want, flags


def _vp8_header(data: bytes) -> dict:
    """The segment and filter fields of a lossy file's first partition."""
    pos = data.index(b"VP8 ") + 8
    br = BoolDecoder(data[pos + 10:pos + 10 + (int.from_bytes(data[pos:pos + 3], "little") >> 5)])
    br.value_of(2)  # colour space, clamping
    out = {"segments": br.bit(), "update_map": 0, "absolute": 1}
    if out["segments"]:
        out["update_map"] = br.bit()
        if br.bit():
            out["absolute"] = br.bit()
            for n in (7,) * 4 + (6,) * 4:
                if br.bit():
                    br.signed(n)
        if out["update_map"]:
            for _ in range(3):
                if br.bit():
                    br.value_of(8)
    out.update(simple=br.bit(), level=br.value_of(6), sharpness=br.value_of(3))
    return out


def test_fixtures_reach_the_decoder_paths():
    """The fixtures hold what the module docstring names: segments with a
    map, given absolutely and relative to the frame's, the normal loop filter
    at several levels and none at quality 100, the simple one, sharpness,
    every ALPH filter stored raw, ALPH as VP8L with and without its filter
    and level-reduction bits, and the colour-indexing pixel bundlings."""
    headers = {n: _vp8_header(_read(n)) for n in EXPECTED
               if n.startswith(("vp8_", "pil_alpha")) and b"VP8 " in _read(n)}
    assert headers["vp8_segments_96x128.webp"]["segments"]
    assert headers["vp8_segments_96x128.webp"]["update_map"]
    assert headers["vp8_q100.webp"]["level"] == 0
    assert not headers["vp8_relative_segments.webp"]["absolute"]
    levels = {h["level"] for h in headers.values()}
    assert len(levels) >= 4
    assert {h["simple"] for h in headers.values()} == {0, 1}
    assert {h["sharpness"] for h in headers.values()} >= {0, 3, 6}
    alph = {}
    for n in EXPECTED:
        data = _read(n)
        if b"ALPH" in data and not n.startswith("bad"):
            b = data[data.index(b"ALPH") + 8]
            alph[n] = (b & 3, (b >> 2) & 3, (b >> 4) & 3)
    assert {alph[f"alph_raw_filter{m}.webp"] for m in range(4)} == {(0, m, 0) for m in range(4)}
    assert alph["alph_raw_levels.webp"] == (0, 3, 1)
    assert {v[0] for k, v in alph.items() if k.startswith("pil_")} == {1}
    assert {v[2] for k, v in alph.items() if k.startswith("pil_")} == {0, 1}
    for n in (2, 4, 16, 200):  # a VP8L palette's size picks its bundling
        img = imageio.imdecode(_read(f"vp8l_palette{n}.webp"))
        assert len(np.unique(img.reshape(-1, 3), axis=0)) <= n


def _image(h, w, seed, ch=3, blur=2):
    rng = np.random.RandomState(seed)
    img = cv2.GaussianBlur(rng.randint(0, 256, (h, w, ch)).astype(np.uint8), (0, 0), blur)
    img = img.reshape(h, w, ch)
    img[::4, ::5] = rng.randint(0, 256, img[::4, ::5].shape)
    return img


def _pil(img, mode, **kw):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img), mode).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _variants(h, w):
    """(name, bytes): what cv2 and PIL write at h x w with each option."""
    from PIL import Image

    img = _image(h, w, h * w + 1)
    rng = np.random.RandomState(h)
    out = []
    for q in (1, 30, 75, 100, 101):
        out.append((f"cv2 q{q}", cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, q])[1]))
        out.append((f"cv2 grey q{q}", cv2.imencode(".webp", np.ascontiguousarray(img[:, :, 1]),
                                                   [cv2.IMWRITE_WEBP_QUALITY, q])[1]))
    for n in (2, 3, 5, 16, 17, 256):
        pal = rng.randint(0, 256, (n, 3)).astype(np.uint8)
        out.append((f"cv2 palette {n}", cv2.imencode(
            ".webp", pal[rng.randint(0, n, (h, w))], [cv2.IMWRITE_WEBP_QUALITY, 101])[1]))
    noisy = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    for q in (20, 101):
        out.append((f"cv2 noise q{q}", cv2.imencode(".webp", noisy,
                                                    [cv2.IMWRITE_WEBP_QUALITY, q])[1]))
    bgra = np.dstack([img, _image(h, w, 7, ch=1)[:, :, 0]])
    out.append(("cv2 bgra", cv2.imencode(".webp", bgra)[1]))
    rgba = np.ascontiguousarray(bgra[:, :, [2, 1, 0, 3]])
    for kw in ({"quality": 80, "alpha_quality": 100}, {"quality": 80, "alpha_quality": 30},
               {"quality": 30, "method": 0}, {"quality": 90, "method": 6},
               {"lossless": True, "exact": True}, {"lossless": True, "method": 0},
               {"lossless": True, "method": 6, "quality": 100}):
        out.append((f"PIL RGBA {kw}", _pil(rgba, "RGBA", **kw)))
    rgb = np.ascontiguousarray(img[:, :, ::-1])
    out.append(("PIL RGB lossless", _pil(rgb, "RGB", lossless=True)))
    out.append(("PIL L", _pil(rgb[:, :, 0], "L", quality=60)))
    frames = [Image.fromarray(rgb), Image.fromarray(np.ascontiguousarray(255 - rgb))]
    for lossless in (False, True):
        buf = io.BytesIO()
        frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=100,
                       lossless=lossless)
        out.append((f"PIL animation lossless={lossless}", buf.getvalue()))
    buf = io.BytesIO()
    Image.fromarray(rgba, "RGBA").save(buf, "WEBP", save_all=True, duration=50,
                                       append_images=[Image.fromarray(rgba[::-1].copy())])
    out.append(("PIL animation RGBA", buf.getvalue()))
    return [(name, bytes(data)) for name, data in out]


@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (9, 16), (17, 33), (40, 72)])
def test_written_files_decode_as_cv2(hw):
    for name, data in _variants(*hw):
        assert _cv2(data, cv2.IMREAD_COLOR) is not None, name
        _as_cv2(data)


@pytest.mark.parametrize("simple", (0, 1))
def test_rewritten_loop_filters_decode_as_cv2(simple):
    """A lossy frame whose first partition is rewritten
    (``make_fixtures.vp8_with_headers``) with the simple or the normal loop
    filter at each sharpness and several levels, with reference and mode
    deltas, and with segment fields relative to the frame's."""
    img = _image(40, 72, 30, blur=3)
    img[:, 36:] = np.random.RandomState(31).randint(0, 256, (40, 36, 3))
    lossy = bytes(cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 45])[1])
    for sharpness in range(8):
        for level in (1, 17, 63):
            _as_cv2(vp8_with_headers(lossy, simple=simple, level=level, sharpness=sharpness),
                    (cv2.IMREAD_COLOR,))
    for ref, mode in ((5, 0), (-30, 12), (0, -20), (60, 60)):
        _as_cv2(vp8_with_headers(lossy, simple=simple, level=30, ref_delta=ref,
                                 mode_delta=mode), (cv2.IMREAD_COLOR,))
    _as_cv2(vp8_with_headers(lossy, simple=simple, level=12, relative=True,
                             strengths=[-12, 0, 30, 63]), (cv2.IMREAD_COLOR,))


@pytest.mark.parametrize("method", range(4))
@pytest.mark.parametrize("levels", (0, 1))
def test_raw_alpha_filters_decode_as_cv2(method, levels):
    """ALPH stored raw (compression 0) under each filter, with and without
    the level-reduction bit (which leaves the decoder nothing to do); the
    alpha plane comes back as stored."""
    for h, w in ((1, 1), (1, 7), (6, 1), (19, 34)):
        lossy = cv2.imencode(".webp", _image(h, w, 3), [cv2.IMWRITE_WEBP_QUALITY, 70])[1]
        alpha = _image(h, w, 4, ch=1, blur=1)[:, :, 0]
        data = webp_with_raw_alpha(bytes(lossy), alpha, method, levels)
        _as_cv2(data)
        assert np.array_equal(imageio.imdecode(data, cv2.IMREAD_UNCHANGED)[:, :, 3], alpha)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_applies_as_cv2(orientation):
    """The first EXIF chunk of an extended file with the Exif flag: its
    Orientation (either byte order, SHORT or LONG) turns the colour and grey
    reads; no flag, an "Exif" prefix or a simple file leave them as stored."""
    img = _image(21, 34, 8)
    lossy = bytes(cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 85])[1])

    def tiff(order, kind):
        e = "<" if order == b"II" else ">"
        value = struct.pack(e + "HH", orientation, 0) if kind == 3 else struct.pack(
            e + "I", orientation)
        return (order + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
                + struct.pack(e + "HHI", 0x0112, kind, 1) + value + struct.pack(e + "I", 0))

    for exif in (tiff(b"II", 3), tiff(b"MM", 3), tiff(b"II", 4), tiff(b"MM", 4),
                 b"Exif\0\0" + tiff(b"II", 3)):
        for flags, before in ((0x08, False), (0x08, True), (0x00, False)):
            chunk = webp_chunk(b"EXIF", exif)
            body = vp8x_chunk(34, 21, flags) + (chunk if before else b"") + lossy[12:] + (
                b"" if before else chunk)
            _as_cv2(webp_riff(body))
    _as_cv2(lossy + webp_chunk(b"EXIF", tiff(b"II", 3)))


def test_animation_first_frame_on_its_canvas():
    """An animation reads as its first frame at its offset on a transparent
    black canvas (BGRA with the VP8X alpha flag, else BGR), its frame lossy
    or lossless, with or without ALPH."""
    big, small = _image(30, 44, 11), _image(13, 17, 12)
    for q in (70, 101):
        f_small = bytes(cv2.imencode(".webp", small, [cv2.IMWRITE_WEBP_QUALITY, q])[1])
        f_big = bytes(cv2.imencode(".webp", big, [cv2.IMWRITE_WEBP_QUALITY, q])[1])
        for flags in (0x02, 0x12):
            for x, y in ((0, 0), (6, 10), (26, 16)):
                _as_cv2(webp_animation((44, 30), [(x, y, 17, 13, f_small), (0, 0, 44, 30, f_big)],
                                       flags))
    # a frame of ALPH and VP8 chunks; with a VP8L image cv2 refuses the file
    head = b"".join(v.to_bytes(3, "little") for v in (1, 2, 16, 12, 100))
    for q in (70, 101):
        f_small = bytes(cv2.imencode(".webp", small, [cv2.IMWRITE_WEBP_QUALITY, q])[1])
        alpha_frame = webp_with_raw_alpha(f_small, _image(13, 17, 5, ch=1)[:, :, 0], 2)
        frame = alpha_frame[alpha_frame.index(b"ALPH"):]
        body = vp8x_chunk(44, 30, 0x12) + webp_chunk(b"ANIM", bytes(6))
        _as_cv2(webp_riff(body + webp_chunk(b"ANMF", head + b"\0" + frame)))
        _as_cv2(alpha_frame)  # a still image: the VP8L's own alpha, ALPH ignored


@pytest.mark.parametrize("kind", ("lossy", "lossless", "alpha"))
def test_every_prefix_raises_where_cv2_refuses(kind):
    """Each file cut at every length from 33 bytes on (cv2 reads no WebP
    shorter than 32): where cv2 gives no image the port raises, and where
    cv2 decodes a prefix (the cut fell in a trailing chunk) the pixels are
    equal."""
    img = _image(24, 40, 13)
    if kind == "alpha":
        data = _pil(np.dstack([img, _image(24, 40, 14, ch=1)[:, :, 0]]), "RGBA", quality=70)
    else:
        data = bytes(cv2.imencode(".webp", img,
                                  [cv2.IMWRITE_WEBP_QUALITY, 101 if kind == "lossless" else 70])[1])
    data += webp_chunk(b"XMP ", b"<x/>" * 3)
    step = max(1, len(data) // 150)
    for n in list(range(33, len(data), step)) + [len(data) - 1]:
        _as_cv2(data[:n], (cv2.IMREAD_UNCHANGED,))


@pytest.mark.parametrize("seed", range(4))
def test_corrupted_bytes_decode_or_raise_as_cv2(seed):
    """Files with bytes overwritten past their headers: the port gives cv2's
    pixels where cv2 decodes, and raises where it gives no image."""
    rng = np.random.RandomState(seed)
    img = _image(20, 36, 20 + seed)
    files = [bytes(cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, q])[1])
             for q in (40, 95, 101)]
    files.append(_pil(np.dstack([img, img[:, :, 0]]), "RGBA", quality=60))
    for data in files:
        for _ in range(25):
            bad = bytearray(data)
            for _ in range(rng.randint(1, 4)):
                bad[rng.randint(20, len(bad))] = rng.randint(0, 256)
            _as_cv2(bytes(bad), (cv2.IMREAD_UNCHANGED,))


def test_imread_reads_webp(tmp_path):
    img = _image(12, 20, 5)
    for q in (60, 101):
        path = str(tmp_path / f"frame{q}.webp")
        assert cv2.imwrite(path, img, [cv2.IMWRITE_WEBP_QUALITY, q])
        for flags in FLAGS:
            want, got = cv2.imread(path, flags), imageio.imread(path, flags)
            assert got.dtype == want.dtype and np.array_equal(got, want), (q, flags)
