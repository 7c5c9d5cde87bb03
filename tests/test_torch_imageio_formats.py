"""The port's readers of the formats cv2 reads besides PNG and JPEG
(``utils/rasters.py``: BMP, PNM/PAM/PFM, Sun raster, Radiance HDR;
``utils/tiff.py``: TIFF) against ``cv2.imdecode`` (OpenCV 5.0 with
libtiff 4.7), every value equal, under ``IMREAD_COLOR``,
``IMREAD_GRAYSCALE`` and ``IMREAD_UNCHANGED``: the committed fixtures of
``tests/torch_fixtures/formats/`` (against cv2 live and against the
digests of cv2's decodes committed beside them); generated variants of
each reader's options; truncated and corrupt bodies, which raise naming the
format; unknown bytes, which give None, JPEG 2000 and AVIF, which raise
naming themselves, and WebP, which decodes as cv2 decodes it
(``tests/test_torch_webp.py`` holds the WebP reader in full); and the
stacked pair in each format through the port's ``serve._decode_pair``
against the JAX package's, and over HTTP on the CPU against the reply to a
PNG of the same pixels."""

import hashlib
import io
import json
import os
import struct
import threading
import types
import urllib.error
import urllib.request
import zlib

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import (bmp_rows, lzw_encode, write_apng, write_bmp, write_hdr, write_p6,
                        write_sun, write_tiff)
from unopticalflow_tpu_torch.utils import imageio

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures", "formats")
with open(os.path.join(FIXTURES, "expected.json")) as _f:
    EXPECTED = json.load(_f)
FLAGS = (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the suite runs in several workers on one machine's cores, where torch's
    # spinning thread pools slow each model run many times over
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def digest(a) -> str:
    h = hashlib.sha256()
    a = np.ascontiguousarray(a)
    h.update(str(a.dtype.str).encode() + str(a.shape).encode() + a.tobytes())
    return h.hexdigest()


def _cv2(data, flags):
    return cv2.imdecode(np.frombuffer(data, np.uint8), flags)


def _same(data, flags):
    want, got = _cv2(data, flags), imageio.imdecode(data, flags)
    return (want is not None and got.dtype == want.dtype and got.shape == want.shape
            and np.array_equal(got, want, equal_nan=True))


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_fixture_decodes_as_cv2(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    for flags in FLAGS:
        want = EXPECTED[name][str(flags)]
        if want.startswith("raises: "):  # cv2 leaves part of its output unset here
            with pytest.raises(ValueError, match=want[len("raises: "):]):
                imageio.imdecode(data, flags)
            continue
        assert digest(_cv2(data, flags)) == want, flags  # still cv2's decode
        got = imageio.imdecode(data, flags)
        assert digest(got) == want, flags
        assert got.flags.writeable
    png = os.path.join(FIXTURES, name.rsplit(".", 1)[0] + "_cv2.png")
    if os.path.exists(png):
        assert np.array_equal(imageio.imread(png, cv2.IMREAD_UNCHANGED),
                              imageio.imdecode(data, cv2.IMREAD_COLOR))


def _image(h, w, seed, ch=3):
    rng = np.random.RandomState(seed)
    img = cv2.GaussianBlur(rng.randint(0, 256, (h, w, ch)).astype(np.uint8), (0, 0), 2)
    img = img.reshape(h, w, ch)
    img[::4, ::5] = rng.randint(0, 256, img[::4, ::5].shape)
    return img


def _variants():
    """(name, bytes): each reader's options at odd sizes, from cv2, PIL and
    ``chip_smoke.py``'s writers."""
    from PIL import Image

    out = []
    rng = np.random.RandomState(9)
    for h, w in ((1, 1), (5, 9), (19, 34)):
        bgr = _image(h, w, h * w)
        grey = np.ascontiguousarray(bgr[:, :, 1])
        rgb = np.ascontiguousarray(bgr[:, :, ::-1])
        tag = f"{h}x{w}"
        grey16 = grey.astype(np.uint16) * 257
        for ext, img in ((".bmp", bgr), (".bmp", grey), (".ppm", bgr), (".pgm", grey),
                         (".pbm", grey), (".pam", bgr), (".pam", grey), (".ras", bgr),
                         (".ras", grey), (".tiff", bgr), (".tiff", grey), (".tiff", grey16),
                         (".pfm", bgr.astype(np.float32) / 3),
                         (".hdr", bgr.astype(np.float32) / 99)):
            out.append((f"cv2 {ext} {img.shape} {img.dtype} {tag}",
                        cv2.imencode(ext, img)[1].tobytes()))
        for mode in ("1", "L", "P", "RGB", "RGBA"):
            buf = io.BytesIO()
            Image.fromarray(rgb).convert(mode).save(buf, "BMP")
            out.append((f"PIL BMP {mode} {tag}", buf.getvalue()))
        for mode in ("1", "L", "RGB"):
            buf = io.BytesIO()
            Image.fromarray(rgb).convert(mode).save(buf, "PPM")
            out.append((f"PIL PPM {mode} {tag}", buf.getvalue()))
        for mode, comp in (("RGB", "tiff_lzw"), ("L", "packbits"), ("RGBA", "tiff_deflate"),
                           ("LA", None), ("P", None), ("1", None), ("RGB", "jpeg"),
                           ("L", "jpeg")):
            buf = io.BytesIO()
            Image.fromarray(rgb).convert(mode).save(buf, "TIFF", compression=comp)
            out.append((f"PIL TIFF {mode} {comp} {tag}", buf.getvalue()))
        for bpp in (1, 4, 8):
            idx = rng.randint(0, 1 << bpp, (h, w)).astype(np.uint8)
            if bpp == 8:
                rows = [r.tobytes() for r in idx]
            elif bpp == 4:
                pad = np.zeros((h, w + w % 2), np.uint8)
                pad[:, :w] = idx
                rows = [((r[0::2] << 4) | r[1::2]).astype(np.uint8).tobytes() for r in pad]
            else:
                rows = [np.packbits(r).tobytes() for r in idx]
            for n in {1 << bpp, 3}:
                pal = rng.randint(0, 256, (n, 3))
                for hsize in (40, 108, 12):
                    if hsize == 12 and n != 1 << bpp:
                        continue
                    out.append((f"BMP {bpp}-bit palette {n} header {hsize} {tag}",
                                write_bmp(w, h, bpp, bmp_rows(rows), pal, hsize=hsize)))
        rgb16 = rng.randint(0, 65536, (h, w, 3)).astype(np.uint16)
        for kw in ({"order": ">"}, {"big": True, "compression": 5},
                   {"tile": (16, 16), "compression": 8}, {"planar": 2, "compression": 32773},
                   {"rows_per_strip": 2, "compression": 5, "predictor": 2}):
            out.append((f"TIFF RGB {kw} {tag}", write_tiff(rgb, 2, **kw)))
            out.append((f"TIFF grey {kw} {tag}", write_tiff(grey, 1, **kw)))
            if "planar" not in kw:
                out.append((f"TIFF RGB16 {kw} {tag}", write_tiff(rgb16, 2, bps=16, **kw)))
        for o in range(1, 9):
            out.append((f"TIFF orientation {o} {tag}", write_tiff(rgb, 2, orientation=o,
                                                                 rows_per_strip=3)))
        out.append((f"HDR writer {tag}", write_hdr(bgr.astype(np.float32) / 70)))
        out.append((f"Sun writer {tag}", write_sun(bgr)))
        out.append((f"P6 writer {tag}", write_p6(bgr)))
    return out


VARIANTS = _variants()


@pytest.mark.parametrize("case", range(len(VARIANTS)), ids=[n for n, _ in VARIANTS])
def test_variant_decodes_as_cv2(case):
    name, data = VARIANTS[case]
    for flags in FLAGS:
        assert _same(data, flags), (name, flags)


def _rle8(rows, w, h):
    return write_bmp(w, h, 8, rows, [(k, 255 - k, k // 2) for k in range(256)], rle=1)


def _tag(data: bytes, tag: int, value: int) -> bytes:
    """A little-endian classic TIFF with ``tag``'s inline value replaced."""
    ifd = struct.unpack_from("<I", data, 4)[0]
    for k in range(struct.unpack_from("<H", data, ifd)[0]):
        e = ifd + 2 + 12 * k
        t, kind = struct.unpack_from("<HH", data, e)
        if t == tag:
            fmt = "<H" if kind == 3 else "<I"
            return data[:e + 8] + struct.pack(fmt, value).ljust(4, b"\0") + data[e + 12:]
    raise KeyError(tag)


def _lzw_codes(codes) -> bytes:
    """9-bit LZW codes, high bits first."""
    bits = "".join(f"{c:09b}" for c in codes)
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[k:k + 8], 2) for k in range(0, len(bits), 8))


def _corrupt():
    img = _image(6, 10, 1)
    rgb = np.ascontiguousarray(img[:, :, ::-1])
    packed = write_tiff(rgb, 2, compression=32773)
    strip = write_tiff(rgb, 2)
    # (body, the message's words, whether cv2 hands back an image: for a
    # TIFF strip libtiff reports a fault in, OpenCV gives what it read, the
    # rest zeros)
    return {
        # a strip whose byte count is short of its rows, uncompressed and PackBits
        "tiff_short_strip": (_tag(strip, 279, 100), "TIFF strip or tile holds 100 bytes", True),
        "tiff_short_packbits": (_tag(packed, 279, 20), "PackBits data: data ends", True),
        # LZW: clear, a literal, then code 300 with only entry 258 made
        "tiff_lzw_code_past_table": (_tag(write_tiff(
            rgb[:1, :2], 2, compression=7, jpeg=lambda b: _lzw_codes([256, 65, 300, 257])),
            259, 5), "an LZW code past the table", True),
        "tiff_truncated_ifd": (strip[:-40], "TIFF", False),
        # RLE8: a run of 11 in a row of 10
        "bmp_rle_run_past_row": (_rle8(bytes((11, 5, 0, 1)), 10, 2),
                                 "BMP RLE8 data: a run passes the end of its row", False),
        "bmp_rle_absolute_past_row": (_rle8(bytes((4, 1, 0, 7, 1, 2, 3, 4, 5, 6, 7, 0, 0, 1)),
                                            10, 2), "a run passes the end of its row", False),
        "bmp_rle_truncated": (_rle8(bytes((5, 5, 0)), 10, 2), "BMP RLE8 data: truncated", False),
        "bmp_truncated": (cv2.imencode(".bmp", img)[1].tobytes()[:-30], "truncated BMP", False),
        "ppm_truncated": (write_p6(img)[:-1], "truncated PNM", False),
        "pfm_truncated": (cv2.imencode(".pfm", img.astype(np.float32))[1].tobytes()[:-4],
                          "truncated PFM", False),
        "ras_truncated": (write_sun(img)[:-2], "truncated Sun raster", False),
        "hdr_truncated": (write_hdr(img.astype(np.float32) / 9)[:-3], "Radiance HDR pixel data",
                          False),
        "pam_truncated": (b"P7\nWIDTH 2\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nTUPLTYPE RGB\nENDHDR\n"
                          + bytes(11), "truncated PAM", False),
    }


CORRUPT = _corrupt()


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_corrupt_body_raises_naming_the_format(case):
    data, words, cv2_reads = CORRUPT[case]
    assert (_cv2(data, cv2.IMREAD_COLOR) is not None) == cv2_reads
    for flags in FLAGS:
        with pytest.raises(ValueError, match=words):
            imageio.imdecode(data, flags)


def test_palette_index_past_the_palette_reads_black_as_cv2():
    """cv2 reads an index past a short BMP or Sun raster palette as black
    (its palette is zero-filled), so the port reads it so too."""
    idx = np.arange(40, dtype=np.uint8).reshape(4, 10) % 9
    bmp = write_bmp(10, 4, 8, bmp_rows([r.tobytes() for r in idx]), [(9, 99, 199)] * 4)
    rows = np.zeros((4, 10), np.uint8)
    rows[:] = idx
    ras = struct.pack(">8I", 0x59A66A95, 10, 4, 8, 40, 1, 1, 12) + bytes(range(12)) \
        + rows.tobytes()
    for data in (bmp, ras):
        for flags in FLAGS:
            assert _same(data, flags)
        assert (imageio.imdecode(data)[idx >= 4] == 0).all()


def test_unknown_bytes_and_formats_not_read_yet():
    assert imageio.imdecode(b"") is None
    for data in (b"GIF89a", b"\x00\x01\x02\x03" * 8, b"P8\n1 1\n255\n\x00"):
        assert _cv2(data, cv2.IMREAD_COLOR) is None
        assert imageio.imdecode(data) is None
    # cv2's GIF, once taken for bytes of no format, decodes as cv2 decodes it
    gif = cv2.imencode(".gif", _image(8, 8, 2))[1].tobytes()
    for flags in FLAGS:
        assert _same(gif, flags)
    avif = cv2.imencode(".avif", _image(8, 8, 4))[1].tobytes()
    with pytest.raises(ValueError, match="AVIF is not a format the port reads yet"):
        imageio.imdecode(avif)
    # JPEG 2000 stubs, once refused as a format not read yet: cv2 reads no
    # image from them, and the port raises naming the fault
    jp2 = b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(40)
    for data in (jp2, b"\xff\x4f\xff\x51" + bytes(40)):
        for flags in FLAGS:
            assert _cv2(data, flags) is None
            with pytest.raises(ValueError, match="JPEG 2000: "):
                imageio.imdecode(data, flags)
    # WebP and JPEG 2000 (PIL's JP2: cv2 writes none), once refused here, now
    # decode as cv2 decodes them
    from PIL import Image

    jp2 = io.BytesIO()
    Image.fromarray(_image(8, 8, 3)).save(jp2, "JPEG2000")
    for body in (cv2.imencode(".webp", _image(8, 8, 3))[1].tobytes(), jp2.getvalue()):
        for flags in FLAGS:
            assert _same(body, flags)


def test_imread_reads_each_format(tmp_path):
    img = _image(12, 20, 5)
    for ext in (".bmp", ".ppm", ".pfm", ".ras", ".hdr", ".tif", ".pam"):
        path = str(tmp_path / f"frame{ext}")
        src = img.astype(np.float32) / 50 if ext in (".pfm", ".hdr") else img
        assert cv2.imwrite(path, src)
        for flags in FLAGS:
            want = cv2.imread(path, flags)
            if want is None:  # a grey read of a colour PFM, which cv2.imdecode makes
                assert ext == ".pfm" and flags == cv2.IMREAD_GRAYSCALE
                with pytest.raises(ValueError, match="colour PFM"):
                    imageio.imread(path, flags)
                continue
            got = imageio.imread(path, flags)
            assert got.dtype == want.dtype and np.array_equal(got, want), (ext, flags)
    path = str(tmp_path / "frame.gif")
    cv2.imwrite(path, img)
    for flags in FLAGS:
        want, got = cv2.imread(path, flags), imageio.imread(path, flags)
        assert got.dtype == want.dtype and np.array_equal(got, want), flags
    path = str(tmp_path / "frame.bin")  # bytes of no image format
    with open(path, "wb") as f:
        f.write(b"\x00\x01\x02\x03" * 8)
    with pytest.raises(ValueError, match="not an image format the port reads"):
        imageio.imread(path)


def _pil_tiff(rgb, compression) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "TIFF", compression=compression)
    return buf.getvalue()


def _pair_bodies():
    """The stacked pair (two 48x80 frames) in each new format."""
    pair = np.concatenate([_image(48, 80, 21), _image(48, 80, 22)], 0)
    rgb = np.ascontiguousarray(pair[:, :, ::-1])
    return pair, {
        "bmp": write_bmp(80, 96, 24, bmp_rows([r.tobytes() for r in pair])),
        "p6": write_p6(pair),
        "ras": write_sun(pair),
        "tiff": write_tiff(rgb, 2, rows_per_strip=16),
        "tiff_lzw": write_tiff(rgb, 2, compression=5, predictor=2, rows_per_strip=32),
        "tiff_deflate": write_tiff(rgb, 2, compression=8, predictor=2),
        "tiff_jpeg": _pil_tiff(rgb, "jpeg"),
        "hdr": write_hdr(pair.astype(np.float32) / 255),
        "pam": cv2.imencode(".pam", pair)[1].tobytes(),
        "webp": cv2.imencode(".webp", pair, [cv2.IMWRITE_WEBP_QUALITY, 80])[1].tobytes(),
        "webp_lossless": cv2.imencode(".webp", pair, [cv2.IMWRITE_WEBP_QUALITY, 101])[1].tobytes(),
        "gif": cv2.imencode(".gif", pair)[1].tobytes(),
        "apng": write_apng([(pair, 0, 0), (pair[:16, :24], 8, 4)]),
        "apng_default": write_apng([(pair[::-1], 0, 0), (pair[:16, :24], 8, 4)], default=pair),
        "png_rgba16": imageio.encode_png(np.dstack([pair, pair[:, :, :1]]).astype(np.uint16)
                                         * 255 + 255),
        "png_palette4": _palette4_png(pair),
    }


def _palette4_png(bgr) -> bytes:
    """A 4-bit palette PNG of 16 colours, each pixel's the one its grey
    level falls in."""
    from tests.test_torch_png_depths import chunk, png

    rng = np.random.RandomState(23)
    idx = (bgr.astype(np.int32).sum(2) * 16 // 766).astype(np.uint8)
    plte = chunk(b"PLTE", rng.randint(0, 256, 48).astype(np.uint8).tobytes())
    return png(bgr.shape[1], bgr.shape[0], 4, 3, idx[:, :, None], rng, 0, plte)


@pytest.mark.parametrize("fmt", sorted(_pair_bodies()[1]))
def test_decode_pair_matches_jax(fmt, monkeypatch):
    import sys

    from serve import _decode_pair as jax_decode_pair
    from unopticalflow_tpu_torch.serve import _decode_pair

    body = _pair_bodies()[1][fmt]
    want = jax_decode_pair(body, (32, 64))
    monkeypatch.setitem(sys.modules, "cv2", None)  # the port's decode needs no opencv
    got = _decode_pair(body, (32, 64))
    assert got.dtype == want.dtype and got.shape == (64, 64, 3) and np.array_equal(got, want)


def test_server_answers_each_format_as_the_png_of_its_pixels():
    from http.server import ThreadingHTTPServer

    from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig
    from unopticalflow_tpu_torch.serve import FlowServer, make_handler

    h, w = 64, 128
    _, bodies = _pair_bodies()
    model = FlowModel(FlowModelConfig(), device="cpu", scheme="pwc",
                      generator=torch.Generator().manual_seed(0))
    cfg = types.SimpleNamespace(img_hw=(h, w))
    engine = FlowServer(cfg, model, max_batch=2, max_wait_ms=5)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine, cfg))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/flow"

    def post(body):
        req = urllib.request.Request(url, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read()

    try:
        for fmt in ("bmp", "tiff_lzw", "hdr", "webp", "webp_lossless", "gif", "apng",
                    "apng_default", "png_rgba16", "png_palette4"):
            png = imageio.encode_png(imageio.imdecode(bodies[fmt]))
            assert post(bodies[fmt]) == post(png), fmt
        avif = cv2.imencode(".avif", _image(16, 16, 6))[1].tobytes()
        with pytest.raises(urllib.error.HTTPError) as err:
            post(avif)
        assert err.value.code == 400
        assert "AVIF" in json.loads(err.value.read())["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
        engine.close()
    assert not t.is_alive()


def _tiled(bps, channels, hw, tile, seed=0):
    """An uncompressed tiled TIFF of random grey or RGB samples."""
    rng = np.random.RandomState(seed)
    arr = rng.randint(0, 1 << bps, hw + (channels,)).astype(np.uint8 if bps == 8 else np.uint16)
    return write_tiff(arr, 1 if channels == 1 else 2, bps=bps, tile=tile)


@pytest.mark.parametrize("tile", [(16, 16), (32, 32)], ids=["tile16", "tile32"])
@pytest.mark.parametrize("hw", [(64, 64), (40, 56)], ids=["even", "overhang"])
@pytest.mark.parametrize("channels", [1, 3], ids=["grey", "rgb"])
@pytest.mark.parametrize("bps", [8, 16])
def test_uncompressed_tiles_decode_as_cv2_none_included(bps, channels, hw, tile):
    """cv2 gives None for an uncompressed tile that its RGBA reader (every
    read but a 16-bit ``IMREAD_UNCHANGED`` one) takes from a raw buffer of
    another size than the tile's (the byte count rounded up to 1024): 16x16
    tiles of 8- and 16-bit samples there, 32x32 tiles of 8-bit grey (1024
    bytes) or RGB (3072) not.  The port gives the same, None included."""
    data = _tiled(bps, channels, hw, tile)
    nones = 0
    for flags in FLAGS:
        want = _cv2(data, flags)
        if want is None:
            nones += 1
            assert imageio.imdecode(data, flags) is None, flags
        elif bps == 16 and channels == 1 and hw == (40, 56) and flags != cv2.IMREAD_UNCHANGED:
            # cv2's RGBA reader misplaces the rows of overhanging 16-bit grey tiles
            with pytest.raises(ValueError, match="misplaces their rows"):
                imageio.imdecode(data, flags)
        else:
            assert _same(data, flags), flags
    assert nones == (0 if tile == (32, 32) else 2 if bps == 16 else 3)


def test_decode_pair_of_refused_tiles_matches_jax(monkeypatch):
    """A stacked pair in uncompressed 16x16 tiles, which cv2 gives None for:
    the port's ``serve._decode_pair`` refuses it as the JAX server's does (a
    400 over HTTP); in 32x32 tiles both decode it, equal."""
    import sys

    from serve import _decode_pair as jax_decode_pair
    from unopticalflow_tpu_torch.serve import _decode_pair

    pair, _ = _pair_bodies()
    rgb = np.ascontiguousarray(pair[:, :, ::-1])
    refused, read = write_tiff(rgb, 2, tile=(16, 16)), write_tiff(rgb, 2, tile=(32, 32))
    with pytest.raises(ValueError) as jax_err:
        jax_decode_pair(refused, (32, 64))
    want = jax_decode_pair(read, (32, 64))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ValueError) as err:
        _decode_pair(refused, (32, 64))
    assert str(err.value) == str(jax_err.value) == "request body is not a decodable image"
    got = _decode_pair(read, (32, 64))
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_lzw_writer_round_trips_through_libtiff_and_the_port():
    """``chip_smoke.lzw_encode`` writes what libtiff reads, across the code
    width changes and a table reset (the port's LZW is held to cv2 above)."""
    rng = np.random.RandomState(7)
    for n, levels in ((300, 256), (5000, 256), (70000, 3)):
        row = rng.randint(0, levels, n).astype(np.uint8)
        data = write_tiff(row[None, :, None], 1, compression=5)
        assert lzw_encode(row.tobytes())
        for flags in FLAGS:
            assert _same(data, flags)
        assert np.array_equal(imageio.imdecode(data, cv2.IMREAD_GRAYSCALE)[0], row)


def test_single_image_depth_reads_each_format(tmp_path, monkeypatch):
    """``depth_harness.test_single_image`` (cv2 blocked) on a frame stored in
    each new format gives what it gives on a PNG of the frame's decoded pixels."""
    import sys

    from unopticalflow_tpu_torch.evaluation import depth_harness

    frame = _image(40, 72, 31)
    bodies = {"bmp": write_bmp(72, 40, 24, bmp_rows([r.tobytes() for r in frame])),
              "ppm": write_p6(frame), "ras": write_sun(frame),
              "tif": write_tiff(np.ascontiguousarray(frame[:, :, ::-1]), 2, compression=5),
              "hdr": write_hdr(frame.astype(np.float32) / 255),
              "webp": cv2.imencode(".webp", frame, [cv2.IMWRITE_WEBP_QUALITY, 90])[1].tobytes()}

    def infer_disp(images):  # a disparity that follows the frame's pixels
        return 0.05 + 0.3 * images.mean(axis=-1, keepdims=True)

    monkeypatch.setitem(sys.modules, "cv2", None)
    for ext, body in bodies.items():
        path = tmp_path / f"frame.{ext}"
        path.write_bytes(body)
        png = tmp_path / f"frame_{ext}.png"
        png.write_bytes(imageio.encode_png(imageio.imdecode(body)))
        got = depth_harness.test_single_image(str(path), infer_disp, (32, 64),
                                              save_dir=str(tmp_path / ext))
        want = depth_harness.test_single_image(str(png), infer_disp, (32, 64),
                                               save_dir=str(tmp_path / f"{ext}_png"))
        assert got[0].shape == (40, 72) and all(np.array_equal(a, b) for a, b in zip(got, want))


def _rle_stream(rng, w, h, rle4):
    """A random RLE8 / RLE4 stream: encoded and absolute runs (now and then
    one past the row), end-of-line, delta and end-of-bitmap codes."""
    out, x = bytearray(), 0
    for _ in range(rng.randint(1, 40)):
        op = rng.rand()
        if op < 0.4:
            n = rng.randint(1, max(1, w - x + (rng.rand() < 0.1)) + 1)
            out += bytes((n, rng.randint(0, 256)))
            x += n
        elif op < 0.7:
            n = rng.randint(3, max(3, w - x + (rng.rand() < 0.1)) + 1)
            body = rng.randint(0, 256, (n + 1) // 2 if rle4 else n).tolist()
            out += bytes((0, n)) + bytes(body) + bytes(len(body) % 2)
            x += n
        elif op < 0.85:
            out += bytes((0, 0))
            x = 0
        elif op < 0.95:
            dx = rng.randint(0, 4)
            out += bytes((0, 2, dx, rng.randint(0, 3)))
            x += dx
        else:
            break
    if rng.rand() < 0.8:
        out += bytes((0, 1))
    return bytes(out)


@pytest.mark.parametrize("seed", range(8))
def test_fuzzed_bmp_rle_streams_decode_as_cv2(seed):
    """Random RLE8 and RLE4 streams: where cv2 decodes one, the port gives
    the same pixels under every flag; where cv2 gives no image, it raises."""
    rng = np.random.RandomState(seed)
    for _ in range(60):
        w, h, rle4 = rng.randint(1, 13), rng.randint(1, 6), rng.rand() < 0.5
        pal = rng.randint(0, 256, (rng.choice([16 if rle4 else 256, 3]), 3))
        if rng.rand() < 0.2:
            pal[:, 1:] = pal[:, :1]  # a palette of greys: a one-channel image
        data = write_bmp(w, h, 4 if rle4 else 8, _rle_stream(rng, w, h, rle4), pal,
                         rle=2 if rle4 else 1)
        if _cv2(data, cv2.IMREAD_COLOR) is None:
            with pytest.raises(ValueError, match="BMP RLE"):
                imageio.imdecode(data)
            continue
        for flags in FLAGS:
            assert _same(data, flags), (seed, flags, data.hex())


def _with_chunks(data: bytes, chunks) -> bytes:
    """A PNG with ``chunks`` ((type, body), ...) put after its IHDR."""
    return data[:33] + b"".join(imageio._chunk(k, b) for k, b in chunks) + data[33:]


def _srgb_profile() -> bytes:
    from PIL import ImageCms

    return ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()


def _gamma22_profile() -> bytes:
    """A minimal ICC v2 RGB display profile whose three curves are a gamma
    of 2.2 (D50 white point, sRGB's primaries adapted to D50)."""
    def s15(v):
        return struct.pack(">i", int(round(v * 65536)))

    def xyz(x, y, z):
        return b"XYZ " + bytes(4) + s15(x) + s15(y) + s15(z)

    curve = b"curv" + bytes(4) + struct.pack(">IH", 1, int(2.2 * 256)) + b"\0\0"
    tags = [(b"wtpt", xyz(0.9642, 1.0, 0.8249)), (b"rXYZ", xyz(0.4361, 0.2225, 0.0139)),
            (b"gXYZ", xyz(0.3851, 0.7169, 0.0971)), (b"bXYZ", xyz(0.1431, 0.0606, 0.7141)),
            (b"rTRC", curve), (b"gTRC", curve), (b"bTRC", curve),
            (b"desc", b"desc" + bytes(4) + struct.pack(">I", 4) + b"g22\0" + bytes(79)),
            (b"cprt", b"text" + bytes(4) + b"none\0")]
    table, data, offset = b"", b"", 128 + 4 + 12 * len(tags)
    for sig, body in tags:
        data += bytes(-(offset + len(data)) % 4)
        table += sig + struct.pack(">II", offset + len(data), len(body))
        data += body
    body = struct.pack(">I", len(tags)) + table + data
    head = (struct.pack(">I", 128 + len(body)) + b"lcms" + bytes([2, 0x10, 0, 0]) + b"mntrRGB XYZ "
            + bytes(12) + b"acspAPPL" + bytes(24) + s15(0.9642) + s15(1.0) + s15(0.8249)
            + b"lcms" + bytes(44))
    return head + body


_GAMMA_CHUNKS = {
    "gAMA_45455": [(b"gAMA", struct.pack(">I", 45455))],
    "gAMA_50000": [(b"gAMA", struct.pack(">I", 50000))],
    "gAMA_30000": [(b"gAMA", struct.pack(">I", 30000))],
    "gAMA_220000": [(b"gAMA", struct.pack(">I", 220000))],
    "gAMA_100000": [(b"gAMA", struct.pack(">I", 100000))],  # 1.0: no tables
    "gAMA_97000": [(b"gAMA", struct.pack(">I", 97000))],  # within libpng's threshold of 1.0
    "gAMA_0": [(b"gAMA", struct.pack(">I", 0))],  # out of range: ignored
    "gAMA_twice": [(b"gAMA", struct.pack(">I", 50000)), (b"gAMA", struct.pack(">I", 45455))],
    "sRGB": [(b"sRGB", b"\0")],
    "sRGB_over_gAMA": [(b"gAMA", struct.pack(">I", 80000)), (b"sRGB", b"\1")],
    "cHRM": [(b"cHRM", struct.pack(">8I", 31270, 32900, 64000, 33000, 30000, 60000, 15000,
                                   6000))],
    "iCCP_srgb_lcms": "icc",  # an sRGB profile libpng does not know by its checksum
    "iCCP_gamma22": "icc22",  # a valid profile of gamma 2.2 curves
    "iCCP_too_short": [(b"iCCP", b"x\0\0" + zlib.compress(b"short"))],
}


@pytest.mark.parametrize("chunks", sorted(_GAMMA_CHUNKS))
@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "palette8", "rgb16"])
def test_png_grey_read_with_colour_chunks_as_cv2(kind, chunks):
    """``IMREAD_GRAYSCALE`` of a colour PNG with colour-space chunks: libpng
    converts through its gamma tables in linear light where the file gamma
    (``gAMA``, or sRGB's for an ``sRGB`` chunk) is other than 1.0, and as
    plainly as without the chunks otherwise; every value as cv2's, the other
    flags unchanged."""
    rng = np.random.RandomState(sorted(_GAMMA_CHUNKS).index(chunks))
    h, w = 19, 41
    if kind == "palette8":
        pal = rng.randint(0, 256, (40, 3)).astype(np.uint8)
        pal[:5] = pal[:5, :1]  # grey entries
        rows = imageio._filter_rows(rng.randint(0, 40, (h, w)).astype(np.uint8), 1)
        data = (imageio._PNG_MAGIC
                + imageio._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
                + imageio._chunk(b"PLTE", pal.tobytes())
                + imageio._chunk(b"tRNS", bytes(range(0, 200, 10)))
                + imageio._chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + imageio._chunk(b"IEND", b""))
    else:
        ch, top = (4, 256) if kind == "rgba8" else (3, 256 if kind == "rgb8" else 65536)
        img = rng.randint(0, top, (h, w, ch)).astype(np.uint8 if top == 256 else np.uint16)
        img[:4, :, :3] = img[:4, :, :1]  # pixels of three equal samples
        data = imageio.encode_png(img)
    spec = _GAMMA_CHUNKS[chunks]
    if spec == "icc":
        spec = [(b"iCCP", b"sRGB\0\0" + zlib.compress(_srgb_profile()))]
    elif spec == "icc22":
        spec = [(b"iCCP", b"g22\0\0" + zlib.compress(_gamma22_profile()))]
    managed = _with_chunks(data, spec)
    for flags in FLAGS:
        assert _same(managed, flags), flags
    plain = chunks in ("gAMA_100000", "gAMA_97000", "gAMA_0", "cHRM", "iCCP_srgb_lcms",
                       "iCCP_gamma22", "iCCP_too_short")
    assert np.array_equal(_cv2(managed, cv2.IMREAD_GRAYSCALE),
                          _cv2(data, cv2.IMREAD_GRAYSCALE)) == plain


def test_png_grey_read_with_a_known_srgb_profile_length_raises():
    """An ``iCCP`` profile as long as one libpng recognises as sRGB by its
    checksum (libpng then converts with sRGB's gamma; the port cannot tell
    the profiles apart): the grey read of a colour file raises, the others
    decode."""
    colour = np.random.RandomState(2).randint(0, 256, (3, 5, 3)).astype(np.uint8)
    profile = bytes(128) + bytes(3024 - 128)
    managed = _with_chunks(imageio.encode_png(colour),
                           [(b"iCCP", b"x\0\0" + zlib.compress(profile))])
    with pytest.raises(ValueError, match="iCCP profile of 3024 bytes"):
        imageio.imdecode(managed, cv2.IMREAD_GRAYSCALE)
    assert np.array_equal(imageio.imdecode(managed), colour)


@pytest.mark.parametrize("compression", [1, 5, 8, 32773], ids=["none", "lzw", "deflate",
                                                                "packbits"])
@pytest.mark.parametrize("hw_tile", [((6, 4), (32, 16)), ((40, 24), (32, 32)),
                                     ((17, 33), (32, 16)), ((70, 50), (48, 48)),
                                     ((64, 64), (32, 32))],
                         ids=["one_tile", "clipped_right", "clipped_both", "clipped_48",
                              "whole_tiles"])
@pytest.mark.parametrize("bps", [8, 16])
def test_grey_and_alpha_tiles_decode_as_cv2(bps, hw_tile, compression):
    """Grey and alpha (ExtraSamples 0, 1 and 2) in tiles: at 8 bits the
    tiles clipped on the right read as libtiff's RGBA reader reads them for
    cv2 (the hidden columns stepped over as one sample each), every value
    equal; 16-bit grey tiles that overhang raise naming the fault (as
    before); uncompressed tiles libtiff refuses give None."""
    (h, w), tile = hw_tile
    rng = np.random.RandomState(h * w + compression)
    for extra in ([0], [1], [2]):
        arr = rng.randint(0, 1 << bps, (h, w, 2)).astype(np.uint8 if bps == 8 else np.uint16)
        data = write_tiff(arr, 1, bps=bps, tile=tile, compression=compression, extra=extra)
        for flags in FLAGS:
            want = _cv2(data, flags)
            if want is None:
                assert imageio.imdecode(data, flags) is None, flags
            elif bps == 16 and (flags == cv2.IMREAD_UNCHANGED or w % tile[0] or h % tile[1]):
                with pytest.raises(ValueError, match="16-bit grey"):
                    imageio.imdecode(data, flags)
            else:
                assert _same(data, flags), (extra, flags)


def test_grey_and_alpha_tiles_mirrored_by_orientation_raise():
    """8-bit grey and alpha tiles clipped on the right, in a file whose
    Orientation mirrors the columns (2, 3, 6, 7): libtiff's reader reads
    them otherwise than the port repeats, so the port raises; without the
    mirror (4, 5, 8) and without clipping they decode as cv2's."""
    rng = np.random.RandomState(4)
    arr = rng.randint(0, 256, (17, 33, 2)).astype(np.uint8)
    whole = rng.randint(0, 256, (17, 32, 2)).astype(np.uint8)
    for orientation in range(2, 9):
        data = write_tiff(arr, 1, tile=(32, 16), extra=[2], orientation=orientation)
        if orientation in (2, 3, 6, 7):
            with pytest.raises(ValueError, match="mirrors the columns"):
                imageio.imdecode(data)
        else:
            assert all(_same(data, f) for f in FLAGS), orientation
        data = write_tiff(whole, 1, tile=(32, 16), extra=[2], orientation=orientation)
        assert all(_same(data, f) for f in FLAGS), orientation


@pytest.mark.parametrize("compression", [1, 32773, 5, 8])
def test_predictor_applies_after_lzw_and_deflate_only(compression):
    """Predictor 2 is undone after LZW and Deflate, as libtiff's codecs undo
    it; with no compression or PackBits libtiff ignores the tag, and so does
    the port."""
    rng = np.random.RandomState(compression)
    arr = rng.randint(0, 256, (9, 14, 3)).astype(np.uint8)
    data = write_tiff(arr, 2, compression=compression, predictor=2, rows_per_strip=4)
    for flags in FLAGS:
        assert _same(data, flags), flags


GREY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures", "grey")
with open(os.path.join(GREY_DIR, "expected.json")) as _f:
    GREY_EXPECTED = json.load(_f)


@pytest.mark.parametrize("name", sorted(GREY_EXPECTED))
def test_grey_fixture_decodes_as_cv2(name):
    """``tests/torch_fixtures/grey/`` (the colour PNGs read as grey through
    libpng's gamma tables and the grey-and-alpha TIFF tiles chip_smoke.py
    phase 17 checks): each flag's decode against cv2's, live and by the
    committed digest, or the port's raise where it raises by design."""
    with open(os.path.join(GREY_DIR, name), "rb") as f:
        data = f.read()
    for flags, want in GREY_EXPECTED[name].items():
        if want.startswith("raises: "):
            with pytest.raises(ValueError, match=want[len("raises: "):]):
                imageio.imdecode(data, int(flags))
            continue
        assert _same(data, int(flags)), flags
        assert digest(imageio.imdecode(data, int(flags))) == want, flags
