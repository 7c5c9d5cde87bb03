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

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import (bmp_rows, lzw_encode, write_bmp, write_hdr, write_p6, write_sun,
                        write_tiff)
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
    for data in (b"", b"GIF89a", cv2.imencode(".gif", _image(8, 8, 2))[1].tobytes(),
                 b"\x00\x01\x02\x03" * 8, b"P8\n1 1\n255\n\x00"):
        assert imageio.imdecode(data) is None
    avif = cv2.imencode(".avif", _image(8, 8, 4))[1].tobytes()
    jp2 = b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(40)
    for name, data in (("AVIF", avif), ("JPEG 2000", jp2),
                       ("JPEG 2000", b"\xff\x4f\xff\x51" + bytes(40))):
        with pytest.raises(ValueError, match=f"{name} is not a format the port reads yet"):
            imageio.imdecode(data)
    # WebP, once refused here, now decodes as cv2 decodes it
    webp = cv2.imencode(".webp", _image(8, 8, 3))[1].tobytes()
    for flags in FLAGS:
        assert _same(webp, flags)


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
    }


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
        for fmt in ("bmp", "tiff_lzw", "hdr", "webp", "webp_lossless"):
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
