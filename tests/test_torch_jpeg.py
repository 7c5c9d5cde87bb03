"""The port's JPEG decoder (``csrc/jpeg.c`` through ``utils/imageio.py``)
against ``cv2.imdecode`` (written against OpenCV 5.0 with libjpeg-turbo
3.1), bit for bit, on files cv2 writes from a seed: every sampling (4:4:4, 4:2:2, 4:2:0,
4:4:0, 4:1:1, grey) at sizes from 1x1 to 375x1242, qualities 10 to 100,
with and without a restart interval and optimised Huffman tables, under
each of the three flags; the eight Exif orientations; a progressive file
(``tests/test_torch_jpeg_progressive.py`` holds the progressive decoder to
cv2 at length) and refusals; ``imread`` of a ``.jpg``; the server's decode
of a JPEG pair against the JAX ``serve._decode_pair`` and its reply over
HTTP on the CPU, to a baseline and a progressive body, and its 400 for a
progression cut short; and the committed fixtures of
``tests/torch_fixtures/jpeg/``."""

import glob
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

from unopticalflow_tpu_torch.utils import imageio

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures", "jpeg")
SAMPLINGS = ("444", "422", "420", "440", "411", "grey")
SIZES = ((1, 1), (17, 31), (256, 832), (375, 1242))
QUALITIES = (10, 50, 75, 90, 100)
OPTIONS = ((), (cv2.IMWRITE_JPEG_RST_INTERVAL, 3), (cv2.IMWRITE_JPEG_OPTIMIZE, 1))
FLAGS = (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the suite runs in several workers on one machine's cores, where torch's
    # spinning thread pools (one thread a core in every worker) made the model
    # runs here up to ~70 times slower than alone (a 7 s test took 504 s)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _image(h, w, seed):
    """Half smooth, half noise: the noise drives the IDCT to its range limits."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    if min(h, w) > 8:
        smooth = cv2.GaussianBlur(img, (0, 0), 3)
        img[:, : w // 2] = smooth[:, : w // 2]
    return img


def _encode(img, sampling, quality, option):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, *option]
    if sampling == "grey":
        img = np.ascontiguousarray(img[:, :, 1])
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]
    ok, data = cv2.imencode(".jpg", img, params)
    assert ok
    return data.tobytes()


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_decode_equals_cv2(sampling, size):
    img = _image(*size, seed=size[0] + size[1])
    big = size[0] * size[1] > 100_000
    for quality in (QUALITIES[::2] if big else QUALITIES):  # fewer large files
        for option in OPTIONS:
            data = _encode(img, sampling, quality, option)
            for flags in FLAGS:
                want = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
                got = imageio.decode_jpeg(data, flags)
                assert got.dtype == np.uint8 and got.shape == want.shape, (quality, option, flags)
                assert np.array_equal(got, want), (quality, option, flags)


def _exif(orientation: int, order: str) -> bytes:
    tiff = ({"<": b"II", ">": b"MM"}[order] + struct.pack(order + "HI", 42, 8)
            + struct.pack(order + "H", 2)
            + struct.pack(order + "HHII", 0x010F, 2, 4, 0)  # Make: another tag first
            + struct.pack(order + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(order + "I", 0))
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_equals_cv2(orientation):
    """cv2 turns the image under IMREAD_COLOR and IMREAD_GRAYSCALE, not under
    IMREAD_UNCHANGED; the APP1 segment goes after JFIF's APP0 or before it."""
    img = _image(23, 41, seed=orientation)
    for sampling in ("420", "grey"):
        data = _encode(img, sampling, 90, ())
        for order in "<>":
            for at in (2, 20):  # before the APP0 segment, and after it
                body = data[:at] + _exif(orientation, order) + data[at:]
                for flags in FLAGS:
                    want = cv2.imdecode(np.frombuffer(body, np.uint8), flags)
                    got = imageio.decode_jpeg(body, flags)
                    assert got.shape == want.shape and np.array_equal(got, want), \
                        (sampling, order, at, flags)


def test_refusals():
    img = _image(32, 48, seed=5)
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    for flags in FLAGS:  # a progressive file decodes as cv2 decodes it
        assert np.array_equal(imageio.decode_jpeg(prog.tobytes(), flags),
                              cv2.imdecode(prog, flags))
    data = _encode(img, "420", 90, ())
    for cut in (len(data) // 2, len(data) - 2, 200, 3):
        with pytest.raises(ValueError, match="truncated"):
            imageio.decode_jpeg(data[:cut])
    # a 12-bit frame header, an arithmetic-coded one, and a CMYK one
    sof = data.index(b"\xff\xc0")
    twelve = data[:sof + 4] + b"\x0c" + data[sof + 5:]
    with pytest.raises(ValueError, match="12-bit JPEG"):
        imageio.decode_jpeg(twelve)
    with pytest.raises(ValueError, match="arithmetic-coded JPEG"):
        imageio.decode_jpeg(data[:sof + 1] + b"\xc9" + data[sof + 2:])
    with pytest.raises(ValueError, match="lossless JPEG"):
        imageio.decode_jpeg(data[:sof + 1] + b"\xc3" + data[sof + 2:])
    cmyk = bytearray(data)
    cmyk[sof + 9] = 4
    with pytest.raises(ValueError, match="CMYK"):
        imageio.decode_jpeg(bytes(cmyk))
    # a Huffman table with more codes of a length than the length holds (five
    # 1-bit codes) is refused before it fills the decoder's lookup table
    dht = data.index(b"\xff\xc4")
    bad = bytearray(data)
    bad[dht + 5:dht + 7] = bytes([5, 0])
    with pytest.raises(ValueError, match="bad Huffman table"):
        imageio.decode_jpeg(bytes(bad))
    huge = bytearray(data)
    huge[sof + 5:sof + 9] = bytes([0xFF, 0xFF, 0xFF, 0xFF])  # 65535 x 65535
    with pytest.raises(ValueError, match="larger than 2\*\*30 pixels"):
        imageio.decode_jpeg(bytes(huge))
    with pytest.raises(ValueError, match="not a JPEG"):
        imageio.decode_jpeg(b"\x00\x01")
    assert imageio.imdecode(b"GIF89a") is None


def test_imread_reads_jpg(tmp_path):
    img = _image(40, 72, seed=7)
    data = _encode(img, "422", 80, ())
    path = tmp_path / "frame.jpg"
    path.write_bytes(data)
    for flags in FLAGS:
        assert np.array_equal(imageio.imread(str(path), flags), cv2.imread(str(path), flags))
    other = tmp_path / "frame.bmp"
    cv2.imwrite(str(other), img)
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        imageio.imread(str(other))
    assert imageio.imread(str(tmp_path / "missing.jpg")) is None


def test_server_decodes_a_jpeg_pair_as_jax_and_answers_it(monkeypatch):
    import sys
    from http.server import ThreadingHTTPServer

    from serve import _decode_pair as jax_decode_pair
    from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig
    from unopticalflow_tpu_torch.serve import FlowServer, _decode_pair, make_handler

    h, w = 64, 128
    pair = np.concatenate([_image(96, 160, seed=8), _image(96, 160, seed=9)], 0)
    body = _encode(pair, "420", 90, ())
    want = jax_decode_pair(body, (h, w))
    prog = _encode(pair, "420", 90, (cv2.IMWRITE_JPEG_PROGRESSIVE, 1))
    want_prog = jax_decode_pair(prog, (h, w))
    monkeypatch.setitem(sys.modules, "cv2", None)  # the port's decode needs no opencv
    got = _decode_pair(body, (h, w))
    assert got.dtype == want.dtype and np.array_equal(got, want)

    model = FlowModel(FlowModelConfig(), device="cpu", scheme="pwc",
                      generator=torch.Generator().manual_seed(0))
    cfg = types.SimpleNamespace(img_hw=(h, w))
    engine = FlowServer(cfg, model, max_batch=2, max_wait_ms=5)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine, cfg))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/flow"
        with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"),
                                    timeout=120) as r:
            reply = r.read()
        flow = np.frombuffer(reply[12:], np.float32).reshape(h, w, 2)
        assert np.array_equal(flow, engine.infer(want))
        # a progressive body is answered as the JAX server answers it, and a
        # progression cut short (which libjpeg smooths) gets a 400 naming why
        with urllib.request.urlopen(urllib.request.Request(url, data=prog, method="POST"),
                                    timeout=120) as r:
            flow = np.frombuffer(r.read()[12:], np.float32).reshape(h, w, 2)
        assert np.array_equal(flow, engine.infer(want_prog))
        with open(os.path.join(FIXTURES, "prog_cut3.jpg"), "rb") as f:
            cut = f.read()
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(urllib.request.Request(url, data=cut, method="POST"),
                                   timeout=60)
        assert err.value.code == 400
        assert "block smoothing" in json.loads(err.value.read())["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
        engine.close()


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(FIXTURES, "*.jpg"))),
                         ids=lambda p: os.path.basename(p))
def test_committed_fixtures_decode_to_their_pngs(path):
    with open(path, "rb") as f:
        data = f.read()
    name = os.path.basename(path)[:-4]
    if name == "disp_magma_q75":  # PIL's JPEG of disp_magma.png (test_torch_jpeg_encode.py)
        return
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    png = imageio.imread(os.path.join(FIXTURES, "pair_512x832.png") if name.startswith(
        "pair_512x832_") else path[:-4] + ".png")
    assert np.array_equal(png, want)  # the fixture is still cv2's decode
    if name == "prog_cut3":  # libjpeg smooths the blocks of a cut progression
        with pytest.raises(ValueError, match="block smoothing"):
            imageio.decode_jpeg(data)
        return
    assert np.array_equal(imageio.decode_jpeg(data), png)
