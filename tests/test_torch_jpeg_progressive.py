"""The port's progressive JPEG decoding (``csrc/jpeg.c`` through
``utils/imageio.py``) against ``cv2.imdecode`` (OpenCV 5.0 with
libjpeg-turbo 3.1), bit for bit, on files cv2 and PIL write from a seed:
4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1 and grey at qualities 10, 75 and 100,
with and without a restart interval, at 1x1, 17x31 and 48x64, under the
three flags; PIL's progressive file; every progression cut short after
each of its scans, which libjpeg decodes with its block smoothing, at
every sampling, with and without a restart interval; the committed
progressive fixtures and every cut of them; and the server's
reply over HTTP on the CPU to a progressive pair equal to its reply to the
baseline pair of the same pixels."""

import glob
import io
import os
import threading
import types
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from unopticalflow_tpu_torch.utils import imageio

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures", "jpeg")
SAMPLINGS = ("444", "422", "420", "440", "411", "grey")
FLAGS = (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the suite runs in several workers on one machine's cores, where torch's
    # spinning thread pools (one thread a core in every worker) slow each
    # model run many times over
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _image(h, w, seed):
    """Half smooth, half noise: the noise drives the IDCT to its range limits."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    if min(h, w) > 8:
        img[:, : w // 2] = cv2.GaussianBlur(img, (0, 0), 3)[:, : w // 2]
    return img


def _progressive(img, sampling, quality, restart=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if sampling == "grey":
        img = np.ascontiguousarray(img[:, :, 1])
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]
    ok, data = cv2.imencode(".jpg", img, params)
    assert ok
    return data.tobytes()


def _scans(data: bytes) -> list[int]:
    """The offsets of a JPEG's scan headers."""
    pos, out = 2, []
    while data[pos + 1] != 0xD9:
        marker, n = data[pos + 1], int.from_bytes(data[pos + 2:pos + 4], "big")
        pos += 2 + n
        if marker == 0xDA:
            out.append(pos - 2 - n)
            while not (data[pos] == 0xFF and data[pos + 1] not in (0, *range(0xD0, 0xD8))):
                pos += 1
    return out


def _same_as_cv2(data, flags):
    want = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
    got = imageio.decode_jpeg(data, flags)
    return got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("size", [(1, 1), (17, 31), (48, 64)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_progressive_decode_equals_cv2(sampling, size):
    img = _image(*size, seed=size[0] * 7 + size[1])
    for quality in (10, 75, 100):
        for restart in (0, 2):
            data = _progressive(img, sampling, quality, restart)
            assert b"\xff\xc2" in data and len(_scans(data)) > 1  # SOF2, several scans
            for flags in FLAGS:
                assert _same_as_cv2(data, flags), (quality, restart, flags)


def test_pil_progressive_decodes_as_cv2():
    from PIL import Image

    for k, (h, w) in enumerate([(1, 1), (17, 31), (48, 64)]):
        rgb = _image(h, w, seed=40 + k)
        for kwargs in ({}, {"quality": 95, "subsampling": 0}, {"quality": 20, "subsampling": 1}):
            buf = io.BytesIO()
            Image.fromarray(rgb).save(buf, "JPEG", progressive=True, **kwargs)
            for flags in FLAGS:
                assert _same_as_cv2(buf.getvalue(), flags), (h, w, kwargs, flags)


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_cut_progressions_decode_as_cv2_or_raise(sampling):
    """A progressive file ended after each of its scans decodes as cv2
    decodes it: where a component's DC is known and one of its first ten
    coefficients unrefined, through libjpeg's block smoothing (its AC
    estimates from the 5x5 DC neighbourhood, and its DC estimate where no
    AC data came), at odd sizes, with and without a restart interval."""
    for size, restart in (((24, 40), 0), ((17, 31), 2), ((33, 65), 0)):
        data = _progressive(_image(*size, seed=3), sampling, 80, restart)
        scans = _scans(data)
        for k in range(1, len(scans) + 1):
            cut = data[:scans[k]] + b"\xff\xd9" if k < len(scans) else data
            for flags in FLAGS:
                assert _same_as_cv2(cut, flags), (size, restart, k, flags)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(FIXTURES, "*prog*.jpg"))),
                         ids=lambda p: os.path.basename(p))
def test_committed_progressive_fixtures(path):
    with open(path, "rb") as f:
        data = f.read()
    name = os.path.basename(path)[:-4]
    png = os.path.join(FIXTURES, "pair_512x832.png" if name.startswith("pair_") else
                       name + ".png")
    want = imageio.imread(png)
    assert np.array_equal(want, cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    assert np.array_equal(imageio.decode_jpeg(data), want)
    assert _same_as_cv2(data, cv2.IMREAD_GRAYSCALE) and _same_as_cv2(data, -1)
    scans = _scans(data)  # and every cut of it
    for k in range(1, len(scans)):
        cut = data[:scans[k]] + b"\xff\xd9"
        for flags in FLAGS:
            assert _same_as_cv2(cut, flags), (k, flags)


def test_server_answers_a_progressive_pair_as_the_baseline_pair():
    from http.server import ThreadingHTTPServer

    from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig
    from unopticalflow_tpu_torch.serve import FlowServer, make_handler

    h, w = 64, 128
    pair = np.concatenate([_image(64, 128, seed=11), _image(64, 128, seed=12)], 0)
    quality = [cv2.IMWRITE_JPEG_QUALITY, 90]
    base = cv2.imencode(".jpg", pair, quality)[1].tobytes()
    prog = cv2.imencode(".jpg", pair, quality + [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    assert np.array_equal(imageio.decode_jpeg(base), imageio.decode_jpeg(prog))
    model = FlowModel(FlowModelConfig(), device="cpu", scheme="pwc",
                      generator=torch.Generator().manual_seed(0))
    cfg = types.SimpleNamespace(img_hw=(h, w))
    engine = FlowServer(cfg, model, max_batch=2, max_wait_ms=5)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine, cfg))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/flow"
        replies = []
        for body in (base, prog):
            req = urllib.request.Request(url, data=body, method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                replies.append(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
        engine.close()
    assert not t.is_alive()
    assert len(replies[0]) == 12 + h * w * 2 * 4 and replies[0] == replies[1]
