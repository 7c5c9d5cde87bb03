"""The port's baseline JPEG encoder (``csrc/jpeg_enc.c`` through
``utils/imageio.encode_jpeg``) against the files PIL and cv2 write with
libjpeg-turbo's defaults, byte for byte: PIL's default ``save(f, "JPEG")``
of an RGB image and ``cv2.imencode(".jpg", bgr, [IMWRITE_JPEG_QUALITY, q])``
at qualities 1 to 100, at 1x1, 17x31 and 256x832 and sizes that end inside
an MCU in either direction, on noise, smooth and flat images; the port's
decoder and cv2 reading the file back alike; ``VisualizerDebug.
save_disp_color_img`` writing the JAX package's ``<name>_depth.jpg``, the
same bytes; and the committed magma fixture."""

import io
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from unopticalflow_tpu_torch.utils import imageio

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures", "jpeg")
SIZES = [(1, 1), (17, 31), (256, 832), (8, 8), (16, 16), (9, 33), (31, 17), (2, 50)]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(h, w, seed):
    rng = np.random.RandomState(seed)
    noise = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    smooth = cv2.GaussianBlur(noise, (0, 0), 2) if min(h, w) > 2 else noise // 2
    flat = np.full((h, w, 3), (255, 0, 37), np.uint8)  # saturated channels
    return {"noise": noise, "smooth": smooth, "flat": flat}


def _pil(rgb, **kwargs):
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", **kwargs)
    return buf.getvalue()


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_equals_pil_and_cv2(size):
    for kind, rgb in _images(*size, seed=size[0] + 3 * size[1]).items():
        bgr = np.ascontiguousarray(rgb[:, :, ::-1])
        got = imageio.encode_jpeg(bgr)
        assert got == _pil(rgb), kind  # PIL's default: quality 75, 4:2:0
        for quality in (1, 10, 50, 75, 90, 100):
            want = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
            assert imageio.encode_jpeg(bgr, quality) == want, (kind, quality)
            assert want == _pil(rgb, quality=quality), (kind, quality)
        # both decoders read the file back alike
        data = np.frombuffer(got, np.uint8)
        assert np.array_equal(imageio.decode_jpeg(got), cv2.imdecode(data, cv2.IMREAD_COLOR))


def test_encode_checks_its_input():
    with pytest.raises(ValueError, match="takes \\(H, W, 3\\) uint8"):
        imageio.encode_jpeg(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="takes \\(H, W, 3\\) uint8"):
        imageio.encode_jpeg(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="each side must be 1 to 65535"):
        imageio.encode_jpeg(np.zeros((0, 4, 3), np.uint8))
    # a strided view is copied, not read past its rows
    big = np.random.RandomState(0).randint(0, 256, (20, 40, 3)).astype(np.uint8)
    assert imageio.encode_jpeg(big[::2, 5:30]) == imageio.encode_jpeg(big[::2, 5:30].copy())


def test_disp_color_img_writes_the_jax_packages_jpeg(tmp_path):
    from unopticalflow_tpu.utils.visualizer import VisualizerDebug as JaxVisualizerDebug
    from unopticalflow_tpu_torch.utils.visualizer import VisualizerDebug

    rng = np.random.RandomState(7)
    disps = [rng.rand(8, 8), rng.rand(30, 50) * 0.3 + 0.01, np.full((4, 6), 0.5),
             np.linspace(-1, 1, 64).reshape(8, 8), rng.rand(1, 1)]
    port = VisualizerDebug(str(tmp_path / "p"))
    ref = JaxVisualizerDebug(str(tmp_path / "j"))
    for k, d in enumerate(disps):
        path = port.save_disp_color_img(d, f"d{k}")
        ref.save_disp_color_img(d, f"d{k}")
        assert path == str(tmp_path / "p" / f"d{k}_depth.jpg")
        assert (tmp_path / "p" / f"d{k}_depth.jpg").read_bytes() == \
            (tmp_path / "j" / f"d{k}_depth.jpg").read_bytes(), k
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))


def test_committed_magma_fixture():
    """``disp_magma.png`` holds the magma pixels the JAX package handed PIL;
    ``disp_magma_q75.jpg`` is PIL's file of them."""
    bgr = imageio.imread(os.path.join(FIXTURES, "disp_magma.png"))
    with open(os.path.join(FIXTURES, "disp_magma_q75.jpg"), "rb") as f:
        want = f.read()
    assert _pil(np.ascontiguousarray(bgr[:, :, ::-1])) == want  # still PIL's file
    assert imageio.encode_jpeg(bgr) == want
