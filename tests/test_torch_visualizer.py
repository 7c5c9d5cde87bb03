"""The port's ``VisualizerDebug`` writers against the JAX package's (CPU):
``save_img``, ``show_mask``, ``save_depth_img`` and ``save_flow_img`` write
files pixel-equal to the ones the JAX package writes with cv2 (float images
rounded and saturated as cv2 stores them), and ``save_disp_color_img``
writes, under the JAX package's name, the JPEG PIL writes of the pixels the
JAX package hands it: the same bytes.  The magma table equals
``matplotlib.cm.magma``."""

import os

import cv2
import matplotlib.cm as cm
import numpy as np
import pytest

from unopticalflow_tpu.utils.visualizer import VisualizerDebug as JaxVisualizerDebug
from unopticalflow_tpu_torch.utils import visualizer
from unopticalflow_tpu_torch.utils.visualizer import VisualizerDebug


def test_magma_table_equals_matplotlib():
    np.testing.assert_array_equal(visualizer._MAGMA, cm.magma(np.arange(256))[:, :3])


def _inputs(rng):
    return {
        "save_img": [rng.randint(0, 255, (8, 9, 3), np.uint8), rng.rand(6, 7) * 300 - 20,
                     rng.randint(0, 65535, (5, 4), np.uint16)],
        "show_mask": [rng.rand(8, 8, 1), rng.rand(7, 5) * 3, np.zeros((4, 4))],
        "save_depth_img": [rng.rand(8, 8, 1) * 10, rng.rand(9, 6) + 5],
        "save_flow_img": [rng.randn(8, 8, 2), rng.randn(5, 11, 2) * 30],
    }


@pytest.mark.parametrize("method", ["save_img", "show_mask", "save_depth_img", "save_flow_img"])
def test_writers_equal_jax(tmp_path, method):
    port, ref = VisualizerDebug(str(tmp_path / "p")), JaxVisualizerDebug(str(tmp_path / "j"))
    for k, x in enumerate(_inputs(np.random.RandomState(3))[method]):
        getattr(port, method)(x, f"x{k}")
        getattr(ref, method)(x, f"x{k}")
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "p"))
    for name in names:
        a = cv2.imread(str(tmp_path / "p" / name), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(tmp_path / "j" / name), cv2.IMREAD_UNCHANGED)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name


def test_disp_color_equals_jax(tmp_path, monkeypatch):
    from PIL import Image

    handed = []
    real = Image.fromarray

    def keep(arr, *a, **k):
        handed.append(np.array(arr))
        return real(arr, *a, **k)

    monkeypatch.setattr(Image, "fromarray", keep)
    rng = np.random.RandomState(4)
    disps = [rng.rand(8, 8), rng.rand(30, 50) * 0.3 + 0.01, np.full((4, 6), 0.5),
             np.linspace(-1, 1, 64).reshape(8, 8)]
    port = VisualizerDebug(str(tmp_path / "p"))
    ref = JaxVisualizerDebug(str(tmp_path / "j"))
    for k, d in enumerate(disps):
        path = port.save_disp_color_img(d, f"d{k}")
        ref.save_disp_color_img(d, f"d{k}")
        assert path == str(tmp_path / "p" / f"d{k}_depth.jpg")
        assert np.array_equal(visualizer._magma_rgb(d), handed[k]), k
        jax_file = (tmp_path / "j" / f"d{k}_depth.jpg").read_bytes()
        with open(path, "rb") as f:
            assert f.read() == jax_file, k  # PIL's JPEG of the JAX package's pixels
