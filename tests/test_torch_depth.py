"""The port's depth evaluation against the JAX package's (CPU): the metrics
(``compute_errors``, ``eval_depth`` in both protocols), the disparity
resizes, and the three harnesses on the JAX tests' synthetic trees and
oracles, at rtol 1e-6.  The port's float32 ``resize`` (which the harnesses
use) is held to ``cv2.resize`` within 2 float32 ulps of the image's largest
magnitude: cv2 resizes float32 through Intel IPP, whose order of operations
the port's numpy copy matches to that bound (uint8 frames resize bit for bit,
tests/test_torch_imageio.py)."""

import io

import cv2
import numpy as np
import pytest
import torch

from unopticalflow_tpu.evaluation import depth_harness as jdh
from unopticalflow_tpu.evaluation import evaluate_depth as jed
from unopticalflow_tpu_torch.evaluation import depth_harness, evaluate_depth
from unopticalflow_tpu_torch.utils import imageio
from tests.test_depth_harness import _Cfg, _oracle, _smooth_depth, IMG_HW

RTOL = 1e-6


@pytest.fixture(scope="module")
def eigen_tree(tmp_path_factory):
    from tests import test_depth_harness

    return test_depth_harness.eigen_tree.__wrapped__(tmp_path_factory)


def _depths(seed, n=3, hw=(60, 90)):
    rng = np.random.RandomState(seed)
    gts = [_smooth_depth(*hw, seed=k) for k in range(n)]
    for g in gts:
        g[rng.rand(*hw) < 0.2] = 0.0
    preds = [g * (1.5 + k) + rng.rand(*hw) for k, g in enumerate(gts)]
    return gts, preds


@pytest.mark.parametrize("nyu", [False, True])
def test_metrics_equal_jax(nyu):
    gts, preds = _depths(1)
    g, p = np.clip(gts[0][gts[0] > 0], 1e-3, 80), np.clip(preds[0][gts[0] > 0], 1e-3, 80)
    np.testing.assert_allclose(evaluate_depth.compute_errors(g, p, nyu=nyu),
                               jed.compute_errors(g, p, nyu=nyu), rtol=RTOL)
    np.testing.assert_allclose(evaluate_depth.eval_depth(gts, preds, nyu=nyu),
                               jed.eval_depth(gts, preds, nyu=nyu), rtol=RTOL)
    for got, want in zip(evaluate_depth.process_depth(g, p * 100, 1e-3, 80),
                         jed.process_depth(g, p * 100, 1e-3, 80)):
        np.testing.assert_array_equal(got, want)


def test_resizes_equal_jax():
    rng = np.random.RandomState(2)
    gts = [np.ones((75, 124)), np.ones((40, 31))]
    disps = [rng.rand(32, 64, 1).astype(np.float32) + 0.01, rng.rand(16, 16).astype(np.float32)]
    got_d, got_r = depth_harness.resize_depths(gts, disps)
    want_d, want_r = jdh.resize_depths(gts, disps)
    for a, b, c, d, disp in zip(got_d, want_d, got_r, want_r, disps):
        # the resized disparities within the resize's bound, and each depth
        # the JAX formula of the port's own disparity
        assert c.dtype == d.dtype and a.dtype == b.dtype
        assert np.abs(c - d).max() <= 2 * np.spacing(np.float32(np.abs(disp).max()))
        np.testing.assert_array_equal(a, 1.0 / (c + 1e-4))
    # a torch tensor is brought to the host like a numpy array
    got = depth_harness.resize_disp([torch.from_numpy(disps[0])], gts)
    d, want_d = imageio.resize(disps[0][..., 0], (124, 75)), cv2.resize(disps[0], (124, 75))
    assert np.abs(d - want_d).max() <= 2 * np.spacing(np.float32(np.abs(disps[0]).max()))
    np.testing.assert_array_equal(got[0], 1.0 / (d + 1e-6))  # JAX's 1 / (cv2.resize + 1e-6)


@pytest.mark.parametrize("shape,wh", [((375, 1242), (832, 256)), ((427, 561, 3), (576, 448)),
                                      ((192, 256), (561, 427)), ((17, 31), (40, 5)),
                                      ((256, 832), (832, 256)), ((1, 1), (3, 2))],
                         ids=["kitti_down", "nyu_crop", "up", "ragged", "same", "one_pixel"])
@pytest.mark.parametrize("scale", [255.0, 1.0, 0.05])
def test_float32_resize_within_two_ulps_of_cv2(shape, wh, scale):
    img = (np.random.RandomState(sum(shape)).rand(*shape) * scale).astype(np.float32)
    want = cv2.resize(img, wh)
    got = imageio.resize(img, wh)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got.astype(np.float64) - want).max() <= 2 * np.spacing(np.abs(img).max())


def test_eigen_harness_equals_jax(eigen_tree):
    raw, eig, gts = eigen_tree
    for scale in (1.0, 2.0):
        buf, jbuf = io.StringIO(), io.StringIO()
        got = depth_harness.test_eigen_depth(_Cfg(raw), _oracle(gts, scale), eigen_dir=eig,
                                             file=buf)
        want = jdh.test_eigen_depth(_Cfg(raw), _oracle(gts, scale), eigen_dir=eig, file=jbuf)
        np.testing.assert_allclose(got, want, rtol=RTOL)
        assert buf.getvalue() == jbuf.getvalue()


def test_nyu_harness_equals_jax():
    rng = np.random.RandomState(1)
    n, h, w = 2, 480, 640
    images = rng.randint(0, 255, (n, 3, h, w), np.uint8)
    depths = np.stack([_smooth_depth(h, w, seed=i) for i in range(n)])
    crop_gts = [d[45:472, 41:602] for d in depths]
    buf, jbuf = io.StringIO(), io.StringIO()
    got = depth_harness.test_nyu(_Cfg(None), _oracle(crop_gts), images, depths, file=buf)
    want = jdh.test_nyu(_Cfg(None), _oracle(crop_gts), images, depths, file=jbuf)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert buf.getvalue() == jbuf.getvalue()
    assert got[0] < 0.05 and got[4] > 0.95

    # the inputs the harness hands to infer_disp: the float32 crop, resized
    seen = {}

    def keep(key):
        def infer(images):
            seen.setdefault(key, []).append(images)
            return np.ones((1,) + images.shape[1:3], np.float32)
        return infer

    depth_harness.test_nyu(_Cfg(None), keep("port"), images, depths, file=io.StringIO())
    jdh.test_nyu(_Cfg(None), keep("jax"), images, depths, file=io.StringIO())
    for a, b in zip(seen["port"], seen["jax"]):
        assert np.abs(a - b).max() <= 2 * np.spacing(np.float32(1.0))


def test_single_image_equals_jax(tmp_path):
    img = np.random.RandomState(2).randint(0, 255, (96, 160, 3), np.uint8)
    cv2.imwrite(str(tmp_path / "in.png"), img)
    cv2.imwrite(str(tmp_path / "in.jpg"), img)

    def infer(images):
        h, w = images.shape[1:3]
        yy, xx = np.mgrid[0:h, 0:w]
        return (0.1 + images[..., :1] * 0.5 + (xx / w)[None, :, :, None] * 0.2).astype(np.float32)

    for name in ("in.png", "in.jpg"):
        (tmp_path / "port").mkdir(exist_ok=True)
        (tmp_path / "jax").mkdir(exist_ok=True)
        disp, depth = depth_harness.test_single_image(str(tmp_path / name), infer, IMG_HW,
                                                      save_dir=str(tmp_path / "port"))
        wdisp, wdepth = jdh.test_single_image(str(tmp_path / name), infer, IMG_HW,
                                              save_dir=str(tmp_path / "jax"))
        assert disp.shape == wdisp.shape == (96, 160)
        assert np.abs(disp - wdisp).max() <= 2 * np.spacing(np.float32(np.abs(disp).max()))
        np.testing.assert_array_equal(depth, 1.0 / (1e-6 + disp))  # JAX's formula, exactly
        # the JAX package's file: PIL's JPEG of its magma pixels, the same
        # bytes (the disparities, 2 ulps apart, map to the same colours)
        assert (tmp_path / "port" / "demo_depth.jpg").read_bytes() == \
            (tmp_path / "jax" / "demo_depth.jpg").read_bytes()


def test_a_tensor_prediction_is_brought_to_the_host():
    t = torch.rand(1, 8, 12, 1)
    got = depth_harness._as_disp_hw(t[0])
    assert isinstance(got, np.ndarray) and got.shape == (8, 12)
    np.testing.assert_array_equal(got, t[0, :, :, 0].numpy())
