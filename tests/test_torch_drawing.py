"""The port's drawing tools without opencv (``utils/drawing.py``) against cv2
and the JAX package's ``VisualizerDebug``, which draws with cv2:

* ``drawing.circle`` and ``drawing.line`` pixel for pixel against
  ``cv2.circle`` (filled, radius 0 to 6; thickness 2 to 4 at radius 0 to 2,
  the correspondences' circle being radius 1, thickness 2) and ``cv2.line``
  (thickness 1) with centres and endpoints on, beside and far beyond the
  borders, on grey, BGR and BGRA images; the fixed-point polygon fill and
  edge that thick circles draw with against ``cv2.fillConvexPoly`` (shift
  16) on thin quadrangles; ``drawing.epilines`` against
  ``cv2.computeCorrespondEpilines``;
* ``show_corres``, ``draw_point_corres``, ``show_epipolar_line`` (both F
  conventions), ``draw_epipolar_line`` and ``drawlines``: the same files,
  with the same pixels, as the JAX package's, on seeded inputs with points
  and lines at and beyond the borders, and the committed SHA-256 of the JAX
  package's pixels on ``chip_smoke.drawing_inputs(17)``;
* the 3-D ray tools: the same calls, with the same arrays, on a recording
  ``ax`` as the JAX package's, and the same return values;
* ``flowlib.show_flow`` under matplotlib's Agg backend: the image handed to
  ``imshow`` equals the JAX package's."""

import hashlib
import json
import os

import cv2
import numpy as np
import pytest
import torch

from unopticalflow_tpu.utils.visualizer import VisualizerDebug as JaxVisualizerDebug
from unopticalflow_tpu_torch.utils import drawing
from unopticalflow_tpu_torch.utils.visualizer import VisualizerDebug

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 9, 12


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _canvases(rng):
    return [rng.randint(0, 256, (H, W)).astype(np.uint8),
            rng.randint(0, 256, (H, W, 3)).astype(np.uint8),
            rng.randint(0, 256, (H, W, 4)).astype(np.uint8)]


@pytest.mark.parametrize("radius,thickness", [(r, t) for r in (0, 1, 2) for t in (2, 3, 4)]
                         + [(r, -1) for r in range(7)])
def test_circle_equals_cv2(radius, thickness):
    rng = np.random.RandomState(radius * 10 + thickness + 1)
    margin = radius + thickness + 2
    for cy in range(-margin, H + margin):
        for cx in range(-margin, W + margin):
            for img in _canvases(rng):
                color = tuple(int(v) for v in rng.randint(0, 256, 4))
                want = cv2.circle(img.copy(), (cx, cy), radius, color, thickness)
                got = drawing.circle(img.copy(), (cx, cy), radius, color, thickness)
                assert np.array_equal(got, want), (cx, cy, img.shape)


def test_line_equals_cv2():
    rng = np.random.RandomState(0)
    for k in range(3000):
        span = [3, 20, 1000, 10**6, 2**30][k % 5]
        p1 = tuple(int(v) for v in rng.randint(-span, span + W, 2))
        p2 = tuple(int(v) for v in rng.randint(-span, span + H, 2))
        if k % 3 == 0:  # drawlines' lines: from x = 0 to the width
            p1, p2 = (0, p1[1]), (W, p2[1])
        img = _canvases(rng)[k % 3]
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        want = cv2.line(img.copy(), p1, p2, color, 1)
        assert np.array_equal(drawing.line(img.copy(), p1, p2, color), want), (p1, p2)


def test_thin_polygons_and_their_edges_equal_cv2():
    """The quadrangles ``ThickLine`` fills, thin and at any angle, with their
    edges by ``Line2``: a polygon's fill does not cover its edge pixels."""
    rng = np.random.RandomState(3)
    one = drawing.XY_ONE
    for _ in range(1500):
        c = (int(rng.randint(-2 * one, 14 * one)), int(rng.randint(-2 * one, 12 * one)))
        d = (int(rng.randint(-5 * one, 5 * one)), int(rng.randint(-5 * one, 5 * one)))
        t, n = int(rng.randint(0, one)), np.hypot(*d) + 1
        ox, oy = int(-d[1] / n * t), int(d[0] / n * t)
        quad = [(c[0] + ox, c[1] + oy), (c[0] - ox, c[1] - oy),
                (c[0] + d[0] - ox, c[1] + d[1] - oy), (c[0] + d[0] + ox, c[1] + d[1] + oy)]
        want = cv2.fillConvexPoly(np.zeros((H, W), np.uint8), np.array(quad, np.int32), 255,
                                  cv2.LINE_8, 16)
        got = np.zeros((H, W), np.uint8)
        drawing._fill_convex_poly(got, quad, np.uint8(255))
        assert np.array_equal(got, want), quad


def test_drawing_refuses_what_it_does_not_draw():
    img = np.zeros((H, W, 3), np.uint8)
    with pytest.raises(ValueError, match="thickness 1"):
        drawing.circle(img, (3, 3), 2, (1, 2, 3), 1)
    with pytest.raises(ValueError, match="radius 2 or less"):
        drawing.circle(img, (3, 3), 3, (1, 2, 3), 2)
    with pytest.raises(ValueError, match="thickness 1"):
        drawing.line(img, (0, 0), (3, 3), (1, 2, 3), 2)
    with pytest.raises(ValueError, match="32-bit integers"):
        drawing.line(img, (0, 0), (2**31, 3), (1, 2, 3))
    assert not img.any()


def test_epilines_equal_cv2():
    rng = np.random.RandomState(0)
    for k in range(100):
        f = rng.randn(3, 3) * 10.0 ** rng.randint(-6, 2, (3, 3))
        pts = (rng.rand(9, 2) * [800, 300] - 50).astype(np.float32)
        for which in (1, 2):
            want = cv2.computeCorrespondEpilines(pts.reshape(-1, 1, 2), which, f).reshape(-1, 3)
            got = drawing.epilines(pts, which, f)
            assert got.dtype == np.float32 and np.array_equal(got, want), (k, which)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    img1 = rng.randint(0, 255, (40, 64, 3)).astype(np.uint8)
    img2 = rng.randint(0, 255, (40, 64, 3)).astype(np.uint8)
    match = np.stack([rng.uniform(-3, 67, 14), rng.uniform(-3, 43, 14),
                      rng.uniform(-3, 67, 14), rng.uniform(-3, 43, 14)])
    match[:, :5] = [[0, 63, 0.5, 64.5, 2.5], [0, 39, 39.5, -0.5, 3.5],
                    [-1, 64, 1, 2, 3], [40, -1, 1.5, 2, 3]]
    f = np.array([[0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]]) + 0.02 * rng.randn(3, 3)
    return img1, img2, match, f


def _pixels(folder):
    return {n: cv2.imread(os.path.join(folder, n), cv2.IMREAD_UNCHANGED)
            for n in sorted(os.listdir(folder))}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tools_write_the_jax_packages_pixels(tmp_path, seed, capsys):
    img1, img2, match, f = _inputs(seed)
    port, ref = VisualizerDebug(str(tmp_path / "p")), JaxVisualizerDebug(str(tmp_path / "j"))
    for vis in (port, ref):
        vis.show_corres(img1, img2, match, "c")
        vis.draw_point_corres(img2, img1, match[[2, 3, 0, 1]], "d")
        for convention in ("x2Fx1", "x1Fx2"):
            np.random.seed(seed)
            vis.show_epipolar_line(img1, img2, match, f, "e_" + convention, convention)
        np.random.seed(seed + 1)
        vis.draw_epipolar_line(img2, img1, match, f.T, "g")
    printed = capsys.readouterr().out.splitlines()
    assert [ln.replace(str(tmp_path / "p"), "") for ln in printed[:2]] == \
        [ln.replace(str(tmp_path / "j"), "") for ln in printed[2:]]
    got, want = _pixels(tmp_path / "p"), _pixels(tmp_path / "j")
    assert sorted(got) == sorted(want) and len(got) == 10
    for name in want:
        assert got[name].shape == want[name].shape and np.array_equal(got[name], want[name]), name
    with pytest.raises(ValueError, match="unknown F convention"):
        port.show_epipolar_line(img1, img2, match, f, "x", "F")


def test_drawlines_equals_jax_with_a_generator():
    img1, img2, match, f = _inputs(5)
    lines = drawing.epilines(match[2:].T.astype(np.float32), 2, f)
    lines[3, 1] = 0  # a vertical line is skipped, its colour drawn all the same
    got = VisualizerDebug.drawlines(img1, img2, lines, match[:2].T, match[2:].T,
                                    rng=np.random.RandomState(4))
    want = JaxVisualizerDebug.drawlines(img1, img2, lines, match[:2].T, match[2:].T,
                                        rng=np.random.RandomState(4))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert not np.array_equal(got[0], img1)  # drawn on copies


def test_committed_drawing_fixture(tmp_path):
    import chip_smoke

    with open(os.path.join(REPO, "tests", "torch_fixtures", "drawing", "expected.json")) as f:
        want = json.load(f)["png_pixels_sha256"]
    img1, img2, match, fundamental = chip_smoke.drawing_inputs(17)
    vis = VisualizerDebug(str(tmp_path))
    vis.show_corres(img1, img2, match, "draw")
    np.random.seed(17)
    vis.show_epipolar_line(img1, img2, match, fundamental, "draw")
    got = {}
    for name, px in _pixels(tmp_path).items():
        a = np.ascontiguousarray(px)
        got[name] = hashlib.sha256(str(a.dtype.str).encode() + str(a.shape).encode()
                                   + a.tobytes()).hexdigest()
    assert got == want


class _RecordingAx:
    def __init__(self):
        self.calls = []

    def plot3D(self, *args, **kwargs):
        self.calls.append(("plot3D", args, kwargs))

    def scatter(self, *args, **kwargs):
        self.calls.append(("scatter", args, kwargs))


def test_ray_tools_make_the_jax_packages_calls():
    rng = np.random.RandomState(1)
    k = np.array([[700.0, 0, 320], [0, 710.0, 240], [0, 0, 1]])
    rot, _ = np.linalg.qr(rng.randn(3, 3))
    proj1 = np.hstack([k, np.zeros((3, 1))])
    proj2 = k @ np.hstack([rot, rng.randn(3, 1)])
    match = [300.5, 200.25, 310.0, 190.75]
    results = {}
    for name, vis in (("port", VisualizerDebug()), ("jax", JaxVisualizerDebug())):
        ax = _RecordingAx()
        dot = vis.visualize_two_rays(ax, match, proj1, proj2)
        direction = vis.show_ray(ax, k, np.hstack([rot, rng.randn(3, 1) * 0]), [5.0, 6.0])
        vis.scatter_3d(ax, np.array([1.0, 2.0, 3.0]), scatter_color="b")
        vis.visualize_points(ax, np.arange(12.0).reshape(4, 3))
        results[name] = (ax.calls, dot, direction)
    (calls, dot, direction), (jcalls, jdot, jdirection) = results["port"], results["jax"]
    assert dot == jdot and np.array_equal(direction, jdirection)
    assert [(c[0], c[2]) for c in calls] == [(c[0], c[2]) for c in jcalls]
    for (_, args, _), (_, jargs, _) in zip(calls, jcalls):
        assert len(args) == len(jargs)
        assert all(np.array_equal(a, b) for a, b in zip(args, jargs))


def test_show_flow_shows_the_jax_packages_image(tmp_path, monkeypatch):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from unopticalflow_tpu.evaluation import flowlib as jax_flowlib
    from unopticalflow_tpu_torch.evaluation import flowlib

    flow = np.random.RandomState(2).randn(12, 20, 2).astype(np.float32) * 5
    path = str(tmp_path / "f.flo")
    flowlib.write_flow(flow, path)
    shown, calls = [], []
    monkeypatch.setattr(plt, "imshow", lambda img, *a, **k: shown.append(np.array(img)))
    monkeypatch.setattr(plt, "show", lambda *a, **k: calls.append("show"))
    flowlib.show_flow(path)
    jax_flowlib.show_flow(path)
    assert calls == ["show", "show"] and len(shown) == 2
    assert shown[0].dtype == shown[1].dtype and np.array_equal(shown[0], shown[1])
    assert shown[0].shape == (12, 20, 3)
