"""Lens undistortion as OpenCV computes it, in numpy.

``NYU_v2`` undistorts every frame through ``cv2.getOptimalNewCameraMatrix``
(alpha 1), ``cv2.initUndistortRectifyMap`` (float maps) and ``cv2.remap``
(``INTER_LINEAR``, constant zero border) before the ROI crop.  The card's
machine has no opencv, and the port keeps one reader path on every machine,
so these are OpenCV's algorithms written out (5-coefficient model
k1, k2, p1, p2, k3; no rectification; no tilt):

* ``undistort_points``: OpenCV's fixed-point iteration, 5 rounds (its
  default criteria), float64;
* ``optimal_new_camera_matrix`` at alpha 1: the camera matrix mapping the
  circumscribed rectangle of a 9 x 9 grid of undistorted border points onto
  the image, and the valid ROI (the inscribed rectangle of the same grid
  under the new matrix, each side rounded half to even, clipped to the
  image);
* ``init_undistort_rectify_map``: float32 maps of the distorted position of
  each pixel of the new camera, from float64 arithmetic;
* ``LinearRemap``: uint8 bilinear remap as OpenCV 4.11 and later compute
  it, in float32 with fused multiply-adds from the maps' own positions (up to
  4.10 OpenCV rounded positions to 1/32 pixel and weights to 15 bits, which
  moves a value by up to a few levels).

``tests/test_torch_nyu.py`` holds them to cv2 at NYU's intrinsics and size.
"""

from __future__ import annotations

import numpy as np


def _coeffs(dist):
    k = np.zeros(5)
    d = np.asarray(dist, np.float64).ravel()
    k[:len(d)] = d
    return k  # k1, k2, p1, p2, k3


def undistort_points(pts: np.ndarray, K: np.ndarray, dist, P: np.ndarray | None = None
                     ) -> np.ndarray:
    """``cv2.undistortPoints(pts, K, dist, None, P)`` of (N, 2) float64 pixel
    points: normalized coordinates, or pixels of ``P`` when it is given."""
    k1, k2, p1, p2, k3 = _coeffs(dist)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ifx, ify = 1.0 / fx, 1.0 / fy
    u, v = pts[:, 0].astype(np.float64), pts[:, 1].astype(np.float64)
    x0 = x = (u - cx) * ifx
    y0 = y = (v - cy) * ify
    for _ in range(5):  # OpenCV's default criteria: 5 rounds
        r2 = x * x + y * y
        icdist = 1.0 / (1 + ((k3 * r2 + k2) * r2 + k1) * r2)
        delta_x = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        delta_y = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - delta_x) * icdist
        y = (y0 - delta_y) * icdist
    if P is None:
        return np.stack([x, y], 1)
    P = np.asarray(P, np.float64)
    xx = P[0, 0] * x + P[0, 1] * y + P[0, 2]
    yy = P[1, 0] * x + P[1, 1] * y + P[1, 2]
    ww = 1.0 / (P[2, 0] * x + P[2, 1] * y + P[2, 2])
    return np.stack([xx * ww, yy * ww], 1)


def _rectangles(K, dist, size, P=None):
    """(inner, outer) rectangles (x, y, w, h) of the undistorted 9 x 9 grid."""
    n = 9
    w, h = size
    gx, gy = np.meshgrid(np.arange(n, dtype=np.float64), np.arange(n, dtype=np.float64))
    pts = np.stack([gx.ravel() * (w - 1) / (n - 1), gy.ravel() * (h - 1) / (n - 1)], 1)
    p = undistort_points(pts, K, dist, P).reshape(n, n, 2)
    ix0, ix1 = p[:, 0, 0].max(), p[:, n - 1, 0].min()
    iy0, iy1 = p[0, :, 1].max(), p[n - 1, :, 1].min()
    ox0, ox1 = p[..., 0].min(), p[..., 0].max()
    oy0, oy1 = p[..., 1].min(), p[..., 1].max()
    return (ix0, iy0, ix1 - ix0, iy1 - iy0), (ox0, oy0, ox1 - ox0, oy1 - oy0)


def optimal_new_camera_matrix(K: np.ndarray, dist, size):
    """``cv2.getOptimalNewCameraMatrix(K, dist, size, 1, size)`` (alpha 1, as
    ``NYU_v2`` calls it): (new K (3, 3) float64, ROI (x, y, w, h) ints);
    ``size`` is (w, h)."""
    K = np.asarray(K, np.float64)
    w, h = size
    _, outer = _rectangles(K, dist, size)
    M = K.copy()
    M[0, 0] = (w - 1) / outer[2]
    M[1, 1] = (h - 1) / outer[3]
    M[0, 2] = -M[0, 0] * outer[0]
    M[1, 2] = -M[1, 1] * outer[1]
    inner, _ = _rectangles(K, dist, size, M)
    x, y, rw, rh = (int(np.rint(v)) for v in inner)
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + rw, w), min(y + rh, h)
    roi = (x0, y0, x1 - x0, y1 - y0) if x1 > x0 and y1 > y0 else (0, 0, 0, 0)
    return M, roi


def init_undistort_rectify_map(K: np.ndarray, dist, new_K: np.ndarray, size):
    """``cv2.initUndistortRectifyMap(K, dist, None, new_K, size, CV_32FC1)``:
    (map_x, map_y), each (h, w) float32."""
    k1, k2, p1, p2, k3 = _coeffs(dist)
    K = np.asarray(K, np.float64)
    w, h = size
    ir = np.linalg.inv(np.asarray(new_K, np.float64)[:, :3])
    j = np.arange(w, dtype=np.float64)[None, :]
    i = np.arange(h, dtype=np.float64)[:, None]
    _x = i * ir[0, 1] + ir[0, 2] + j * ir[0, 0]
    _y = i * ir[1, 1] + ir[1, 2] + j * ir[1, 0]
    _w = i * ir[2, 1] + ir[2, 2] + j * ir[2, 0]
    wi = 1.0 / _w
    x, y = _x * wi, _y * wi
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    xd = x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy
    u = K[0, 0] * xd + K[0, 2]
    v = K[1, 1] * yd + K[1, 2]
    return u.astype(np.float32), v.astype(np.float32)


class LinearRemap:
    """``cv2.remap(img, map_x, map_y, INTER_LINEAR)`` of uint8 (H, W[, C])
    images of one size with a zero constant border -> (h, w[, C]) uint8.

    OpenCV's float32 path: alpha = x - floor(x), beta likewise, taps outside
    the image zero, v0 = fma(alpha, p01 - p00, p00), v1 = fma(alpha, p11 -
    p10, p10), v = fma(beta, v1 - v0, v0), rounded half to even.  A float32
    FMA is one rounding of the exact a * b + c, which float64 holds here (the
    products have at most 48 significant bits).  The taps' indices and
    weights are worked out once, for every image remapped by the same maps.
    """

    def __init__(self, map_x: np.ndarray, map_y: np.ndarray, src_hw):
        f32 = np.float32
        hs, ws = src_hw
        map_x, map_y = map_x.astype(f32), map_y.astype(f32)
        ix, iy = np.floor(map_x).astype(np.int64), np.floor(map_y).astype(np.int64)
        self.alpha = (map_x - ix.astype(f32))[..., None].astype(np.float64)
        self.beta = (map_y - iy.astype(f32))[..., None].astype(np.float64)
        self.src_hw = (hs, ws)
        self.taps = []  # (flat index, inside) of p00, p01, p10, p11
        for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            yy, xx = iy + dy, ix + dx
            inside = (yy >= 0) & (yy < hs) & (xx >= 0) & (xx < ws)
            idx = np.clip(yy, 0, hs - 1) * ws + np.clip(xx, 0, ws - 1)
            self.taps.append((idx, inside[..., None].astype(f32)))

    def __call__(self, img: np.ndarray) -> np.ndarray:
        f32 = np.float32
        if img.shape[:2] != self.src_hw:
            raise ValueError(f"LinearRemap for {self.src_hw} images got {img.shape[:2]}")
        flat = img.reshape(self.src_hw[0] * self.src_hw[1], -1)
        p00, p01, p10, p11 = (flat[idx].astype(f32) * inside for idx, inside in self.taps)
        v0 = (self.alpha * (p01 - p00) + p00).astype(f32)
        v1 = (self.alpha * (p11 - p10) + p10).astype(f32)
        v = (self.beta * (v1 - v0) + v0).astype(f32)
        out = np.clip(np.rint(v), 0, 255).astype(np.uint8)
        return out if img.ndim == 3 else out[:, :, 0]
