"""The OpenCV calls of ``VisualizerDebug``'s tools, without opencv.

``utils/visualizer.py`` draws correspondences and epipolar lines as the JAX
package does with ``cv2.circle``, ``cv2.line`` and
``cv2.computeCorrespondEpilines``; this module follows OpenCV's own code
(``imgproc/src/drawing.cpp``, ``calib3d/src/fundam.cpp``) for the calls it
makes, so the port draws the same pixels:

* ``line(img, p0, p1, color)``: thickness 1, ``LINE_8``.  An endpoint
  outside the image is first moved onto its border by ``clipLine`` (integer
  arithmetic with one double-precision product and quotient), then
  ``LineIterator`` walks Bresenham's line from the left end.
* ``circle(img, center, radius, color, -1)``: ``Circle``'s filled midpoint
  circle, row spans clipped to the image.
* ``circle(img, center, radius, color, thickness)`` with ``thickness > 1``:
  ``EllipseEx`` in 16-bit fixed point, the polygon ``ellipse2Poly`` gives,
  drawn by ``PolyLine`` as thick segments (``ThickLine``: a filled
  quadrangle, ``FillConvexPoly`` with its edges by ``Line2``, and a filled
  circle at each joint).  Radii of at most 2 pixels only, where the polygon
  is the four points ``ellipse2Poly`` takes at 90 degrees, which its sine
  table holds exactly; a larger radius raises.

Other thicknesses, line types and sub-pixel shifts raise ``ValueError``.
``img`` is (H, W) or (H, W, C) uint8 and is drawn on in place, as cv2 draws;
``color`` gives the first C of its values to the C channels.

* ``epilines(points, which, F)``: ``computeCorrespondEpilines`` of (N, 2)
  points of image ``which`` (1: F x, 2: F^T x) in float64, each line scaled
  to a^2 + b^2 = 1 and stored as float32, (N, 3).
"""

from __future__ import annotations

import math

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_INT_MAX = 2**31 - 1


def _cdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _point(p, what: str) -> tuple[int, int]:
    x, y = (int(v) for v in p)
    if not (-_INT_MAX - 1 <= x <= _INT_MAX and -_INT_MAX - 1 <= y <= _INT_MAX):
        raise ValueError(f"{what} {p}: OpenCV takes points of 32-bit integers")
    return x, y


def _pixel(img: np.ndarray, color) -> np.ndarray:
    ch = 1 if img.ndim == 2 else img.shape[2]
    vals = ([int(c) for c in color] + [0] * 4)[:ch]
    return np.array(vals if img.ndim == 3 else vals[0], np.uint8)


def _put(img, x: int, y: int, px) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = px


def _hline(img, y: int, x1: int, x2: int, px) -> None:
    """A row span, both ends included, already inside the image."""
    img[y, x1:x2 + 1] = px


def _clip_line(w: int, h: int, p1, p2):
    """``cv::clipLine``: (inside, p1, p2), the endpoints moved onto an image
    of w x h where they lie outside it."""
    if w <= 0 or h <= 0:
        return False, p1, p2
    right, bottom = w - 1, h - 1
    (x1, y1), (x2, y2) = p1, p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line8(img, p1, p2, px) -> None:
    """``Line``: ``LineIterator(img, p1, p2, 8, leftToRight=true)``'s pixels."""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2) = p1, p2
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, (x1, y1), (x2, y2) = _clip_line(w, h, (x1, y1), (x2, y2))
        if not inside:
            return
    if x2 < x1:  # left to right
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, abs(y2 - y1)
    sy = 1 if y2 >= y1 else -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = px
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += sy
            x += minor
        else:
            x += 1
            y += sy if minor else 0


def _line2(img, p1, p2, px) -> None:
    """``Line2``: an 8-connected line between points in 16-bit fixed point."""
    h, w = img.shape[:2]
    inside, (x1, y1), (x2, y2) = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = XY_ONE, _cdiv(dy << XY_SHIFT, ax | 1)
        count = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _cdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        count = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    _put(img, (x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT, px)
    if ax > ay:
        x1 >>= XY_SHIFT
        for _ in range(count + 1):
            _put(img, x1, y1 >> XY_SHIFT, px)
            x1 += 1
            y1 += y_step
    else:
        y1 >>= XY_SHIFT
        for _ in range(count + 1):
            _put(img, x1 >> XY_SHIFT, y1, px)
            x1 += x_step
            y1 += 1


def _fill_convex_poly(img, v, px, shift: int = XY_SHIFT) -> None:
    """``FillConvexPoly`` for ``LINE_8``: the outline by ``Line2``, then
    each row's span between the two edges walked down from the top vertex."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = 1 << shift >> 1
    p0 = v[-1]
    xs_, ys_ = [p[0] for p in v], [p[1] for p in v]
    ymin = min(ys_)
    imin = ys_.index(ymin)
    for p in v:
        _line2(img, p0, p, px)
        p0 = p
    xmin, xmax = (min(xs_) + delta) >> shift, (max(xs_) + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (max(ys_) + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # each edge: [vertex index, index step, x, x step, last row]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0 = e[0]
                idx = idx0 + e[1]
                if idx >= npts:
                    idx -= npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e[4] = ty
                        e[3] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx += e[1]
                    if idx >= npts:
                        idx -= npts
                else:
                    edges -= 1  # the loop's test that failed also counted down
        if edges < 0:
            break
        if y >= 0:
            left, right = (edge[1], edge[0]) if edge[0][2] > edge[1][2] else (edge[0], edge[1])
            x1 = (left[2] + (XY_ONE >> 1)) >> XY_SHIFT
            x2 = (right[2] + (XY_ONE >> 1)) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                _hline(img, y, max(x1, 0), min(x2, w - 1), px)
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _circle_filled(img, center, radius: int, px) -> None:
    """``Circle(img, center, radius, color, fill=1)``: the midpoint circle's
    row spans, clipped to the image."""
    h, w = img.shape[:2]
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            for yy in (y11, y12):
                if 0 <= yy < h:
                    _hline(img, yy, x11, x12, px)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                for yy in (y21, y22):
                    if 0 <= yy < h:
                        _hline(img, yy, x21, x22, px)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line(img, p0, p1, px, thickness: int, flags: int) -> None:
    """``ThickLine`` (``LINE_8``, thickness > 1, points in 16-bit fixed
    point): a filled quadrangle about the segment and, where ``flags`` asks,
    a filled circle at either end."""
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > np.finfo(np.float64).eps:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        ox, oy = round(dy * r), round(dx * r)  # cvRound: to nearest, ties to even
        quad = [(p0[0] + ox, p0[1] + oy), (p0[0] - ox, p0[1] - oy),
                (p1[0] - ox, p1[1] - oy), (p1[0] + ox, p1[1] + oy)]
        _fill_convex_poly(img, quad, px)
    for i in range(2):
        if flags & (i + 1):
            center = ((p0[0] + (XY_ONE >> 1)) >> XY_SHIFT, (p0[1] + (XY_ONE >> 1)) >> XY_SHIFT)
            _circle_filled(img, center, (thickness + (XY_ONE >> 1)) >> XY_SHIFT, px)
        p0 = p1


def _ellipse_thick(img, center, radius: int, px, thickness: int) -> None:
    """``EllipseEx`` of a full circle, ``LINE_8``, thickness > 1."""
    c = (center[0] << XY_SHIFT, center[1] << XY_SHIFT)
    r = radius << XY_SHIFT
    if ((r + (XY_ONE >> 1)) >> XY_SHIFT) >= 3:
        raise ValueError(f"circle of radius {radius} with thickness {thickness}: the port "
                         "draws thick circles of radius 2 or less")
    # ellipse2Poly at delta 90: sin and cos of 0, 90, 180, 270 and 360 degrees
    poly = [(c[0] + r * cos_, c[1] + r * sin_)
            for cos_, sin_ in ((1, 0), (0, 1), (-1, 0), (0, -1), (1, 0))]
    pts = []
    for p in poly:
        if not pts or p != pts[-1]:
            pts.append(p)
    if len(pts) == 1:
        pts = [c, c]
    # PolyLine, open: round caps at both ends of the first segment, then at
    # the far end of each next one
    flags = 3
    for a, b in zip(pts[:-1], pts[1:]):
        _thick_line(img, a, b, px, thickness, flags)
        flags = 2


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """``cv2.line(img, pt1, pt2, color, thickness)`` at thickness 1
    (``LINE_8``, no shift); draws in place and returns ``img``."""
    if thickness != 1:
        raise ValueError(f"line of thickness {thickness}: the port draws thickness 1")
    _line8(img, _point(pt1, "pt1"), _point(pt2, "pt2"), _pixel(img, color))
    return img


def circle(img: np.ndarray, center, radius: int, color, thickness: int = 1) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, thickness)`` filled
    (``thickness < 0``) or with ``thickness > 1`` (radius at most 2);
    ``LINE_8``, no shift.  Draws in place and returns ``img``."""
    center = _point(center, "center")
    radius = int(radius)
    if radius < 0:
        raise ValueError(f"circle of radius {radius}")
    px = _pixel(img, color)
    if thickness < 0:
        _circle_filled(img, center, radius, px)
    elif thickness > 1:
        _ellipse_thick(img, center, radius, px, int(thickness))
    else:
        raise ValueError(f"circle of thickness {thickness}: the port draws filled circles "
                         "and thicknesses above 1")
    return img


def epilines(points, which: int, fundamental) -> np.ndarray:
    """``cv2.computeCorrespondEpilines(points, which, F)`` as (N, 3) float32."""
    if which not in (1, 2):
        raise ValueError(f"the points' image is 1 or 2, got {which}")
    f = np.asarray(fundamental, np.float64).reshape(3, 3)
    if which == 2:
        f = f.T
    pts = np.asarray(points, np.float32).reshape(-1, 2).astype(np.float64)
    x, y = pts[:, 0], pts[:, 1]
    a = f[0, 0] * x + f[0, 1] * y + f[0, 2]
    b = f[1, 0] * x + f[1, 1] * y + f[1, 2]
    c = f[2, 0] * x + f[2, 1] * y + f[2, 2]
    nu = a * a + b * b
    with np.errstate(divide="ignore"):
        nu = np.where(nu != 0, 1.0 / np.sqrt(nu), 1.0)
    return np.stack([a * nu, b * nu, c * nu], axis=1).astype(np.float32)
