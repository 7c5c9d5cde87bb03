"""Optical-flow file I/O, metrics and renderings (host-side numpy).

The port's copy of ``unopticalflow_tpu/evaluation/flowlib.py``: Middlebury
``.flo`` reading and writing, the KITTI 16-bit PNG flow encoding ((value -
2^15) / 64, third channel validity) and disparity encoding (value / 256),
the average EPE, the direction segmentation, the bilinear backward warp,
the Middlebury colour wheel and the hue/saturation rendering (with its own
copy of matplotlib's ``hsv_to_rgb``).  Images go through
``utils/imageio.py`` (PNG or JPEG; 16-bit PNG in cv2's BGR channel order).
``show_flow`` shows a ``.flo`` file's colour wheel with matplotlib, which
it imports when called, as the JAX package's does.
"""

from __future__ import annotations

import numpy as np

from unopticalflow_tpu_torch.utils import imageio

TAG_FLOAT = 202021.25  # .flo magic


def read_flow(filename: str) -> np.ndarray:
    """Read a Middlebury .flo file -> (H, W, 2) float32."""
    with open(filename, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != np.float32(TAG_FLOAT):
            raise ValueError(f"{filename}: invalid .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def encode_flow(flow: np.ndarray) -> bytes:
    """(H, W, >=2) flow -> Middlebury .flo bytes (the serving endpoint's reply)."""
    h, w = flow.shape[:2]
    return (
        np.array([TAG_FLOAT], np.float32).tobytes()
        + np.array([w, h], np.int32).tobytes()
        + flow[:, :, :2].astype(np.float32).tobytes()
    )


def write_flow(flow: np.ndarray, filename: str) -> None:
    """Write (H, W, 2) flow as Middlebury .flo."""
    with open(filename, "wb") as f:
        f.write(encode_flow(flow))


def read_flow_png(flow_file: str) -> np.ndarray:
    """Read a KITTI 16-bit flow PNG -> (H, W, 3) float64 [u, v, valid].

    Invalid pixels are zeroed.
    """
    raw = imageio.imread(flow_file, imageio.IMREAD_UNCHANGED)
    if raw is None:
        raise FileNotFoundError(flow_file)
    raw = raw.astype(np.float64)
    flow = np.zeros_like(raw)
    flow[:, :, 0] = (raw[:, :, 2] - 2.0**15) / 64.0  # R channel = u (BGR read)
    flow[:, :, 1] = (raw[:, :, 1] - 2.0**15) / 64.0  # G channel = v
    flow[:, :, 2] = raw[:, :, 0]  # B channel = valid
    invalid = flow[:, :, 2] == 0
    flow[invalid, 0] = 0
    flow[invalid, 1] = 0
    return flow


def write_flow_png(flo: np.ndarray, flow_file: str) -> None:
    """Write (H, W, >=2) flow in the KITTI 16-bit PNG encoding."""
    imageio.imwrite(flow_file, flow_png_samples(flo))


def flow_png_samples(flo: np.ndarray) -> np.ndarray:
    """(H, W, >=2) flow -> the (H, W, 3) uint16 BGR samples of its KITTI PNG."""
    h, w = flo.shape[:2]
    enc = np.ones((h, w, 3), dtype=np.uint16)
    u = np.clip(flo[:, :, 0] * 64.0 + 2.0**15, 0, 2**16 - 1)
    v = np.clip(flo[:, :, 1] * 64.0 + 2.0**15, 0, 2**16 - 1)
    enc[:, :, 2] = u.astype(np.uint16)  # R (cv2 writes BGR)
    enc[:, :, 1] = v.astype(np.uint16)  # G
    if flo.shape[2] > 2:
        enc[:, :, 0] = flo[:, :, 2].astype(np.uint16)
    return enc


def read_disp_png(disp_file: str) -> np.ndarray:
    """KITTI disparity PNG -> (H, W) float64 (uint16 / 256)."""
    raw = imageio.imread(disp_file, imageio.IMREAD_UNCHANGED)
    if raw is None:
        raise FileNotFoundError(disp_file)
    if raw.ndim == 3:
        raw = raw[:, :, 0]
    return raw.astype(np.float64) / 256.0


def write_disp_png(disp: np.ndarray, disp_file: str) -> None:
    """(H, W) disparity -> KITTI 16-bit PNG (value * 256, clipped)."""
    imageio.imwrite(disp_file, np.clip(disp * 256.0, 0, 2**16 - 1).astype(np.uint16))


def flow_error(tu, tv, u, v) -> float:
    """Average EPE over the pixels where the ground truth is non-zero."""
    tu, tv, u, v = (np.asarray(a, np.float64) for a in (tu, tv, u, v))
    valid = (np.abs(tu) > 0) | (np.abs(tv) > 0)
    epe = np.sqrt((u - tu) ** 2 + (v - tv) ** 2)
    return float(epe[valid].mean()) if valid.any() else 0.0


# ---------------------------------------------------------------------------
# Middlebury colour wheel
# ---------------------------------------------------------------------------

_UNKNOWN_THRESH = 1e7


def make_color_wheel() -> np.ndarray:
    """(55, 3) RGB colour wheel (Middlebury convention)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((ry + yg + gc + cb + bm + mr, 3))
    col = 0
    # RY
    wheel[0:ry, 0] = 255
    wheel[0:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    # YG
    wheel[col : col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col : col + yg, 1] = 255
    col += yg
    # GC
    wheel[col : col + gc, 1] = 255
    wheel[col : col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    # CB
    wheel[col : col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col : col + cb, 2] = 255
    col += cb
    # BM
    wheel[col : col + bm, 2] = 255
    wheel[col : col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    # MR
    wheel[col : col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col : col + mr, 0] = 255
    return wheel


def compute_color(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Map normalised flow components to the colour wheel -> (H, W, 3) uint8."""
    wheel = make_color_wheel()
    ncols = wheel.shape[0]
    nan = np.isnan(u) | np.isnan(v)
    u = np.where(nan, 0, u)
    v = np.where(nan, 0, v)

    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros(u.shape + (3,), dtype=np.uint8)
    for c in range(3):
        col0 = wheel[k0, c] / 255.0
        col1 = wheel[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        small = rad <= 1
        col = np.where(small, 1 - rad * (1 - col), col * 0.75)
        img[:, :, c] = np.where(nan, 0, np.floor(255 * col)).astype(np.uint8)
    return img


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """(H, W, >=2) flow -> (H, W, 3) uint8 colour-wheel visualisation."""
    u = flow[:, :, 0].astype(np.float64).copy()
    v = flow[:, :, 1].astype(np.float64).copy()
    unknown = (np.abs(u) > _UNKNOWN_THRESH) | (np.abs(v) > _UNKNOWN_THRESH)
    u[unknown] = 0
    v[unknown] = 0
    rad = np.sqrt(u**2 + v**2)
    maxrad = max(-1.0, float(rad.max()))
    u = u / (maxrad + np.finfo(float).eps)
    v = v / (maxrad + np.finfo(float).eps)
    img = compute_color(u, v)
    img[unknown] = 0
    return img


# ---------------------------------------------------------------------------
# the rest of the JAX package's flowlib
# ---------------------------------------------------------------------------

SMALLFLOW = 0.0
LARGEFLOW = 1e8


def segment_flow(flow: np.ndarray) -> np.ndarray:
    """Flow directions in 8 classes: (H, W) float labels, 0 for zero or
    invalid flow, 1-8 for the 45-degree octants."""
    u = flow[:, :, 0].copy()
    v = flow[:, :, 1]
    idx = (np.abs(u) > LARGEFLOW) | (np.abs(v) > LARGEFLOW)
    class0 = (v == 0) & (u == 0)
    u[np.abs(u) == SMALLFLOW] = 0.00001
    tan_value = v / u

    seg = np.zeros(u.shape)
    seg[(tan_value < 1) & (tan_value >= 0) & (u > 0) & (v >= 0)] = 1
    seg[(tan_value >= 1) & (u >= 0) & (v >= 0)] = 2
    seg[(tan_value < -1) & (u <= 0) & (v >= 0)] = 3
    seg[(tan_value < 0) & (tan_value >= -1) & (u < 0) & (v >= 0)] = 4
    seg[(tan_value >= 0) & (tan_value < 1) & (u < 0) & (v <= 0)] = 5
    seg[(tan_value >= 1) & (u <= 0) & (v <= 0)] = 6
    seg[(tan_value < -1) & (u >= 0) & (v <= 0)] = 7
    seg[(tan_value >= -1) & (tan_value < 0) & (u > 0) & (v <= 0)] = 8
    seg[class0] = 0
    seg[idx] = 0
    return seg


def evaluate_flow(gt_flow: np.ndarray, pred_flow: np.ndarray) -> float:
    """Average EPE of two flow arrays."""
    return flow_error(gt_flow[:, :, 0], gt_flow[:, :, 1], pred_flow[:, :, 0], pred_flow[:, :, 1])


def evaluate_flow_file(gt: str, pred: str) -> float:
    """Average EPE between two .flo files."""
    return evaluate_flow(read_flow(gt), read_flow(pred))


def disp_to_flowfile(disp: np.ndarray, filename: str) -> None:
    """A disparity map as a .flo file with zero vertical flow."""
    h, w = disp.shape[:2]
    write_flow(np.dstack([disp.astype(np.float32), np.zeros((h, w), np.float32)]), filename)


def read_image(filename: str) -> np.ndarray:
    """A PNG or JPEG as PIL gives it: RGB (RGBA) uint8, grey as (H, W)."""
    img = imageio.imread(filename, imageio.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(filename)
    if img.ndim == 3:
        img = np.ascontiguousarray(img[:, :, [2, 1, 0, 3][:img.shape[2]]])
    return img


def warp_image(im: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Backward-warp an image by a flow field: ``im`` sampled bilinearly at
    (x + u, y + v), clamped to the image, pixels that fall outside set to 1."""
    h, w = im.shape[:2]
    iy, ix = np.mgrid[0:h, 0:w].astype(np.float64)
    fx = ix + flow[:, :, 0]
    fy = iy + flow[:, :, 1]
    oob = (fx < 0) | (fx > w - 1) | (fy < 0) | (fy > h - 1)
    fx = np.clip(fx, 0, w - 1)
    fy = np.clip(fy, 0, h - 1)
    x0 = np.floor(fx).astype(np.int64)
    y0 = np.floor(fy).astype(np.int64)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    dx = (fx - x0)[..., None]
    dy = (fy - y0)[..., None]
    img = im.astype(np.float64)
    if img.ndim == 2:
        img = img[..., None]
    out = (img[y0, x0] * (1 - dy) * (1 - dx) + img[y0, x1] * (1 - dy) * dx
           + img[y1, x0] * dy * (1 - dx) + img[y1, x1] * dy * dx)
    out[oob] = 1.0
    return out


def scale_image(image: np.ndarray, new_range) -> np.ndarray:
    """Rescale an image linearly into ``new_range`` -> uint8."""
    image = np.asarray(image, np.float32)
    lo, hi = float(np.min(image)), float(np.max(image))
    new_lo, new_hi = float(min(new_range)), float(max(new_range))
    scaled = (image - lo) / max(hi - lo, 1e-12) * (new_hi - new_lo) + new_lo
    return scaled.astype(np.uint8)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """(..., 3) HSV in [0, 1] -> RGB, as ``matplotlib.colors.hsv_to_rgb``."""
    hsv = np.asarray(hsv)
    in_shape = hsv.shape
    hsv = np.array(hsv, dtype=np.promote_types(hsv.dtype, np.float32), ndmin=2)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    r, g, b = np.empty_like(h), np.empty_like(h), np.empty_like(h)
    i = (h * 6.0).astype(int)
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    for idx, (rr, gg, bb) in ((i % 6 == 0, (v, t, p)), (i == 1, (q, v, p)),
                              (i == 2, (p, v, t)), (i == 3, (p, q, v)),
                              (i == 4, (t, p, v)), (i == 5, (v, p, q)),
                              (s == 0, (v, v, v))):
        r[idx], g[idx], b[idx] = rr[idx], gg[idx], bb[idx]
    return np.stack([r, g, b], axis=-1).reshape(in_shape)


def visualize_flow(flow: np.ndarray, mode: str = "Y") -> np.ndarray:
    """A flow field rendered for display; returns the (H, W, 3) uint8 image.

    Mode 'Y': the Middlebury colour wheel; mode 'RGB': hue = angle,
    saturation = magnitude, black where the validity channel (if any) is 0.
    """
    if mode == "Y":
        return flow_to_image(flow)
    h, w = flow.shape[:2]
    du, dv = flow[:, :, 0], flow[:, :, 1]
    valid = flow[:, :, 2] if flow.shape[2] > 2 else np.ones((h, w))
    max_flow = max(np.max(du), np.max(dv), 1e-12)
    img = np.zeros((h, w, 3), np.float64)
    img[:, :, 0] = np.arctan2(dv, du) / (2 * np.pi) % 1.0
    img[:, :, 1] = np.sqrt(du * du + dv * dv) * 8 / max_flow
    img[:, :, 2] = 8 - img[:, :, 1]
    img[valid == 0] = 0
    return (hsv_to_rgb(np.clip(img, 0, 1)) * 255).astype(np.uint8)


def show_flow(filename: str) -> None:
    """Display a .flo file's colour wheel with matplotlib (imported here)."""
    import matplotlib.pyplot as plt

    plt.imshow(flow_to_image(read_flow(filename)))
    plt.show()
