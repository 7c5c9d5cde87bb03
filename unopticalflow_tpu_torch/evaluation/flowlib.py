"""Optical-flow file I/O and the colour-wheel rendering (host-side numpy).

The port's copy of the parts of ``unopticalflow_tpu/evaluation/flowlib.py``
that evaluation and serving use: Middlebury ``.flo`` reading and encoding,
the KITTI 16-bit PNG flow encoding ((value - 2^15) / 64, third channel
validity) and the Middlebury colour wheel.  PNGs go through
``utils/imageio.py`` (16-bit, in cv2's BGR channel order).
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
