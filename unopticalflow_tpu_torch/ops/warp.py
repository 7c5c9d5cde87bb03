"""Backward warping by an optical-flow field (plain PyTorch, NCHW).

Semantics of the JAX package's ``ops/warp.py::bilinear_warp``: sample the
image at pixel position ``(x + u, y + v)`` with bilinear weights, where any of
the four integer taps outside the image contributes zero (the reference's
``grid_sample(align_corners=True, padding_mode='zeros')``).

Written as the explicit four-corner form and not ``F.grid_sample``: the
sampling positions and weights stay float32 whatever the image dtype (in
bfloat16 the spacing near x = 208 is already 1 px, which would collapse the
bilinear weights), the blend runs in float32 with one cast at the end, and
no ``(size - 1)`` normalisation breaks on a size-1 map.

A row-shard of a height-sharded model warps by its own flow rows but samples
the whole target map (``row0``: the global row of the flow's first row), as
GSPMD all-gathers the warped map in the JAX package's spatial mode: flow
displacements are unbounded, so no bounded halo would do.
"""

from __future__ import annotations

import torch


def _corners(flow: torch.Tensor, h: int, w: int, row0: int = 0):
    """[(flat index, weight)] for the 4 taps; weights f32 and zero out of bounds.

    flow: (B, 2, Hf, W), channel 0 = x (width) and channel 1 = y (height)
    displacement; its row y sits at row ``row0 + y`` of the (h, w) map sampled.
    Indices are clamped into the map; their weight is zeroed.
    """
    gx = torch.arange(w, dtype=torch.float32, device=flow.device)[None, None, :]
    gy = torch.arange(row0, row0 + flow.shape[2], dtype=torch.float32,
                      device=flow.device)[None, :, None]
    x = gx + flow[:, 0].float()
    y = gy + flow[:, 1].float()
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    dx = x - x0f
    dy = y - y0f
    x0 = x0f.long()
    y0 = y0f.long()
    out = []
    for yi, xi, wgt in (
        (y0, x0, (1.0 - dy) * (1.0 - dx)),
        (y0, x0 + 1, (1.0 - dy) * dx),
        (y0 + 1, x0, dy * (1.0 - dx)),
        (y0 + 1, x0 + 1, dy * dx),
    ):
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        out.append((idx, wgt * inb))
    return out


def bilinear_warp(img: torch.Tensor, flow: torch.Tensor, use_mask: bool = False,
                  row0: int = 0) -> torch.Tensor:
    """Warp ``img`` (B, C, H, W) back to the source frame by ``flow`` (B, 2, Hf, W).

    ``use_mask`` multiplies by the border-validity mask (total in-bounds
    weight >= 0.9999).  The flow's rows are rows ``row0 .. row0 + Hf`` of the
    frame (the whole frame, Hf = H, by default).  Returns (B, C, Hf, W) in
    ``img.dtype``.
    """
    b, c, h, w = img.shape
    hf = flow.shape[2]
    corners = _corners(flow, h, w, row0)
    flat = img.reshape(b, c, h * w)
    out = 0.0
    for idx, wgt in corners:
        taps = torch.gather(flat, 2, idx.reshape(b, 1, hf * w).expand(b, c, hf * w))
        out = out + taps.reshape(b, c, hf, w).float() * wgt[:, None]
    if use_mask:
        total = sum(wgt for _, wgt in corners)
        out = out * (total >= 0.9999).float()[:, None]
    return out.to(img.dtype)


def warp_validity_mask(flow: torch.Tensor, img_hw) -> torch.Tensor:
    """(B, 1, H, W) mask: 1 where the warp footprint lies inside the image."""
    h, w = img_hw
    total = sum(wgt for _, wgt in _corners(flow, h, w))
    return (total >= 0.9999).to(flow.dtype)[:, None]
