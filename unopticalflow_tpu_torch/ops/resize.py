"""Bilinear resizing with the reference's ``F.interpolate`` semantics (NCHW)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Resize (B, C, H, W) to ``out_hw`` with bilinear, align_corners=False."""
    size = (int(out_hw[0]), int(out_hw[1]))
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


def upsample2x_double(flow: torch.Tensor) -> torch.Tensor:
    """``F.interpolate(flow, scale_factor=2, mode='bilinear') * 2``: the
    resolution doubles between decoder levels and the flow values with it."""
    _, _, h, w = flow.shape
    return resize_bilinear(flow, (2 * h, 2 * w)) * 2.0
