"""Multi-scale image pyramids by adaptive average pooling (NCHW).

Port of ``unopticalflow_tpu/ops/pyramid.py``: level s is
``F.adaptive_avg_pool2d(img, [int(H / 2^s), int(W / 2^s)])`` (the same
window formula as the JAX package's ``adaptive_avg_pool``), and every level
is detached, so the photometric losses reach the flows only through the
warps.  When every level halves the previous one evenly, each level pools
the previous one (a 2x2 mean of 2x2 means is the 4x4 mean).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def avg_pool_pyramid(img: torch.Tensor, num_levels: int) -> list[torch.Tensor]:
    """[img, pool(H/2), pool(H/4), ...] of a (B, C, H, W) image, all detached."""
    h, w = img.shape[2], img.shape[3]
    sizes = [(int(h / (2**s)), int(w / (2**s))) for s in range(num_levels)]
    chain = all(
        ph == 2 * ch and pw == 2 * cw
        for (ph, pw), (ch, cw) in zip(sizes[:-1], sizes[1:])
    )
    out = [img.detach()]
    for size in sizes[1:]:
        src = out[-1] if chain else out[0]
        out.append(F.adaptive_avg_pool2d(src, size).detach())
    return out
