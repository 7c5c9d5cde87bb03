"""Windowed SSIM by 3x3 average pooling (NCHW).

Port of ``unopticalflow_tpu/ops/ssim.py``: means, variances and covariance
from a 3x3 stride-1 zero-padded average pool whose divisor is always 9
(``count_include_pad=True``), C1 = 0.01^2, C2 = 0.03^2.  Computed in float32
whatever the input dtype: the sigma terms are differences of products whose
cancellation loses most bits in bfloat16.  Returns the raw per-pixel map
(the loss layer clamps).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

C1 = 0.01**2
C2 = 0.03**2


def _pool3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, kernel_size=3, stride=1, padding=1, count_include_pad=True)


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-pixel SSIM map of two (B, C, H, W) images, float32."""
    x = x.float()
    y = y.float()
    mu_x = _pool3(x)
    mu_y = _pool3(y)
    sigma_x = _pool3(x * x) - mu_x * mu_x
    sigma_y = _pool3(y * y) - mu_y * mu_y
    sigma_xy = _pool3(x * y) - mu_x * mu_y
    num = (2.0 * mu_x * mu_y + C1) * (2.0 * sigma_xy + C2)
    den = (mu_x * mu_x + mu_y * mu_y + C1) * (sigma_x + sigma_y + C2)
    return num / den
