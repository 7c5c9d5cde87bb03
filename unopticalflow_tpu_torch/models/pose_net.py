"""6-DoF pose network of the flow+pose branch (NCHW).

Port of ``unopticalflow_tpu/models/pose_net.py``: seven 3x3 stride-2 conv
blocks (LeakyReLU 0.1) over two RGB frames stacked on the channels, a 1x1
``pose_pred`` conv to 6 channels, the mean over H and W in float32, times
``POSE_SCALE``.  ``pose = (tx, ty, tz, rx, ry, rz)`` maps the second frame's
camera points into the first's (``ops/geometry.py::pose_vec2mat``).

State-dict keys: ``conv<i>.0.weight`` / ``.bias`` (a conv block) and
``pose_pred.weight`` / ``.bias`` (bare), under the ``pose.`` prefix of
``FlowPoseModel``.  Plain convolutions (cuDNN on the card), as the JAX
package computes them.
"""

from __future__ import annotations

import torch
from torch import nn

from unopticalflow_tpu_torch.models.layers import Conv2d, conv_block

# (in_ch, out_ch, stride); the input is two RGB frames stacked on channels
_LAYERS = (
    (6, 16, 2),
    (16, 32, 2),
    (32, 64, 2),
    (64, 128, 2),
    (128, 256, 2),
    (256, 256, 2),
    (256, 256, 2),
)

POSE_SCALE = 0.01


class PoseNet(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        for i, (cin, cout, stride) in enumerate(_LAYERS):
            self.add_module(f"conv{i + 1}", conv_block(cin, cout, stride, device=device))
        self.pose_pred = Conv2d(_LAYERS[-1][1], 6, device=device, ksize=1)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) x 2 -> (B, 6) float32 pose, frame 2 -> frame 1."""
        x = torch.cat([img1, img2], 1)
        for i in range(len(_LAYERS)):
            x = getattr(self, f"conv{i + 1}")(x)
        x = self.pose_pred(x)
        return POSE_SCALE * x.float().mean((2, 3))
