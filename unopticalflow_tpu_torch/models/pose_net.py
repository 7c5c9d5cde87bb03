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

On row-shards (``parallel/spatial.py::pose_rows``) the same ``encode`` runs
each conv on a shard with its halo rows, and the mean is the shards' float32
sums added over H * W.  The pose net halves the rows seven times, the
encoder six: where a stride-2 conv would start a shard on an odd row (the
1-row shards of level 6 at H = n * 64), neighbouring shards are joined first,
so the last levels run on fewer shards.
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

    def encode(self, x, conv=lambda layer, x: layer(x)):
        """The conv blocks and ``pose_pred`` of (B, 6, H, W) -> (B, 6, H / 128,
        W / 128), before the mean.  ``conv(layer, x)`` applies a layer
        (``parallel/spatial.py`` passes its row-shard form, with ``x`` a list
        of row-shards)."""
        for i in range(len(_LAYERS)):
            x = conv(getattr(self, f"conv{i + 1}"), x)
        return conv(self.pose_pred, x)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) x 2 -> (B, 6) float32 pose, frame 2 -> frame 1."""
        x = self.encode(torch.cat([img1, img2], 1))
        return POSE_SCALE * x.float().mean((2, 3))
