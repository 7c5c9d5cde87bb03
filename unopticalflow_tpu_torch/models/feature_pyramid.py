"""Six-stage convolutional feature encoder (NCHW).

Port of ``unopticalflow_tpu/models/feature_pyramid.py``: 12 conv blocks,
alternating stride 2 and stride 1, giving features at 1/2 .. 1/64 resolution
with (16, 32, 64, 96, 128, 196) channels.  The JAX package's space-to-depth
packing of conv1-conv3 is an exact re-lay for the TPU's matrix unit; here the
plain convolutions compute the same values.
"""

from __future__ import annotations

import torch
from torch import nn

from unopticalflow_tpu_torch.models.layers import conv_block

# (in_ch, out_ch, stride) for conv1..conv12; every odd layer downsamples.
_LAYERS = (
    (3, 16, 2), (16, 16, 1),
    (16, 32, 2), (32, 32, 1),
    (32, 64, 2), (64, 64, 1),
    (64, 96, 2), (96, 96, 1),
    (96, 128, 2), (128, 128, 1),
    (128, 196, 2), (196, 196, 1),
)


class FeaturePyramid(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        for i, (cin, cout, stride) in enumerate(_LAYERS):
            self.add_module(f"conv{i + 1}", conv_block(cin, cout, stride, device=device))

    def forward(self, img, conv=lambda layer, x: layer(x)) -> tuple[torch.Tensor, ...]:
        """img (B, 3, H, W) -> 6 feature maps at 1/2 .. 1/64 resolution.

        ``conv(layer, x)`` applies a layer (``parallel/spatial.py`` passes its
        row-shard form, with ``img`` a list of row-shards)."""
        feats = []
        x = img
        for i, (_, _, stride) in enumerate(_LAYERS):
            x = conv(getattr(self, f"conv{i + 1}"), x)
            if stride == 1:  # every stride-1 conv closes one pyramid stage
                feats.append(x)
        return tuple(feats)
