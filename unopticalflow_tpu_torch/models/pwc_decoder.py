"""PWC-style coarse-to-fine optical-flow decoder (NCHW).

Port of ``unopticalflow_tpu/models/pwc_decoder.py``: five levels (6 -> 2).
Each level correlates the source features against the (warped) target
features in a +-4 px window (81 channels, no activation on the cost volume),
runs the dense-concat estimator (128, 128, 96, 64, 32) and a 2-channel flow
head; levels 5..2 warp the target features by the 2x-upsampled coarser flow
and predict a residual.  Level 2 is refined by the dilated context network.
Outputs are 4 flows upsampled (and scaled x4) to (H, W) .. (H/8, W/8).

``PWCDecoder.decode`` walks the levels once for both forms of the model: it
takes its operations (convolution, concatenation, sum, cost volume, 2x
upsampling, warp) as an object, ``DenseOps`` on whole maps here, and
``parallel/spatial.py``'s on maps split into row-shards.
"""

from __future__ import annotations

import torch
from torch import nn

from unopticalflow_tpu_torch.models.layers import Conv2d, conv_block
from unopticalflow_tpu_torch.ops.cost_volume import cost_volume
from unopticalflow_tpu_torch.ops.resize import resize_bilinear, upsample2x_double
from unopticalflow_tpu_torch.ops.warp import bilinear_warp

MAX_DISPLACEMENT = 4
_ND = (2 * MAX_DISPLACEMENT + 1) ** 2  # 81 correlation channels
_DD = (128, 128, 96, 64, 32)  # estimator widths

# (level id, feature channels, extra input channels beyond the cost volume:
# features + upsampled flow), coarsest first
_LEVELS = (
    (6, 196, 0),
    (5, 128, 128 + 2),
    (4, 96, 96 + 2),
    (3, 64, 64 + 2),
    (2, 32, 32 + 2),
)

# context network: (in_ch, out_ch, dilation); dc_conv7 is a linear flow head
_CONTEXT = (
    (_DD[4] + 2, 128, 1),
    (128, 128, 2),
    (128, 128, 4),
    (128, 96, 8),
    (96, 64, 16),
    (64, 32, 1),
)


class DenseOps:
    """The decoder's and encoder's operations on whole (B, C, H, W) maps."""

    def __init__(self, corr_fn=cost_volume):
        self.corr_fn = corr_fn

    @staticmethod
    def conv(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return layer(x)

    @staticmethod
    def cat(xs) -> torch.Tensor:
        return torch.cat(xs, 1)

    @staticmethod
    def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a + b

    def corr(self, f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
        return self.corr_fn(f1, f2, MAX_DISPLACEMENT)

    @staticmethod
    def up(flow: torch.Tensor) -> torch.Tensor:
        return upsample2x_double(flow)

    @staticmethod
    def warp(f2: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        return bilinear_warp(f2, flow)


def _estimator_widths(in_ch: int):
    pairs = [(in_ch, _DD[0]), (_DD[0], _DD[1]), (_DD[0] + _DD[1], _DD[2]),
             (_DD[1] + _DD[2], _DD[3]), (_DD[2] + _DD[3], _DD[4])]
    head = (_DD[3] + _DD[4], 2)
    return pairs, head


class PWCDecoder(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        # registration order = the JAX init order (estimators, then context)
        for lvl, _, extra in _LEVELS:
            pairs, head = _estimator_widths(_ND + extra)
            for i, (cin, cout) in enumerate(pairs):
                self.add_module(f"conv{lvl}_{i}", conv_block(cin, cout, device=device))
            self.add_module(f"predict_flow{lvl}", Conv2d(*head, device=device))
        for i, (cin, cout, dil) in enumerate(_CONTEXT):
            self.add_module(f"dc_conv{i + 1}", conv_block(cin, cout, dilation=dil, device=device))
        self.dc_conv7 = Conv2d(_CONTEXT[-1][1], 2, device=device)

    def _estimate(self, lvl: int, inp, ops):
        """Dense-concat estimator; returns (last hidden x4, predicted flow)."""
        conv = lambda i, x: ops.conv(getattr(self, f"conv{lvl}_{i}"), x)  # noqa: E731
        x0 = conv(0, inp)
        x1 = conv(1, x0)
        x2 = conv(2, ops.cat([x0, x1]))
        x3 = conv(3, ops.cat([x1, x2]))
        x4 = conv(4, ops.cat([x2, x3]))
        flow = ops.conv(getattr(self, f"predict_flow{lvl}"), ops.cat([x3, x4]))
        return x4, flow

    def decode(self, feats1, feats2, ops) -> dict:
        """{level: flow at that level's resolution} for levels 6..2, from two
        6-level feature pyramids (finest first), computed with ``ops``."""
        flows = {}
        flow = None
        for lvl, _, extra in _LEVELS:
            f1 = feats1[lvl - 1]
            f2 = feats2[lvl - 1]
            if extra == 0:  # coarsest level: no warp, no upsampled flow
                x4, flow = self._estimate(lvl, ops.corr(f1, f2), ops)
            else:
                up_flow = ops.up(flow)
                corr = ops.corr(f1, ops.warp(f2, up_flow))
                x4, res = self._estimate(lvl, ops.cat([corr, f1, up_flow]), ops)
                flow = ops.add(res, up_flow)
            if lvl == 2:  # dilated context refinement
                x = ops.cat([flow, x4])
                for i in range(len(_CONTEXT)):
                    x = ops.conv(getattr(self, f"dc_conv{i + 1}"), x)
                flow = ops.add(flow, ops.conv(self.dc_conv7, x))
            flows[lvl] = flow
        return flows

    def forward(self, feats1, feats2, img_hw, corr_fn=cost_volume):
        """Decode flow from two 6-level feature pyramids (finest first).

        ``corr_fn(f1, f2, md)`` builds each level's cost volume; the default
        dispatches to the CUDA kernel for CUDA tensors.  Returns 4 NCHW flows,
        finest first.
        """
        flows = self.decode(feats1, feats2, DenseOps(corr_fn))
        h, w = int(img_hw[0]), int(img_hw[1])
        return [
            resize_bilinear(flows[2] * 4.0, (h, w)),
            resize_bilinear(flows[3] * 4.0, (h // 2, w // 2)),
            resize_bilinear(flows[4] * 4.0, (h // 4, w // 4)),
            resize_bilinear(flows[5] * 4.0, (h // 8, w // 8)),
        ]
