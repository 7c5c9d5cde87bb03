"""PWC-style coarse-to-fine optical-flow decoder (NCHW).

Port of ``unopticalflow_tpu/models/pwc_decoder.py``: five levels (6 -> 2).
Each level correlates the source features against the (warped) target
features in a +-4 px window (81 channels, no activation on the cost volume),
runs the dense-concat estimator (128, 128, 96, 64, 32) and a 2-channel flow
head; levels 5..2 warp the target features by the 2x-upsampled coarser flow
and predict a residual.  Level 2 is refined by the dilated context network.
Outputs are 4 flows upsampled (and scaled x4) to (H, W) .. (H/8, W/8).
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

    def _estimate(self, lvl: int, inp: torch.Tensor):
        """Dense-concat estimator; returns (last hidden x4, predicted flow)."""
        conv = lambda i: getattr(self, f"conv{lvl}_{i}")  # noqa: E731
        x0 = conv(0)(inp)
        x1 = conv(1)(x0)
        x2 = conv(2)(torch.cat([x0, x1], 1))
        x3 = conv(3)(torch.cat([x1, x2], 1))
        x4 = conv(4)(torch.cat([x2, x3], 1))
        flow = getattr(self, f"predict_flow{lvl}")(torch.cat([x3, x4], 1))
        return x4, flow

    def forward(self, feats1, feats2, img_hw, corr_fn=cost_volume):
        """Decode flow from two 6-level feature pyramids (finest first).

        ``corr_fn(f1, f2, md)`` builds each level's cost volume; the default
        dispatches to the CUDA kernel for CUDA tensors.  Returns 4 NCHW flows,
        finest first.
        """
        flows = {}
        flow = None
        for lvl, _, extra in _LEVELS:
            f1 = feats1[lvl - 1]
            f2 = feats2[lvl - 1]
            if extra == 0:  # coarsest level: no warp, no upsampled flow
                corr = corr_fn(f1, f2, MAX_DISPLACEMENT)
                x4, flow = self._estimate(lvl, corr)
            else:
                up_flow = upsample2x_double(flow)
                warped = bilinear_warp(f2, up_flow)
                corr = corr_fn(f1, warped, MAX_DISPLACEMENT)
                x4, res = self._estimate(lvl, torch.cat([corr, f1, up_flow], 1))
                flow = res + up_flow
            if lvl == 2:  # dilated context refinement
                x = torch.cat([flow, x4], 1)
                for i in range(len(_CONTEXT)):
                    x = getattr(self, f"dc_conv{i + 1}")(x)
                flow = flow + self.dc_conv7(x)
            flows[lvl] = flow
        h, w = int(img_hw[0]), int(img_hw[1])
        return [
            resize_bilinear(flows[2] * 4.0, (h, w)),
            resize_bilinear(flows[3] * 4.0, (h // 2, w // 2)),
            resize_bilinear(flows[4] * 4.0, (h // 4, w // 4)),
            resize_bilinear(flows[5] * 4.0, (h // 8, w // 8)),
        ]
