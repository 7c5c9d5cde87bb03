"""The flow model for inference: encoder + PWC decoder.

Port of the inference half of ``unopticalflow_tpu/models/flow_model.py``.
The children are ``fpyramid`` and ``pwc_model``, so the state-dict keys are
the reference's (and ``params_to_torch_state_dict``'s output).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from unopticalflow_tpu_torch.models.feature_pyramid import FeaturePyramid
from unopticalflow_tpu_torch.models.layers import init_convs, set_compute_dtype
from unopticalflow_tpu_torch.models.pwc_decoder import PWCDecoder
from unopticalflow_tpu_torch.ops.cost_volume import cost_volume


class FlowModelConfig(NamedTuple):
    """The subset of the JAX ``FlowModelConfig`` that inference reads."""

    # compute dtype for conv/corr work; parameters stay float32
    compute_dtype: str = "float32"


class FlowModel(nn.Module):
    def __init__(self, cfg: FlowModelConfig = FlowModelConfig(), device=None,
                 scheme: str = "torch", generator: torch.Generator | None = None):
        super().__init__()
        self.fpyramid = FeaturePyramid(device=device)
        self.pwc_model = PWCDecoder(device=device)
        init_convs(self, scheme, generator)
        set_compute_dtype(self, getattr(torch, cfg.compute_dtype))


def inference_flow(model: FlowModel, img1: torch.Tensor, img2: torch.Tensor,
                   corr_fn=cost_volume) -> torch.Tensor:
    """Full-resolution flow img1 -> img2.

    img1/img2: (B, H, W, 3) in [0, 1], the JAX package's layout.
    Returns (B, H, W, 2) float32 flow in pixels.  ``corr_fn`` overrides the
    decoder's cost volume (e.g. with the plain version, to check the kernel).
    """
    b, h, w = img1.shape[:3]
    # one encoder pass for both frames, stacked on the batch; contiguous NCHW
    # so every feature map (and so the correlation kernel's input) is too
    imgs = torch.cat([img1, img2], 0).permute(0, 3, 1, 2).contiguous()
    feats = model.fpyramid(imgs)
    f1 = [f[:b] for f in feats]
    f2 = [f[b:] for f in feats]
    flow = model.pwc_model(f1, f2, (h, w), corr_fn=corr_fn)[0]
    return flow.permute(0, 2, 3, 1).float()
