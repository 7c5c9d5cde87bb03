"""The flow model: encoder + PWC decoder, inference and the training forward.

Port of ``unopticalflow_tpu/models/flow_model.py``.  The children are
``fpyramid`` and ``pwc_model``, so the state-dict keys are the reference's
(and ``params_to_torch_state_dict``'s output).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from unopticalflow_tpu_torch.models import losses
from unopticalflow_tpu_torch.models.feature_pyramid import FeaturePyramid
from unopticalflow_tpu_torch.models.layers import init_convs, set_compute_dtype
from unopticalflow_tpu_torch.models.pwc_decoder import PWCDecoder
from unopticalflow_tpu_torch.ops.cost_volume import cost_volume
from unopticalflow_tpu_torch.ops.photometric import photometric_pack
from unopticalflow_tpu_torch.ops.pyramid import avg_pool_pyramid
from unopticalflow_tpu_torch.ops.regularizer import regularizer_pack
from unopticalflow_tpu_torch.ops.warp import bilinear_warp


class FlowModelConfig(NamedTuple):
    """The subset of the JAX ``FlowModelConfig`` that the port reads."""

    # loss scales of the training forward (finest first)
    num_scales: int = 3
    # compute dtype for conv/corr work; parameters stay float32
    compute_dtype: str = "float32"
    # dtype of the image-space loss stack (pyramids, warps, diffs); positions,
    # SSIM statistics and per-sample reductions stay float32
    loss_dtype: str = "float32"
    # ablation: False replaces the softmax occlusion weights by the warp
    # validity alone and takes the unfused plain loss path
    use_occlusion_weights: bool = True
    # the JAX field's name: route smoothness and consistency through the fused
    # regularizer (the port's CUDA kernels, ops/regularizer.py) at each scale
    # of the fused photometric path; off by default, as in the JAX package
    use_pallas_reg: bool = False


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


def forward(model: FlowModel, cfg: FlowModelConfig, images: torch.Tensor,
            corr_fn=cost_volume, photo_fn=photometric_pack, reg_fn=regularizer_pack) -> dict:
    """Training forward pass -> the four per-sample (B,) float32 losses.

    images: (B, 3H, W, 3) vertically stacked (prev, center, next) frames in
    [0, 1], the JAX layout.  One encoder pass at 3B ``[img; imgl; imgr]``
    and one decoder pass at 2B ``[bwd; fwd]`` (center->prev, center->next).
    Each loss scale runs ``photo_fn`` (the fused photometric pack) and, with
    ``cfg.use_pallas_reg``, ``reg_fn`` (the fused smoothness and consistency
    sums); the occlusion ablation takes the unfused plain path instead.
    ``corr_fn``, ``photo_fn`` and ``reg_fn`` let a check run the plain
    versions on the card.
    """
    b, h3, w = images.shape[:3]
    h = h3 // 3
    x = images.permute(0, 3, 1, 2)
    imgl, img, imgr = (x[:, :, i * h:(i + 1) * h].contiguous() for i in range(3))

    feats = model.fpyramid(torch.cat([img, imgl, imgr], 0))
    feats_cc = [torch.cat([f[:b], f[:b]], 0) for f in feats]
    feats_lr = [f[b:] for f in feats]
    flows = [f.float() for f in model.pwc_model(feats_cc, feats_lr, (h, w), corr_fn=corr_fn)]

    ld = getattr(torch, cfg.loss_dtype)
    pyr_c = avg_pool_pyramid(img.to(ld), len(flows))
    pyr_lr = avg_pool_pyramid(torch.cat([imgl, imgr], 0).to(ld), len(flows))

    ns = cfg.num_scales
    flows_bwd = [f[:b] for f in flows[:ns]]
    flows_fwd = [f[b:] for f in flows[:ns]]
    fused_reg = cfg.use_pallas_reg and cfg.use_occlusion_weights
    if cfg.use_occlusion_weights:
        loss_pixel = loss_ssim = smooth = consis = 0.0
        weights = []
        for s in range(ns):
            out = photo_fn(pyr_lr[s][:b], pyr_lr[s][b:], flows_bwd[s], flows_fwd[s], pyr_c[s])
            h_s, w_s = pyr_c[s].shape[2], pyr_c[s].shape[3]
            hw = h_s * w_s
            mean_w = out["s_w"] / hw + 1e-12
            loss_pixel = loss_pixel + (out["s_dw"] / hw) / mean_w
            loss_ssim = loss_ssim + (out["s_cl"] / hw) / mean_w
            weights.append(out["weights"])
            if fused_reg:
                # the plain losses' mean denominators (JAX flow_model.py:287-294)
                reg = reg_fn(flows_bwd[s], flows_fwd[s], pyr_c[s], out["weights"][b:].detach())
                err = reg["s_sx"] / (h_s * (w_s - 2) * 2) + reg["s_sy"] / ((h_s - 2) * w_s * 2)
                smooth = smooth + err / 2.0
                occ_mean = 1.0 - out["s_w"][b:] / hw  # mean(1 - w_fwd)
                consis = consis + (reg["s_consis"] / (hw * 2)) / (occ_mean + 1e-12)
    else:
        warped_lr = [bilinear_warp(i, f, use_mask=True) for i, f in zip(pyr_lr[:ns], flows[:ns])]
        diffs, weights = losses.diff_and_occlusion_weights_packed(
            warped_lr, pyr_c, ns, use_weights=False)
        pyr_cc = [torch.cat([p, p], 0) for p in pyr_c[:ns]]
        loss_pixel = losses.masked_diff_loss(diffs, weights, ns)
        loss_ssim = losses.masked_ssim_loss(pyr_cc, warped_lr, weights, ns)

    if not fused_reg:
        # the B-sized center pyramid: both packed halves share its edge weights
        smooth = losses.flow_smooth_loss(flows, pyr_c[:ns], ns)
        consis = losses.flow_consistency_loss(flows_fwd, flows_bwd, [w[b:] for w in weights], ns)
    return {
        "loss_pixel": loss_pixel[:b] + loss_pixel[b:],
        "loss_ssim": loss_ssim[:b] + loss_ssim[b:],
        "loss_flow_smooth": smooth[:b] + smooth[b:],
        "loss_flow_consis": consis,
    }
