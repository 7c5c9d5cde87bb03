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
            corr_fn=cost_volume, photo_fn=photometric_pack, reg_fn=regularizer_pack,
            return_aux: bool = False):
    """Training forward pass -> the four per-sample (B,) float32 losses.

    images: (B, 3H, W, 3) vertically stacked (prev, center, next) frames in
    [0, 1], the JAX layout.  One encoder pass at 3B ``[img; imgl; imgr]``
    and one decoder pass at 2B ``[bwd; fwd]`` (center->prev, center->next).
    Each loss scale runs ``photo_fn`` (the fused photometric pack) and, with
    ``cfg.use_pallas_reg``, ``reg_fn`` (the fused smoothness and consistency
    sums); the occlusion ablation takes the unfused plain path instead.
    ``corr_fn``, ``photo_fn`` and ``reg_fn`` let a check run the plain
    versions on the card.  With ``return_aux``: (pack, {"flows": the packed
    [bwd; fwd] (2B, 2, h, w) float32 flows of every level, finest first,
    "weights": the detached (2B, 1, h, w) occlusion weights of each loss
    scale}), for the flow+pose branch.
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
    pack = {
        "loss_pixel": loss_pixel[:b] + loss_pixel[b:],
        "loss_ssim": loss_ssim[:b] + loss_ssim[b:],
        "loss_flow_smooth": smooth[:b] + smooth[b:],
        "loss_flow_consis": consis,
    }
    if return_aux:
        return pack, {"flows": flows, "weights": [w.detach() for w in weights]}
    return pack


def forward_pair(model: FlowModel, cfg: FlowModelConfig, images: torch.Tensor,
                 corr_fn=cost_volume, return_aux: bool = False):
    """2-frame training forward pass (the JAX ``forward_pair``).

    images: (B, 2H, W, 3) stacked (frame1, frame2) in [0, 1].  One encoder
    pass at 2B and one decoder pass at 2B, packed ``[1->2; 2->1]``; the
    photometric terms are weighted by the warp validity times a soft
    forward-backward weight ``exp(-|f_ab + back|^2 / (|f_ab|^2 + |back|^2 +
    1))``, ``back`` the backward flow resampled at ``x + f_ab(x)``, and go
    through the plain ``losses`` (no photometric kernel, as in JAX).  The
    consistency term compares f_ab against ``back``.  Returns the four (B,)
    losses; with ``return_aux`` also {"flows", "weights"} as ``forward``
    gives them.
    """
    b, h2, w = images.shape[:3]
    h = h2 // 2
    x = images.permute(0, 3, 1, 2)
    img1, img2 = (x[:, :, i * h:(i + 1) * h].contiguous() for i in range(2))

    feats = model.fpyramid(torch.cat([img1, img2], 0))
    feats_src = list(feats)
    feats_tgt = [torch.cat([f[b:], f[:b]], 0) for f in feats]
    flows = [f.float() for f in model.pwc_model(feats_src, feats_tgt, (h, w), corr_fn=corr_fn)]

    ld = getattr(torch, cfg.loss_dtype)
    ns = cfg.num_scales
    pyr1 = avg_pool_pyramid(img1.to(ld), len(flows))
    pyr2 = avg_pool_pyramid(img2.to(ld), len(flows))
    pyr_tgt = [torch.cat([p2, p1], 0) for p1, p2 in zip(pyr1[:ns], pyr2[:ns])]
    pyr_src = [torch.cat([p1, p2], 0) for p1, p2 in zip(pyr1[:ns], pyr2[:ns])]
    warped = [bilinear_warp(t, f, use_mask=True) for t, f in zip(pyr_tgt, flows)]

    weights, backs = [], []
    for s in range(ns):
        f_ab = flows[s]
        f_ba = torch.cat([f_ab[b:], f_ab[:b]], 0)
        back = bilinear_warp(f_ba, f_ab, use_mask=False)
        backs.append(back)
        sq = ((f_ab + back) ** 2).sum(1, keepdim=True)
        mag = (f_ab ** 2 + back ** 2).sum(1, keepdim=True)
        soft = torch.exp(-sq / (mag + 1.0))
        valid = 1.0 - (warped[s] == 0).all(1, keepdim=True).to(f_ab.dtype)
        weights.append((soft * valid).detach().to(ld))
    diffs = [(p - wp).abs().mean(1, keepdim=True) for p, wp in zip(pyr_src, warped)]

    def halves(v):
        return v[:b] + v[b:]

    pack = {
        "loss_pixel": halves(losses.masked_diff_loss(diffs, weights, ns)),
        "loss_ssim": halves(losses.masked_ssim_loss(pyr_src, warped, weights, ns)),
        "loss_flow_smooth": halves(losses.flow_smooth_loss(flows, pyr_src, ns)),
        "loss_flow_consis": losses.flow_consistency_loss(
            [f[:b] for f in flows[:ns]], [bk[:b] for bk in backs], [w[:b] for w in weights], ns),
    }
    if return_aux:
        return pack, {"flows": flows, "weights": weights}
    return pack
