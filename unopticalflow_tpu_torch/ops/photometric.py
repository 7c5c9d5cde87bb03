"""The photometric loss pack of one scale: warp, occlusion weights, L1 and SSIM sums.

Port of ``unopticalflow_tpu/ops/pallas_photometric.py::photometric_pack``,
NCHW, taking the images themselves instead of pre-gathered corners:

    photometric_pack(img_l, img_r, flow_b, flow_f, img) -> {
        "s_dw": (2B,) f32  sum of diff * weight,
        "s_w":  (2B,) f32  sum of weight (no gradient),
        "s_cl": (2B,) f32  sum of clamp((1 - SSIM(img*w, warped*w)) / 2, 0, 1) / 3,
        "weights": (2B, 1, h, w) occlusion weights in the image dtype (no gradient),
    }

packed [bwd; fwd]: bwd warps ``img_l`` by ``flow_b``, fwd warps ``img_r`` by
``flow_f``, both against the center frame ``img``.  Images are (B, 3, h, w)
float32 or bfloat16, flows (B, 2, h, w) float32.  Only the flows receive a
gradient.

* ``photometric_pack_reference`` is the plain PyTorch version, built from
  ``bilinear_warp(use_mask=True)``, ``losses.diff_and_occlusion_weights_packed``
  and ``ssim`` (the composition of the JAX package's
  ``photometric_pack_reference``).
* ``photometric_pack`` dispatches: CUDA tensors go to the hand-written kernels
  (``ops/photometric_cuda.py``), CPU tensors to the plain version.

In bfloat16 the two differ slightly: the kernel blends the bf16 corners in
float32 and never rounds the warped image, as the fused JAX kernel does,
while ``bilinear_warp`` rounds it to bf16.
"""

from __future__ import annotations

import torch

from unopticalflow_tpu_torch.ops import photometric_cuda
from unopticalflow_tpu_torch.ops.ssim import ssim
from unopticalflow_tpu_torch.ops.warp import bilinear_warp


def photometric_pack_reference(img_l, img_r, flow_b, flow_f, img) -> dict:
    """Plain version of the photometric pack (same contract)."""
    # imported here: models/ imports this module
    from unopticalflow_tpu_torch.models import losses

    warped = torch.cat([bilinear_warp(img_l, flow_b, use_mask=True),
                        bilinear_warp(img_r, flow_f, use_mask=True)], 0)
    diffs, weights = losses.diff_and_occlusion_weights_packed([warped], [img], 1)
    diff, weight = diffs[0], weights[0]
    s_map = ssim(torch.cat([img, img], 0) * weight, warped * weight)
    cl = torch.clamp((1.0 - s_map) / 2.0, 0.0, 1.0)
    return {
        "s_dw": (diff * weight).float().sum((1, 2, 3)),
        "s_w": weight.float().sum((1, 2, 3)).detach(),
        "s_cl": cl.float().sum((1, 2, 3)) / 3.0,
        "weights": weight.detach(),
    }


def photometric_pack(img_l, img_r, flow_b, flow_f, img) -> dict:
    """The photometric pack: the CUDA kernels for CUDA tensors, plain on CPU."""
    if img.is_cuda:
        return photometric_cuda.photometric(img_l, img_r, flow_b, flow_f, img)
    if img.device.type == "cpu":
        return photometric_pack_reference(img_l, img_r, flow_b, flow_f, img)
    raise ValueError(f"photometric_pack: unsupported device {img.device}")
