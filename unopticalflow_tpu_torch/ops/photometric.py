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

One row-shard of a height-sharded model (``parallel/spatial.py``) takes the
pack over the rows it owns:

    photometric_pack_rows(img_l, img_r, flow_b_h, flow_f_h, img_h, row0, height)

with the whole (B, 3, height, w) sources ``img_l``/``img_r`` gathered onto the
shard's device, and the shard's center rows ``img_h`` and flows carrying one
halo row on each side ((B, ., h + 2, w); rows outside the image are zeros).
Its owned rows are global rows ``row0 .. row0 + h - 1``.  It returns the
owned rows' ``s_dw``, ``s_w``, ``s_cl`` and ``weights`` (2B, 1, h, w): added
over the shards, the sums are the whole map's.  The halo rows hold SSIM's
3x3 windows: inside the image they are real rows, with their own warps and
weights; outside it their products are SSIM's zero padding (their warp falls
outside the image, so their weight is 0).  The gradient reaches the halo
rows' flows, which autograd carries to the shards that own them.
``photometric_pack_rows_reference`` is its plain version, and
``photometric_pack_rows`` dispatches as ``photometric_pack`` does, to the
kernels' halo-prepadded form (``photometric_cuda.photometric_rows``).

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


def photometric_pack_rows_reference(img_l, img_r, flow_b_h, flow_f_h, img_h, row0: int,
                                    height: int, use_weights: bool = True) -> dict:
    """Plain version of one row-shard's pack (see the module docstring).
    ``use_weights=False`` is the occlusion ablation's pack: the weights are
    the warp's validity alone (``losses.diff_and_occlusion_weights_packed``),
    a form the kernels do not take, as in the unsharded forward."""
    from unopticalflow_tpu_torch.models import losses

    if img_l.shape[2] != height or img_r.shape[2] != height:
        raise ValueError(f"photometric_pack_rows: sources of {img_l.shape[2]} and "
                         f"{img_r.shape[2]} rows, want the whole {height}")
    warped = torch.cat([bilinear_warp(img_l, flow_b_h, use_mask=True, row0=row0 - 1),
                        bilinear_warp(img_r, flow_f_h, use_mask=True, row0=row0 - 1)], 0)
    diffs, weights = losses.diff_and_occlusion_weights_packed([warped], [img_h], 1,
                                                              use_weights=use_weights)
    return owned_rows_pack(torch.cat([img_h, img_h], 0), warped, diffs[0], weights[0])


def owned_rows_pack(img_h, warped_h, diff_h, weight_h) -> dict:
    """The pack's sums over a slab's owned rows, all but its first and last
    (the halo rows, which only SSIM's 3x3 window reads): ``img_h`` and
    ``warped_h`` (N, C, h + 2, w), ``diff_h`` and ``weight_h`` (N, 1, h + 2,
    w) of the same slab; the weights of the owned rows, detached, as
    ``weights``."""
    own = slice(1, img_h.shape[2] - 1)
    s_map = ssim(img_h * weight_h, warped_h * weight_h)[:, :, own]
    diff, weight = diff_h[:, :, own], weight_h[:, :, own]
    cl = torch.clamp((1.0 - s_map) / 2.0, 0.0, 1.0)
    return {
        "s_dw": (diff * weight).float().sum((1, 2, 3)),
        "s_w": weight.float().sum((1, 2, 3)).detach(),
        "s_cl": cl.float().sum((1, 2, 3)) / 3.0,
        "weights": weight.detach(),
    }


def photometric_pack_rows(img_l, img_r, flow_b_h, flow_f_h, img_h, row0: int,
                          height: int) -> dict:
    """One row-shard's pack: the halo-prepadded kernels for CUDA tensors, plain on CPU."""
    if img_h.is_cuda:
        return photometric_cuda.photometric_rows(img_l, img_r, flow_b_h, flow_f_h, img_h, row0,
                                                 height)
    if img_h.device.type == "cpu":
        return photometric_pack_rows_reference(img_l, img_r, flow_b_h, flow_f_h, img_h, row0,
                                               height)
    raise ValueError(f"photometric_pack_rows: unsupported device {img_h.device}")
