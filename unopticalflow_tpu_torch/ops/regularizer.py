"""The fused regularizer of one loss scale: smoothness and consistency sums.

Port of ``unopticalflow_tpu/ops/pallas_regularizer.py::regularizer_pack``,
NCHW:

    regularizer_pack(flow_b, flow_f, img, w_fwd) -> {
        "s_sx":     (2B,) f32  sum_c sum_{i, j<=W-3} wx[i, j+1] |D2x g|[i, j],
        "s_sy":     (2B,) f32  sum_c sum_{i<=H-3, j} wy[i+1, j] |D2y g|[i, j],
        "s_consis": (B,)  f32  sum |n(flow_f) + n(flow_b)|_1 (1 - w_fwd),
    }

packed [bwd; fwd] like the photometric pack, with g = flow / 20,
D2x g[j] = (g[j+2] - g[j+1]) - (g[j+1] - g[j]) (D2y likewise along rows),
wx = exp(-10 mean_c |img[:, :, j+1] - img[:, :, j]|) (wy along rows), and
n(f) = f / (sqrt(f.f + 1e-24) + 1e-12) with flow_b detached in the
consistency term.  flow_b, flow_f: (B, 2, H, W) float32, the only inputs that
receive a gradient; img: (B, 3, H, W) float32 or bfloat16, the center
pyramid level; w_fwd: (B, 1, H, W) in img's dtype, the photometric pack's
forward occlusion weights.  The caller applies the plain losses' mean
denominators.

* ``regularizer_pack_reference`` is the plain PyTorch version, in float32,
  built from ``losses._grad_x``/``_grad_y``/``flow_normalization`` as the
  JAX package's ``regularizer_pack_reference`` is.
* ``regularizer_pack`` dispatches: CUDA tensors go to the hand-written
  kernels (``ops/regularizer_cuda.py``), CPU tensors to the plain version.

One row-shard of a height-sharded model (``parallel/spatial.py``) takes the
sums of the terms it owns:

    regularizer_pack_rows(flow_b_h, flow_f_h, img_h, w_fwd, row0, height)

with its flows and center rows carrying one halo row on each side ((B, .,
h + 2, w); rows outside the image are zeros), its owned rows global rows
``row0 .. row0 + h - 1`` of a ``height``-row map, and ``w_fwd`` the owned
rows' weights (B, 1, h, w).  A term along rows spans three rows and belongs
to the shard of its middle row, the row of its edge weight wy; the terms
along a row and the consistency term belong to the row's shard.  Added over
the shards, the sums are the whole map's.  ``regularizer_pack_rows_reference``
is the plain version (``losses.smoothness_rows``); ``regularizer_pack_rows``
dispatches CUDA tensors to the kernels' halo-prepadded form
(``regularizer_cuda.regularizer_rows``).

The scale by 1/20 is the product with the float32 0.05, written out: PyTorch
divides a CUDA tensor by a Python number as a product with its reciprocal
and a CPU tensor by true division, so ``flow / 20.0`` would round
differently on the two devices.  The second differences of upsampled flows
vanish over large areas, where a rounding difference flips the gradient's
sign(0) = 0 to +-w; the kernel scales by the same product and takes the
differences in the same order, so it agrees with this version bit for bit
there.
"""

from __future__ import annotations

import torch

from unopticalflow_tpu_torch.ops import regularizer_cuda

INV20 = 1.0 / 20.0


def regularizer_pack_reference(flow_b, flow_f, img, w_fwd) -> dict:
    """Plain version of the regularizer pack (same contract)."""
    # imported here: models/ imports this module
    from unopticalflow_tpu_torch.models import losses

    img2 = torch.cat([img, img], 0).float()
    g = torch.cat([flow_b, flow_f], 0).float() * INV20
    wx = torch.exp(-10.0 * losses._grad_x(img2).abs().mean(1, keepdim=True))
    wy = torch.exp(-10.0 * losses._grad_y(img2).abs().mean(1, keepdim=True))
    dx2 = losses._grad_x(losses._grad_x(g))
    dy2 = losses._grad_y(losses._grad_y(g))
    s_sx = (wx[..., 1:] * dx2.abs()).sum((1, 2, 3))
    s_sy = (wy[:, :, 1:, :] * dy2.abs()).sum((1, 2, 3))

    n_f = losses.flow_normalization(flow_f.float())
    n_b = losses.flow_normalization(flow_b.float()).detach()
    occ = 1.0 - w_fwd.float()
    s_c = ((n_f + n_b).abs() * occ).sum((1, 2, 3))
    return {"s_sx": s_sx, "s_sy": s_sy, "s_consis": s_c}


def regularizer_pack(flow_b, flow_f, img, w_fwd) -> dict:
    """The regularizer pack: the CUDA kernels for CUDA tensors, plain on CPU."""
    if img.is_cuda:
        return regularizer_cuda.regularizer(flow_b, flow_f, img, w_fwd)
    if img.device.type == "cpu":
        return regularizer_pack_reference(flow_b, flow_f, img, w_fwd)
    raise ValueError(f"regularizer_pack: unsupported device {img.device}")


def regularizer_pack_rows_reference(flow_b_h, flow_f_h, img_h, w_fwd, row0: int,
                                    height: int) -> dict:
    """Plain version of one row-shard's pack (see the module docstring)."""
    from unopticalflow_tpu_torch.models import losses

    g = torch.cat([flow_b_h, flow_f_h], 0).float() * INV20
    s_sx, s_sy = losses.smoothness_rows(g, torch.cat([img_h, img_h], 0).float(), row0, height)
    s_c, _ = losses.consistency_rows(flow_f_h[:, :, 1:-1].float(), flow_b_h[:, :, 1:-1].float(),
                                     w_fwd.float())
    return {"s_sx": s_sx, "s_sy": s_sy, "s_consis": s_c}


def regularizer_pack_rows(flow_b_h, flow_f_h, img_h, w_fwd, row0: int, height: int) -> dict:
    """One row-shard's pack: the halo-prepadded kernels for CUDA tensors, plain on CPU."""
    if img_h.is_cuda:
        return regularizer_cuda.regularizer_rows(flow_b_h, flow_f_h, img_h, w_fwd, row0, height)
    if img_h.device.type == "cpu":
        return regularizer_pack_rows_reference(flow_b_h, flow_f_h, img_h, w_fwd, row0, height)
    raise ValueError(f"regularizer_pack_rows: unsupported device {img_h.device}")
