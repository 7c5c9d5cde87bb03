"""Occlusion-aware unsupervised flow losses (NCHW).

Port of ``unopticalflow_tpu/models/losses.py``:

* softmax diff-weight occlusion masks: per pixel, 1 - softmax over the (bwd,
  fwd) warped photometric errors, detached, sharpened by
  ``2 exp(-(w - 0.5)^2 / 0.03)`` and gated by the warped-pixel validity;
* masked L1 photometric loss and masked SSIM loss;
* second-order edge-aware smoothness on flow / 20;
* forward/backward direction consistency on occluded pixels, bwd detached.

Every loss is a per-sample (B,) float32 vector summed over ``num_scales``
scales; per-sample means accumulate in float32 even when the image-space
stack runs in bfloat16.  The caller applies the config weights and the
batch mean.

``smoothness_rows`` and ``consistency_rows`` give one row-shard's sums of the
smoothness and consistency terms for a height-sharded forward
(``parallel/spatial.py``), whose caller adds them over the shards and then
divides by the whole map's mean denominators.
"""

from __future__ import annotations

import torch

from unopticalflow_tpu_torch.ops.ssim import ssim

EPS_DIV = 1e-12


def _mean_chw(x: torch.Tensor) -> torch.Tensor:
    """Mean over all but the batch axis -> (B,), accumulated in float32."""
    return x.float().mean(dim=(1, 2, 3))


def flow_normalization(flow: torch.Tensor) -> torch.Tensor:
    """flow / (||flow||_2 + 1e-12) per pixel; (B, 2, H, W).

    The sum of squares gets a 1e-24 floor before the sqrt so the gradient is
    finite at exactly-zero flow.
    """
    norm = torch.sqrt((flow * flow).sum(1, keepdim=True) + 1e-24)
    return flow / (norm + EPS_DIV)


def diff_and_occlusion_weights_packed(warped_lr, imgs, num_scales: int,
                                      use_weights: bool = True):
    """Per-scale photometric diffs and occlusion weights, packed [bwd; fwd].

    ``warped_lr[s]`` is (2B, C, h, w): the from-prev (bwd) and from-next (fwd)
    warped images stacked on the batch; ``imgs[s]`` is the (B, C, h, w)
    center frame.  Returns per-scale (2B, 1, h, w) diffs and weights.
    ``use_weights=False`` is the occlusion ablation: the softmax weights
    become 1 and only the warp validity remains.
    """
    diffs, weights = [], []
    for s in range(num_scales):
        w2 = warped_lr[s]
        img = imgs[s]
        b = img.shape[0]
        # a warped pixel is valid unless every channel is exactly zero
        valid = 1.0 - (w2 == 0).all(1, keepdim=True).to(img.dtype)
        diff = (torch.cat([img, img], 0) - w2).abs().mean(1, keepdim=True)
        if use_weights:
            w = 1.0 - torch.softmax(torch.cat([diff[:b], diff[b:]], 1), 1)
            w = 2.0 * torch.exp(-torch.square(w.detach() - 0.5) / 0.03)
            weights.append(torch.cat([w[:, 0:1], w[:, 1:2]], 0) * valid)
        else:
            weights.append(valid)
        diffs.append(diff)
    return diffs, weights


def masked_diff_loss(diffs, occ_masks, num_scales: int) -> torch.Tensor:
    """Sum over scales of mean(diff * occ) / (mean(occ) + eps)."""
    total = 0.0
    for s in range(num_scales):
        divider = _mean_chw(occ_masks[s])
        total = total + _mean_chw(diffs[s] * occ_masks[s]) / (divider + EPS_DIV)
    return total


def masked_ssim_loss(imgs, imgs_warped, occ_masks, num_scales: int) -> torch.Tensor:
    """Sum over scales of the masked DSSIM loss."""
    total = 0.0
    for s in range(num_scales):
        occ = occ_masks[s]
        divider = _mean_chw(occ)
        s_map = ssim(imgs[s] * occ, imgs_warped[s] * occ)
        loss = _mean_chw(torch.clamp((1.0 - s_map) / 2.0, 0.0, 1.0))
        total = total + loss / (divider + EPS_DIV)
    return total


def _grad_x(x: torch.Tensor) -> torch.Tensor:
    return x[..., 1:] - x[..., :-1]


def _grad_y(x: torch.Tensor) -> torch.Tensor:
    return x[:, :, 1:, :] - x[:, :, :-1, :]


def second_order_smoothness(flow: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware second-order smoothness of one flow scale -> (B_flow,).

    ``img`` may carry a batch that divides ``flow``'s (the packed [bwd; fwd]
    flows share one center frame): the edge weights are computed once and
    tiled, which is exact because both halves see the same image.
    """
    w_x = torch.exp(-10.0 * _grad_x(img).abs().mean(1, keepdim=True))
    w_y = torch.exp(-10.0 * _grad_y(img).abs().mean(1, keepdim=True))
    if img.shape[0] != flow.shape[0]:
        reps = flow.shape[0] // img.shape[0]
        w_x = torch.cat([w_x] * reps, 0)
        w_y = torch.cat([w_y] * reps, 0)
    dx2 = _grad_x(_grad_x(flow))
    dy2 = _grad_y(_grad_y(flow))
    err = _mean_chw(w_x[..., 1:] * dx2.abs()) + _mean_chw(w_y[:, :, 1:, :] * dy2.abs())
    return err / 2.0


def smoothness_rows(flow_h: torch.Tensor, img_h: torch.Tensor, row0: int,
                    height: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The sums of ``second_order_smoothness``'s two terms that one row-shard
    owns -> ((B_flow,), (B_flow,)) float32, before the means' denominators
    (C h (w - 2) and C (h - 2) w of the whole map).

    ``flow_h`` (already scaled) and ``img_h`` hold the shard's rows with one
    halo row each side (global rows row0 - 1 .. row0 + h of a ``height``-row
    map; rows outside it are never read).  A term along a row belongs to its
    row's shard; a term along rows spans three rows and belongs to the shard
    of its middle row (the row of its edge weight), so each term is counted
    once over the shards.  ``img_h`` may carry a batch that divides the flow's,
    as in ``second_order_smoothness``.
    """
    h = flow_h.shape[2] - 2
    w_x = torch.exp(-10.0 * _grad_x(img_h[:, :, 1:h + 1]).abs().mean(1, keepdim=True))
    w_y = torch.exp(-10.0 * _grad_y(img_h).abs().mean(1, keepdim=True))
    if img_h.shape[0] != flow_h.shape[0]:
        reps = flow_h.shape[0] // img_h.shape[0]
        w_x = torch.cat([w_x] * reps, 0)
        w_y = torch.cat([w_y] * reps, 0)
    # y terms by their window's first slab row a: global row row0 - 1 + a in
    # [0, height - 3], middle row a + 1 owned
    lo = max(0, 1 - row0)
    hi = max(lo, min(h, height - 1 - row0))
    dx2 = _grad_x(_grad_x(flow_h[:, :, 1:h + 1]))
    dy2 = _grad_y(_grad_y(flow_h[:, :, lo:hi + 2]))
    s_x = (w_x[..., 1:] * dx2.abs()).float().sum((1, 2, 3))
    s_y = (w_y[:, :, lo + 1:hi + 1] * dy2.abs()).float().sum((1, 2, 3))
    return s_x, s_y


def flow_smooth_loss(flows, imgs, num_scales: int) -> torch.Tensor:
    """Sum over scales of second_order_smoothness(flow / 20, img)."""
    total = 0.0
    for s in range(num_scales):
        total = total + second_order_smoothness(flows[s] / 20.0, imgs[s])
    return total


def flow_consistency_loss(fwd_flows, bwd_flows, occ_masks, num_scales: int) -> torch.Tensor:
    """Direction consistency on occluded pixels (1 - weight), bwd detached."""
    total = 0.0
    for s in range(num_scales):
        fwd_n = flow_normalization(fwd_flows[s])
        bwd_n = flow_normalization(bwd_flows[s]).detach()
        occ = 1.0 - occ_masks[s]
        divider = _mean_chw(occ)
        loss = _mean_chw((fwd_n + bwd_n).abs() * occ)
        total = total + loss / (divider + EPS_DIV)
    return total


def consistency_rows(fwd_flow: torch.Tensor, bwd_flow: torch.Tensor,
                     occ_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One row-shard's sums of ``flow_consistency_loss``'s numerator and
    divider at one scale -> ((B,), (B,)) float32, over the rows it owns
    (``fwd_flow``, ``bwd_flow`` and ``occ_mask``, the weights, hold just those)."""
    fwd_n = flow_normalization(fwd_flow)
    bwd_n = flow_normalization(bwd_flow).detach()
    occ = 1.0 - occ_mask
    return ((fwd_n + bwd_n).abs() * occ).float().sum((1, 2, 3)), occ.float().sum((1, 2, 3))
