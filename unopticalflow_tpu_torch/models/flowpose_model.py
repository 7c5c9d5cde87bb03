"""Flow + pose joint training (``--mode flowposenet``), NCHW.

Port of ``unopticalflow_tpu/models/flowpose_model.py``.  ``FlowPoseModel``
holds the flow model (``flow``: the unchanged ``FlowModel``, with its
correlation and photometric kernels) and a 6-DoF ``PoseNet`` (``pose``), as
the JAX tree ``{"flow", "pose"}``.  The pose branch is supervised by the flow
through the epipolar constraint: a match ``p -> p + flow(p)`` must lie on the
epipolar line of the predicted pose, so ``loss_pose_epipolar`` is the
occlusion-weighted mean (robustified) Sampson distance under F(pose, K).
Its gradient reaches both branches.

Batches are ``(images, K, K_inv)``: (B, 3H, W, 3) snippets (2H for the
2-frame variant) in the JAX layout, and (B, 3, 3) intrinsics at the network's
resolution.  The pose net runs batch-packed at 2B over the same pairs as the
decoder.
"""

from __future__ import annotations

import torch
from torch import nn

from unopticalflow_tpu_torch.models.flow_model import (
    FlowModel,
    FlowModelConfig,
    forward,
    forward_pair,
)
from unopticalflow_tpu_torch.models.layers import init_convs, set_compute_dtype
from unopticalflow_tpu_torch.models.pose_net import PoseNet
from unopticalflow_tpu_torch.ops.cost_volume import cost_volume
from unopticalflow_tpu_torch.ops.geometry import (
    fundamental_from_pose,
    sampson_epipolar_distance,
)


class FlowPoseModel(nn.Module):
    def __init__(self, cfg: FlowModelConfig = FlowModelConfig(), device=None,
                 scheme: str = "torch", generator: torch.Generator | None = None):
        super().__init__()
        self.flow = FlowModel(cfg, device=device, scheme=scheme, generator=generator)
        self.pose = PoseNet(device=device)
        init_convs(self.pose, scheme, generator)
        set_compute_dtype(self.pose, getattr(torch, cfg.compute_dtype))


def epipolar_loss(flow, weight, pose, intrinsics, intrinsics_inv) -> torch.Tensor:
    """Occlusion-weighted mean of sqrt(Sampson distance + 1e-6), per sample.

    flow: (N, 2, H, W) frame1 -> frame2; weight: (N, 1, H, W); pose: (N, 6)
    mapping frame2 points into frame1; intrinsics / inverse: (N, 3, 3).
    Returns (N,) float32.
    """
    f = fundamental_from_pose(pose.float(), intrinsics.float(), intrinsics_inv.float())
    d = torch.sqrt(sampson_epipolar_distance(flow.float(), f) + 1e-6)
    w = weight[:, 0].float()
    return (d * w).sum((1, 2)) / (w.sum((1, 2)) + 1e-8)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _pose_pack(model: FlowPoseModel, pack: dict, aux: dict, first, second,
               intrinsics, intrinsics_inv) -> dict:
    """``pack`` with ``loss_pose_epipolar``: the pose net over the 2B pairs
    (first[i], second[i]), the loss on the finest flow and weights."""
    b = intrinsics.shape[0]
    pose = model.pose(torch.cat(first, 0), torch.cat(second, 0))
    k2 = torch.cat([intrinsics, intrinsics], 0)
    k2_inv = torch.cat([intrinsics_inv, intrinsics_inv], 0)
    loss2 = epipolar_loss(aux["flows"][0], aux["weights"][0], pose, k2, k2_inv)
    return {**pack, "loss_pose_epipolar": loss2[:b] + loss2[b:]}


def forward_flowpose(model: FlowPoseModel, cfg: FlowModelConfig, images, intrinsics,
                     intrinsics_inv, **fns) -> dict:
    """Joint forward of a (B, 3H, W, 3) (prev, center, next) batch -> the
    flow losses and ``loss_pose_epipolar``.  The pose net runs over the pairs
    [(center, prev); (center, next)], the packed [bwd; fwd] flows' layout.
    ``fns`` (``corr_fn``, ``photo_fn``, ``reg_fn``) pass through to the flow
    model's ``forward``."""
    pack, aux = forward(model.flow, cfg, images, return_aux=True, **fns)
    h = images.shape[1] // 3
    x = _nchw(images)
    imgl, img, imgr = (x[:, :, i * h:(i + 1) * h] for i in range(3))
    return _pose_pack(model, pack, aux, (img, img), (imgl, imgr), intrinsics, intrinsics_inv)


def forward_flowpose_pair(model: FlowPoseModel, cfg: FlowModelConfig, images, intrinsics,
                          intrinsics_inv, corr_fn=cost_volume) -> dict:
    """2-frame joint forward of a (B, 2H, W, 3) (frame1, frame2) batch: the
    four losses of ``forward_pair`` and ``loss_pose_epipolar``, the pose net
    over [(frame1, frame2); (frame2, frame1)], the packed flows' layout."""
    pack, aux = forward_pair(model.flow, cfg, images, corr_fn=corr_fn, return_aux=True)
    h = images.shape[1] // 2
    x = _nchw(images)
    img1, img2 = x[:, :, :h], x[:, :, h:]
    return _pose_pack(model, pack, aux, (img1, img2), (img2, img1), intrinsics, intrinsics_inv)


def inference_pose(model: FlowPoseModel, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) x 2 in the JAX layout -> (B, 6) float32 pose mapping
    img2's camera into img1's."""
    return model.pose(_nchw(img1), _nchw(img2)).float()
