"""One training step: forward + loss weighting + backward + Adam.

Port of ``unopticalflow_tpu/training/train_step.py``.  The JAX package
compiles the whole step into one XLA program; here it runs eagerly: the
forward launches the correlation and photometric kernels (and the
regularizer's, with ``FlowModelConfig.use_pallas_reg``), autograd launches
their backward kernels, and ``torch.optim.Adam`` updates the parameters.

The forward by ``mode`` and the snippet's frame count, as JAX ``_loss_fn``:
``flow`` takes a (B, 3H, W, 3) batch through ``forward`` (2H:
``forward_pair``), ``flowposenet`` an ``(images, K, K_inv)`` tuple through
``forward_flowpose`` (2H: ``forward_flowpose_pair``).

Loss weighting (``generate_loss_weights_dict`` of the reference):
pixel = 1 - w_ssim, ssim = w_ssim, smooth = w_flow_smooth,
consis = w_flow_consis, and in flowposenet mode pose_epipolar =
w_pose_epipolar.
"""

from __future__ import annotations

import torch

from unopticalflow_tpu_torch.models.flow_model import FlowModelConfig, forward, forward_pair
from unopticalflow_tpu_torch.models.flowpose_model import forward_flowpose, forward_flowpose_pair

FORWARDS = {("flow", 3): forward, ("flow", 2): forward_pair,
            ("flowposenet", 3): forward_flowpose, ("flowposenet", 2): forward_flowpose_pair}


def loss_weights_from_config(cfg) -> dict[str, float]:
    """Config -> loss-weight table; flowposenet mode adds ``loss_pose_epipolar``."""
    w_ssim = float(getattr(cfg, "w_ssim", 0.85))
    weights = {
        "loss_pixel": 1.0 - w_ssim,
        "loss_ssim": w_ssim,
        "loss_flow_smooth": float(getattr(cfg, "w_flow_smooth", 10.0)),
        "loss_flow_consis": float(getattr(cfg, "w_flow_consis", 0.01)),
    }
    if getattr(cfg, "mode", "flow") == "flowposenet":
        weights["loss_pose_epipolar"] = float(getattr(cfg, "w_pose_epipolar", 1.0))
    return weights


def make_optimizer(model: torch.nn.Module, lr: float = 1e-4,
                   freeze_flow: bool = False) -> torch.optim.Adam:
    """Adam with the reference's (torch-default) hyperparameters, as optax.adam.

    ``freeze_flow`` (a ``FlowPoseModel``): Adam takes the pose branch only, so
    the flow branch stays bit-identical (JAX's ``multi_transform`` with
    ``set_to_zero``).  The trainer also sets the flow branch's
    ``requires_grad`` to False, so that autograd skips its backward.
    """
    params = model.pose.parameters() if freeze_flow else model.parameters()
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def loss_fn(model, cfg: FlowModelConfig, batch, weights: dict, mode: str = "flow",
            snippet_frames: int = 3, **fns):
    """(weighted total, {loss name: batch mean}) of one batch: a (B, 3H, W, 3)
    tensor in flow mode, ``(images, K, K_inv)`` in flowposenet mode.

    uint8 tensors (the datasets' ``emit_uint8`` path) are cast to float32 and
    divided by 255 on their device.  ``fns`` (``corr_fn``, ``photo_fn``,
    ``reg_fn``) pass through to the forward; the 2-frame forwards take
    ``corr_fn`` only (their losses are the plain ones, as in JAX).
    """
    batch = batch if isinstance(batch, tuple) else (batch,)
    batch = tuple(x.float() / 255.0 if x.dtype == torch.uint8 else x for x in batch)
    pack = FORWARDS[mode, snippet_frames](model, cfg, *batch, **fns)
    means = {k: v.mean() for k, v in pack.items()}
    total = sum(weights[k] * v for k, v in means.items())
    return total, means


def train_step(model, opt: torch.optim.Optimizer, batch, weights: dict,
               cfg: FlowModelConfig, mode: str = "flow", snippet_frames: int = 3) -> dict:
    """One optimizer step; returns the detached per-loss means and ``loss_total``.

    Nothing here waits for the device: the returned values are device
    tensors, read when the caller logs them.
    """
    opt.zero_grad(set_to_none=True)
    total, means = loss_fn(model, cfg, batch, weights, mode, snippet_frames)
    total.backward()
    opt.step()
    return {**{k: v.detach() for k, v in means.items()}, "loss_total": total.detach()}
