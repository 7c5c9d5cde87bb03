"""One training step: forward + loss weighting + backward + Adam.

Port of ``unopticalflow_tpu/training/train_step.py`` (flow mode).  The JAX
package compiles the whole step into one XLA program; here it runs eagerly:
the forward launches the correlation and photometric kernels (and the regularizer's,
with ``FlowModelConfig.use_pallas_reg``), autograd launches their backward
kernels, and ``torch.optim.Adam`` updates the parameters.

Loss weighting (``generate_loss_weights_dict`` of the reference):
pixel = 1 - w_ssim, ssim = w_ssim, smooth = w_flow_smooth,
consis = w_flow_consis.
"""

from __future__ import annotations

import torch

from unopticalflow_tpu_torch.models.flow_model import FlowModelConfig, forward


def loss_weights_from_config(cfg) -> dict[str, float]:
    """Config -> loss-weight table (flow mode)."""
    w_ssim = float(getattr(cfg, "w_ssim", 0.85))
    return {
        "loss_pixel": 1.0 - w_ssim,
        "loss_ssim": w_ssim,
        "loss_flow_smooth": float(getattr(cfg, "w_flow_smooth", 10.0)),
        "loss_flow_consis": float(getattr(cfg, "w_flow_consis", 0.01)),
    }


def make_optimizer(model: torch.nn.Module, lr: float = 1e-4) -> torch.optim.Adam:
    """Adam with the reference's (torch-default) hyperparameters, as optax.adam."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def loss_fn(model, cfg: FlowModelConfig, batch: torch.Tensor, weights: dict, **fns):
    """(weighted total, {loss name: batch mean}) of one (B, 3H, W, 3) batch.

    A uint8 batch (the datasets' ``emit_uint8`` path) is cast to float32 and
    divided by 255 on its device.  ``fns`` (``corr_fn``, ``photo_fn``,
    ``reg_fn``) pass through to ``forward``.
    """
    if batch.dtype == torch.uint8:
        batch = batch.float() / 255.0
    pack = forward(model, cfg, batch, **fns)
    means = {k: v.mean() for k, v in pack.items()}
    total = sum(weights[k] * v for k, v in means.items())
    return total, means


def train_step(model, opt: torch.optim.Optimizer, batch: torch.Tensor, weights: dict,
               cfg: FlowModelConfig) -> dict:
    """One optimizer step; returns the detached per-loss means and ``loss_total``.

    Nothing here waits for the device: the returned values are device
    tensors, read when the caller logs them.
    """
    opt.zero_grad(set_to_none=True)
    total, means = loss_fn(model, cfg, batch, weights)
    total.backward()
    opt.step()
    return {**{k: v.detach() for k, v in means.items()}, "loss_total": total.detach()}
