"""Local cost-volume (correlation) layer, NCHW.

Semantics of the JAX package's ``ops/cost_volume.py``: zero-pad the target
features by ``md`` on each spatial side and, for each of the (2md+1)^2
displacements, emit the channel-mean of the product of source and displaced
target features.  Channel k = dy*(2md+1) + dx, dy-major, which fixes the
channel order the decoder convolutions were trained against.

* ``cost_volume_reference`` is the plain PyTorch version: 81 shifted
  channel-means over an ``F.pad``'ed f2, accumulated in float32 and cast to
  the input dtype (the kernel's contract).
* ``cost_volume_bwd_reference`` is the plain backward (``corr_df1_reference``
  and ``corr_df2_reference``): the shifted-accumulation formula of the JAX
  package's ``ops/pallas_kernels_xla_bwd.py::cost_volume_bwd_xla``, float32
  accumulation, output in the input dtype.
* ``cost_volume`` dispatches: a CUDA tensor goes to the hand-written kernels
  (``ops/correlation_cuda.py``, forward and backward), a CPU tensor to the
  plain version (whose backward is autograd's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from unopticalflow_tpu_torch.ops import correlation_cuda


def cost_volume_reference(f1: torch.Tensor, f2: torch.Tensor, md: int = 4) -> torch.Tensor:
    """(B, C, H, W) x2 -> (B, (2md+1)^2, H, W) in the input dtype."""
    if f1.shape != f2.shape:
        raise ValueError(f"shape mismatch {tuple(f1.shape)} vs {tuple(f2.shape)}")
    _, c, h, w = f1.shape
    a = f1.float()
    f2p = F.pad(f2.float(), (md, md, md, md))
    side = 2 * md + 1
    planes = [
        (a * f2p[:, :, dy : dy + h, dx : dx + w]).sum(1) / c
        for dy in range(side)
        for dx in range(side)
    ]
    return torch.stack(planes, 1).to(f1.dtype)


def corr_df1_reference(g: torch.Tensor, f2: torch.Tensor, md: int = 4) -> torch.Tensor:
    """d(f1) = (1/C) sum_k g_k * shift_k(f2): (B, 81, H, W), (B, C, H, W) -> (B, C, H, W)."""
    _, c, h, w = f2.shape
    gf = g.float()
    f2p = F.pad(f2.float(), (md, md, md, md))
    side = 2 * md + 1
    df1 = torch.zeros((f2.shape[0], c, h, w), dtype=torch.float32, device=f2.device)
    for dy in range(side):
        for dx in range(side):
            k = dy * side + dx
            df1 += gf[:, k : k + 1] * f2p[:, :, dy : dy + h, dx : dx + w]
    return (df1 * (1.0 / c)).to(f2.dtype)


def corr_df2_reference(g: torch.Tensor, f1: torch.Tensor, md: int = 4) -> torch.Tensor:
    """d(f2): each g_k * f1 accumulated at its shifted place of a padded map."""
    b, c, h, w = f1.shape
    gf = g.float()
    f1f = f1.float()
    side = 2 * md + 1
    df2p = torch.zeros((b, c, h + 2 * md, w + 2 * md), dtype=torch.float32, device=f1.device)
    for dy in range(side):
        for dx in range(side):
            k = dy * side + dx
            df2p[:, :, dy : dy + h, dx : dx + w] += gf[:, k : k + 1] * f1f
    return (df2p[:, :, md : md + h, md : md + w] * (1.0 / c)).to(f1.dtype)


def cost_volume_bwd_reference(g: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                              md: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain backward of the cost volume: (d f1, d f2) for the gradient ``g``."""
    return corr_df1_reference(g, f2, md), corr_df2_reference(g, f1, md)


def cost_volume(f1: torch.Tensor, f2: torch.Tensor, md: int = 4) -> torch.Tensor:
    """Cost volume: the CUDA kernels for CUDA tensors, the plain version on CPU."""
    if f1.is_cuda:
        return correlation_cuda.correlation(f1, f2, md)
    if f1.device.type == "cpu":
        return cost_volume_reference(f1, f2, md)
    raise ValueError(f"cost_volume: unsupported device {f1.device}")
