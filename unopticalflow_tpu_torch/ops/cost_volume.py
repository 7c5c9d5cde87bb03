"""Local cost-volume (correlation) layer, NCHW.

Semantics of the JAX package's ``ops/cost_volume.py``: zero-pad the target
features by ``md`` on each spatial side and, for each of the (2md+1)^2
displacements, emit the channel-mean of the product of source and displaced
target features.  Channel k = dy*(2md+1) + dx, dy-major, which fixes the
channel order the decoder convolutions were trained against.

* ``cost_volume_reference`` is the plain PyTorch version: 81 shifted
  channel-means over an ``F.pad``'ed f2, accumulated in float32 and cast to
  the input dtype (the kernel's contract).
* ``cost_volume`` dispatches: a CUDA tensor goes to the hand-written kernel
  (``ops/correlation_cuda.py``), a CPU tensor to the plain version.
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


def cost_volume(f1: torch.Tensor, f2: torch.Tensor, md: int = 4) -> torch.Tensor:
    """Cost volume: the CUDA kernel for CUDA tensors, the plain version on CPU."""
    if f1.is_cuda:
        return correlation_cuda.correlation(f1, f2, md)
    if f1.device.type == "cpu":
        return cost_volume_reference(f1, f2, md)
    raise ValueError(f"cost_volume: unsupported device {f1.device}")
