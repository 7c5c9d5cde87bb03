"""The gathers of the two gather probes, in the JAX probes' layouts.

Ports of the TPU kernels of ``benchmarks/gather_probe.py`` (``kernel3`` in
``pallas_loop3``, a row gather) and ``benchmarks/pallas_gather_probe.py``
(``lane_kernel`` and ``sublane_kernel``, gathers inside one block):

    row_gather(img, idx)           img (B, N, C), idx (B, R, 1) int32 -> (B, R, C)
        out[b, r, :] = img[b, idx[b, r, 0], :]    (jnp.take_along_axis(img, idx, 1))
    lane_gather(x, idx)            x (S, W), idx (S, W) int32 -> (S, W)
        out[s, l] = sum_{k < 64} x[s, (idx[s, l] + k) mod W]
    sublane_gather(x, idx)         x (S, L), idx (S, L) int32 -> (S, L)
        out[s, l] = sum_{k < 64} x[(idx[s, l] + k) mod S, l]

``mod`` is the floor modulo of JAX's ``%`` (``torch.remainder``); the JAX
kernels' 128 and 8 are the widths of the arrays they are given.  The sums
run in x's dtype in the order k = 0, 1, ..., rounding after every add as the
JAX kernels' ``acc = acc + g`` does (a bfloat16 sum taken in float32 and
rounded once differs by up to 2%).  Row indices are in [0, N) by contract.

* ``*_reference`` are the plain PyTorch versions.
* ``row_gather``, ``lane_gather`` and ``sublane_gather`` dispatch: CUDA
  tensors go to the hand-written kernels (``ops/gather_cuda.py``), CPU
  tensors to the plain versions.
"""

from __future__ import annotations

import torch

from unopticalflow_tpu_torch.ops import gather_cuda

REPS = 64  # benchmarks/pallas_gather_probe.py's in-kernel repetitions (csrc/gather.cu's kReps)


def row_gather_reference(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain row gather: ``torch.gather`` on the expanded int64 index."""
    return torch.gather(img, 1, idx.long().expand(-1, -1, img.shape[2]))


def lane_gather_reference(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain lane gather: ``REPS`` gathers along dim 1, summed in x's dtype."""
    acc = torch.zeros_like(x)
    for k in range(REPS):
        acc = acc + torch.gather(x, 1, torch.remainder(idx.long() + k, x.shape[1]))
    return acc


def sublane_gather_reference(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain sublane gather: ``REPS`` gathers along dim 0, summed in x's dtype."""
    acc = torch.zeros_like(x)
    for k in range(REPS):
        acc = acc + torch.gather(x, 0, torch.remainder(idx.long() + k, x.shape[0]))
    return acc


def _dispatch(name: str, kernel, reference, x: torch.Tensor, *args):
    if x.is_cuda:
        return kernel(x, *args)
    if x.device.type == "cpu":
        return reference(x, *args)
    raise ValueError(f"{name}: unsupported device {x.device}")


def row_gather(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The row gather: the CUDA kernel for CUDA tensors, plain on the CPU."""
    return _dispatch("row_gather", gather_cuda.row_gather, row_gather_reference, img, idx)


def lane_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The lane gather: the CUDA kernel for CUDA tensors, plain on the CPU."""
    return _dispatch("lane_gather", gather_cuda.lane_gather, lane_gather_reference, x, idx)


def sublane_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The sublane gather: the CUDA kernel for CUDA tensors, plain on the CPU."""
    return _dispatch("sublane_gather", gather_cuda.sublane_gather, sublane_gather_reference,
                     x, idx)
