"""Wrappers of the hand-written CUDA gather kernels (``csrc/gather.cu``).

The kernels replace the TPU kernels of the two gather probes:
``benchmarks/gather_probe.py``'s ``kernel3`` (``row_gather``) and
``benchmarks/pallas_gather_probe.py``'s ``lane_kernel`` and
``sublane_kernel`` (``lane_gather``, ``sublane_gather``).  The plain PyTorch
versions are in ``ops/gather.py``.  ``ops/_build.py`` compiles the source
with nvcc at first use.

``launches`` counts kernel launches by kernel (one per wrapper call on
CUDA), so a run can show that its path went through the kernels.  It
counts host launches: under a CUDA graph (``training.make_multi_train_step``)
the launches that the capture records; a replay launches them again
without the wrapper and adds none.
``block_gather_plan`` says which of csrc/gather.cu's block-gather kernels a
shape takes and how it launches, without launching.
"""

from __future__ import annotations

import ctypes

import torch

from unopticalflow_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LANE_WIDTH = 4096  # csrc/gather.cu: a row and its first 63 values in 48 KB of shared memory
MAX_SUBLANES = 64
_INT_MAX = 2**31 - 1
_SIGNATURES = {
    # img, idx, out, B, N, R, C, dtype, stream
    "row_gather": [_build.P] * 3 + [_build.I] * 5 + [_build.P],
    # x, idx, out, S, W (or L), dtype, stream
    "lane_gather": [_build.P] * 3 + [_build.I] * 3 + [_build.P],
    "sublane_gather": [_build.P] * 3 + [_build.I] * 3 + [_build.P],
    # kind, S, W (or L), dtype, plan (int[8])
    "block_gather_plan": [_build.I] * 4 + [_build.P],
}
# csrc/gather.cu's kernels of the block gathers, by block_gather_plan's number
BLOCK_KERNELS = ("lane_gather_kernel", "lane_gather_rows_kernel", "sublane_gather_kernel")

launches = {"row_gather": 0, "lane_gather": 0, "sublane_gather": 0}


def _lib():
    return _build.load("gather", _SIGNATURES)


def _check(name: str, x: torch.Tensor, idx: torch.Tensor) -> None:
    if not (x.is_cuda and idx.is_cuda and x.device == idx.device):
        raise ValueError(f"{name} kernel needs both inputs on one CUDA device, got "
                         f"{x.device} and {idx.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 values, got {x.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name} kernel takes int32 indices, got {idx.dtype}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name} kernel needs contiguous inputs")


def _launch(name: str, *args) -> None:
    x = args[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), name)(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                                      for a in args), _DTYPES[x.dtype], stream)
    _build.check_launch(err, name)
    launches[name] += 1


def row_gather(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """img (B, N, C), idx (B, R, 1) int32 -> (B, R, C) of img's dtype."""
    _check("row_gather", img, idx)
    if img.dim() != 3 or idx.dim() != 3 or idx.shape[2] != 1 or idx.shape[0] != img.shape[0]:
        raise ValueError(f"row_gather kernel needs img (B, N, C) and idx (B, R, 1), got "
                         f"{tuple(img.shape)} and {tuple(idx.shape)}")
    b, n, c = img.shape
    r = idx.shape[1]
    # the grid's y is the batch (at most 65535); a row is at most INT_MAX bytes
    if n < 1 or b > 65535 or max(n, r, c * img.element_size()) > _INT_MAX:
        raise ValueError(f"row_gather kernel cannot launch img {tuple(img.shape)}, "
                         f"idx {tuple(idx.shape)}")
    out = torch.empty((b, r, c), dtype=img.dtype, device=img.device)
    if out.numel():  # an empty output launches nothing
        _launch("row_gather", img, idx, out, b, n, r, c)
    return out


def _block_check(name: str, x: torch.Tensor, idx: torch.Tensor) -> None:
    _check(name, x, idx)
    if x.dim() != 2 or idx.shape != x.shape:
        raise ValueError(f"{name} kernel needs x and idx of one 2-D shape, got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)}")
    if x.numel() == 0 or max(x.shape) > _INT_MAX:
        raise ValueError(f"{name} kernel cannot launch shape {tuple(x.shape)}")


def lane_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (S, W), idx (S, W) int32 -> (S, W): 64 taps along each row, summed."""
    _block_check("lane_gather", x, idx)
    if x.shape[1] > MAX_LANE_WIDTH:
        raise ValueError(f"lane_gather kernel takes rows of at most {MAX_LANE_WIDTH}, got "
                         f"{x.shape[1]}")
    out = torch.empty_like(x)
    _launch("lane_gather", x, idx, out, x.shape[0], x.shape[1])
    return out


def block_gather_plan(kind: str, shape: tuple[int, int], dtype: torch.dtype) -> dict:
    """How ``lane_gather`` (kind "lane") or ``sublane_gather`` ("sublane")
    launches at ``shape`` on the current CUDA device: the kernel csrc/gather.cu
    chooses, threads and dynamic shared bytes a block, the grid, the blocks an
    SM holds (the CUDA occupancy calculator's), registers and local (spill)
    bytes a thread.  Launches nothing."""
    if kind not in ("lane", "sublane") or dtype not in _DTYPES:
        raise ValueError(f"block_gather_plan: no block gather {kind!r} of {dtype}")
    plan = (ctypes.c_int * 8)()
    err = _lib().block_gather_plan(int(kind == "sublane"), shape[0], shape[1], _DTYPES[dtype],
                                   ctypes.addressof(plan))
    _build.check_launch(err, "block_gather_plan")
    keys = ("kernel", "threads", "smem_bytes", "grid_x", "grid_y", "blocks_per_sm",
            "registers", "local_bytes")
    out = dict(zip(keys, plan))
    out["kernel"] = BLOCK_KERNELS[out["kernel"]]
    return out


def sublane_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (S, L), idx (S, L) int32 -> (S, L): 64 taps down each column, summed."""
    _block_check("sublane_gather", x, idx)
    if x.shape[0] > MAX_SUBLANES:
        raise ValueError(f"sublane_gather kernel takes at most {MAX_SUBLANES} rows, got "
                         f"{x.shape[0]}")
    out = torch.empty_like(x)
    _launch("sublane_gather", x, idx, out, x.shape[0], x.shape[1])
    return out
