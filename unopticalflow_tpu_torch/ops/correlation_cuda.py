"""Wrappers of the hand-written CUDA correlation kernels (``csrc/correlation.cu``).

The kernels replace ``unopticalflow_tpu/ops/pallas_kernels.py``'s
``_corr_fwd_kernel`` (forward) and ``_corr_df1_kernel``/``_corr_df2_kernel``
(backward).  Their plain PyTorch versions are ``ops/cost_volume.py``'s
``cost_volume_reference``, ``corr_df1_reference`` and ``corr_df2_reference``.
``ops/_build.py`` compiles the source with nvcc at first use.

``launches`` counts kernel launches by kernel (one per wrapper call on
CUDA), so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import torch

from unopticalflow_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MD = 4  # the kernels are instantiated for the decoder's +-4 px window only
_SIGNATURES = {
    # f1, f2, out, B, C, H, W, md, dtype, stream
    "corr_fwd": [_build.P] * 3 + [_build.I] * 6 + [_build.P],
    # which, g, src, out, B, C, H, W, md, dtype, stream
    "corr_bwd": [_build.I] + [_build.P] * 3 + [_build.I] * 6 + [_build.P],
}

launches = {"corr_fwd": 0, "corr_bwd_df1": 0, "corr_bwd_df2": 0}


def _lib():
    return _build.load("correlation", _SIGNATURES)


def _check(a: torch.Tensor, b: torch.Tensor, md: int, what: str) -> None:
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(
            f"correlation kernel needs {what} on one CUDA device, got "
            f"{a.device} and {b.device}"
        )
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(
            f"correlation kernel takes float32 or bfloat16, got {a.dtype}/{b.dtype}"
        )
    if a.dim() != 4 or b.dim() != 4:
        raise ValueError(f"correlation kernel needs (B, C, H, W) shapes, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("correlation kernel needs contiguous NCHW inputs")
    if md != _MD:
        raise ValueError(f"correlation kernel supports md={_MD} only, got {md}")


def _check_grid(shape, grid_z: int) -> None:
    """The launch grid is (ceil(W / 64), H, grid_z): CUDA caps y and z at 65535."""
    if min(shape) < 1 or shape[2] > 65535 or grid_z > 65535:
        raise ValueError(f"correlation kernel cannot launch shape {tuple(shape)}")


def corr_fwd(f1: torch.Tensor, f2: torch.Tensor, md: int = 4) -> torch.Tensor:
    """(B, C, H, W) x2 -> (B, 81, H, W) cost volume, input dtype; no autograd."""
    _check(f1, f2, md, "both inputs")
    if f1.shape != f2.shape:
        raise ValueError(f"correlation kernel needs two equal (B, C, H, W) shapes, got "
                         f"{tuple(f1.shape)} and {tuple(f2.shape)}")
    _check_grid(f1.shape, f1.shape[0])
    lib = _lib()
    b, c, h, w = f1.shape
    out = torch.empty((b, (2 * md + 1) ** 2, h, w), dtype=f1.dtype, device=f1.device)
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.corr_fwd(f1.data_ptr(), f2.data_ptr(), out.data_ptr(),
                           b, c, h, w, md, _DTYPES[f1.dtype], stream)
    _build.check_launch(err, "correlation")
    launches["corr_fwd"] += 1
    return out


def _bwd(which: int, g: torch.Tensor, src: torch.Tensor, md: int) -> torch.Tensor:
    name = ("corr_bwd_df1", "corr_bwd_df2")[which]
    _check(g, src, md, "the gradient and the features")
    nd = (2 * md + 1) ** 2
    b, c, h, w = src.shape
    if tuple(g.shape) != (b, nd, h, w):
        raise ValueError(f"correlation kernel needs a ({b}, {nd}, {h}, {w}) gradient, "
                         f"got {tuple(g.shape)}")
    _check_grid(src.shape, b * c)
    lib = _lib()
    out = torch.empty_like(src)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.corr_bwd(which, g.data_ptr(), src.data_ptr(), out.data_ptr(),
                           b, c, h, w, md, _DTYPES[src.dtype], stream)
    _build.check_launch(err, name)
    launches[name] += 1
    return out


def corr_df1(g: torch.Tensor, f2: torch.Tensor, md: int = 4) -> torch.Tensor:
    """d(cost volume)/d(f1) applied to ``g`` (B, 81, H, W): (B, C, H, W)."""
    return _bwd(0, g, f2, md)


def corr_df2(g: torch.Tensor, f1: torch.Tensor, md: int = 4) -> torch.Tensor:
    """d(cost volume)/d(f2) applied to ``g`` (B, 81, H, W): (B, C, H, W)."""
    return _bwd(1, g, f1, md)


class _Correlation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f1, f2, md):
        ctx.md = md
        ctx.save_for_backward(f1, f2)
        return corr_fwd(f1, f2, md)

    @staticmethod
    def backward(ctx, grad):
        f1, f2 = ctx.saved_tensors
        g = grad.to(f1.dtype).contiguous()
        df1 = corr_df1(g, f2, ctx.md) if ctx.needs_input_grad[0] else None
        df2 = corr_df2(g, f1, ctx.md) if ctx.needs_input_grad[1] else None
        return df1, df2, None


def correlation(f1: torch.Tensor, f2: torch.Tensor, md: int = 4) -> torch.Tensor:
    """(B, C, H, W) x2 on CUDA -> (B, (2md+1)^2, H, W) cost volume, input dtype.

    Differentiable: the backward launches the df1/df2 kernels for the inputs
    that need a gradient.
    """
    return _Correlation.apply(f1, f2, md)
