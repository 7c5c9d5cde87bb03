"""Wrappers of the hand-written CUDA correlation kernels (``csrc/correlation.cu``).

The kernels replace ``unopticalflow_tpu/ops/pallas_kernels.py``'s
``_corr_fwd_kernel`` (forward) and ``_corr_df1_kernel``/``_corr_df2_kernel``
(backward).  Their plain PyTorch versions are ``ops/cost_volume.py``'s
``cost_volume_reference``, ``corr_df1_reference`` and ``corr_df2_reference``.
The ``*_hpad`` wrappers launch the same kernels on a row-shard whose read
operands already carry their md halo rows on each side (``h_prepad``; the
TPU's ``unopticalflow_tpu/ops/pallas_spmd.py`` ``_fwd_hpad``/``_df1_hpad``/
``_df2_hpad``); their plain versions are the ``*_hpad_reference`` functions
there.  ``ops/_build.py`` compiles the source with nvcc at first use.

``launches`` counts kernel launches by kernel (one per wrapper call on
CUDA), so a run can show that its path went through the kernels.  It
counts host launches: under a CUDA graph (``training.make_multi_train_step``)
the launches that the capture records; a replay launches them again
without the wrapper and adds none.
"""

from __future__ import annotations

import torch

from unopticalflow_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MD = 4  # the kernels are instantiated for the decoder's +-4 px window only
_SIGNATURES = {
    # f1, f2, out, B, C, H, W, md, h_prepad, dtype, stream
    "corr_fwd": [_build.P] * 3 + [_build.I] * 7 + [_build.P],
    # which, g, src, out, B, C, H, W, md, h_prepad, dtype, stream
    "corr_bwd": [_build.I] + [_build.P] * 3 + [_build.I] * 7 + [_build.P],
}

launches = {"corr_fwd": 0, "corr_bwd_df1": 0, "corr_bwd_df2": 0,
            "corr_fwd_hpad": 0, "corr_bwd_df1_hpad": 0, "corr_bwd_df2_hpad": 0}


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


def _check_grid(shape) -> None:
    """Every correlation kernel's grid is (ceil(W / 32), ceil(H / 4), B), whose z
    grows to 3B (forward dy groups) or B * channel groups (backward) only where
    a level has under 2 blocks per SM, so B < 264 there; CUDA caps y and z at
    65535.  Output shape (B, C, H, W)."""
    b, _, h, _ = shape
    if min(shape) < 1 or -(-h // 4) > 65535 or b > 65535:
        raise ValueError(f"correlation kernel cannot launch shape {tuple(shape)}")


def _fwd(f1: torch.Tensor, f2: torch.Tensor, md: int, hpad: bool) -> torch.Tensor:
    name = "corr_fwd_hpad" if hpad else "corr_fwd"
    _check(f1, f2, md, "both inputs")
    b, c, h, w = f1.shape
    halo = 2 * md if hpad else 0
    if tuple(f2.shape) != (b, c, h + halo, w):
        raise ValueError(f"correlation kernel needs f2 of shape {(b, c, h + halo, w)} for f1 "
                         f"{tuple(f1.shape)} (two equal (B, C, H, W) shapes, plus {halo} halo "
                         f"rows), got {tuple(f2.shape)}")
    _check_grid(f1.shape)
    lib = _lib()
    out = torch.empty((b, (2 * md + 1) ** 2, h, w), dtype=f1.dtype, device=f1.device)
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.corr_fwd(f1.data_ptr(), f2.data_ptr(), out.data_ptr(),
                           b, c, h, w, md, int(hpad), _DTYPES[f1.dtype], stream)
    _build.check_launch(err, name)
    launches[name] += 1
    return out


def corr_fwd(f1: torch.Tensor, f2: torch.Tensor, md: int = 4) -> torch.Tensor:
    """(B, C, H, W) x2 -> (B, 81, H, W) cost volume, input dtype; no autograd."""
    return _fwd(f1, f2, md, False)


def corr_fwd_hpad(f1: torch.Tensor, f2h: torch.Tensor, md: int = 4) -> torch.Tensor:
    """f1 (B, C, h, W), f2h (B, C, h + 2md, W) with its halo rows -> (B, 81, h, W)."""
    return _fwd(f1, f2h, md, True)


def _bwd(which: int, g: torch.Tensor, src: torch.Tensor, md: int, hpad: bool) -> torch.Tensor:
    name = ("corr_bwd_df1", "corr_bwd_df2")[which] + ("_hpad" if hpad else "")
    _check(g, src, md, "the gradient and the features")
    nd = (2 * md + 1) ** 2
    b, c, hs, w = src.shape
    h = hs - 2 * md if hpad else hs  # the output's rows
    # df1 reads f2's halo; df2 reads the halos of both g and f1
    g_rows = hs if which == 1 else h
    if h < 1 or tuple(g.shape) != (b, nd, g_rows, w):
        raise ValueError(f"correlation kernel needs a ({b}, {nd}, {g_rows}, {w}) gradient "
                         f"for features {tuple(src.shape)}, got {tuple(g.shape)}")
    _check_grid((b, c, h, w))
    lib = _lib()
    out = torch.empty((b, c, h, w), dtype=src.dtype, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.corr_bwd(which, g.data_ptr(), src.data_ptr(), out.data_ptr(),
                           b, c, h, w, md, int(hpad), _DTYPES[src.dtype], stream)
    _build.check_launch(err, name)
    launches[name] += 1
    return out


def corr_df1(g: torch.Tensor, f2: torch.Tensor, md: int = 4) -> torch.Tensor:
    """d(cost volume)/d(f1) applied to ``g`` (B, 81, H, W): (B, C, H, W)."""
    return _bwd(0, g, f2, md, False)


def corr_df2(g: torch.Tensor, f1: torch.Tensor, md: int = 4) -> torch.Tensor:
    """d(cost volume)/d(f2) applied to ``g`` (B, 81, H, W): (B, C, H, W)."""
    return _bwd(1, g, f1, md, False)


def corr_df1_hpad(g: torch.Tensor, f2h: torch.Tensor, md: int = 4) -> torch.Tensor:
    """d(f1) of a row-shard: g (B, 81, h, W), f2h (B, C, h + 2md, W) -> (B, C, h, W)."""
    return _bwd(0, g, f2h, md, True)


def corr_df2_hpad(gh: torch.Tensor, f1h: torch.Tensor, md: int = 4) -> torch.Tensor:
    """d(f2) of a row-shard: gh (B, 81, h + 2md, W) and f1h (B, C, h + 2md, W),
    both with their halo rows, -> (B, C, h, W)."""
    return _bwd(1, gh, f1h, md, True)


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
