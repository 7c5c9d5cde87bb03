"""Wrappers of the hand-written CUDA regularizer kernels (``csrc/regularizer.cu``).

The kernels replace ``unopticalflow_tpu/ops/pallas_regularizer.py``'s
``_reg_fwd_kernel`` and ``_reg_bwd_kernel``.  The plain PyTorch version is
``ops/regularizer.py::regularizer_pack_reference``.  ``ops/_build.py``
compiles the source with nvcc at first use.

The ``*_hpad`` wrappers and ``regularizer_rows`` launch the kernels' halo-
prepadded form on one row-shard of a height-sharded model
(``parallel/spatial.py``): flows and image with one halo row each side, the
owned rows' weights, the sums of the terms the shard owns, and d(flow) for
the halo rows too (the plain version is ``regularizer_pack_rows_reference``).

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
_TY, _TX = 16, 32  # the kernels' tile, which sets the grid and the forward's workspace
_SIGNATURES = {
    # flow_b, flow_f, img, w_fwd, work, B, H, W, dtype, stream
    "reg_fwd": [_build.P] * 5 + [_build.I] * 4 + [_build.P],
    # flow_b, flow_f, img, w_fwd, g_sx, g_sy, g_c, dflow_b, dflow_f, B, H, W, dtype, stream
    "reg_bwd": [_build.P] * 9 + [_build.I] * 4 + [_build.P],
    # flow_b_h, flow_f_h, img_h, w_fwd, work, B, HS, H, W, row0, dtype, stream
    "reg_fwd_hpad": [_build.P] * 5 + [_build.I] * 6 + [_build.P],
    # flow_b_h, flow_f_h, img_h, w_fwd, g_sx, g_sy, g_c, dflow_b_h, dflow_f_h,
    # B, HS, H, W, row0, dtype, stream
    "reg_bwd_hpad": [_build.P] * 9 + [_build.I] * 6 + [_build.P],
}

launches = {"regularizer_fwd": 0, "regularizer_bwd": 0,
            "regularizer_fwd_hpad": 0, "regularizer_bwd_hpad": 0}


def _lib():
    return _build.load("regularizer", _SIGNATURES)


def _check(flow_b, flow_f, img, w_fwd, w_rows: int | None = None) -> None:
    """``w_rows``: the weights' rows where they hold fewer than the image's (a
    row-shard's owned rows)."""
    tensors = (flow_b, flow_f, img, w_fwd)
    dev = img.device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(
            "regularizer kernel needs every input on one CUDA device, got "
            f"{[str(t.device) for t in tensors]}"
        )
    if img.dtype not in _DTYPES or w_fwd.dtype != img.dtype:
        raise TypeError(
            "regularizer kernel takes a float32 or bfloat16 image and weights of its "
            f"dtype, got {img.dtype}/{w_fwd.dtype}"
        )
    if flow_b.dtype != torch.float32 or flow_f.dtype != torch.float32:
        raise TypeError(f"regularizer kernel takes float32 flows, got "
                        f"{flow_b.dtype}/{flow_f.dtype}")
    if img.dim() != 4 or img.shape[1] != 3:
        raise ValueError(f"regularizer kernel needs a (B, 3, H, W) image, got "
                         f"{tuple(img.shape)}")
    b, _, h, w = img.shape
    if tuple(flow_b.shape) != (b, 2, h, w) or tuple(flow_f.shape) != (b, 2, h, w):
        raise ValueError(f"regularizer kernel needs ({b}, 2, {h}, {w}) flows, got "
                         f"{tuple(flow_b.shape)} and {tuple(flow_f.shape)}")
    wh = h if w_rows is None else w_rows
    if tuple(w_fwd.shape) != (b, 1, wh, w):
        raise ValueError(f"regularizer kernel needs ({b}, 1, {wh}, {w}) weights, got "
                         f"{tuple(w_fwd.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("regularizer kernel needs contiguous NCHW inputs")
    _check_grid(img.shape)


def _check_grid(shape) -> None:
    """Both regularizer kernels launch the grid (ceil(W / 32), ceil(H / 16), B),
    whose y and z CUDA caps at 65535, and index the (B, 3, H, W) image with
    32-bit integers, so B * 3 * H * W stays below 2**31."""
    b, _, h, w = shape
    if min(b, h, w) < 1 or b > 65535 or -(-h // _TY) > 65535 or b * 3 * h * w >= 2**31:
        raise ValueError(f"regularizer kernel cannot launch shape {tuple(shape)}")


def reg_fwd(flow_b, flow_f, img, w_fwd):
    """Forward kernel: (s_sx (2B,), s_sy (2B,), s_consis (B,)), float32."""
    _check(flow_b, flow_f, img, w_fwd)
    lib = _lib()
    b, _, h, w = img.shape
    n_tiles = -(-h // _TY) * -(-w // _TX)
    # the kernel's workspace: the sums it returns, [s_sx bwd, s_sx fwd, s_sy bwd,
    # s_sy fwd, s_consis] x sample, then what it adds them from
    work = torch.empty(6 * b + 5 * b * n_tiles, dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.reg_fwd(flow_b.data_ptr(), flow_f.data_ptr(), img.data_ptr(),
                          w_fwd.data_ptr(), work.data_ptr(), b, h, w, _DTYPES[img.dtype],
                          stream)
    _build.check_launch(err, "regularizer forward")
    launches["regularizer_fwd"] += 1
    # the packed [bwd; fwd] sums are views
    return work[:2 * b], work[2 * b:4 * b], work[4 * b:5 * b]


def reg_bwd(flow_b, flow_f, img, w_fwd, g_sx, g_sy, g_c):
    """Backward kernel: (d flow_b, d flow_f), each (B, 2, H, W) f32.

    ``g_sx``/``g_sy``: (2B,) gradients of ``s_sx``/``s_sy``; ``g_c``: (B,)
    gradient of ``s_consis``.
    """
    _check(flow_b, flow_f, img, w_fwd)
    b, _, h, w = img.shape
    g_sx, g_sy, g_c = (t.to(torch.float32).contiguous() for t in (g_sx, g_sy, g_c))
    if tuple(g_sx.shape) != (2 * b,) or tuple(g_sy.shape) != (2 * b,) or tuple(g_c.shape) != (b,):
        raise ValueError(f"regularizer backward needs ({2 * b},), ({2 * b},) and ({b},) "
                         f"cotangents, got {tuple(g_sx.shape)}, {tuple(g_sy.shape)} and "
                         f"{tuple(g_c.shape)}")
    lib = _lib()
    d_b = torch.empty_like(flow_b)
    d_f = torch.empty_like(flow_f)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.reg_bwd(flow_b.data_ptr(), flow_f.data_ptr(), img.data_ptr(),
                          w_fwd.data_ptr(), g_sx.data_ptr(), g_sy.data_ptr(), g_c.data_ptr(),
                          d_b.data_ptr(), d_f.data_ptr(), b, h, w, _DTYPES[img.dtype], stream)
    _build.check_launch(err, "regularizer backward")
    launches["regularizer_bwd"] += 1
    return d_b, d_f


def _check_rows(flow_b_h, flow_f_h, img_h, w_fwd, row0: int, height: int) -> None:
    """One row-shard's inputs: (B, ., h + 2, W) flows and image with their halo,
    (B, 1, h, W) weights, owned rows row0 .. row0 + h - 1 inside the image."""
    hh = img_h.shape[2] if img_h.dim() == 4 else 0
    _check(flow_b_h, flow_f_h, img_h, w_fwd, hh - 2)
    if hh < 3 or row0 < 0 or row0 + hh - 2 > height:
        raise ValueError(f"regularizer rows kernel: owned rows {row0} .. {row0 + hh - 3} of a "
                         f"{height}-row image, from a {hh}-row slab")


def reg_fwd_hpad(flow_b_h, flow_f_h, img_h, w_fwd, row0: int, height: int):
    """Halo-prepadded forward kernel of one row-shard: the owned terms'
    (s_sx (2B,), s_sy (2B,), s_consis (B,)), float32."""
    _check_rows(flow_b_h, flow_f_h, img_h, w_fwd, row0, height)
    lib = _lib()
    b, _, hh, w = img_h.shape
    n_tiles = -(-(hh - 2) // _TY) * -(-w // _TX)
    work = torch.empty(6 * b + 5 * b * n_tiles, dtype=torch.float32, device=img_h.device)
    with torch.cuda.device(img_h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.reg_fwd_hpad(flow_b_h.data_ptr(), flow_f_h.data_ptr(), img_h.data_ptr(),
                               w_fwd.data_ptr(), work.data_ptr(), b, height, hh, w, row0,
                               _DTYPES[img_h.dtype], stream)
    _build.check_launch(err, "regularizer hpad forward")
    launches["regularizer_fwd_hpad"] += 1
    return work[:2 * b], work[2 * b:4 * b], work[4 * b:5 * b]


def reg_bwd_hpad(flow_b_h, flow_f_h, img_h, w_fwd, row0: int, height: int, g_sx, g_sy, g_c):
    """Halo-prepadded backward kernel: (d flow_b_h, d flow_f_h), each (B, 2,
    h + 2, W) f32, the halo rows included."""
    _check_rows(flow_b_h, flow_f_h, img_h, w_fwd, row0, height)
    b, _, hh, w = img_h.shape
    g_sx, g_sy, g_c = (t.to(torch.float32).contiguous() for t in (g_sx, g_sy, g_c))
    if tuple(g_sx.shape) != (2 * b,) or tuple(g_sy.shape) != (2 * b,) or tuple(g_c.shape) != (b,):
        raise ValueError(f"regularizer backward needs ({2 * b},), ({2 * b},) and ({b},) "
                         f"cotangents, got {tuple(g_sx.shape)}, {tuple(g_sy.shape)} and "
                         f"{tuple(g_c.shape)}")
    lib = _lib()
    d_b = torch.empty_like(flow_b_h)
    d_f = torch.empty_like(flow_f_h)
    with torch.cuda.device(img_h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.reg_bwd_hpad(flow_b_h.data_ptr(), flow_f_h.data_ptr(), img_h.data_ptr(),
                               w_fwd.data_ptr(), g_sx.data_ptr(), g_sy.data_ptr(), g_c.data_ptr(),
                               d_b.data_ptr(), d_f.data_ptr(), b, height, hh, w, row0,
                               _DTYPES[img_h.dtype], stream)
    _build.check_launch(err, "regularizer hpad backward")
    launches["regularizer_bwd_hpad"] += 1
    return d_b, d_f


class _Regularizer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flow_b, flow_f, img, w_fwd):
        s_sx, s_sy, s_c = reg_fwd(flow_b, flow_f, img, w_fwd)
        ctx.save_for_backward(flow_b, flow_f, img, w_fwd)
        return s_sx, s_sy, s_c

    @staticmethod
    def backward(ctx, g_sx, g_sy, g_c):
        # only the flows get a gradient; autograd hands zeros for unused outputs
        flow_b, flow_f, img, w_fwd = ctx.saved_tensors
        if not (ctx.needs_input_grad[0] or ctx.needs_input_grad[1]):
            return None, None, None, None
        d_b, d_f = reg_bwd(flow_b, flow_f, img, w_fwd, g_sx, g_sy, g_c)
        return (d_b if ctx.needs_input_grad[0] else None,
                d_f if ctx.needs_input_grad[1] else None, None, None)


def regularizer(flow_b, flow_f, img, w_fwd) -> dict:
    """The fused regularizer pack of one scale on CUDA (see ops/regularizer.py)."""
    s_sx, s_sy, s_c = _Regularizer.apply(flow_b, flow_f, img, w_fwd)
    return {"s_sx": s_sx, "s_sy": s_sy, "s_consis": s_c}


class _RegularizerRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flow_b_h, flow_f_h, img_h, w_fwd, row0, height):
        s_sx, s_sy, s_c = reg_fwd_hpad(flow_b_h, flow_f_h, img_h, w_fwd, row0, height)
        ctx.save_for_backward(flow_b_h, flow_f_h, img_h, w_fwd)
        ctx.rows = row0, height
        return s_sx, s_sy, s_c

    @staticmethod
    def backward(ctx, g_sx, g_sy, g_c):
        flow_b_h, flow_f_h, img_h, w_fwd = ctx.saved_tensors
        if not (ctx.needs_input_grad[0] or ctx.needs_input_grad[1]):
            return (None,) * 6
        d_b, d_f = reg_bwd_hpad(flow_b_h, flow_f_h, img_h, w_fwd, *ctx.rows, g_sx, g_sy, g_c)
        return (d_b if ctx.needs_input_grad[0] else None,
                d_f if ctx.needs_input_grad[1] else None, None, None, None, None)


def regularizer_rows(flow_b_h, flow_f_h, img_h, w_fwd, row0: int, height: int) -> dict:
    """One row-shard's regularizer pack on CUDA (see ops/regularizer.py)."""
    s_sx, s_sy, s_c = _RegularizerRows.apply(flow_b_h, flow_f_h, img_h, w_fwd, row0, height)
    return {"s_sx": s_sx, "s_sy": s_sy, "s_consis": s_c}
