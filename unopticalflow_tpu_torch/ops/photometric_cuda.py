"""Wrappers of the hand-written CUDA photometric kernels (``csrc/photometric.cu``).

The kernels replace ``unopticalflow_tpu/ops/pallas_photometric.py``'s
``_fwd_kernel``/``_fwd_body`` and ``_bwd_kernel``/``_bwd_body`` (float32
images) and their ``_cm`` variants (bfloat16 images).  The plain PyTorch
version is ``ops/photometric.py::photometric_pack_reference``.
``ops/_build.py`` compiles the source with nvcc at first use.

The ``*_hpad`` wrappers and ``photometric_rows`` launch the kernels' halo-
prepadded form on one row-shard of a height-sharded model
(``parallel/spatial.py``): the center image and the flows carry one halo row
each side, the source images are whole, the sums and weights are the owned
rows' and the backward's d(flow) covers the halo rows too (the plain version
is ``photometric_pack_rows_reference``).

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
    # img_l, img_r, img, flow_b, flow_f, weights, work, B, H, W, dtype, stream
    "photo_fwd": [_build.P] * 7 + [_build.I] * 4 + [_build.P],
    # img_l, img_r, img, flow_b, flow_f, g_dw, g_cl, dflow_b, dflow_f, B, H, W, dtype, stream
    "photo_bwd": [_build.P] * 9 + [_build.I] * 4 + [_build.P],
    # img_l, img_r, img_h, flow_b_h, flow_f_h, weights, work, B, HS, H, W, row0, dtype, stream
    "photo_fwd_hpad": [_build.P] * 7 + [_build.I] * 6 + [_build.P],
    # img_l, img_r, img_h, flow_b_h, flow_f_h, g_dw, g_cl, dflow_b_h, dflow_f_h,
    # B, HS, H, W, row0, dtype, stream
    "photo_bwd_hpad": [_build.P] * 9 + [_build.I] * 6 + [_build.P],
}

launches = {"photometric_fwd": 0, "photometric_bwd": 0,
            "photometric_fwd_hpad": 0, "photometric_bwd_hpad": 0}


def _lib():
    return _build.load("photometric", _SIGNATURES)


def _check_inputs(img_l, img_r, flow_b, flow_f, img) -> None:
    """Devices, dtypes, layout and the center image's shape; not the shapes
    that relate the inputs."""
    tensors = (img_l, img_r, flow_b, flow_f, img)
    dev = img.device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(
            "photometric kernel needs every input on one CUDA device, got "
            f"{[str(t.device) for t in tensors]}"
        )
    if img.dtype not in _DTYPES or img_l.dtype != img.dtype or img_r.dtype != img.dtype:
        raise TypeError(
            "photometric kernel takes float32 or bfloat16 images of one dtype, got "
            f"{img_l.dtype}/{img_r.dtype}/{img.dtype}"
        )
    if flow_b.dtype != torch.float32 or flow_f.dtype != torch.float32:
        raise TypeError(f"photometric kernel takes float32 flows, got "
                        f"{flow_b.dtype}/{flow_f.dtype}")
    if img.dim() != 4 or img.shape[1] != 3:
        raise ValueError(f"photometric kernel needs (B, 3, H, W) images, got {tuple(img.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("photometric kernel needs contiguous NCHW inputs")


def _check(img_l, img_r, flow_b, flow_f, img) -> None:
    _check_inputs(img_l, img_r, flow_b, flow_f, img)
    b, _, h, w = img.shape
    if img_l.shape != img.shape or img_r.shape != img.shape:
        raise ValueError(f"photometric kernel needs equal image shapes, got "
                         f"{tuple(img_l.shape)}, {tuple(img_r.shape)}, {tuple(img.shape)}")
    if tuple(flow_b.shape) != (b, 2, h, w) or tuple(flow_f.shape) != (b, 2, h, w):
        raise ValueError(f"photometric kernel needs ({b}, 2, {h}, {w}) flows, got "
                         f"{tuple(flow_b.shape)} and {tuple(flow_f.shape)}")
    _check_grid(img.shape)


def _check_rows(img_l, img_r, flow_b_h, flow_f_h, img_h, row0: int, height: int) -> None:
    """One row-shard's inputs: (B, 3, h + 2, W) center rows and (B, 2, h + 2, W)
    flows with their halo, the whole (B, 3, height, W) sources, and owned rows
    row0 .. row0 + h - 1 inside the image."""
    _check_inputs(img_l, img_r, flow_b_h, flow_f_h, img_h)
    b, _, hh, w = img_h.shape
    if img_l.shape != (b, 3, height, w) or img_r.shape != (b, 3, height, w):
        raise ValueError(f"photometric rows kernel needs ({b}, 3, {height}, {w}) sources, got "
                         f"{tuple(img_l.shape)} and {tuple(img_r.shape)}")
    if tuple(flow_b_h.shape) != (b, 2, hh, w) or tuple(flow_f_h.shape) != (b, 2, hh, w):
        raise ValueError(f"photometric rows kernel needs ({b}, 2, {hh}, {w}) flows, got "
                         f"{tuple(flow_b_h.shape)} and {tuple(flow_f_h.shape)}")
    if hh < 3 or row0 < 0 or row0 + hh - 2 > height:
        raise ValueError(f"photometric rows kernel: owned rows {row0} .. {row0 + hh - 3} of a "
                         f"{height}-row image, from a {hh}-row slab")
    _check_grid(img_h.shape)
    _check_grid(img_l.shape)


def _check_grid(shape) -> None:
    """Both photometric kernels launch the grid (ceil(W / 32), ceil(H / 16), B),
    whose y and z CUDA caps at 65535, and index the (B, 3, H, W) images with
    32-bit integers, so B * 3 * H * W stays below 2**31."""
    b, _, h, w = shape
    if min(b, h, w) < 1 or b > 65535 or -(-h // _TY) > 65535 or b * 3 * h * w >= 2**31:
        raise ValueError(f"photometric kernel cannot launch shape {tuple(shape)}")


def photo_fwd(img_l, img_r, flow_b, flow_f, img):
    """Forward kernel: (s_dw, s_w, s_cl) each (2B,) f32, weights (2B, 1, H, W)."""
    _check(img_l, img_r, flow_b, flow_f, img)
    lib = _lib()
    b, _, h, w = img.shape
    n_tiles = -(-h // _TY) * -(-w // _TX)
    weights = torch.empty((2 * b, 1, h, w), dtype=img.dtype, device=img.device)
    # the kernel's workspace: the (3, 2B) sums it returns, then what it adds them from
    work = torch.empty(7 * b + 6 * b * n_tiles, dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.photo_fwd(img_l.data_ptr(), img_r.data_ptr(), img.data_ptr(),
                            flow_b.data_ptr(), flow_f.data_ptr(), weights.data_ptr(),
                            work.data_ptr(), b, h, w, _DTYPES[img.dtype], stream)
    _build.check_launch(err, "photometric forward")
    launches["photometric_fwd"] += 1
    s_dw, s_w, s_cl = work[:6 * b].view(3, 2 * b)
    return s_dw, s_w, s_cl, weights


def photo_bwd(img_l, img_r, flow_b, flow_f, img, g_dw, g_cl):
    """Backward kernel: (d flow_b, d flow_f), each (B, 2, H, W) f32.

    ``g_dw``/``g_cl``: (2B,) gradients of ``s_dw``/``s_cl``.
    """
    _check(img_l, img_r, flow_b, flow_f, img)
    b, _, h, w = img.shape
    g_dw = g_dw.to(torch.float32).contiguous()
    g_cl = g_cl.to(torch.float32).contiguous()
    if tuple(g_dw.shape) != (2 * b,) or tuple(g_cl.shape) != (2 * b,):
        raise ValueError(f"photometric backward needs ({2 * b},) cotangents, got "
                         f"{tuple(g_dw.shape)} and {tuple(g_cl.shape)}")
    lib = _lib()
    d_b = torch.empty_like(flow_b)
    d_f = torch.empty_like(flow_f)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.photo_bwd(img_l.data_ptr(), img_r.data_ptr(), img.data_ptr(),
                            flow_b.data_ptr(), flow_f.data_ptr(), g_dw.data_ptr(),
                            g_cl.data_ptr(), d_b.data_ptr(), d_f.data_ptr(), b, h, w,
                            _DTYPES[img.dtype], stream)
    _build.check_launch(err, "photometric backward")
    launches["photometric_bwd"] += 1
    return d_b, d_f


def photo_fwd_hpad(img_l, img_r, flow_b_h, flow_f_h, img_h, row0: int, height: int):
    """Halo-prepadded forward kernel of one row-shard: the owned rows' (s_dw,
    s_w, s_cl), each (2B,) f32, and weights (2B, 1, h, W)."""
    _check_rows(img_l, img_r, flow_b_h, flow_f_h, img_h, row0, height)
    lib = _lib()
    b, _, hh, w = img_h.shape
    h = hh - 2
    n_tiles = -(-h // _TY) * -(-w // _TX)
    weights = torch.empty((2 * b, 1, h, w), dtype=img_h.dtype, device=img_h.device)
    work = torch.empty(7 * b + 6 * b * n_tiles, dtype=torch.float32, device=img_h.device)
    with torch.cuda.device(img_h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.photo_fwd_hpad(img_l.data_ptr(), img_r.data_ptr(), img_h.data_ptr(),
                                 flow_b_h.data_ptr(), flow_f_h.data_ptr(), weights.data_ptr(),
                                 work.data_ptr(), b, height, hh, w, row0,
                                 _DTYPES[img_h.dtype], stream)
    _build.check_launch(err, "photometric hpad forward")
    launches["photometric_fwd_hpad"] += 1
    s_dw, s_w, s_cl = work[:6 * b].view(3, 2 * b)
    return s_dw, s_w, s_cl, weights


def photo_bwd_hpad(img_l, img_r, flow_b_h, flow_f_h, img_h, row0: int, height: int, g_dw,
                   g_cl):
    """Halo-prepadded backward kernel: (d flow_b_h, d flow_f_h), each (B, 2, h + 2,
    W) f32, the halo rows included."""
    _check_rows(img_l, img_r, flow_b_h, flow_f_h, img_h, row0, height)
    b, _, hh, w = img_h.shape
    g_dw = g_dw.to(torch.float32).contiguous()
    g_cl = g_cl.to(torch.float32).contiguous()
    if tuple(g_dw.shape) != (2 * b,) or tuple(g_cl.shape) != (2 * b,):
        raise ValueError(f"photometric backward needs ({2 * b},) cotangents, got "
                         f"{tuple(g_dw.shape)} and {tuple(g_cl.shape)}")
    lib = _lib()
    d_b = torch.empty_like(flow_b_h)
    d_f = torch.empty_like(flow_f_h)
    with torch.cuda.device(img_h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.photo_bwd_hpad(img_l.data_ptr(), img_r.data_ptr(), img_h.data_ptr(),
                                 flow_b_h.data_ptr(), flow_f_h.data_ptr(), g_dw.data_ptr(),
                                 g_cl.data_ptr(), d_b.data_ptr(), d_f.data_ptr(), b, height, hh,
                                 w, row0, _DTYPES[img_h.dtype], stream)
    _build.check_launch(err, "photometric hpad backward")
    launches["photometric_bwd_hpad"] += 1
    return d_b, d_f


class _Photometric(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img_l, img_r, flow_b, flow_f, img):
        s_dw, s_w, s_cl, weights = photo_fwd(img_l, img_r, flow_b, flow_f, img)
        ctx.save_for_backward(img_l, img_r, flow_b, flow_f, img)
        ctx.mark_non_differentiable(s_w, weights)
        return s_dw, s_w, s_cl, weights

    @staticmethod
    def backward(ctx, g_dw, g_w, g_cl, g_weights):
        # only the flows get a gradient; autograd hands zeros for unused outputs
        img_l, img_r, flow_b, flow_f, img = ctx.saved_tensors
        if not (ctx.needs_input_grad[2] or ctx.needs_input_grad[3]):
            return None, None, None, None, None
        d_b, d_f = photo_bwd(img_l, img_r, flow_b, flow_f, img, g_dw, g_cl)
        return (None, None, d_b if ctx.needs_input_grad[2] else None,
                d_f if ctx.needs_input_grad[3] else None, None)


def photometric(img_l, img_r, flow_b, flow_f, img) -> dict:
    """The fused photometric pack of one scale on CUDA (see ops/photometric.py)."""
    s_dw, s_w, s_cl, weights = _Photometric.apply(img_l, img_r, flow_b, flow_f, img)
    return {"s_dw": s_dw, "s_w": s_w, "s_cl": s_cl, "weights": weights}


class _PhotometricRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img_l, img_r, flow_b_h, flow_f_h, img_h, row0, height):
        s_dw, s_w, s_cl, weights = photo_fwd_hpad(img_l, img_r, flow_b_h, flow_f_h, img_h, row0,
                                                  height)
        ctx.save_for_backward(img_l, img_r, flow_b_h, flow_f_h, img_h)
        ctx.rows = row0, height
        ctx.mark_non_differentiable(s_w, weights)
        return s_dw, s_w, s_cl, weights

    @staticmethod
    def backward(ctx, g_dw, g_w, g_cl, g_weights):
        img_l, img_r, flow_b_h, flow_f_h, img_h = ctx.saved_tensors
        if not (ctx.needs_input_grad[2] or ctx.needs_input_grad[3]):
            return (None,) * 7
        d_b, d_f = photo_bwd_hpad(img_l, img_r, flow_b_h, flow_f_h, img_h, *ctx.rows, g_dw,
                                  g_cl)
        return (None, None, d_b if ctx.needs_input_grad[2] else None,
                d_f if ctx.needs_input_grad[3] else None, None, None, None)


def photometric_rows(img_l, img_r, flow_b_h, flow_f_h, img_h, row0: int, height: int) -> dict:
    """One row-shard's photometric pack on CUDA (see ops/photometric.py)."""
    s_dw, s_w, s_cl, weights = _PhotometricRows.apply(img_l, img_r, flow_b_h, flow_f_h, img_h,
                                                      row0, height)
    return {"s_dw": s_dw, "s_w": s_w, "s_cl": s_cl, "weights": weights}
