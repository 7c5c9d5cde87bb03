"""Wrappers of the hand-written CUDA photometric kernels (``csrc/photometric.cu``).

The kernels replace ``unopticalflow_tpu/ops/pallas_photometric.py``'s
``_fwd_kernel``/``_fwd_body`` and ``_bwd_kernel``/``_bwd_body`` (float32
images) and their ``_cm`` variants (bfloat16 images).  The plain PyTorch
version is ``ops/photometric.py::photometric_pack_reference``.
``ops/_build.py`` compiles the source with nvcc at first use.

``launches`` counts kernel launches by kernel (one per wrapper call on
CUDA), so a run can show that its path went through the kernels.
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
}

launches = {"photometric_fwd": 0, "photometric_bwd": 0}


def _lib():
    return _build.load("photometric", _SIGNATURES)


def _check(img_l, img_r, flow_b, flow_f, img) -> None:
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
    b, _, h, w = img.shape
    if img_l.shape != img.shape or img_r.shape != img.shape:
        raise ValueError(f"photometric kernel needs equal image shapes, got "
                         f"{tuple(img_l.shape)}, {tuple(img_r.shape)}, {tuple(img.shape)}")
    if tuple(flow_b.shape) != (b, 2, h, w) or tuple(flow_f.shape) != (b, 2, h, w):
        raise ValueError(f"photometric kernel needs ({b}, 2, {h}, {w}) flows, got "
                         f"{tuple(flow_b.shape)} and {tuple(flow_f.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("photometric kernel needs contiguous NCHW inputs")
    _check_grid(img.shape)


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
