"""Wrapper of the hand-written CUDA correlation kernel (``csrc/correlation.cu``).

The kernel replaces ``unopticalflow_tpu/ops/pallas_kernels.py::_corr_fwd_kernel``.
Its plain PyTorch version is ``ops/cost_volume.py::cost_volume_reference``.

Build: at first use, ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``
compiles the source into ``build/kernels/`` at the repository root, under a
name keyed on a hash of the source, and the library is loaded with ``ctypes``.
Nothing is built or loaded at import time, so this module imports on a
machine without ``nvcc`` or a GPU.

``launches`` counts kernel launches (one per ``correlation`` call on CUDA),
so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "correlation.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MD = 4  # the kernel is instantiated for the decoder's +-4 px window only

launches = 0

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> str:
    """Compile the kernel library if its source changed; return its path."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"correlation_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-o", tmp, SOURCE,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file
    return lib_path


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.corr_fwd.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.corr_fwd.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(f1: torch.Tensor, f2: torch.Tensor, md: int) -> None:
    if not (f1.is_cuda and f2.is_cuda) or f1.device != f2.device:
        raise ValueError(
            f"correlation kernel needs both inputs on one CUDA device, got "
            f"{f1.device} and {f2.device}"
        )
    if f1.dtype not in _DTYPES or f2.dtype != f1.dtype:
        raise TypeError(
            f"correlation kernel takes float32 or bfloat16, got {f1.dtype}/{f2.dtype}"
        )
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(
            f"correlation kernel needs two equal (B, C, H, W) shapes, got "
            f"{tuple(f1.shape)} and {tuple(f2.shape)}"
        )
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("correlation kernel needs contiguous NCHW inputs")
    if md != _MD:
        raise ValueError(f"correlation kernel supports md={_MD} only, got {md}")
    b, c, h, w = f1.shape
    if min(b, c, h, w) < 1 or b > 65535 or h > 65535:
        raise ValueError(f"correlation kernel cannot launch shape {tuple(f1.shape)}")


def _launch(f1: torch.Tensor, f2: torch.Tensor, md: int) -> torch.Tensor:
    global launches
    _check(f1, f2, md)
    lib = _load()
    b, c, h, w = f1.shape
    out = torch.empty((b, (2 * md + 1) ** 2, h, w), dtype=f1.dtype, device=f1.device)
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.corr_fwd(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(),
            b, c, h, w, md, _DTYPES[f1.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"correlation kernel launch failed: cudaError {err}")
    launches += 1
    return out


class _Correlation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f1, f2, md):
        return _launch(f1, f2, md)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "correlation backward on CUDA is not ported yet: the training slice "
            "ports _corr_df1_kernel and _corr_df2_kernel "
            "(unopticalflow_tpu/ops/pallas_kernels.py)"
        )


def correlation(f1: torch.Tensor, f2: torch.Tensor, md: int = 4) -> torch.Tensor:
    """(B, C, H, W) x2 on CUDA -> (B, (2md+1)^2, H, W) cost volume, input dtype."""
    return _Correlation.apply(f1, f2, md)
