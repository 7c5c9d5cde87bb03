"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """Map a ``--device`` value to a ``torch.device``.

    A CUDA device is returned only when CUDA is present; otherwise this
    raises.  It never falls back to the CPU: a CPU run asks for ``"cpu"``.
    """
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} requested but CUDA is not available"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(name)!r} (cuda|cpu)")


def gpu_device(device: str, gpu: str | None) -> str:
    """``--device`` with ``-g/--gpu``: a bare "cuda" becomes "cuda:<gpu>"."""
    return f"cuda:{int(gpu)}" if gpu is not None and device == "cuda" else device


def set_float32_precision(device: torch.device, precision: str) -> None:
    """Turn TF32 off for cuDNN and matmul when ``device`` is CUDA and
    ``precision`` is float32: the JAX package runs float32 at
    Precision.HIGHEST, and PyTorch's default runs float32 convolutions in
    TF32 (``torch.backends.cudnn.allow_tf32`` is True).  Other cases change
    nothing."""
    if torch.device(device).type == "cuda" and precision == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        print("float32: TF32 off (cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False)")
