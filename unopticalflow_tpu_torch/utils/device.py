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
