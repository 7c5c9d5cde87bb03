"""Save, restore and load the port's checkpoints.

The files are reference-format ``.pth``: ``{"iteration", "model_state_dict",
"optimizer_state_dict"}``, as the reference's train loop and the JAX
package's ``export_torch_checkpoint`` write them, so the trainer's files
load into the serving slice and vice versa.  A write goes to a temporary
file that ``os.replace`` then renames, so a reader never sees half a file.
The JAX package's own ``.ckpt`` (flax msgpack) is not read here yet.
"""

from __future__ import annotations

import os
import re

import torch
from torch import nn


def strip_prefixes(state_dict) -> dict:
    """Drop the DataParallel ``module.`` and warm-start wrapper prefixes."""
    out = {}
    for k, v in state_dict.items():
        k = re.sub(r"^(module\.)+", "", k)
        k = re.sub(r"^(model_flow\.|model_pose\.model_flow\.)", "", k)
        out[k] = v
    return out


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(paths: list[str], iteration: int, model: nn.Module,
                    opt: torch.optim.Optimizer) -> None:
    """Write the model, the optimizer and the iteration to each of ``paths``."""
    state = {
        "iteration": int(iteration),
        "model_state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer_state_dict": opt.state_dict(),
    }
    for path in paths:
        _atomic_save(state, path)


def restore_checkpoint(path: str, model: nn.Module, opt: torch.optim.Optimizer) -> int:
    """Load the model (strict) and the optimizer; return the iteration."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    if "optimizer_state_dict" not in data:
        raise ValueError(f"{path} holds no optimizer state to resume from")
    model.load_state_dict(strip_prefixes(data["model_state_dict"]), strict=True)
    opt.load_state_dict(data["optimizer_state_dict"])
    return int(data["iteration"])


def load_pretrained(model: nn.Module, path: str) -> int:
    """Load ``path`` into ``model`` (strict) and return its iteration."""
    if path.endswith(".ckpt"):
        raise ValueError(
            f"{path}: flax .ckpt checkpoints wait for the checkpoint port; "
            "convert it first with unopticalflow_tpu.utils.torch_convert."
            "export_torch_checkpoint and pass the resulting .pth"
        )
    data = torch.load(path, map_location="cpu", weights_only=True)
    state = data.get("model_state_dict", data)
    model.load_state_dict(strip_prefixes(state), strict=True)
    return int(data.get("iteration", 0))
