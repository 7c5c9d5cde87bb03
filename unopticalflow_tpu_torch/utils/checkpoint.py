"""Load pretrained weights into the port's ``FlowModel``.

Reference-format ``.pth`` files (``{"iteration", "model_state_dict"}``, as
the reference's train loop and the JAX package's ``export_torch_checkpoint``
write them) load directly.  The JAX package's own ``.ckpt`` (flax msgpack)
is not read here yet.
"""

from __future__ import annotations

import torch
from torch import nn

from unopticalflow_tpu.utils.torch_convert import strip_prefixes


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
