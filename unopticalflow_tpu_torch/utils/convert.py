"""Move JAX parameter trees into the port's modules.

``params_to_torch_state_dict`` maps a ``{"fpyramid", "pwc"}`` tree of HWIO
numpy arrays to the reference's state-dict keys with OIHW weights (the
mapping of ``unopticalflow_tpu/utils/torch_convert.py``, numpy only): a conv
inside an ``nn.Sequential`` with its LeakyReLU is ``<prefix>.<name>.0``, the
bare convs ``predict_flow*`` and ``dc_conv7`` are ``<prefix>.<name>``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def params_to_torch_state_dict(params) -> dict[str, np.ndarray]:
    """HWIO -> OIHW, with the reference's module paths as keys."""
    out = {}
    for group, prefix in (("fpyramid", "fpyramid"), ("pwc", "pwc_model")):
        for name, leaf in params[group].items():
            seq = not name.startswith(("predict_flow", "dc_conv7"))
            base = f"{prefix}.{name}.0" if seq else f"{prefix}.{name}"
            out[f"{base}.weight"] = np.transpose(np.asarray(leaf["w"]), (3, 2, 0, 1))
            out[f"{base}.bias"] = np.asarray(leaf["b"])
    return out


def load_jax_params(model: nn.Module, params) -> nn.Module:
    """Load a JAX ``{"fpyramid", "pwc"}`` tree (numpy leaves) into ``model``.

    Strict: every key of the model must be present and no extra key may be.
    """
    state = {
        k: torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in params_to_torch_state_dict(params).items()
    }
    model.load_state_dict(state, strict=True)
    return model
