"""Move JAX parameter trees into the port's modules.

The mapping itself is the JAX package's numpy-only
``unopticalflow_tpu.utils.torch_convert.params_to_torch_state_dict``
(HWIO -> OIHW, reference key names), so both packages share one source of
the key layout.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from unopticalflow_tpu.utils.torch_convert import params_to_torch_state_dict


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
