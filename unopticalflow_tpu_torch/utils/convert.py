"""Move JAX parameter trees and optax Adam state into the port, and back.

``params_to_torch_state_dict`` maps a ``{"fpyramid", "pwc"}`` tree of HWIO
numpy arrays to the reference's state-dict keys with OIHW weights (the
mapping of ``unopticalflow_tpu/utils/torch_convert.py``, numpy only): a conv
inside an ``nn.Sequential`` with its LeakyReLU is ``<prefix>.<name>.0``, the
bare convs ``predict_flow*`` and ``dc_conv7`` are ``<prefix>.<name>``.
``torch_state_dict_to_params`` is its inverse.

optax's Adam state ``{"count", "mu", "nu"}`` is torch Adam's ``step``,
``exp_avg`` and ``exp_avg_sq``: ``mu`` and ``nu`` are trees shaped as the
params and take the same transpose; ``count`` equals ``step``, since both
bias-correct with the count after its increment.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

_KEY = re.compile(r"^(fpyramid|pwc_model)\.([A-Za-z0-9_]+?)(?:\.0)?\.(weight|bias)$")


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


def torch_state_dict_to_params(state_dict) -> dict:
    """A reference state dict (prefixes stripped) -> ``{"fpyramid", "pwc"}``
    of HWIO float32 numpy arrays; an unknown key raises."""
    params = {"fpyramid": {}, "pwc": {}}
    unmatched = []
    for key, val in state_dict.items():
        m = _KEY.match(key)
        if not m:
            unmatched.append(key)
            continue
        group = "fpyramid" if m.group(1) == "fpyramid" else "pwc"
        arr = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)
        arr = np.asarray(arr, np.float32)
        leaf = params[group].setdefault(m.group(2), {})
        if m.group(3) == "weight":
            leaf["w"] = np.ascontiguousarray(np.transpose(arr, (2, 3, 1, 0)))  # OIHW -> HWIO
        else:
            leaf["b"] = arr
    if unmatched:
        raise ValueError(f"unrecognized checkpoint keys: {unmatched[:8]}")
    return params


def _tensors(params) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in params_to_torch_state_dict(params).items()}


def load_jax_params(model: nn.Module, params) -> nn.Module:
    """Load a JAX ``{"fpyramid", "pwc"}`` tree (numpy leaves) into ``model``.

    Strict: every key of the model must be present and no extra key may be.
    """
    model.load_state_dict(_tensors(params), strict=True)
    return model


def adam_state_to_torch(model: nn.Module, opt: torch.optim.Adam, adam: dict) -> None:
    """Load optax's ``{"count", "mu", "nu"}`` into ``opt`` for ``model``'s params."""
    mu, nu = _tensors(adam["mu"]), _tensors(adam["nu"])
    names = [n for n, _ in model.named_parameters()]
    if set(mu) != set(names) or set(nu) != set(names):
        raise ValueError("the Adam state's tree does not match the model's parameters")
    sd = opt.state_dict()
    step = float(np.asarray(adam["count"]))
    sd["state"] = {i: {"step": torch.tensor(step), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                   for i, n in enumerate(names)}
    opt.load_state_dict(sd)


def adam_state_from_torch(model: nn.Module, opt: torch.optim.Adam) -> dict:
    """optax's ``{"count", "mu", "nu"}`` of ``opt`` (zeros before its first step)."""
    state = opt.state_dict()["state"]
    mu, nu, count = {}, {}, 0
    for i, (n, p) in enumerate(model.named_parameters()):
        s = state.get(i)
        if s is None:
            mu[n] = nu[n] = torch.zeros_like(p, device="cpu")
            continue
        mu[n], nu[n], count = s["exp_avg"], s["exp_avg_sq"], int(s["step"])
    return {"count": np.asarray(count, np.int32),
            "mu": torch_state_dict_to_params(mu), "nu": torch_state_dict_to_params(nu)}
