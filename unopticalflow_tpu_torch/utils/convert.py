"""Move JAX parameter trees and optax Adam state into the port, and back.

``params_to_torch_state_dict`` maps a ``{"fpyramid", "pwc"}`` tree of HWIO
numpy arrays to the reference's state-dict keys with OIHW weights (the
mapping of ``unopticalflow_tpu/utils/torch_convert.py``, numpy only): a conv
inside an ``nn.Sequential`` with its LeakyReLU is ``<prefix>.<name>.0``, the
bare convs ``predict_flow*`` and ``dc_conv7`` are ``<prefix>.<name>``.  A
flowposenet tree ``{"flow": {...}, "pose": {...}}`` maps to ``FlowPoseModel``'s
keys: the flow's under ``flow.``, the pose net's ``pose.conv<i>.0.*`` and the
bare ``pose.pose_pred.*``.  ``torch_state_dict_to_params`` is the inverse.

optax's Adam state ``{"count", "mu", "nu"}`` is torch Adam's ``step``,
``exp_avg`` and ``exp_avg_sq``: ``mu`` and ``nu`` are trees shaped as the
params and take the same transpose; ``count`` equals ``step``, since both
bias-correct with the count after its increment.  Under ``--freeze_flow``
the optimizer holds the pose branch only, and ``mu``/``nu``'s ``flow``
subtree is empty (optax's ``MaskedNode``).
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

_KEY = re.compile(r"^(fpyramid|pwc_model)\.([A-Za-z0-9_]+?)(?:\.0)?\.(weight|bias)$")
_POSE_KEY = re.compile(r"^pose\.([A-Za-z0-9_]+?)(?:\.0)?\.(weight|bias)$")


def _is_flowpose(params) -> bool:
    return set(params) == {"flow", "pose"}


def _conv(out: dict, base: str, leaf) -> None:
    out[f"{base}.weight"] = np.transpose(np.asarray(leaf["w"]), (3, 2, 0, 1))
    out[f"{base}.bias"] = np.asarray(leaf["b"])


def params_to_torch_state_dict(params) -> dict[str, np.ndarray]:
    """HWIO -> OIHW, with the reference's (or ``FlowPoseModel``'s) module paths
    as keys; an empty ``flow`` or ``pose`` subtree gives no key."""
    if _is_flowpose(params):
        out = {f"flow.{k}": v for k, v in
               (params_to_torch_state_dict(params["flow"]) if params["flow"] else {}).items()}
        for name, leaf in params["pose"].items():
            _conv(out, f"pose.{name}" if name == "pose_pred" else f"pose.{name}.0", leaf)
        return out
    out = {}
    for group, prefix in (("fpyramid", "fpyramid"), ("pwc", "pwc_model")):
        for name, leaf in params[group].items():
            seq = not name.startswith(("predict_flow", "dc_conv7"))
            _conv(out, f"{prefix}.{name}.0" if seq else f"{prefix}.{name}", leaf)
    return out


def _numpy(val) -> np.ndarray:
    arr = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)
    return np.asarray(arr, np.float32)


def _put(leaf: dict, kind: str, arr: np.ndarray) -> None:
    if kind == "weight":
        leaf["w"] = np.ascontiguousarray(np.transpose(arr, (2, 3, 1, 0)))  # OIHW -> HWIO
    else:
        leaf["b"] = arr


def torch_state_dict_to_params(state_dict) -> dict:
    """A reference state dict (prefixes stripped) -> ``{"fpyramid", "pwc"}``,
    or a ``FlowPoseModel`` one (``flow.``/``pose.`` keys) -> ``{"flow",
    "pose"}``, of HWIO float32 numpy arrays; an unknown key raises."""
    if any(k.startswith(("flow.", "pose.")) for k in state_dict):
        flow = {k[len("flow."):]: v for k, v in state_dict.items() if k.startswith("flow.")}
        pose, unmatched = {}, []
        for key, val in state_dict.items():
            if key.startswith("flow."):
                continue
            m = _POSE_KEY.match(key)
            if not m:
                unmatched.append(key)
                continue
            _put(pose.setdefault(m.group(1), {}), m.group(2), _numpy(val))
        if unmatched:
            raise ValueError(f"unrecognized checkpoint keys: {unmatched[:8]}")
        return {"flow": torch_state_dict_to_params(flow) if flow else {}, "pose": pose}
    params = {"fpyramid": {}, "pwc": {}}
    unmatched = []
    for key, val in state_dict.items():
        m = _KEY.match(key)
        if not m:
            unmatched.append(key)
            continue
        group = "fpyramid" if m.group(1) == "fpyramid" else "pwc"
        _put(params[group].setdefault(m.group(2), {}), m.group(3), _numpy(val))
    if unmatched:
        raise ValueError(f"unrecognized checkpoint keys: {unmatched[:8]}")
    return params


def _tensors(params) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in params_to_torch_state_dict(params).items()}


def load_jax_params(model: nn.Module, params) -> nn.Module:
    """Load a JAX ``{"fpyramid", "pwc"}`` (``FlowModel``) or ``{"flow",
    "pose"}`` (``FlowPoseModel``) tree of numpy leaves into ``model``.

    Strict: every key of the model must be present and no extra key may be.
    """
    model.load_state_dict(_tensors(params), strict=True)
    return model


def _opt_names(model: nn.Module, opt: torch.optim.Optimizer) -> list[str]:
    """The names of ``opt``'s parameters, in its order (its state's indices)."""
    by_id = {id(p): n for n, p in model.named_parameters()}
    return [by_id[id(p)] for g in opt.param_groups for p in g["params"]]


def adam_state_to_torch(model: nn.Module, opt: torch.optim.Adam, adam: dict) -> None:
    """Load optax's ``{"count", "mu", "nu"}`` into ``opt`` for ``model``'s params.

    ``count`` becomes every ``step``: on the host for an eager Adam, on the
    parameter's device for a capturable one (``load_state_dict``'s placement
    by ``opt``'s own groups)."""
    mu, nu = _tensors(adam["mu"]), _tensors(adam["nu"])
    names = _opt_names(model, opt)
    if set(mu) != set(names) or set(nu) != set(names):
        raise ValueError("the Adam state's tree does not match the optimizer's parameters")
    sd = opt.state_dict()
    step = float(np.asarray(adam["count"]))
    sd["state"] = {i: {"step": torch.tensor(step), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                   for i, n in enumerate(names)}
    opt.load_state_dict(sd)


def adam_state_from_torch(model: nn.Module, opt: torch.optim.Adam) -> dict:
    """optax's ``{"count", "mu", "nu"}`` of ``opt`` (zeros before its first step),
    a capturable Adam's device ``step`` read back to the host; a frozen flow
    branch (not in ``opt``) is an empty ``flow`` subtree."""
    state = opt.state_dict()["state"]
    params = dict(model.named_parameters())
    mu, nu, count = {}, {}, 0
    for i, n in enumerate(_opt_names(model, opt)):
        s = state.get(i)
        if s is None:
            mu[n] = nu[n] = torch.zeros_like(params[n], device="cpu")
            continue
        mu[n], nu[n], count = s["exp_avg"], s["exp_avg_sq"], int(s["step"])
    return {"count": np.asarray(count, np.int32),
            "mu": torch_state_dict_to_params(mu), "nu": torch_state_dict_to_params(nu)}
