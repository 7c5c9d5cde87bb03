"""Save, restore and load the port's checkpoints, and read the JAX package's.

The port's files are reference-format ``.pth``: ``{"iteration",
"model_state_dict", "optimizer_state_dict"}``, as the reference's train loop
and the JAX package's ``export_torch_checkpoint`` write them, so the
trainer's files load into the serving slice and vice versa.  A write goes to
a temporary file that ``os.replace`` then renames, so a reader never sees
half a file.

The JAX package's ``.ckpt`` (flax msgpack of ``{"iteration", "params",
"opt_state"}``, ``opt_state`` optax's ``({"count", "mu", "nu"}, {})``, the
``multi_transform`` of it under ``--freeze_flow``, or nil) is read by
``utils/flax_msgpack.py`` and moved across by ``utils/convert.py``:
``load_pretrained`` and ``restore_checkpoint`` take either format by the
file's suffix, for a ``FlowModel`` (``params`` ``{"fpyramid", "pwc"}``) or a
``FlowPoseModel`` (``{"flow", "pose"}``), and ``save_flax_checkpoint``
writes one that the JAX package's ``restore_checkpoint`` reads back.

An Adam of either form saves and restores into either (``restore_checkpoint``
keeps the running optimizer's ``capturable``).

``AsyncCheckpointer`` is the JAX package's asynchronous saver: ``save()``
copies the state on its device and returns; one worker thread copies it to
the host, serialises it once and writes every path in order.
"""

from __future__ import annotations

import io
import os
import queue
import re
import threading

import torch
from torch import nn

from unopticalflow_tpu_torch.utils import flax_msgpack
from unopticalflow_tpu_torch.utils.convert import (
    adam_state_from_torch,
    adam_state_to_torch,
    load_jax_params,
    torch_state_dict_to_params,
)


def strip_prefixes(state_dict) -> dict:
    """Drop the DataParallel ``module.`` and warm-start wrapper prefixes."""
    out = {}
    for k, v in state_dict.items():
        k = re.sub(r"^(module\.)+", "", k)
        k = re.sub(r"^(model_flow\.|model_pose\.model_flow\.)", "", k)
        out[k] = v
    return out


def _is_flax(path: str) -> bool:
    return path.endswith(".ckpt")


def _atomic_write(path: str, blob: bytes) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def _pth_bytes(state: dict) -> bytes:
    buf = io.BytesIO()
    torch.save(state, buf)
    return buf.getvalue()


def _map(fn, obj):
    """``fn`` on every tensor of a nest of dicts and lists."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map(fn, v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_map(fn, v) for v in obj]
    return obj


def _opt_state(opt: torch.optim.Optimizer) -> dict:
    """``opt.state_dict()`` with a learning rate held as a tensor (a schedule
    computed on the device) stored as its float, so every ``.pth`` holds one."""
    state = opt.state_dict()
    for group in state["param_groups"]:
        if isinstance(group.get("lr"), torch.Tensor):
            group["lr"] = float(group["lr"])
    return state


def _in_form_of(state: dict, opt: torch.optim.Optimizer) -> dict:
    """A saved optimizer state dict with ``opt``'s ``capturable`` flag, so that
    ``load_state_dict`` places each ``step`` as ``opt`` needs it.  The flag
    says how an optimizer runs, not what it has learned: a capturable Adam's
    checkpoint resumes an eager one, and back."""
    groups = [{**saved, "capturable": cur.get("capturable", False)}
              for saved, cur in zip(state["param_groups"], opt.param_groups)]
    return {**state, "param_groups": groups}


def _state(iteration: int, model: nn.Module, opt: torch.optim.Optimizer, copy) -> dict:
    return {"iteration": int(iteration),
            "model_state_dict": {k: copy(v.detach()) for k, v in model.state_dict().items()},
            "optimizer_state_dict": _map(copy, _opt_state(opt))}


def save_checkpoint(paths: list[str], iteration: int, model: nn.Module,
                    opt: torch.optim.Optimizer) -> None:
    """Write the model, the optimizer and the iteration to each of ``paths``."""
    blob = _pth_bytes(_state(iteration, model, opt, lambda t: t.cpu()))
    for path in paths:
        _atomic_write(path, blob)


# ---------------------------------------------------------------------------
# the JAX package's .ckpt
# ---------------------------------------------------------------------------


def _flowpose(model: nn.Module) -> bool:
    return hasattr(model, "flow") and hasattr(model, "pose")


def read_flax_checkpoint(path: str, flowpose: bool = False) -> dict:
    """``{"iteration", "params", "opt_state"}`` of a JAX ``.ckpt`` (numpy
    leaves): a flow-mode train state, or with ``flowpose`` a flowposenet one
    (``params`` ``{"flow": {"fpyramid", "pwc"}, "pose"}``)."""
    with open(path, "rb") as f:
        tree = flax_msgpack.loads(f.read())
    params = tree.get("params") if isinstance(tree, dict) else None
    if flowpose:
        ok = isinstance(params, dict) and set(params) == {"flow", "pose"} \
            and {"fpyramid", "pwc"} <= set(params["flow"] or {})
        kind = "flowposenet train state ({'iteration', 'params': {'flow', 'pose'}, 'opt_state'})"
    else:
        ok = isinstance(params, dict) and {"fpyramid", "pwc"} <= set(params)
        kind = "flow-mode train state ({'iteration', 'params': {'fpyramid', 'pwc'}, 'opt_state'})"
    if not ok or "iteration" not in tree:
        raise ValueError(f"{path}: not a {kind} of the JAX package")
    return tree


def _adam(path: str, opt_state, frozen: bool) -> dict:
    """optax Adam's ``{"count", "mu", "nu"}`` out of ``(adam, {})``, or out
    of the ``multi_transform`` state of a ``--freeze_flow`` run
    (``{"inner_states": {"frozen": {"inner_state": {}}, "train":
    {"inner_state": (adam, {})}}}``); the other layout raises ``ValueError``
    naming ``--freeze_flow``."""
    def plain(state):
        return isinstance(state, dict) and set(state) == {"0", "1"} and state["1"] == {} \
            and isinstance(state["0"], dict) and set(state["0"]) == {"count", "mu", "nu"}

    inner = (opt_state or {}).get("inner_states") if isinstance(opt_state, dict) else None
    saved_frozen = isinstance(inner, dict) and set(inner) == {"frozen", "train"} \
        and plain(inner["train"].get("inner_state"))
    if not (saved_frozen or plain(opt_state)):
        raise ValueError(f"{path}: the optimizer state is neither optax.adam's "
                         "({'0': {'count', 'mu', 'nu'}, '1': {}}) nor a --freeze_flow "
                         "multi_transform of it")
    if saved_frozen != frozen:
        raise ValueError(f"{path}: saved {'with' if saved_frozen else 'without'} "
                         f"--freeze_flow, resumed {'with' if frozen else 'without'} it: "
                         "resume with the --freeze_flow setting the checkpoint was saved "
                         "under")
    return inner["train"]["inner_state"]["0"] if frozen else opt_state["0"]


def _frozen(model: nn.Module, opt: torch.optim.Optimizer) -> bool:
    """Whether ``opt`` leaves a ``FlowPoseModel``'s flow branch out (``--freeze_flow``)."""
    held = {id(p) for g in opt.param_groups for p in g["params"]}
    return _flowpose(model) and not any(id(p) in held for p in model.flow.parameters())


def save_flax_checkpoint(path: str, iteration: int, model: nn.Module,
                         opt: torch.optim.Adam | None = None) -> None:
    """Write a JAX-package ``.ckpt`` of ``model`` (and ``opt``'s Adam state,
    as the ``multi_transform`` state when ``opt`` leaves the flow branch out)."""
    params = torch_state_dict_to_params(strip_prefixes(model.state_dict()))
    opt_state = None
    if opt is not None:
        opt_state = {"0": adam_state_from_torch(model, opt), "1": {}}
        if _frozen(model, opt):
            opt_state = {"inner_states": {"frozen": {"inner_state": {}},
                                          "train": {"inner_state": opt_state}}}
    _atomic_write(path, flax_msgpack.dumps(
        {"iteration": int(iteration), "params": params, "opt_state": opt_state}))


# ---------------------------------------------------------------------------
# reading either format
# ---------------------------------------------------------------------------


def restore_checkpoint(path: str, model: nn.Module, opt: torch.optim.Optimizer) -> int:
    """Load the model (strict) and the optimizer; return the iteration.  A
    checkpoint whose optimizer holds another set of parameters than ``opt``
    (saved with or without ``--freeze_flow``, resumed the other way) raises
    ``ValueError``.  ``opt`` keeps its own ``capturable`` flag: a capturable
    Adam gets each ``step`` on its parameter's device,
    an eager one on the host, whichever wrote the file."""
    frozen = _frozen(model, opt)
    if _is_flax(path):
        tree = read_flax_checkpoint(path, _flowpose(model))
        if tree.get("opt_state") is None:
            raise ValueError(f"{path} holds no optimizer state to resume from")
        adam = _adam(path, tree["opt_state"], frozen)
        load_jax_params(model, tree["params"])
        adam_state_to_torch(model, opt, adam)
        return int(tree["iteration"])
    data = torch.load(path, map_location="cpu", weights_only=True)
    if "optimizer_state_dict" not in data:
        raise ValueError(f"{path} holds no optimizer state to resume from")
    saved = sum(len(g["params"]) for g in data["optimizer_state_dict"]["param_groups"])
    held = sum(len(g["params"]) for g in opt.param_groups)
    if saved != held:
        raise ValueError(f"{path}: its optimizer holds {saved} parameter tensors and this one "
                         f"{held} (--freeze_flow={frozen}): resume with the --freeze_flow "
                         "setting the checkpoint was saved under")
    model.load_state_dict(strip_prefixes(data["model_state_dict"]), strict=True)
    opt.load_state_dict(_in_form_of(data["optimizer_state_dict"], opt))
    return int(data["iteration"])


def load_pretrained(model: nn.Module, path: str) -> int:
    """Load ``path`` (``.pth`` or the JAX ``.ckpt``) into ``model`` (strict)
    and return its iteration.  A ``FlowModel`` takes flow-mode weights only;
    a flow warm start of a ``FlowPoseModel`` loads into its ``flow``."""
    if _is_flax(path):
        tree = read_flax_checkpoint(path, _flowpose(model))
        load_jax_params(model, tree["params"])
        return int(tree["iteration"])
    data = torch.load(path, map_location="cpu", weights_only=True)
    state = data.get("model_state_dict", data)
    model.load_state_dict(strip_prefixes(state), strict=True)
    return int(data.get("iteration", 0))


# ---------------------------------------------------------------------------
# asynchronous saves
# ---------------------------------------------------------------------------


class AsyncCheckpointer:
    """Checkpoint writes off the training loop's thread.

    ``save()`` clones the model's and the optimizer's tensors on their device
    (queued on the current stream, so the next step's in-place Adam update
    cannot reach the copy) and returns.  One worker thread waits for the
    clones, copies them to the host on a stream of its own, serialises the
    ``.pth`` once and writes every path atomically, in order, so ``last.pth``
    is always the newest.  At most 2 snapshots wait: a loop that saves faster
    than the disk writes blocks in ``save()``.  A worker's error is raised
    by the next ``save()``, ``wait()`` or ``close()``; ``close()`` drains the
    queue and stops the worker first, whatever happened.
    """

    def __init__(self):
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err: BaseException | None = None
        self._closed = False
        self._streams: dict = {}
        self._thread = threading.Thread(target=self._run, name="checkpoint-writer",
                                         daemon=True)
        self._thread.start()

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        if t.device.type != "cuda":
            return t
        stream = self._streams.get(t.device)
        if stream is None:  # one pool stream a device, taken once
            stream = self._streams[t.device] = torch.cuda.Stream(t.device)
        with torch.cuda.stream(stream):
            return t.cpu()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                paths, snap, ready = item
                if ready is not None:
                    ready.synchronize()
                blob = _pth_bytes(_map(self._host, snap))
                del snap
                for path in paths:
                    _atomic_write(path, blob)
            except Exception as e:  # raised again by the next save/wait/close
                self._err = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("asynchronous checkpoint write failed") from err

    def save(self, paths, iteration: int, model: nn.Module,
             opt: torch.optim.Optimizer) -> None:
        """Snapshot now, write later: every file of ``paths``."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        self._check()
        snap = _state(iteration, model, opt, lambda t: t.clone())
        ready = None
        devices = {p.device for p in model.parameters() if p.device.type == "cuda"}
        if devices:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(next(iter(devices))))
        self._q.put((list(paths), snap, ready))

    def wait(self) -> None:
        """Block until every queued checkpoint is on disk."""
        self._q.join()
        self._check()

    def close(self) -> None:
        """Drain, stop the worker, then raise a pending write error."""
        if not self._closed:
            self._closed = True
            try:
                self._q.join()
            finally:
                self._q.put(None)
                self._thread.join(timeout=60)
        self._check()
