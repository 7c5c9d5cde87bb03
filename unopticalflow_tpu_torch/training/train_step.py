"""One training step: forward + loss weighting + backward + Adam, and K of
them a dispatch.

Port of ``unopticalflow_tpu/training/train_step.py``.  The JAX package
compiles the whole step into one XLA program; here ``train_step`` runs
eagerly: the forward launches the correlation and photometric kernels (and
the regularizer's, with ``FlowModelConfig.use_pallas_reg``), autograd
launches their backward kernels, and ``torch.optim.Adam`` updates the
parameters.  ``make_multi_train_step`` is JAX's ``lax.scan`` of K steps over
K stacked batches: on CUDA one replay of a CUDA graph that holds the K
whole steps, on the CPU K eager steps.

Data parallelism (``group``: a ``torch.distributed`` process group, JAX's
``mesh``): every rank runs the step on its block of the global batch, and
between the backward and Adam the gradients, the weighted total and the
per-loss means are pmean-reduced (``parallel.all_reduce_mean``: one
all-reduce of one flat buffer), so every rank applies the update of the
global batch and logs its losses.  Under NCCL the all-reduce is recorded in
the K-step CUDA graph with the rest of the step; a gloo group cannot be
captured.

The forward by ``mode`` and the snippet's frame count, as JAX ``_loss_fn``:
``flow`` takes a (B, 3H, W, 3) batch through ``forward`` (2H:
``forward_pair``), ``flowposenet`` an ``(images, K, K_inv)`` tuple through
``forward_flowpose`` (2H: ``forward_flowpose_pair``).

Loss weighting (``generate_loss_weights_dict`` of the reference):
pixel = 1 - w_ssim, ssim = w_ssim, smooth = w_flow_smooth,
consis = w_flow_consis, and in flowposenet mode pose_epipolar =
w_pose_epipolar.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from unopticalflow_tpu_torch.models.flow_model import FlowModelConfig, forward, forward_pair
from unopticalflow_tpu_torch.models.flowpose_model import forward_flowpose, forward_flowpose_pair
from unopticalflow_tpu_torch.parallel.mesh import all_reduce_mean

FORWARDS = {("flow", 3): forward, ("flow", 2): forward_pair,
            ("flowposenet", 3): forward_flowpose, ("flowposenet", 2): forward_flowpose_pair}


def loss_weights_from_config(cfg) -> dict[str, float]:
    """Config -> loss-weight table; flowposenet mode adds ``loss_pose_epipolar``."""
    w_ssim = float(getattr(cfg, "w_ssim", 0.85))
    weights = {
        "loss_pixel": 1.0 - w_ssim,
        "loss_ssim": w_ssim,
        "loss_flow_smooth": float(getattr(cfg, "w_flow_smooth", 10.0)),
        "loss_flow_consis": float(getattr(cfg, "w_flow_consis", 0.01)),
    }
    if getattr(cfg, "mode", "flow") == "flowposenet":
        weights["loss_pose_epipolar"] = float(getattr(cfg, "w_pose_epipolar", 1.0))
    return weights


def make_optimizer(model: torch.nn.Module, lr: float = 1e-4,
                   freeze_flow: bool = False) -> torch.optim.Adam:
    """Adam with the reference's (torch-default) hyperparameters, as optax.adam.

    ``freeze_flow`` (a ``FlowPoseModel``): Adam takes the pose branch only, so
    the flow branch stays bit-identical (JAX's ``multi_transform`` with
    ``set_to_zero``).  The trainer also sets the flow branch's
    ``requires_grad`` to False, so that autograd skips its backward.
    ``set_capturable`` turns it into the form a CUDA graph can hold.
    """
    params = model.pose.parameters() if freeze_flow else model.parameters()
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def set_capturable(opt: torch.optim.Optimizer) -> None:
    """Switch ``opt`` to its capturable form in place, state kept, after any
    resume (CUDA parameters only): the step count and the bias corrections
    live on the device, so that a CUDA graph can hold the update
    (``make_multi_train_step``); the same math, rounded in other places.  The
    state dict's round trip moves each ``step`` to its parameter's device."""
    state = opt.state_dict()
    for group in state["param_groups"]:
        group["capturable"] = True
    opt.load_state_dict(state)


def loss_fn(model, cfg: FlowModelConfig, batch, weights: dict, mode: str = "flow",
            snippet_frames: int = 3, **fns):
    """(weighted total, {loss name: batch mean}) of one batch: a (B, 3H, W, 3)
    tensor in flow mode, ``(images, K, K_inv)`` in flowposenet mode.

    uint8 tensors (the datasets' ``emit_uint8`` path) are cast to float32 and
    divided by 255 on their device.  ``fns`` (``corr_fn``, ``photo_fn``,
    ``reg_fn``) pass through to the forward; the 2-frame forwards take
    ``corr_fn`` only (their losses are the plain ones, as in JAX).
    """
    batch = batch if isinstance(batch, tuple) else (batch,)
    batch = tuple(x.float() / 255.0 if x.dtype == torch.uint8 else x for x in batch)
    pack = FORWARDS[mode, snippet_frames](model, cfg, *batch, **fns)
    means = {k: v.mean() for k, v in pack.items()}
    total = sum(weights[k] * v for k, v in means.items())
    return total, means


def train_step(model, opt: torch.optim.Optimizer, batch, weights: dict,
               cfg: FlowModelConfig, mode: str = "flow", snippet_frames: int = 3,
               group=None) -> dict:
    """One optimizer step; returns the detached per-loss means and ``loss_total``.

    ``group``: this rank's ``batch`` is its block of the global batch, and
    the gradients and the metrics are pmean-reduced over the group before
    Adam steps (JAX ``train_step.py``'s pmean of grads, loss and pack).  The
    parameters without a gradient (a frozen flow branch) are left out, on
    every rank alike.  Nothing here waits for the device: the returned
    values are device tensors, read when the caller logs them.
    """
    opt.zero_grad(set_to_none=True)
    total, means = loss_fn(model, cfg, batch, weights, mode, snippet_frames)
    total.backward()
    metrics = {**{k: v.detach() for k, v in means.items()}, "loss_total": total.detach()}
    if group is not None:
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        # float32, so that the metrics share the gradients' buffer: one collective
        stats = torch.stack([v.float() for v in metrics.values()])
        all_reduce_mean(grads + [stats], group)
        metrics = {k: s.to(v.dtype) for (k, v), s in zip(metrics.items(), stats.unbind())}
    opt.step()
    return metrics


def _slot(batch: tuple, k: int):
    """Sub-step ``k`` of a stacked batch: a tensor in flow mode, else a tuple."""
    parts = tuple(x[k] for x in batch)
    return parts if len(parts) > 1 else parts[0]


class MultiTrainStep:
    """``make_multi_train_step``'s step function (see there)."""

    def __init__(self, model, opt, cfg, weights, steps, mode, snippet_frames, pre_step,
                 group):
        self.model, self.opt, self.cfg, self.weights = model, opt, cfg, weights
        self.steps, self.mode, self.snippet_frames = steps, mode, snippet_frames
        self.pre_step, self.group = pre_step, group
        self._warmed_up = False  # CUDA: the first dispatch ran eagerly
        self._graph = None  # the captured K steps (CUDA, from the second dispatch)
        self._slots = None  # the graph's input slots, (K, ...) per leaf
        self._static_metrics = None  # (metrics, K), written by every replay
        self._names = None

    @property
    def captures_next(self) -> bool:
        """Whether the next CUDA dispatch captures the graph.  A caller's
        other threads must then leave the card's pool streams alone (PyTorch
        hands its 32 streams a card round-robin, so any of them can be the
        capture's): the trainer drains its checkpoint writer first."""
        return self._warmed_up and self._graph is None

    def _run(self, batch: tuple) -> dict:
        """K steps on ``batch``'s slots; metrics stacked to (K,)."""
        out = []
        for k in range(self.steps):
            if self.pre_step is not None:
                self.pre_step()
            out.append(train_step(self.model, self.opt, _slot(batch, k), self.weights,
                                  self.cfg, self.mode, self.snippet_frames, self.group))
        return {name: torch.stack([m[name] for m in out]) for name in out[0]}

    def _warm_up(self, batch: tuple) -> dict:
        """The first dispatch: K real steps, eagerly, on a side stream (PyTorch's
        recipe before a capture).  It builds and loads the kernels, creates the
        library handles and Adam's state, and runs the group's all-reduce on
        this stream before the capture records it; nothing is thrown away."""
        device = batch[0].device
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side), warnings.catch_warnings():
            # capturable Adam warns when it steps outside a capture
            warnings.filterwarnings("ignore", message=".*capturable=True.*")
            metrics = self._run(batch)
        current.wait_stream(side)
        # the caching allocator frees a tensor after the streams it was used on
        for x in batch:
            x.record_stream(side)
        for m in metrics.values():
            m.record_stream(current)
        return metrics

    def _capture(self, batch: tuple) -> None:
        """Capture the K steps on static slots shaped as ``batch``.  A failed
        capture raises: there is no quiet fall-back to eager steps."""
        self._slots = tuple(torch.empty_like(x) for x in batch)
        # each sub-step's train_step sets the gradients to None before its
        # backward, so sub-step k never adds into sub-step k - 1's .grad
        self.opt.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        # thread_local: this thread's calls are checked, not other threads'
        # (see captures_next for the streams they may use meanwhile)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            metrics = self._run(self._slots)
            self._static_metrics = torch.stack(list(metrics.values()))
        self._names = list(metrics)
        self._graph = graph

    def __call__(self, batch) -> dict:
        batch = batch if isinstance(batch, tuple) else (batch,)
        if any(x.shape[0] != self.steps for x in batch):
            raise ValueError(f"a dispatch takes {self.steps} stacked batches (a leading axis "
                             f"of {self.steps}), got {[tuple(x.shape) for x in batch]}")
        if batch[0].device.type != "cuda":
            return self._run(batch)
        if not all(g["capturable"] for g in self.opt.param_groups):
            raise ValueError("a CUDA graph of the step needs a capturable Adam "
                             "(set_capturable)")
        if self.group is not None and dist.get_backend(self.group) != "nccl":
            raise RuntimeError(f"a {dist.get_backend(self.group)} process group cannot be "
                               f"captured in a CUDA graph: a K = {self.steps} dispatch on "
                               "CUDA needs NCCL (or --steps_per_dispatch 1)")
        if not self._warmed_up:
            self._warmed_up = True
            return self._warm_up(batch)
        if self._graph is None:
            self._capture(batch)
        for slot, x in zip(self._slots, batch):
            slot.copy_(x)  # on the consumer stream, before the replay reads it
        self._graph.replay()
        metrics = self._static_metrics.clone()  # the next replay overwrites the buffer
        return dict(zip(self._names, metrics))


def make_multi_train_step(model, opt: torch.optim.Optimizer, cfg: FlowModelConfig,
                          weights: dict, steps_per_dispatch: int, mode: str = "flow",
                          snippet_frames: int = 3, freeze_flow: bool = False,
                          pre_step=None, group=None) -> MultiTrainStep:
    """K optimizer steps a call: the JAX ``make_multi_train_step``.

    Returns ``step_fn(batch) -> metrics``.  Every leaf of ``batch`` carries a
    leading (K, ...) axis, (K, B, 3H, W, 3) in flow mode and ``(images, K,
    K_inv)`` stacked in flowposenet mode, and every metric comes back stacked
    to (K,), sub-step k's at k.  The sub-steps are ``train_step`` calls on
    slots 0 ... K-1, in order.

    The path follows the device of the batch passed in.  On the CPU a call
    runs the K steps eagerly, bit for bit K ``train_step`` calls.  On CUDA
    ``opt`` must be capturable (``set_capturable``):
    the first call runs its K steps eagerly as real training steps, on a side
    stream; the second captures one ``torch.cuda.CUDAGraph`` of the K whole
    steps (forward, backward, Adam) on static input slots and replays it;
    every later call copies its batch into the slots on the current stream
    and replays the graph once.  The kernels' wrappers run, and count their
    launches, only while the first call runs and while the graph is captured;
    replays launch the recorded kernels without them.  Resume (load the
    optimizer's state) before the first call.  ``freeze_flow``: the flow
    branch of a ``FlowPoseModel`` gets no gradient and ``opt`` must not hold
    it.  ``pre_step()``, when given, runs before each sub-step, and on CUDA
    is captured with it (device operations only: a learning-rate schedule
    computed on the device from a step count).  ``group``: each sub-step is
    ``train_step(..., group=group)``; on CUDA the group must be NCCL's,
    whose all-reduce the graph records (a gloo group raises at the first
    call).
    """
    if steps_per_dispatch < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
    if freeze_flow:
        held = {id(p) for g in opt.param_groups for p in g["params"]}
        if any(id(p) in held for p in model.flow.parameters()):
            raise ValueError("freeze_flow: the optimizer holds the flow branch")
        model.flow.requires_grad_(False)
    return MultiTrainStep(model, opt, cfg, weights, steps_per_dispatch, mode, snippet_frames,
                          pre_step, group)
