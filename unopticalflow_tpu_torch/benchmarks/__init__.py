"""The port's counterparts of the JAX package's probes, learning harnesses
and measuring tools (``benchmarks/``).  Each runs on the card unless given
``--device cpu``, and raises without a GPU otherwise.

    python -m unopticalflow_tpu_torch.benchmarks.gather_probe [--device cuda|cpu]
    python -m unopticalflow_tpu_torch.benchmarks.block_gather_probe [--device cuda|cpu]
    python -m unopticalflow_tpu_torch.benchmarks.sanity_train [--device cuda|cpu]
    python -m unopticalflow_tpu_torch.benchmarks.synthetic_epe [--device cuda|cpu] \
        [--device-gen | --pool N --pool-device]
    python -m unopticalflow_tpu_torch.benchmarks.make_pool --out pool.npy --n N
    python -m unopticalflow_tpu_torch.benchmarks.make_prepared_synth --out DIR --n N
    python -m unopticalflow_tpu_torch.benchmarks.loader_bench [--device-rate R]
    python -m unopticalflow_tpu_torch.benchmarks.profile_step [--device cuda|cpu]
    python -m unopticalflow_tpu_torch.benchmarks.ablate [--device cuda|cpu]
    python -m unopticalflow_tpu_torch.benchmarks.loss_landscape_probe [--device cuda|cpu]
    python -m unopticalflow_tpu_torch.benchmarks.fg_probe --ckpt last.ckpt
    python -m unopticalflow_tpu_torch.benchmarks.synth_epe_summarize --run name=log ...
    python -m unopticalflow_tpu_torch.benchmarks.real_kitti_eval --gt_2015_dir DIR ...

``synth_device_gen`` is a module without a command line: the on-device
snippet generator behind ``synthetic_epe --device-gen``.  The JAX
``trace_step.py`` is the ``trace`` phase of ``probe.py``; the JAX
``reference_parity.py`` needs the reference's sources, which neither
machine has, and is left out.

``time_ms`` times one call as both probes do, and ``StepClock`` the steps of a
training loop: CUDA events on the card, the host clock on the CPU.
``recipe_step`` builds the KITTI recipe's step, one step or K a dispatch, for
the tools that time it; ``launch_counts`` reads the training kernels' counters.
"""

from __future__ import annotations

import statistics
import time

import torch

# config/kitti.yaml's loss weights, as the JAX tools hardcode them
RECIPE_WEIGHTS = {"loss_pixel": 0.15, "loss_ssim": 0.85, "loss_flow_smooth": 10.0,
                  "loss_flow_consis": 0.01}


def time_ms(fn, args, device: torch.device, iters: int, warmup: int) -> float:
    """Median ms of ``iters`` calls of ``fn(*args)`` after ``warmup`` calls."""
    if iters < 1:
        raise ValueError(f"iters must be at least 1, got {iters}")
    for _ in range(warmup):
        fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        events = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            events.append((start, end))
        torch.cuda.synchronize(device)
        times = [start.elapsed_time(end) for start, end in events]
    else:
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
    return float(statistics.median(times))


def device_name(device: torch.device) -> str:
    """The card's name for a CUDA device, else the device type."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


class StepClock:
    """Marks the end of each step of a loop; ``median_ms`` is the median time
    between consecutive marks, the first ``WARMUP`` intervals left out.

    On the card a mark is a CUDA event on the current stream, so an interval
    is what the device took between two steps' ends, host stalls included;
    on the CPU it is the host clock.
    """

    WARMUP = 2

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def median_ms(self) -> float | None:
        """None when fewer than ``WARMUP + 2`` steps were marked."""
        if len(self.marks) < self.WARMUP + 2:
            return None
        pairs = zip(self.marks[self.WARMUP:], self.marks[self.WARMUP + 1:])
        if self.cuda:
            self.marks[-1].synchronize()
            return float(statistics.median(a.elapsed_time(b) for a, b in pairs))
        return float(statistics.median((b - a) * 1e3 for a, b in pairs))


def launch_counts() -> dict:
    """A copy of the training kernels' launch counters (correlation,
    photometric and regularizer wrappers)."""
    from unopticalflow_tpu_torch.ops import correlation_cuda, photometric_cuda, regularizer_cuda

    return {**correlation_cuda.launches, **photometric_cuda.launches,
            **regularizer_cuda.launches}


def launches_since(before: dict, per: int = 1) -> dict:
    """The counters' growth since ``before``, divided by ``per``."""
    return {k: (v - before[k]) / per for k, v in launch_counts().items()}


def recipe_step(cfg, device: torch.device, k: int = 1, seed: int = 0, scheme: str = "torch",
                weights: dict | None = None):
    """(model, optimizer, step) at the KITTI recipe: ``step(batch)`` is one
    ``train_step`` (K = 1) or one dispatch of ``make_multi_train_step`` over
    a (K, B, 3H, W, 3) stack (on CUDA a CUDA graph of the K steps from the
    second dispatch, with a capturable Adam).  Weights from ``scheme`` and a
    generator seeded with ``seed``, as the JAX tools' ``PRNGKey(0)``."""
    from unopticalflow_tpu_torch.models import FlowModel
    from unopticalflow_tpu_torch.training import (
        make_multi_train_step,
        make_optimizer,
        set_capturable,
        train_step,
    )

    weights = weights or RECIPE_WEIGHTS
    model = FlowModel(cfg, device=device, scheme=scheme,
                      generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer(model, 1e-4)
    if k == 1:
        return model, opt, lambda batch: train_step(model, opt, batch, weights, cfg)
    if device.type == "cuda":
        set_capturable(opt)
    return model, opt, make_multi_train_step(model, opt, cfg, weights, k)


def last_loss(metrics: dict) -> float:
    """The last (sub-)step's total loss as a float: a hard sync with the device."""
    return float(metrics["loss_total"].reshape(-1)[-1])
