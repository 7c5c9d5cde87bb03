"""The port's counterparts of the JAX package's probes and learning
harnesses (``benchmarks/``).

    python -m unopticalflow_tpu_torch.benchmarks.gather_probe [--device cuda|cpu]
    python -m unopticalflow_tpu_torch.benchmarks.block_gather_probe [--device cuda|cpu]
    python -m unopticalflow_tpu_torch.benchmarks.sanity_train [--device cuda|cpu]
    python -m unopticalflow_tpu_torch.benchmarks.synthetic_epe [--device cuda|cpu]

``time_ms`` times one call as both probes do, and ``StepClock`` the steps of a
training loop: CUDA events on the card, the host clock on the CPU.
"""

from __future__ import annotations

import statistics
import time

import torch


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
