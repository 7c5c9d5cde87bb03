"""The port's counterparts of the JAX package's gather probes (``benchmarks/``).

    python -m unopticalflow_tpu_torch.benchmarks.gather_probe [--device cuda|cpu]
    python -m unopticalflow_tpu_torch.benchmarks.block_gather_probe [--device cuda|cpu]

``time_ms`` times one call as both probes do: CUDA events on the card, the
host clock on the CPU.
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
