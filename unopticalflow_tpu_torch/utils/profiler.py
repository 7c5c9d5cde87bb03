"""A section timer, and the PyTorch profiler's trace.

The port's counterpart of ``unopticalflow_tpu/utils/profiler.py``:
``Profiler`` accumulates wall-clock sections, each ended after the device
that holds ``sync_on`` has finished its queued work
(``torch.cuda.synchronize`` of each CUDA tensor's device; CPU tensors need
no wait), and ``torch_trace`` (for ``xla_trace``) records
``torch.profiler`` activity (the CPU, and CUDA where a card is present)
and writes a Chrome trace into a directory.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from collections import defaultdict

import torch


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of the tensors in a nest of lists, tuples and dicts."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


class Profiler:
    """Accumulating wall-clock section timer (device-synchronised)."""

    def __init__(self, silent: bool = False):
        self.silent = silent
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._starts = {}

    def start(self, name: str = "default") -> None:
        self._starts[name] = time.perf_counter()

    def end(self, name: str = "default", sync_on=None) -> float:
        for device in _cuda_devices(sync_on, set()):
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - self._starts.pop(name)
        self.totals[name] += dt
        self.counts[name] += 1
        if not self.silent:
            print(f"[profiler] {name}: {dt * 1e3:.2f} ms")
        return dt

    @contextlib.contextmanager
    def section(self, name: str, sync_on=None):
        self.start(name)
        try:
            yield
        finally:
            self.end(name, sync_on=sync_on)

    def report_all(self) -> dict[str, float]:
        report = {}
        for name, total in self.totals.items():
            n = self.counts[name]
            report[name] = total / max(n, 1)
            if not self.silent:
                print(f"[profiler] {name}: {n} calls, avg {report[name] * 1e3:.2f} ms")
        return report


@contextlib.contextmanager
def torch_trace(logdir: str):
    """Record ``torch.profiler`` activity inside the block (the CPU's, and
    the card's where one is present) and write it to
    ``<logdir>/<host>_<pid>.<ns>.pt.trace.json`` (Chrome / Perfetto).

    Yields the profile; its ``trace_path`` is set when the block ends.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}"
                            ".pt.trace.json")
        prof.export_chrome_trace(path)
        prof.trace_path = path
