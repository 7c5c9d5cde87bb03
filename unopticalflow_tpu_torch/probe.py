"""Measure the port's serving slice on one CUDA device.

    python -m unopticalflow_tpu_torch.probe [--out build/probe] \
        [--requests 512] [--seed 0]

Everything runs at the KITTI serving shape (``config/kitti.yaml``: img_hw
256x832), ``max_batch`` 8, bfloat16 (serve's default), with random "pwc"
weights from ``--seed``.  Two phases, each printing one JSON line:

1. ``profile``: ``inference_flow`` on one full batch.
   * ``ms_batch``: CUDA events around one batch, median of 30, with
     no profiler running;
   * ``busy_ms_batch``: the union of the device's kernel, memcpy and memset
     intervals per batch, from ``torch.profiler`` over 5 batches (the per-op table goes to ``<out>/profile.txt``);
   * ``idle_share`` = 1 - busy_ms_batch / ms_batch;
   * host clock, median of 30: the host-to-device copy of one
     (8, 256, 832, 3) float32 frame batch, ``inference_flow`` plus a
     synchronise, and the flow's copy back.
2. ``serve``: ``FlowServer`` under closed-loop load from 8 client
   threads, once per warm-up placement, each in a fresh process (PyTorch
   keeps cuDNN state per thread, and a process keeps that of threads that
   ended), in the order serving, constructor, constructor, serving.
   ``serving`` is ``FlowServer`` as shipped, warmed up on its serving
   thread; ``constructor`` warms up on the thread that builds the server.
   Each run reports its first request's latency (the fresh server's first
   batch), then served pairs/s and request-latency percentiles over
   ``--requests`` requests.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import types

import numpy as np
import torch

from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, inference_flow
from unopticalflow_tpu_torch.serve import FlowServer
from unopticalflow_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG_HW = (256, 832)  # config/kitti.yaml
MAX_BATCH = 8  # serve.py --max_batch default
WARM_UPS = ("serving", "constructor")
CLIENTS = 8  # closed-loop client threads: one full batch in flight
REPS = 30  # timed batches per measurement of the profile phase
PROFILED = 5  # batches under torch.profiler


class ConstructorWarmServer(FlowServer):
    """``FlowServer`` warmed up on the thread that constructs it."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        z = np.zeros((self.max_batch, self.h, self.w, 3), np.float32)
        self._run(z, z)

    def _warm_up(self) -> bool:
        self._ready.set()
        return True


def _model(device, seed: int) -> FlowModel:
    return FlowModel(FlowModelConfig(compute_dtype="bfloat16"), device=device,
                     scheme="pwc", generator=torch.Generator().manual_seed(seed))


def _pairs(img_hw, n: int, seed: int) -> list[np.ndarray]:
    h, w = img_hw
    rng = np.random.RandomState(seed)
    return [rng.rand(2 * h, w, 3).astype(np.float32) for _ in range(n)]


def serve_run(model: FlowModel, img_hw, warm_up: str, n_requests: int,
              n_clients: int, max_batch: int = MAX_BATCH, seed: int = 0) -> dict:
    """One fresh server under closed-loop load; host-clock times in ms."""
    server_cls = {"serving": FlowServer, "constructor": ConstructorWarmServer}[warm_up]
    pairs = _pairs(img_hw, n_requests + 1, seed)
    t0 = time.perf_counter()
    server = server_cls(types.SimpleNamespace(img_hw=img_hw), model,
                        max_batch=max_batch, max_wait_ms=5.0)
    start_ms = (time.perf_counter() - t0) * 1e3
    try:
        t0 = time.perf_counter()
        server.infer(pairs[-1], timeout=300.0)
        first_ms = (time.perf_counter() - t0) * 1e3
        latencies = [0.0] * n_requests

        def client(k):
            for i in range(k, n_requests, n_clients):
                t = time.perf_counter()
                server.infer(pairs[i], timeout=300.0)
                latencies[i] = (time.perf_counter() - t) * 1e3

        threads = [threading.Thread(target=client, args=(k,)) for k in range(n_clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        stats = json.loads(json.dumps(server.stats))
    finally:
        server.close()
    if stats["served"] != n_requests + 1 or stats["errors"] or stats["shed"]:
        raise RuntimeError(f"server stats {stats}")
    p50, p90, p99 = np.percentile(latencies, [50, 90, 99])
    return {
        "phase": "serve", "warm_up": warm_up, "start_ms": start_ms,
        "first_request_ms": first_ms, "requests": n_requests, "clients": n_clients,
        "wall_s": wall, "pairs_per_s": n_requests / wall,
        "latency_ms": {"p50": p50, "p90": p90, "p99": p99},
        "batches": stats["batches"], "occupancy": stats["occupancy"],
    }


def _busy_us(events) -> float:
    """Length of the union of the device intervals (kernels, copies, sets)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_run(model: FlowModel, reps: int, profiled: int, out_dir: str, seed: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    device = next(model.parameters()).device
    h, w = IMG_HW
    pairs = np.stack(_pairs(IMG_HW, MAX_BATCH, seed))
    host1, host2 = pairs[:, :h].copy(), pairs[:, h:].copy()
    i1 = torch.from_numpy(host1).to(device)
    i2 = torch.from_numpy(host2).to(device)
    with torch.inference_mode():
        for _ in range(3):
            flow = inference_flow(model, i1, i2)
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            inference_flow(model, i1, i2)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        copy_in = _median_ms(lambda: torch.from_numpy(host1).to(device), reps)
        infer_sync = _median_ms(lambda: inference_flow(model, i1, i2), reps)
        copy_out = _median_ms(lambda: flow.cpu(), reps)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(profiled):
                inference_flow(model, i1, i2)
            torch.cuda.synchronize()
    ms_batch = statistics.median(times)
    busy = _busy_us(prof.events()) / 1e3 / profiled
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    with open(os.path.join(out_dir, "profile.txt"), "w") as f:
        f.write(f"{profiled} batches of inference_flow, bfloat16, "
                f"{MAX_BATCH}x{h}x{w}\n{table}\n")
    return {
        "phase": "profile", "ms_batch": ms_batch, "ms_batch_min": min(times),
        "ms_batch_max": max(times), "reps": reps, "busy_ms_batch": busy,
        "idle_share": 1.0 - busy / ms_batch, "profiled_batches": profiled,
        "host_ms": {"copy_in_frames": copy_in, "inference_flow_sync": infer_sync,
                    "copy_out_flow": copy_out},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="measure the port's serving slice")
    p.add_argument("--out", default="build/probe")
    p.add_argument("--requests", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--serve_one", choices=WARM_UPS, default=None,
                   help="run one serve measurement in this process and exit")
    args = p.parse_args(argv)

    device = resolve_device("cuda")
    model = _model(device, args.seed)
    if args.serve_one:
        print(json.dumps(serve_run(model, IMG_HW, args.serve_one, args.requests,
                                   CLIENTS, seed=args.seed)))
        return 0

    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    print(json.dumps(profile_run(model, REPS, PROFILED, args.out, args.seed)))
    del model
    torch.cuda.empty_cache()
    for warm_up in ("serving", "constructor", "constructor", "serving"):
        proc = subprocess.run(
            [sys.executable, "-m", "unopticalflow_tpu_torch.probe", "--serve_one", warm_up,
             "--requests", str(args.requests), "--seed", str(args.seed)],
            cwd=REPO, capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"serve run ({warm_up}) failed:\n{proc.stderr}")
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
