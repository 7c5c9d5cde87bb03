"""Measure the port's serving and training slices on one CUDA device.

    python -m unopticalflow_tpu_torch.probe [--out build/probe] \
        [--requests 512] [--seed 0] [--phases profile,serve,train,spatial]

Everything runs at the KITTI shape (``config/kitti.yaml``: img_hw 256x832)
with random "pwc" weights from ``--seed``; serving at ``max_batch`` 8 in
bfloat16 (serve's default), training at batch 8 with 3 loss scales.  Each
phase prints JSON lines:

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
3. ``train``: ``train_step`` at the KITTI recipe in float32 (TF32 off) and
   in bfloat16 (``--precision``/``--loss_precision``), on one
   device-resident uint8 batch of synthetic snippets; per dtype four runs,
   with ``FlowModelConfig.use_pallas_reg`` off, on, on, off (the fused
   regularizer kernels against the plain smoothness and consistency terms,
   in turns within one process).
   * ``ms_step``: CUDA events around each step, median of 20, with no
     profiler running;
   * ``busy_ms_step`` and ``idle_share`` as in ``profile``, over 5 profiled
     steps; device time per step by kind of kernel and the top device ops
     (the full table goes to ``<out>/train_<dtype>[_reg].txt``);
   * ``launches_per_step``: the hand-written kernels' launch counts;
     ``device_ops_per_step``: every kernel, copy and set the device ran per
     profiled step (what the host had to launch).
4. ``spatial``: one full batch of ``inference_flow`` (``n_spatial`` 0) against
   ``make_spatial_infer`` with 1, 2 and 4 row-shards, all on this card, in
   float32 (TF32 off) and bfloat16, in the order 0, 1, 2, 4, 4, 2, 1, 0 per
   dtype: ``ms_batch`` (CUDA events, median of ``REPS``, no profiler),
   ``busy_ms_batch``, ``idle_share``, ``device_ops_per_batch`` and
   ``device_ms_by_kind`` over 5 profiled batches, and the hand-written
   kernels' launches per batch (tables in ``<out>/spatial_<dtype>_n<n>.txt``).
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

from unopticalflow_tpu_torch.data.synthetic import SyntheticSnippets
from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, inference_flow
from unopticalflow_tpu_torch.ops import correlation_cuda, photometric_cuda, regularizer_cuda
from unopticalflow_tpu_torch.serve import FlowServer
from unopticalflow_tpu_torch.training import loss_weights_from_config, make_optimizer, train_step
from unopticalflow_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG_HW = (256, 832)  # config/kitti.yaml
MAX_BATCH = 8  # serve.py --max_batch default
WARM_UPS = ("serving", "constructor")
CLIENTS = 8  # closed-loop client threads: one full batch in flight
REPS = 30  # timed batches per measurement of the profile phase
PROFILED = 5  # batches (or steps) under torch.profiler
TRAIN_REPS = 20  # timed steps per dtype of the train phase
TOP_OPS = 12


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


# a marker of the host waiting on a full launch queue, not device work
_NOT_DEVICE_WORK = ("Command Buffer Full",)


def _device_work(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in _NOT_DEVICE_WORK)


def _busy_us(events) -> float:
    """Length of the union of the device intervals (kernels, copies, sets)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events if _device_work(e))
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


def top_device_ops(averages, steps: int, n: int = TOP_OPS) -> list[dict]:
    """The ``n`` device kernels, copies and sets of ``prof.key_averages()``
    with the most device time, in ms per step."""
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
            for e in averages if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in _NOT_DEVICE_WORK]
    rows.sort(key=lambda r: -r[1])
    return [{"op": k, "ms_per_step": t, "calls_per_step": c} for k, t, c in rows[:n]]


# kinds of device work in a training step, by kernel name (first match wins)
KINDS = (
    ("port kernels", ("corr_fwd_kernel", "corr_df1_kernel", "corr_df2_kernel",
                      "photo_fwd_kernel", "photo_bwd_kernel", "reg_fwd_kernel",
                      "reg_bwd_kernel")),
    ("convolution (cuDNN/cuBLAS)", ("cudnn", "xmma", "fft", "winograd", "dgrad", "wgrad",
                                    "gemm", "DSE::", "region_transform", "nchwToNhwc",
                                    "nhwcToNchw", "scalePackedTensor",
                                    "pointwise_mult_and_sum_complex")),
    ("gather/scatter (warps)", ("gather", "scatter")),
    ("optimizer", ("adam", "Adam", "multi_tensor")),
    ("elementwise/reduction", ("elementwise", "reduce", "Reduce", "CatArray", "pool", "upsample",
                               "softmax", "copy", "fill")),
)


def device_ops_per_step(averages, steps: int) -> float:
    """Kernels, copies and sets the device ran per step (``prof.key_averages()``)."""
    return sum(e.count for e in averages if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in _NOT_DEVICE_WORK) / steps


def device_time_by_kind(averages, steps: int) -> dict:
    """Device kernel time per step (ms), summed by ``KINDS``; the rest is "other"."""
    out = {name: 0.0 for name, _ in KINDS}
    out["other"] = 0.0
    for e in averages:
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key in _NOT_DEVICE_WORK:
            continue
        kind = next((name for name, pats in KINDS if any(p in e.key for p in pats)), "other")
        out[kind] += e.self_device_time_total / 1e3 / steps
    return out


def _launch_counts() -> dict:
    return {**correlation_cuda.launches, **photometric_cuda.launches,
            **regularizer_cuda.launches}


def train_run(device, precision: str, out_dir: str, seed: int, use_pallas_reg: bool = False,
              reps: int = TRAIN_REPS, profiled: int = PROFILED) -> dict:
    """One run of the train phase (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats(device)
    cfg = FlowModelConfig(compute_dtype=precision, loss_dtype=precision,
                          use_pallas_reg=use_pallas_reg)
    model = FlowModel(cfg, device=device, scheme="pwc",
                      generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer(model, 1e-4)
    weights = loss_weights_from_config(types.SimpleNamespace())  # config/kitti.yaml's
    batch = torch.from_numpy(SyntheticSnippets(IMG_HW, MAX_BATCH, seed=seed).snippets).to(device)
    for _ in range(3):
        train_step(model, opt, batch, weights, cfg)
    torch.cuda.synchronize()
    before = _launch_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    events[0].record()
    for i in range(reps):
        train_step(model, opt, batch, weights, cfg)
        events[i + 1].record()
    torch.cuda.synchronize()
    launches = {k: (v - before[k]) / reps for k, v in _launch_counts().items()}
    times = [events[i].elapsed_time(events[i + 1]) for i in range(reps)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            train_step(model, opt, batch, weights, cfg)
        torch.cuda.synchronize()
    ms_step = statistics.median(times)
    busy = _busy_us(prof.events()) / 1e3 / profiled
    h, w = IMG_HW
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=50)
    tag = "_reg" if use_pallas_reg else ""
    with open(os.path.join(out_dir, f"train_{precision}{tag}.txt"), "w") as f:
        f.write(f"{profiled} train steps, {precision}, use_pallas_reg={use_pallas_reg}, "
                f"{MAX_BATCH}x{h}x{w}, 3 scales\n{table}\n")
    return {
        "phase": "train", "precision": precision, "use_pallas_reg": use_pallas_reg,
        "ms_step": ms_step,
        "ms_step_min": min(times), "ms_step_max": max(times), "reps": reps,
        "snippets_per_s": MAX_BATCH / ms_step * 1e3, "busy_ms_step": busy,
        "idle_share": 1.0 - busy / ms_step, "profiled_steps": profiled,
        "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 2**30,
        "launches_per_step": launches,
        "device_ops_per_step": device_ops_per_step(prof.key_averages(), profiled),
        "device_ms_by_kind": device_time_by_kind(prof.key_averages(), profiled),
        "top_ops": top_device_ops(prof.key_averages(), profiled),
    }


def spatial_run(model: FlowModel, n_spatial: int, out_dir: str, seed: int) -> dict:
    """One run of the spatial phase; ``n_spatial`` 0 is the unsharded path."""
    from torch.profiler import ProfilerActivity, profile

    from unopticalflow_tpu_torch.parallel import make_spatial_infer, spatial_mesh

    reps, profiled = REPS, PROFILED
    device = next(model.parameters()).device
    h, w = IMG_HW
    pairs = np.stack(_pairs(IMG_HW, MAX_BATCH, seed))
    i1 = torch.from_numpy(pairs[:, :h].copy()).to(device)
    i2 = torch.from_numpy(pairs[:, h:].copy()).to(device)
    fn = (make_spatial_infer(model, spatial_mesh(n_spatial, devices=[device] * n_spatial))
          if n_spatial else lambda a, b: inference_flow(model, a, b))
    with torch.inference_mode():
        for _ in range(3):
            fn(i1, i2)
        torch.cuda.synchronize()
        before = _launch_counts()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        events[0].record()
        for i in range(reps):
            fn(i1, i2)
            events[i + 1].record()
        torch.cuda.synchronize()
        launches = {k: (v - before[k]) / reps for k, v in _launch_counts().items() if v > before[k]}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(profiled):
                fn(i1, i2)
            torch.cuda.synchronize()
    times = [events[i].elapsed_time(events[i + 1]) for i in range(reps)]
    ms_batch = statistics.median(times)
    busy = _busy_us(prof.events()) / 1e3 / profiled
    precision = str(model.fpyramid.conv1[0].compute_dtype).replace("torch.", "")
    with open(os.path.join(out_dir, f"spatial_{precision}_n{n_spatial}.txt"), "w") as f:
        f.write(f"{profiled} batches, {precision}, n_spatial={n_spatial}, {MAX_BATCH}x{h}x{w}\n"
                + prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    return {
        "phase": "spatial", "precision": precision, "n_spatial": n_spatial,
        "ms_batch": ms_batch, "ms_batch_min": min(times), "ms_batch_max": max(times),
        "reps": reps, "busy_ms_batch": busy, "idle_share": 1.0 - busy / ms_batch,
        "launches_per_batch": launches,
        "device_ops_per_batch": device_ops_per_step(prof.key_averages(), profiled),
        "device_ms_by_kind": device_time_by_kind(prof.key_averages(), profiled),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="measure the port's serving and training slices")
    p.add_argument("--out", default="build/probe")
    p.add_argument("--requests", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--serve_one", choices=WARM_UPS, default=None,
                   help="run one serve measurement in this process and exit")
    p.add_argument("--phases", default="profile,serve,train",
                   help="comma-separated subset of profile,serve,train,spatial")
    args = p.parse_args(argv)
    phases = set(args.phases.split(","))

    device = resolve_device("cuda")
    if args.serve_one:
        print(json.dumps(serve_run(_model(device, args.seed), IMG_HW, args.serve_one,
                                   args.requests, CLIENTS, seed=args.seed)))
        return 0

    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    if "profile" in phases:
        model = _model(device, args.seed)
        print(json.dumps(profile_run(model, REPS, PROFILED, args.out, args.seed)))
        del model
        torch.cuda.empty_cache()
    if "train" in phases:
        # float32 is true float32, as the trainer sets it (bfloat16 never uses TF32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        for precision in ("float32", "bfloat16"):
            for reg in (False, True, True, False):
                print(json.dumps(train_run(device, precision, args.out, args.seed, reg)),
                      flush=True)
                torch.cuda.empty_cache()
    if "spatial" in phases:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        for precision in ("float32", "bfloat16"):
            model = FlowModel(FlowModelConfig(compute_dtype=precision), device=device,
                              scheme="pwc", generator=torch.Generator().manual_seed(args.seed))
            for n in (0, 1, 2, 4, 4, 2, 1, 0):
                print(json.dumps(spatial_run(model, n, args.out, args.seed)), flush=True)
            del model
            torch.cuda.empty_cache()
    for warm_up in ("serving", "constructor", "constructor", "serving") if "serve" in phases else ():
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
