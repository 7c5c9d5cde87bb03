"""Measure the port's serving and training slices on one CUDA device.

    python -m unopticalflow_tpu_torch.probe [--out build/probe] \
        [--requests 512] [--seed 0] \
        [--phases profile,serve,train,trace,spatial,spatial_gap]

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
4. ``trace`` (the JAX ``benchmarks/trace_step.py``, folded in here): the
   KITTI-recipe step at K = 8 steps a dispatch, one CUDA graph of the 8
   whole steps (``make_multi_train_step``), in float32 (TF32 off) and in
   bfloat16, ``use_pallas_reg`` off, on 8 device-resident uint8 batches.
   * ``ms_step``: the median CUDA-event interval of ``TRACE_TIMED``
     replays over 8, with no profiler running;
   * over ``TRACE_PROFILED`` profiled replays: ``device_ms_by_kind`` per
     step by ``TRACE_KINDS`` (``KINDS`` with transposes and layout
     conversions, and copies and sets, as kinds of their own), the top
     device ops, ``device_ops_per_step``, ``busy_ms_step`` and the
     ``idle_share`` against the unprofiled ``ms_step``;
   * ``launches_per_step``: the hand-written kernels' launches of the
     eager first dispatch and of the capture, over 8 (replays launch
     none through the wrappers);
   * ``peak_allocated_gib`` and ``reserved_gib``: the peak of allocated
     memory and the growth of reserved memory (the graph's private pool
     included) over the run's start, after the capture.
   The table goes to ``<out>/trace_<dtype>.txt``.
5. ``spatial``: one full batch of ``inference_flow`` (``n_spatial`` 0) against
   ``make_spatial_infer`` with 1, 2 and 4 row-shards, all on this card, in
   float32 (TF32 off) and bfloat16, in the order 0, 1, 2, 4, 4, 2, 1, 0 per
   dtype: ``ms_batch`` (CUDA events, median of ``REPS``, no profiler),
   ``busy_ms_batch``, ``idle_share``, ``device_ops_per_batch`` and
   ``device_ms_by_kind`` over 5 profiled batches, and the hand-written
   kernels' launches per batch (tables in ``<out>/spatial_<dtype>_n<n>.txt``).
6. ``spatial_gap``: where the sharded bfloat16 flow departs from the
   unsharded one.  The same random "pwc" weights in float32 (TF32 off) and
   bfloat16, the same images; every operation of the encoder and decoder
   (convolutions, cost volumes, warps, upsamplings, additions) recorded on
   the unsharded path and on ``make_spatial_infer``'s row-shards (joined),
   at n = 2, batch 8, 256x832.  Per operation, max |sharded - unsharded| /
   max |unsharded| in each dtype; the first operations whose bfloat16 gap
   exceeds the float32 one.  Then the final flow's gaps at n = 2 and 4
   (256x832) and n = 8 (512x832), each beside the unsharded path's own
   bfloat16-versus-float32 gap, all relative to max |flow|.
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

from unopticalflow_tpu_torch.benchmarks import launch_counts
from unopticalflow_tpu_torch.data.synthetic import SyntheticSnippets
from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, inference_flow
from unopticalflow_tpu_torch.serve import FlowServer
from unopticalflow_tpu_torch.training import loss_weights_from_config, make_optimizer, train_step
from unopticalflow_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG_HW = (256, 832)  # config/kitti.yaml
MAX_BATCH = 8  # serve.py --max_batch default
# spatial_gap's final-flow cases: (row-shards, image size)
GAP_CASES = ((2, IMG_HW), (4, IMG_HW), (8, (512, 832)))
WARM_UPS = ("serving", "constructor")
CLIENTS = 8  # closed-loop client threads: one full batch in flight
REPS = 30  # timed batches per measurement of the profile phase
PROFILED = 5  # batches (or steps) under torch.profiler
TRAIN_REPS = 20  # timed steps per dtype of the train phase
TOP_OPS = 12
TRACE_K = 8  # the trace phase's steps a dispatch
TRACE_TIMED = 5  # replays timed without the profiler
TRACE_PROFILED = 2  # replays under torch.profiler


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


# the trace phase's kinds: KINDS with layout conversions split out of the
# convolutions and copies and sets out of the elementwise work (first match wins)
TRACE_KINDS = (
    KINDS[0],
    ("transposes/layout", ("nchwToNhwc", "nhwcToNchw", "transpose", "Transpose", "permute")),
    ("convolution (cuDNN/cuBLAS)", ("cudnn", "xmma", "fft", "winograd", "dgrad", "wgrad",
                                    "gemm", "DSE::", "region_transform", "scalePackedTensor",
                                    "pointwise_mult_and_sum_complex")),
    KINDS[2],
    KINDS[3],
    ("copies and sets", ("Memcpy", "Memset", "copy", "fill", "Fill", "CatArray")),
    ("elementwise/reduction", ("elementwise", "reduce", "Reduce", "pool", "upsample",
                               "softmax")),
)


def device_ops_per_step(averages, steps: int) -> float:
    """Kernels, copies and sets the device ran per step (``prof.key_averages()``)."""
    return sum(e.count for e in averages if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in _NOT_DEVICE_WORK) / steps


def device_time_by_kind(averages, steps: int, kinds=KINDS) -> dict:
    """Device kernel time per step (ms), summed by ``kinds``; the rest is "other"."""
    out = {name: 0.0 for name, _ in kinds}
    out["other"] = 0.0
    for e in averages:
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key in _NOT_DEVICE_WORK:
            continue
        kind = next((name for name, pats in kinds if any(p in e.key for p in pats)), "other")
        out[kind] += e.self_device_time_total / 1e3 / steps
    return out


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
    before = launch_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    events[0].record()
    for i in range(reps):
        train_step(model, opt, batch, weights, cfg)
        events[i + 1].record()
    torch.cuda.synchronize()
    launches = {k: (v - before[k]) / reps for k, v in launch_counts().items()}
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


def trace_run(device, precision: str, out_dir: str, seed: int, k: int = TRACE_K,
              timed: int = TRACE_TIMED, profiled: int = TRACE_PROFILED) -> dict:
    """One run of the trace phase (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from unopticalflow_tpu_torch.training import make_multi_train_step, set_capturable

    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base_alloc = torch.cuda.memory_allocated(device)
    base_reserved = torch.cuda.memory_reserved(device)
    cfg = FlowModelConfig(compute_dtype=precision, loss_dtype=precision)
    model = FlowModel(cfg, device=device, scheme="pwc",
                      generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer(model, 1e-4)
    set_capturable(opt)
    weights = loss_weights_from_config(types.SimpleNamespace())  # config/kitti.yaml's
    multi = make_multi_train_step(model, opt, cfg, weights, k)
    h, w = IMG_HW
    snippets = SyntheticSnippets(IMG_HW, k * MAX_BATCH, seed=seed).snippets
    xs = torch.from_numpy(np.stack([snippets[i % len(snippets)] for i in range(k * MAX_BATCH)])
                          ).to(device).reshape(k, MAX_BATCH, 3 * h, w, 3)
    before = launch_counts()
    multi(xs)  # the eager dispatch
    multi(xs)  # the capture and its replay
    torch.cuda.synchronize()
    launches = {n: (v - before[n]) / (2 * k) for n, v in launch_counts().items()}
    peak_gib = (torch.cuda.max_memory_allocated(device) - base_alloc) / 2**30
    reserved_gib = (torch.cuda.memory_reserved(device) - base_reserved) / 2**30
    events = [torch.cuda.Event(enable_timing=True) for _ in range(timed + 1)]
    events[0].record()
    for i in range(timed):
        multi(xs)
        events[i + 1].record()
    torch.cuda.synchronize()
    ms_step = statistics.median(events[i].elapsed_time(events[i + 1])
                                for i in range(timed)) / k
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            m = multi(xs)
        torch.cuda.synchronize()
    if not bool(torch.isfinite(m["loss_total"]).all()):
        raise RuntimeError(f"trace {precision}: a replay's losses are not finite")
    steps = profiled * k
    busy = _busy_us(prof.events()) / 1e3 / steps
    averages = prof.key_averages()
    with open(os.path.join(out_dir, f"trace_{precision}.txt"), "w") as f:
        f.write(f"{profiled} replays of a CUDA graph of {k} train steps, {precision}, "
                f"{MAX_BATCH}x{h}x{w}, 3 scales\n"
                + averages.table(sort_by="self_device_time_total", row_limit=60) + "\n")
    return {
        "phase": "trace", "precision": precision, "steps_per_dispatch": k,
        "ms_step": ms_step, "snippets_per_s": MAX_BATCH / ms_step * 1e3,
        "busy_ms_step": busy, "idle_share": 1.0 - busy / ms_step, "profiled_steps": steps,
        "launches_per_step": launches, "peak_allocated_gib": peak_gib,
        "reserved_gib": reserved_gib,
        "device_ops_per_step": device_ops_per_step(averages, steps),
        "device_ms_by_kind": device_time_by_kind(averages, steps, TRACE_KINDS),
        "top_ops": top_device_ops(averages, steps),
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
        before = launch_counts()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        events[0].record()
        for i in range(reps):
            fn(i1, i2)
            events[i + 1].record()
        torch.cuda.synchronize()
        launches = {k: (v - before[k]) / reps for k, v in launch_counts().items() if v > before[k]}
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


class _TracedOps:
    """An ops object (``DenseOps`` or the row-shard ops) that records each
    operation's output as one float32 map (row-shards joined)."""

    def __init__(self, base, join):
        self.base, self.join, self.rec = base, join, []

    def _keep(self, kind, out):
        self.rec.append((kind, self.join(out).float()))
        return out

    def conv(self, layer, x):
        return self._keep("conv", self.base.conv(layer, x))

    def cat(self, parts):
        return self.base.cat(parts)  # a copy: exact on both paths

    def add(self, a, b):
        return self._keep("add", self.base.add(a, b))

    def corr(self, f1, f2):
        return self._keep("corr", self.base.corr(f1, f2))

    def up(self, flow):
        return self._keep("up", self.base.up(flow))

    def warp(self, f2, flow):
        return self._keep("warp", self.base.warp(f2, flow))


def _trace(model, i1, i2, n_spatial: int) -> list:
    """(kind, float32 map) of every encoder and decoder operation of one batch."""
    from unopticalflow_tpu_torch.models.pwc_decoder import DenseOps
    from unopticalflow_tpu_torch.parallel.spatial import _ShardOps, shard_images, spatial_mesh

    b = i1.shape[0]
    if n_spatial == 0:
        ops = _TracedOps(DenseOps(), lambda x: x)
        imgs = torch.cat([i1, i2], 0).permute(0, 3, 1, 2).contiguous()
    else:
        device = i1.device
        ops = _TracedOps(_ShardOps(), lambda xs: torch.cat(xs, 2))
        g1, g2 = shard_images(spatial_mesh(n_spatial, devices=[device] * n_spatial), None,
                              i1, i2)
        imgs = [torch.cat([a, c], 0).permute(0, 3, 1, 2).contiguous()
                for a, c in zip(g1[0], g2[0])]
    with torch.inference_mode():
        feats = model.fpyramid(imgs, conv=ops.conv)
        if n_spatial == 0:
            f1, f2 = [f[:b] for f in feats], [f[b:] for f in feats]
        else:
            f1 = [[x[:b] for x in f] for f in feats]
            f2 = [[x[b:] for x in f] for f in feats]
        model.pwc_model.decode(f1, f2, ops)
    return ops.rec


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def spatial_gap_run(device, seed: int) -> list[dict]:
    """The spatial_gap phase: one JSON record per measurement."""
    from unopticalflow_tpu_torch.parallel import gather_rows, make_spatial_infer, spatial_mesh

    models = {}
    for precision in ("float32", "bfloat16"):
        models[precision] = FlowModel(FlowModelConfig(compute_dtype=precision), device=device)
    models["bfloat16"].load_state_dict(_model(device, seed).state_dict())
    models["float32"].load_state_dict(models["bfloat16"].state_dict())
    h, w = IMG_HW
    pairs = np.stack(_pairs(IMG_HW, MAX_BATCH, seed))
    i1 = torch.from_numpy(pairs[:, :h].copy()).to(device)
    i2 = torch.from_numpy(pairs[:, h:].copy()).to(device)
    gaps = {}
    for precision, model in models.items():
        dense, shard = _trace(model, i1, i2, 0), _trace(model, i1, i2, 2)
        if [k for k, _ in dense] != [k for k, _ in shard]:
            raise RuntimeError("the sharded and unsharded paths ran different operations")
        gaps[precision] = [(k, tuple(d.shape), _gap(s, d)) for (k, d), (_, s) in zip(dense, shard)]
        del dense, shard
        torch.cuda.empty_cache()
    ops = [{"op": i, "kind": k, "shape": list(shape), "gap_bfloat16": g16,
            "gap_float32": gaps["float32"][i][2]}
           for i, (k, shape, g16) in enumerate(gaps["bfloat16"])]
    first = [o for o in ops if o["gap_bfloat16"] > o["gap_float32"]][:5]
    out = [{"phase": "spatial_gap", "n_spatial": 2, "batch": MAX_BATCH, "img_hw": list(IMG_HW),
            "ops": len(ops), "first_departing_ops": first,
            "largest_bfloat16_gaps": sorted(ops, key=lambda o: -o["gap_bfloat16"])[:5],
            "ops_equal_in_bfloat16": sum(o["gap_bfloat16"] == 0 for o in ops),
            "ops_equal_in_float32": sum(o["gap_float32"] == 0 for o in ops)}]
    for n, hw in GAP_CASES:
        rng = np.random.RandomState(seed + n)
        a, b = (torch.from_numpy(rng.rand(MAX_BATCH, *hw, 3).astype(np.float32)).to(device)
                for _ in range(2))
        with torch.inference_mode():
            flows = {p: inference_flow(m, a, b) for p, m in models.items()}
            sharded = {p: gather_rows(make_spatial_infer(
                m, spatial_mesh(n, devices=[device] * n))(a, b), device)
                for p, m in models.items()}
        peak = float(flows["float32"].abs().max())
        rec = {"phase": "spatial_gap", "n_spatial": n, "batch": MAX_BATCH, "img_hw": list(hw),
               "max_abs_flow": peak}
        for p in models:
            rec[f"sharded_vs_unsharded_{p}"] = float((sharded[p] - flows[p]).abs().max()) / peak
        rec["unsharded_bfloat16_vs_float32"] = float(
            (flows["bfloat16"] - flows["float32"]).abs().max()) / peak
        rec["sharded_bfloat16_vs_unsharded_float32"] = float(
            (sharded["bfloat16"] - flows["float32"]).abs().max()) / peak
        out.append(rec)
        del flows, sharded
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="measure the port's serving and training slices")
    p.add_argument("--out", default="build/probe")
    p.add_argument("--requests", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--serve_one", choices=WARM_UPS, default=None,
                   help="run one serve measurement in this process and exit")
    p.add_argument("--phases", default="profile,serve,train",
                   help="comma-separated subset of "
                        "profile,serve,train,trace,spatial,spatial_gap")
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
    if "trace" in phases:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        for precision in ("float32", "bfloat16"):
            print(json.dumps(trace_run(device, precision, args.out, args.seed)), flush=True)
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
    if "spatial_gap" in phases:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        for rec in spatial_gap_run(device, args.seed):
            print(json.dumps(rec), flush=True)
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
