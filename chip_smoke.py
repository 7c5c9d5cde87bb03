#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the run exits non-zero):

1. Setup: require CUDA, print the card (nvidia-smi name and power limit),
   torch and CUDA versions, build the correlation kernel from
   ``unopticalflow_tpu_torch/csrc/correlation.cu`` and print the build time.
   TF32 is switched off for cuDNN and matmul, so float32 comparisons are
   float32.
2. Kernel vs plain: the CUDA correlation against ``cost_volume_reference``
   at the five decoder-level shapes of the KITTI serving recipe (batch 8,
   256x832) and one ragged shape, in float32 (rtol 1e-5 / atol 1e-6) and
   bfloat16 (2e-2), the JAX package's tolerances
   (benchmarks/PALLAS_VALIDATE.json); times by CUDA events (median).
3. The slice: a full-width FlowModel (random "pwc" weights from a seed,
   bfloat16 as serve's default) behind the port's FlowServer at 256x832,
   max_batch 8; 24 requests from 8 client threads.  Every flow must be
   finite (256, 832, 2) float32, the kernel must launch 5 times per served
   batch, and one batch must agree with the same model using the plain
   correlation (bf16 within 2e-2 of max|flow|; f32 within 1e-4*(1+max|flow|)).

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Only the CUDA path is driven: with no
GPU the script exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
import types

SEED = 0
# config/kitti.yaml: img_hw [256, 832]; serve.py: --max_batch 8,
# --precision bfloat16 (defaults)
IMG_HW = (256, 832)
MAX_BATCH = 8
N_REQUESTS = 24
N_CLIENTS = 8
# (B, C, H, W) of the decoder's five cost volumes at 256x832, batch 8, + a ragged one
LEVEL_SHAPES = {
    "L6": (8, 196, 4, 13),
    "L5": (8, 128, 8, 26),
    "L4": (8, 96, 16, 52),
    "L3": (8, 64, 32, 104),
    "L2": (8, 32, 64, 208),
    "ragged": (2, 5, 7, 33),
}
KERNEL_SOURCE = "unopticalflow_tpu_torch/csrc/correlation.cu"
KERNEL_REPLACES = "unopticalflow_tpu/ops/pallas_kernels.py:59"


def _time_ms(torch, fn, reps: int = 15, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs a GPU",
              file=sys.stderr)
        return 1

    import numpy as np

    from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, inference_flow
    from unopticalflow_tpu_torch.ops import correlation_cuda
    from unopticalflow_tpu_torch.ops.cost_volume import cost_volume_reference
    from unopticalflow_tpu_torch.serve import FlowServer
    from unopticalflow_tpu_torch.utils.device import resolve_device

    # ---- 1. setup -------------------------------------------------------
    device = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("tf32: cudnn.allow_tf32=False cuda.matmul.allow_tf32=False")
    t0 = time.perf_counter()
    lib_path = correlation_cuda.build()
    print(f"build: {lib_path} in {time.perf_counter() - t0:.2f} s")

    # ---- 2. kernel vs plain on the card ---------------------------------
    gen = torch.Generator(device=device).manual_seed(SEED)
    max_err = 0.0
    kernel_ms = plain_ms = 0.0
    for name, shape in LEVEL_SHAPES.items():
        for dtype, rtol, atol in ((torch.float32, 1e-5, 1e-6), (torch.bfloat16, 2e-2, 2e-2)):
            f1 = torch.randn(shape, generator=gen, device=device).to(dtype)
            f2 = torch.randn(shape, generator=gen, device=device).to(dtype)
            got = correlation_cuda.correlation(f1, f2, 4)
            torch.cuda.synchronize()
            want = cost_volume_reference(f1, f2, 4)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != (shape[0], 81) + shape[2:]:
                raise AssertionError(f"{name}: kernel gave {got.dtype} {tuple(got.shape)}")
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
            err = float((got.float() - want.float()).abs().max())
            max_err = max(max_err, err)
            k_ms = _time_ms(torch, lambda: correlation_cuda.correlation(f1, f2, 4))
            p_ms = _time_ms(torch, lambda: cost_volume_reference(f1, f2, 4), inner=2)
            if dtype == torch.bfloat16 and name != "ragged":
                kernel_ms += k_ms
                plain_ms += p_ms
            print(f"corr {name} {shape} {str(dtype)[6:]}: max_abs_err={err:.3e} "
                  f"(rtol {rtol}, atol {atol}) kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                  f"speedup={p_ms / k_ms:.1f}x")
    print(f"corr per batch (5 levels, bfloat16): kernel_ms={kernel_ms:.4f} "
          f"plain_ms={plain_ms:.4f}")

    # ---- 3. the slice: FlowServer at the KITTI serving shape ------------
    h, w = IMG_HW
    cfg = FlowModelConfig(compute_dtype="bfloat16")
    model = FlowModel(cfg, device=device, scheme="pwc",
                      generator=torch.Generator().manual_seed(SEED))
    rng = np.random.RandomState(SEED)
    pairs = [rng.rand(2 * h, w, 3).astype(np.float32) for _ in range(N_REQUESTS)]
    server = FlowServer(types.SimpleNamespace(img_hw=IMG_HW), model,
                        max_batch=MAX_BATCH, max_wait_ms=5.0)
    try:
        flows = [None] * N_REQUESTS

        def client(k):
            for i in range(k, N_REQUESTS, N_CLIENTS):
                flows[i] = server.infer(pairs[i], timeout=300.0)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(N_CLIENTS)]
        correlation_cuda.launches = 0
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = correlation_cuda.launches
        if any(t.is_alive() for t in threads):
            raise AssertionError("client threads did not finish")
        stats = json.loads(json.dumps(server.stats))
    finally:
        server.close()
    for i, f in enumerate(flows):
        if f is None or f.shape != (h, w, 2) or f.dtype != np.float32 or not np.isfinite(f).all():
            raise AssertionError(f"request {i}: bad flow {None if f is None else (f.shape, f.dtype)}")
    if stats["served"] != N_REQUESTS or stats["errors"] or stats["shed"]:
        raise AssertionError(f"server stats {stats}")
    if launches != 5 * stats["batches"]:
        raise AssertionError(f"{launches} kernel launches for {stats['batches']} batches")
    print(f"served {stats['served']} requests in {stats['batches']} batches, "
          f"occupancy {stats['occupancy']}, kernel launches {launches} "
          f"(5 per batch), wall {wall:.3f} s, served pairs/s {N_REQUESTS / wall:.2f}")

    # one full batch through inference_flow directly: timing and parity
    i1 = torch.from_numpy(np.stack([p[:h] for p in pairs[:MAX_BATCH]])).to(device)
    i2 = torch.from_numpy(np.stack([p[h:] for p in pairs[:MAX_BATCH]])).to(device)
    with torch.inference_mode():
        ms_batch = _time_ms(torch, lambda: inference_flow(model, i1, i2), reps=10, inner=1)
        print(f"slice bfloat16 {MAX_BATCH}x{h}x{w}: {ms_batch:.3f} ms/batch, "
              f"{MAX_BATCH / ms_batch * 1e3:.2f} pairs/s (device path, CUDA events)")
        flow_k = inference_flow(model, i1, i2)
        flow_p = inference_flow(model, i1, i2, corr_fn=cost_volume_reference)
        served = torch.from_numpy(np.stack(flows[:MAX_BATCH])).to(device)
        peak = float(flow_p.abs().max())
        err = float((flow_k - flow_p).abs().max())
        err_served = float((served - flow_k).abs().max())
        print(f"slice parity bfloat16 kernel vs plain corr: max_abs_err={err:.4e} "
              f"max|flow|={peak:.4f} tol={2e-2 * peak:.4e}; served vs direct {err_served:.4e}")
        if not (err <= 2e-2 * peak and err_served <= 2e-2 * peak):
            raise AssertionError("bfloat16 slice parity failed")
        model32 = FlowModel(cfg._replace(compute_dtype="float32"), device=device)
        model32.load_state_dict(model.state_dict())
        flow_k = inference_flow(model32, i1, i2)
        flow_p = inference_flow(model32, i1, i2, corr_fn=cost_volume_reference)
        peak = float(flow_p.abs().max())
        err = float((flow_k - flow_p).abs().max())
        print(f"slice parity float32 (TF32 off) kernel vs plain corr: max_abs_err={err:.4e} "
              f"max|flow|={peak:.4f} tol={1e-4 * (1 + peak):.4e}")
        if not err <= 1e-4 * (1 + peak):
            raise AssertionError("float32 slice parity failed")
    torch.cuda.synchronize()

    print(json.dumps({"kernels": [{
        "name": "corr_fwd",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
