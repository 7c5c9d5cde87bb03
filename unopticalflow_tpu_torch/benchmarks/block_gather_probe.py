"""Time a gather inside one block's shared memory on the card.

The port's counterpart of ``benchmarks/pallas_gather_probe.py``, which timed
Mosaic's in-kernel vector gather on the TPU (``lane_kernel``,
``sublane_kernel``): on this card the same functions gather from a block's
shared memory (``csrc/gather.cu``, through ``ops/gather.py``).

  lane       out[s,l] = sum_{k<64} x[s, (idx[s,l]+k) % 128]   (gather along a row)
  sublane    out[s,l] = sum_{k<64} x[(idx[s,l]+k) % 8, l]     (gather down a column)

The same three runs: ``lane_f32`` and ``lane_bf16`` on (4096, 128),
``sublane_f32`` on (8, 8192), each summing ``REPS`` = 64 gathers in x's dtype.

    python -m unopticalflow_tpu_torch.benchmarks.block_gather_probe \
        [--device cuda] [--iters 20] [--warmup 5]

Each time is the median of ``--iters`` calls after ``--warmup``: CUDA events
on the card, the host clock on the CPU (where the plain versions run).  It
prints the JAX probe's lines (ms, ns per gathered element, ns per 128-element
row), then one JSON line with every run and the device.  A kernel's failure
raises.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from unopticalflow_tpu_torch.benchmarks import device_name, time_ms
from unopticalflow_tpu_torch.ops.gather import REPS, lane_gather, sublane_gather
from unopticalflow_tpu_torch.utils.device import resolve_device

R = 4096  # rows per call


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="time gathers inside one block's shared memory")
    p.add_argument("--device", default="cuda")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--warmup", type=int, default=5)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.RandomState(0)

    def put(a):
        return torch.from_numpy(a).to(device)

    x = put(rng.rand(R, 128).astype(np.float32))
    idx_l = put(rng.randint(0, 128, (R, 128)).astype(np.int32))
    x8 = put(rng.rand(8, 128 * 64).astype(np.float32))
    idx_s = put(rng.randint(0, 8, (8, 128 * 64)).astype(np.int32))
    runs = {"lane_f32": (lane_gather, x, idx_l),
            "lane_bf16": (lane_gather, x.to(torch.bfloat16), idx_l),
            "sublane_f32": (sublane_gather, x8, idx_s)}

    results = {}
    for name, (fn, xs, idx) in runs.items():
        ms = time_ms(fn, (xs, idx), device, args.iters, args.warmup)
        n_gathers = xs.shape[0] * xs.shape[1] * REPS
        results[name] = {"ms": ms, "shape": list(xs.shape), "ns_per_elem": ms * 1e6 / n_gathers,
                         "ns_per_128_row": ms * 1e6 / (n_gathers / 128)}
        print(f"  {name:12s} {ms:9.4f} ms  {ms * 1e6 / n_gathers:7.3f} ns/elem"
              f"  ({ms * 1e6 / (n_gathers / 128):7.2f} ns per 128-elem row-equiv)")
    print(json.dumps({"probe": "block_gather_probe", "device": device_name(device),
                      "reps": REPS, "iters": args.iters, "warmup": args.warmup,
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
