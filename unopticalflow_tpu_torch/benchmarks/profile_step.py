"""Train-step timing in interleaved trials, with a hard sync every dispatch.

The port's counterpart of ``benchmarks/profile_step.py``: it runs the
KITTI-recipe training step under each setup several times in an
interleaved order (A B A B ...), so that the machine's own drift shows as
spread across trials instead of biasing one setup.  The JAX tool's A/B axis
is its XLA against its Pallas correlation; the port has no plain
correlation on a CUDA tensor, so its axis is the switch it does have,
``FlowModelConfig.use_pallas_reg`` off and on (the plain smoothness and
consistency terms against the fused regularizer kernels).  The pair runs
at K = 1 (eager ``train_step``) and at K = 8 (``make_multi_train_step``, on
the card one CUDA graph of the 8 steps), per dtype: one pair at a time,
freed before the next (a float32 graph of 8 steps holds its private memory
pool, tens of GiB, for as long as it lives).

A trial times ``--iters`` dispatches, each followed by reading its loss (a
hard sync): ms/step = the trial's host time / (iters x K).  It prints each
trial's ms/step and snippets/s, then per setup the median, the spread over
trials ((max - min) / median) and the training kernels' launches per step
(from the setup's first, eager dispatch), and one JSON line of it all.

    python -m unopticalflow_tpu_torch.benchmarks.profile_step [--batch 8] \
        [--hw 256 832] [--iters 5] [--trials 3] [--fp32 | --precisions float32 bfloat16] \
        [--steps-per-dispatch 1 8] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from unopticalflow_tpu_torch.benchmarks import (
    device_name,
    last_loss,
    launch_counts,
    launches_since,
    recipe_step,
)
from unopticalflow_tpu_torch.models import FlowModelConfig
from unopticalflow_tpu_torch.utils.device import resolve_device, set_float32_precision


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="interleaved trials of the train step")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--hw", type=int, nargs=2, default=(256, 832))
    p.add_argument("--iters", type=int, default=5, help="timed dispatches a trial")
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--fp32", action="store_true", help="float32 only (default bfloat16)")
    p.add_argument("--precisions", nargs="+", choices=["float32", "bfloat16"], default=None,
                   help="the dtypes to run, one after the other (overrides --fp32)")
    p.add_argument("--steps-per-dispatch", type=int, nargs="+", default=[1, 8],
                   help="K values: 1 is the eager step, K > 1 a CUDA graph of K steps")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (raises without a GPU) or cpu")
    return p


def run(args) -> dict:
    device = resolve_device(args.device)
    precisions = args.precisions or (["float32"] if args.fp32 else ["bfloat16"])
    h, w = args.hw
    imgs = np.random.RandomState(args.seed).rand(args.batch, 3 * h, w, 3).astype(np.float32)
    x = torch.from_numpy(imgs).to(device)
    out = {"benchmark": "interleaved train-step trials", "batch": args.batch,
           "hw": list(args.hw), "iters": args.iters, "trials": args.trials,
           "device": device_name(device), "setups": []}
    for precision, k in ((p, k) for p in precisions for k in args.steps_per_dispatch):
        set_float32_precision(device, precision)
        setups = {}
        xs = x if k == 1 else x[None].expand(k, *x.shape)
        for reg in (False, True):
            cfg = FlowModelConfig(num_scales=3, compute_dtype=precision,
                                  loss_dtype=precision, use_pallas_reg=reg)
            name = f"{precision} K={k} reg-{'on' if reg else 'off'}"
            _, _, step = recipe_step(cfg, device, k, args.seed)
            before = launch_counts()
            t0 = time.perf_counter()
            last_loss(step(xs))  # the eager first dispatch (builds the kernels)
            launches = launches_since(before, k)
            if k > 1:
                last_loss(step(xs))  # on CUDA: the capture and its replay
            print(f"[{name}] first dispatches: {time.perf_counter() - t0:.1f}s", flush=True)
            setups[name] = {"step": step, "xs": xs, "k": k, "launches": launches,
                            "ms": []}
        for trial in range(args.trials):
            for name, su in setups.items():
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    last_loss(su["step"](su["xs"]))  # a hard sync every dispatch
                dt = (time.perf_counter() - t0) / (args.iters * su["k"])
                su["ms"].append(dt * 1e3)
                print(f"trial {trial} {name}: {dt * 1e3:8.2f} ms/step "
                      f"({args.batch / dt:6.1f} snippets/s)", flush=True)
        for name, su in setups.items():
            med = statistics.median(su["ms"])
            rec = {"setup": name, "ms_step": su["ms"], "ms_step_median": med,
                   "snippets_per_s_median": args.batch / med * 1e3,
                   "spread": (max(su["ms"]) - min(su["ms"])) / med,
                   "launches_per_step": su["launches"]}
            out["setups"].append(rec)
            print(f"{name}: median {med:.2f} ms/step, spread {rec['spread']:.1%} over "
                  f"{args.trials} trials, launches a step "
                  f"{ {n: v for n, v in su['launches'].items() if v} }", flush=True)
        del setups
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    print(json.dumps(run(build_arg_parser().parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
