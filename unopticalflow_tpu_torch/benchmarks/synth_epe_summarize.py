"""Summarise ``synthetic_epe`` training logs into one JSON.

The port's counterpart of ``benchmarks/synth_epe_summarize.py``.  It reads
the stdout logs of ``synthetic_epe`` runs, the port's or the JAX harness's
(the same lines: the zero-flow line, a loss line every 250 iterations, a
JSON line per evaluation point, the final JSON), and writes
``<out-dir>/<name>.json``: each run's evaluation trajectory, final metrics,
last evaluation, mean of its last loss lines and its own
``zero_flow_measured`` (the bar that run must go under: runs at other
motion bounds have other bars), the analytic zero-flow EPEs of its motion
grids, and the ablation deltas when the runs are named for them (``main``
against ``nomask``: the occlusion masks; ``main`` against ``fp32``: bfloat16
against float32).

Left out: the JAX tool's learning-curve PNG, which needs matplotlib, which
the port does not import and the card's machine lacks.

    python -m unopticalflow_tpu_torch.benchmarks.synth_epe_summarize \
        --run main=main.log --run nomask=nomask.log --run fp32=fp32.log \
        [--out-dir build/synth_epe] [--name SYNTH_EPE]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np

_LOSS_RE = re.compile(r"iter (\d+): total ([\d.]+) pixel ([\d.]+) ssim ([\d.]+)")


def parse_log(path: str):
    """(eval_points, loss_points, final) of a ``synthetic_epe`` log; the
    zero-flow line comes back among the eval points as {"zero_flow_line": ...}."""
    evals, losses, final = [], [], None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{"):
                d = json.loads(line)
                if "iter" in d:
                    evals.append(d)
                elif "benchmark" in d:
                    final = d
                elif "zero_flow" in d and len(d) == 1:
                    evals.append({"zero_flow_line": d["zero_flow"]})
            else:
                m = _LOSS_RE.match(line)
                if m:
                    losses.append({"iter": int(m.group(1)), "total": float(m.group(2)),
                                   "pixel": float(m.group(3)), "ssim": float(m.group(4))})
    return evals, losses, final


def zero_flow_epe(m: int) -> float:
    """E|(u, v)| over the integer motion grid [-m, m]^2: the EPE of a constant
    zero prediction.  A run has learned when it goes under it; part of an
    early drop of epe_all is only unlearning the init's constant bias."""
    u, v = np.mgrid[-m:m + 1, -m:m + 1]
    return round(float(np.hypot(u, v).mean()), 3)


def summarize(run_specs, name: str) -> dict:
    """The summary of ``run_specs`` ([(run name, log path)])."""
    runs = {}
    for run, path in run_specs:
        evals, losses, final = parse_log(path)
        zf = next((d["zero_flow_line"] for d in evals if "zero_flow_line" in d), None)
        evals = [d for d in evals if "zero_flow_line" not in d]
        runs[run] = {
            "zero_flow_measured": zf or (final or {}).get("zero_flow"),
            "log": os.path.relpath(path),
            "eval_points": evals,
            "final": final,
            "last_eval": evals[-1] if evals else None,
            "mean_loss_last_1k": (
                round(sum(d["total"] for d in losses[-4:]) / max(len(losses[-4:]), 1), 4)
                if losses else None),
        }
    summary = {"benchmark": f"synthetic occlusion-aware EPE campaign ({name})", "runs": runs}
    for r in runs.values():
        fin = r.get("final")
        if fin and "max_bg" in fin:
            r["zero_flow_epe_bg"] = zero_flow_epe(fin["max_bg"])
            r["zero_flow_epe_fg"] = zero_flow_epe(fin["max_fg"])

    def last_point(run):
        """A run's last eval point, else its final metrics (a run without
        --eval-every has only the final JSON)."""
        r = runs.get(run, {})
        if r.get("last_eval"):
            return r["last_eval"]
        fin = r.get("final")
        return {"iter": fin["iters"], **fin} if fin else None

    def at(run, key):
        return (last_point(run) or {}).get(key)

    def main_at_iter(it):
        return next((d for d in runs["main"]["eval_points"] if d["iter"] == it),
                    last_point("main"))

    if "main" in runs and "nomask" in runs:
        # the endpoints at the last common eval iteration, and the shared
        # trajectory: the masks act during training
        it = last_point("nomask")["iter"]
        main_at = main_at_iter(it)
        summary["ablation_occlusion_masks"] = {
            "compared_at_iter": it,
            "epe_all_with_masks": main_at["epe_all"],
            "epe_all_without_masks": at("nomask", "epe_all"),
            "epe_occluded_with_masks": main_at["epe_occluded"],
            "epe_occluded_without_masks": at("nomask", "epe_occluded"),
            "epe_all_trajectory": [
                {"iter": d["iter"], "with_masks": main_at_iter(d["iter"])["epe_all"],
                 "without_masks": d["epe_all"]}
                for d in runs["nomask"]["eval_points"]
            ],
        }
    if "main" in runs and "fp32" in runs:
        # at the float32 run's final point: mid-run points can predate a late
        # escape from a basin
        fin = runs["fp32"].get("final") or last_point("fp32")
        it = fin.get("iters", fin.get("iter"))
        main_at = main_at_iter(it)
        summary["bf16_vs_f32"] = {
            "compared_at_iter": it,
            "epe_all_bf16": main_at["epe_all"],
            "epe_all_f32": fin["epe_all"],
            "outlier_bf16": main_at["outlier_rate_kitti"],
            "outlier_f32": fin["outlier_rate_kitti"],
        }
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="summarise synthetic_epe logs")
    p.add_argument("--run", action="append", required=True, help="name=logpath (repeatable)")
    p.add_argument("--out-dir", default=os.path.join("build", "synth_epe"))
    p.add_argument("--name", default="SYNTH_EPE", help="the output JSON's basename")
    args = p.parse_args(argv)
    specs = [tuple(spec.split("=", 1)) for spec in args.run]
    summary = summarize(specs, args.name)
    os.makedirs(args.out_dir, exist_ok=True)
    out_json = os.path.join(args.out_dir, args.name + ".json")
    with open(out_json, "w") as f:
        json.dump(summary, f, indent=1)
    print("wrote", out_json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
