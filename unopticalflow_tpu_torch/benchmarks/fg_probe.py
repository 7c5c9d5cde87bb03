"""What does a trained model predict inside the moving foreground?

The port's counterpart of ``benchmarks/fg_probe.py``.  Trained learning runs
capture the background motion while the foreground's EPE stays near its
own motion; this asks what the model predicts inside the foreground
rectangle, on snippets of the host generator from ``RandomState(4242)``:

  * ``corr_predfg_with_bg_gt``: the correlation of the mean foreground
    prediction with the background's true motion (about 1: the model paints
    the background's field through the rectangle), beside
    ``corr_predfg_with_fg_gt`` (about 1: it tracks the object);
  * the foreground's EPE by bins of |fg - bg| relative motion: does capture
    decay with relative displacement (a correlation-window limit) or is it
    flat (the foreground ignored wholesale)?

The weights are the JAX package's ``.ckpt`` or a ``.pth``
(``utils/checkpoint.py::load_pretrained``), the network in float32.

    python -m unopticalflow_tpu_torch.benchmarks.fg_probe --ckpt last.ckpt \
        [--hw 128 256] [--snippets 48] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from unopticalflow_tpu_torch.benchmarks.synthetic_epe import make_snippet
from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, inference_flow
from unopticalflow_tpu_torch.utils.checkpoint import load_pretrained
from unopticalflow_tpu_torch.utils.device import resolve_device, set_float32_precision

SEED = 4242
BINS = ((0, 6), (6, 12), (12, 18), (18, 40))


def corr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    a = a - a.mean()
    b = b - b.mean()
    d = np.sqrt((a**2).sum() * (b**2).sum())
    return float((a * b).sum() / d) if d else 0.0


def probe(infer, hw, snippets: int, batch: int, gen_kw: dict) -> list[dict]:
    """One row per snippet with a foreground: its motions and the prediction."""
    h, w = hw
    rng = np.random.RandomState(SEED)
    rows = []
    done = 0
    while done < snippets:
        n = min(batch, snippets - done)
        stacked, gts, _ = zip(*[make_snippet(rng, h, w, **gen_kw) for _ in range(n)])
        stacked = np.stack(stacked)
        flow = np.asarray(infer(stacked[:, h:2 * h], stacked[:, 2 * h:]), np.float32)
        for i in range(n):
            gt = gts[i]
            bg_uv = gt[0, 0]
            fg_mask = np.linalg.norm(gt - bg_uv, axis=-1) > 0
            if not fg_mask.any():
                continue
            fg_uv = gt[fg_mask][0]
            pred_fg = flow[i][fg_mask].mean(0)
            err_fg = float(np.linalg.norm(flow[i][fg_mask] - fg_uv[None], axis=-1).mean())
            rows.append({
                "bg_uv": bg_uv.tolist(),
                "fg_uv": fg_uv.tolist(),
                "rel_mag": float(np.linalg.norm(fg_uv - bg_uv)),
                "pred_fg_mean": [round(float(x), 2) for x in pred_fg],
                "epe_fg": round(err_fg, 2),
                "epe_fg_if_painted_bg": round(float(np.linalg.norm(fg_uv - bg_uv)), 2),
                "fg_px": int(fg_mask.sum()),
            })
        done += n
    return rows


def summarize(rows: list[dict], ckpt: str) -> dict:
    """The JAX tool's JSON of ``probe``'s rows."""
    pf = np.array([r["pred_fg_mean"] for r in rows])
    bg = np.array([r["bg_uv"] for r in rows])
    fg = np.array([r["fg_uv"] for r in rows])
    bins = {}
    for lo, hi in BINS:
        sel = [r for r in rows if lo <= r["rel_mag"] < hi]
        if sel:
            bins[f"rel_{lo}-{hi}px"] = {
                "n": len(sel),
                "epe_fg": round(float(np.mean([r["epe_fg"] for r in sel])), 2),
                "epe_if_painted_bg": round(
                    float(np.mean([r["epe_fg_if_painted_bg"] for r in sel])), 2),
            }
    return {
        "probe": "fg-region prediction analysis",
        "ckpt": ckpt,
        "snippets": len(rows),
        "corr_predfg_with_bg_gt": {"u": round(corr(pf[:, 0], bg[:, 0]), 3),
                                   "v": round(corr(pf[:, 1], bg[:, 1]), 3)},
        "corr_predfg_with_fg_gt": {"u": round(corr(pf[:, 0], fg[:, 0]), 3),
                                   "v": round(corr(pf[:, 1], fg[:, 1]), 3)},
        "epe_fg_by_relative_motion": bins,
        "epe_fg_overall": round(float(np.mean([r["epe_fg"] for r in rows])), 2),
        "epe_if_painted_bg_overall": round(
            float(np.mean([r["epe_fg_if_painted_bg"] for r in rows])), 2),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="foreground-region prediction analysis")
    p.add_argument("--ckpt", required=True, help="the JAX package's .ckpt or a .pth")
    p.add_argument("--hw", type=int, nargs=2, default=(128, 256))
    p.add_argument("--max-bg", type=int, default=8)
    p.add_argument("--max-fg", type=int, default=16)
    p.add_argument("--tex-power", type=float, default=1.0)
    p.add_argument("--snippets", type=int, default=48)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--device", default="cuda", help="cuda (raises without a GPU) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    set_float32_precision(device, "float32")
    model = FlowModel(FlowModelConfig(num_scales=3), device=device)
    load_pretrained(model, args.ckpt)

    def infer(img1, img2):
        with torch.inference_mode():
            return inference_flow(model, torch.from_numpy(img1).to(device),
                                  torch.from_numpy(img2).to(device)).cpu().numpy()

    gen_kw = dict(max_bg=args.max_bg, max_fg=args.max_fg, tex_power=args.tex_power)
    rows = probe(infer, tuple(args.hw), args.snippets, args.batch, gen_kw)
    print(json.dumps(summarize(rows, args.ckpt), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
