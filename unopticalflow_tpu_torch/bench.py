"""Training and inference throughput of the port on one card, and its
kernels held against their plain versions there.

The port's counterpart of the root ``bench.py``:

    python3 -m unopticalflow_tpu_torch.bench [--batch 8] [--iters 40] [--hw 256 832] \
        [--fp32] [--infer] [--scan-steps 8] [--device cuda|cpu]
    python3 -m unopticalflow_tpu_torch.bench --validate [--validate-out PATH]

It prints ONE JSON line on stdout,
``{"metric": "...", "value": N, "unit": "...", "vs_baseline": N}``, built as
the JAX bench builds it, and its diagnostics (the median step, the windows'
IQR and the windows, with the device's name) as one JSON line on stderr.

Metric: train snippets/s at the KITTI recipe (256x832, batch 8, Adam at lr
1e-4, 3 loss scales, bfloat16 unless ``--fp32``), one 3-frame snippet a
sample.  ``--scan-steps K`` (default 8, what the trainer's
``--steps_per_dispatch auto`` picks at these intervals) runs K steps a
dispatch through ``training.make_multi_train_step`` on the image stacked K
times: on the card the first dispatch is K eager steps and every later one
replays one CUDA graph of the K steps, with a capturable Adam (the JAX
bench's ``lax.scan`` A/B).  ``--scan-steps 0`` runs ``train_step`` eagerly,
one step a dispatch.  ``--infer`` times ``inference_flow`` on an image pair
instead (pairs/s).  float32 is true float32 (TF32 off), as the JAX
package's Precision.HIGHEST.

Timing, as the JAX bench times: warm-up dispatches, each followed by a
synchronise, until two in a row agree within 20% (at most 30); then
windows of ``max(4, min(10, iters // 2))`` dispatches, ``max(3, iters //
that)`` of them, each started on a drained queue and ended by a
synchronise; ms a step = the window's host time / (dispatches x K), and
the value is batch / the median window's ms a step.

vs_baseline: the value over the JAX bench's constants, which are its
estimates for the reference's own code on that code's era GPUs, neither a
TPU's figure nor this card's: 20 train snippets/s for the original
PyTorch trainer at 256x832 and batch 8 (pixel-normalised for other shapes:
a 384x832 rate is held to 20 x (256 x 832) / (384 x 832)), and 35 pairs/s
for PWC-Net's inference on a Titan X.

``--validate`` holds every hand-written kernel of the training step on the
card against its plain PyTorch version, at the JAX bench's shapes, seeds and
tolerances (``validate_on_chip``), writes the full report to
``--validate-out`` (default ``build/bench/validate.json`` at the
repository's root) and prints one line ``{"validate", "ok", "platform",
"worst"}``; the exit code is 1 when a check fails.  It needs the card: on
the CPU both sides would be the plain version.  The JAX bench's
``photo_cm_vs_packed_bfloat16`` check has no counterpart: it holds one TPU
layout of the bfloat16 photometric kernel against another, and the port has
one bfloat16-image kernel.

Not carried from the JAX bench: its hardcoded attribution of a TPU trace
(``device_ms_attrib``, ``model_tflop_per_step``, ``effective_mfu_pct``),
``--no-pallas`` (the port has no XLA-composition route on the card: a CUDA
tensor always takes the kernels) and ``--quant-warps`` (no quantised warps).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from unopticalflow_tpu_torch.benchmarks import (
    RECIPE_WEIGHTS,
    device_name,
    launch_counts,
    launches_since,
)
from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, inference_flow
from unopticalflow_tpu_torch.training import (
    make_multi_train_step,
    make_optimizer,
    set_capturable,
    train_step,
)
from unopticalflow_tpu_torch.utils.device import resolve_device, set_float32_precision

# the JAX bench's estimates for the reference's code (see the module docstring)
REFERENCE_TRAIN_SNIPPETS_PER_SEC = 20.0
REFERENCE_INFER_PAIRS_PER_SEC = 35.0
RECIPE_HW = (256, 832)
RECIPE_BATCH = 8
LR = 1e-4
VALIDATE_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "build", "bench", "validate.json")


def _config(precision: str) -> FlowModelConfig:
    """The JAX bench's model config: 3 loss scales, the compute and loss
    stacks in ``precision``, the regularizer kernels off (the default)."""
    return FlowModelConfig(num_scales=3, compute_dtype=precision, loss_dtype=precision)


def _model(cfg: FlowModelConfig, device: torch.device) -> FlowModel:
    """Weights from the default ("torch") init and a generator seeded with 0,
    as the JAX bench's ``init_flow_model(PRNGKey(0))``."""
    return FlowModel(cfg, device=device, generator=torch.Generator().manual_seed(0))


def train_setup(batch: int, img_hw, precision: str, scan_steps: int, device: torch.device):
    """(model, step, images) of ``bench_train``: ``step(images)`` is one
    dispatch, ``train_step`` on the (B, 3H, W, 3) images when ``scan_steps``
    is 0, else a ``make_multi_train_step`` dispatch of K = ``scan_steps``
    steps on them stacked K times (on CUDA with a capturable Adam).  The
    images are ``RandomState(0).rand`` in [0, 1), float32."""
    h, w = img_hw
    cfg = _config(precision)
    model = _model(cfg, device)
    opt = make_optimizer(model, LR)
    images = np.random.RandomState(0).rand(batch, 3 * h, w, 3).astype(np.float32)
    images = torch.from_numpy(images).to(device)
    if not scan_steps:
        return model, lambda x: train_step(model, opt, x, RECIPE_WEIGHTS, cfg), images
    if device.type == "cuda":
        set_capturable(opt)
    step = make_multi_train_step(model, opt, cfg, RECIPE_WEIGHTS, scan_steps)
    return model, step, images[None].expand(scan_steps, *images.shape)


def infer_setup(batch: int, img_hw, precision: str, device: torch.device):
    """(model, flow, (img1, img2)) of ``bench_infer``: ``flow(img1, img2)`` is
    ``inference_flow`` under ``torch.inference_mode``; img1 then img2 from
    ``RandomState(0).rand``, (B, H, W, 3) float32."""
    h, w = img_hw
    model = _model(_config(precision), device)
    rng = np.random.RandomState(0)
    pair = tuple(torch.from_numpy(rng.rand(batch, h, w, 3).astype(np.float32)).to(device)
                 for _ in range(2))

    def flow(img1, img2):
        with torch.inference_mode():
            return inference_flow(model, img1, img2)

    return model, flow, pair


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _warm_up(run, device: torch.device, limit: int = 30) -> list[float]:
    """Dispatch ``run()``, synchronising after each, until two in a row agree
    within 20% or ``limit`` ran; returns each dispatch's ms (the first holds
    the first calls' costs: on the card the kernels' loading and, at K > 0,
    the eager dispatch before the capture)."""
    ms = []
    while len(ms) < limit:
        t0 = time.perf_counter()
        run()
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        if len(ms) > 1 and abs(ms[-1] - ms[-2]) < 0.2 * ms[-2]:
            break
    return ms


def _windows(run, device: torch.device, iters: int, steps_per_dispatch: int) -> dict:
    """The timed windows (see the module docstring): ms a step by window, their
    median and IQR, the dispatches a window and the dispatches timed."""
    k = max(4, min(10, iters // 2))
    n_windows = max(3, iters // k)
    window_ms = []
    for _ in range(n_windows):
        _sync(device)  # drain the queue before timing
        t0 = time.perf_counter()
        for _ in range(k):
            run()
        _sync(device)  # a hard sync: the host returns before the device is done
        window_ms.append((time.perf_counter() - t0) * 1e3 / (k * steps_per_dispatch))
    return {"median_step_ms": float(np.median(window_ms)),
            "window_iqr_ms": float(np.percentile(window_ms, 75) - np.percentile(window_ms, 25)),
            "windows": window_ms, "steps_per_window": k, "timed_dispatches": k * n_windows}


def _timed(run, device: torch.device, iters: int, steps_per_dispatch: int,
           setup_s: float) -> dict:
    warm = _warm_up(run, device)
    res = _windows(run, device, iters, steps_per_dispatch)
    return {**res, "warmup_dispatches": len(warm), "warmup_ms": warm,
            "dispatches": len(warm) + res["timed_dispatches"], "setup_s": setup_s,
            "device": device_name(device)}


def bench_train(batch: int, img_hw, iters: int, precision: str, scan_steps: int = 0,
                device="cuda") -> dict:
    """Train snippets/s (``value``) of the step ``train_setup`` builds, with
    the timing's diagnostics (the setup's seconds and each warm-up
    dispatch's ms apart from the windows), the last step's ``loss`` and the
    dispatches made (``dispatches``, warm-up included)."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    _, step, images = train_setup(batch, img_hw, precision, scan_steps, device)
    setup_s = time.perf_counter() - t0
    last = {}

    def run():
        last["metrics"] = step(images)

    res = _timed(run, device, iters, max(1, scan_steps), setup_s)
    loss = float(last["metrics"]["loss_total"].reshape(-1)[-1])
    return {**res, "value": batch / res["median_step_ms"] * 1e3, "loss": loss,
            "precision": precision, "scan_steps": scan_steps}


def bench_infer(batch: int, img_hw, iters: int, precision: str, device="cuda") -> dict:
    """Inference pairs/s (``value``) of ``infer_setup``'s flow, with the
    timing's diagnostics, the dispatches made and whether the last flow is
    finite and (B, H, W, 2) float32 (``flow_ok``)."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    _, flow, pair = infer_setup(batch, img_hw, precision, device)
    setup_s = time.perf_counter() - t0
    last = {}

    def run():
        last["flow"] = flow(*pair)

    res = _timed(run, device, iters, 1, setup_s)
    out = last["flow"]
    flow_ok = (tuple(out.shape) == (batch, *img_hw, 2) and out.dtype == torch.float32
               and bool(torch.isfinite(out).all()))
    return {**res, "value": batch / res["median_step_ms"] * 1e3, "flow_ok": flow_ok,
            "precision": precision}


def result_line(batch: int, img_hw, value: float, infer: bool, scan_steps: int) -> dict:
    """The stdout line, as the JAX bench builds it (``bench.py:451-480``)."""
    if infer:
        return {"metric": "infer frame-pairs/sec/chip (256x832)", "value": round(value, 2),
                "unit": "pairs/s",
                "vs_baseline": round(value / REFERENCE_INFER_PAIRS_PER_SEC, 2)}
    h, w = img_hw
    if (h, w) == RECIPE_HW and batch == RECIPE_BATCH:
        metric = "train snippets/sec/chip (KITTI recipe 256x832, batch 8)"
    else:
        metric = f"train snippets/sec/chip ({h}x{w}, batch {batch})"
    if scan_steps:
        metric += f", {scan_steps} steps/dispatch"
    base = REFERENCE_TRAIN_SNIPPETS_PER_SEC * (RECIPE_HW[0] * RECIPE_HW[1]) / float(h * w)
    return {"metric": metric, "value": round(value, 2), "unit": "snippets/s",
            "vs_baseline": round(value / base, 2)}


# ---------------------------------------------------------------------------
# --validate: the kernels against their plain versions on the card
# ---------------------------------------------------------------------------


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The JAX bench's measure: max |got - want| over max |want| (1 where
    ``want`` is all zeros)."""
    got, want = got.detach().float(), want.detach().float()
    scale = float(want.abs().max()) or 1.0
    return float((got - want).abs().max()) / scale


def _nchw(a: np.ndarray, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """An NHWC array of the JAX bench's draws as the port's NCHW tensor."""
    t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32).transpose(0, 3, 1, 2)))
    return t.to(device=device, dtype=dtype)


def _vjp(fn, inputs, cotangents, out_keys=None, aux_keys=()):
    """(outputs, aux outputs, input gradients) of ``fn(*inputs)`` under
    ``cotangents``; ``out_keys`` picks the differentiated outputs of a dict."""
    leaves = [x.detach().clone().requires_grad_() for x in inputs]
    out = fn(*leaves)
    outs = [out[k] for k in out_keys] if out_keys else [out]
    grads = torch.autograd.grad(outs, leaves, cotangents)
    return ([o.detach() for o in outs], [out[k].detach() for k in aux_keys], list(grads))


def _check(got, want, labels, tol) -> dict:
    errs = {k: rel_err(a, b) for k, a, b in zip(labels, got, want)}
    return {"max_rel_err": errs, "tol": tol, "ok": all(e < tol for e in errs.values())}


def check_errors(check: dict) -> list[float]:
    """Every error a check holds to its tolerance."""
    errs = check.get("max_rel_err_fwd_df1_df2") or list(check["max_rel_err"].values())
    return [*errs, *check.get("max_rel_err_vs_bf16_plain", {}).values()]


def _checks(device: torch.device) -> dict:
    """``validate_on_chip``'s checks on ``device`` (see there)."""
    from unopticalflow_tpu_torch.ops.cost_volume import cost_volume, cost_volume_reference
    from unopticalflow_tpu_torch.ops.photometric import (
        photometric_pack,
        photometric_pack_reference,
    )
    from unopticalflow_tpu_torch.ops.regularizer import (
        regularizer_pack,
        regularizer_pack_reference,
    )

    rng = np.random.RandomState(0)
    checks = {}

    # ---- correlation (fwd + df1 + df2), the recipe's level-3 shape ----
    bsz, h, w, c = 2, 32, 104, 64
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        f1 = _nchw(rng.randn(bsz, h, w, c), device, dtype)
        f2 = _nchw(rng.randn(bsz, h, w, c), device, dtype)
        g = _nchw(np.random.RandomState(1).randn(bsz, h, w, 81), device, dtype)
        got, want = ([*outs, *grads] for outs, _, grads in (
            _vjp(lambda a, b: fn(a, b, 4), (f1, f2), g)
            for fn in (cost_volume, cost_volume_reference)))
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        checks[f"corr_{str(dtype)[6:]}"] = {"max_rel_err_fwd_df1_df2": errs, "tol": tol,
                                            "ok": all(e < tol for e in errs)}

    # ---- the photometric pack (sums, weights, d(flow)) ----
    labels = ["s_dw", "s_cl", "s_w", "weights", "d_flow_b", "d_flow_f"]
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        images = [_nchw(rng.rand(bsz, h, w, 3), device, dtype) for _ in range(3)]
        flows = [_nchw(rng.uniform(-5, 5, (bsz, h, w, 2)), device) for _ in range(2)]
        g = torch.from_numpy(np.random.RandomState(2).randn(2 * bsz).astype(np.float32))
        g = g.to(device)

        def run(fn, imgs):
            img, img_l, img_r = imgs
            outs, aux, grads = _vjp(lambda fb, ff: fn(img_l, img_r, fb, ff, img), flows,
                                    (g, g), ("s_dw", "s_cl"), ("s_w", "weights"))
            return [*outs, *aux, *grads]

        got = run(photometric_pack, images)
        if dtype == torch.float32:
            checks["photo_float32"] = _check(got, run(photometric_pack_reference, images),
                                             labels, tol)
            continue
        check = _check(got, run(photometric_pack_reference, [x.float() for x in images]),
                       labels, tol)
        rounded = _check(got[:4], run(photometric_pack_reference, images)[:4], labels[:4],
                         tol)
        check["max_rel_err_vs_bf16_plain"] = rounded["max_rel_err"]
        check["ok"] = check["ok"] and rounded["ok"]
        checks["photo_bfloat16"] = check
    # the draws of the JAX bench's channel-major check, which has no
    # counterpart here (see the module docstring): skipped over so that the
    # regularizer's inputs are the JAX bench's
    for _ in range(3):
        rng.rand(bsz, h, w, 3)
    for _ in range(2):
        rng.uniform(-5, 5, (bsz, h, w, 2))

    # ---- the regularizer pack (smoothness and consistency sums, d(flow)) ----
    flows = [_nchw(rng.uniform(-6, 6, (bsz, h, w, 2)), device) for _ in range(2)]
    img = _nchw(rng.rand(bsz, h, w, 3), device)
    wfd = _nchw(rng.rand(bsz, h, w, 1), device)
    sums = ("s_sx", "s_sy", "s_consis")
    g = tuple(torch.from_numpy(np.random.RandomState(7 + i).randn(*shape).astype(np.float32))
              .to(device) for i, shape in enumerate(((2 * bsz,), (2 * bsz,), (bsz,))))
    got, want = ([*outs, *grads] for outs, _, grads in (
        _vjp(lambda fb, ff: fn(fb, ff, img, wfd), flows, g, sums)
        for fn in (regularizer_pack, regularizer_pack_reference)))
    checks["regularizer_float32"] = _check(got, want, [*sums, "d_flow_b", "d_flow_f"], 1e-4)
    return checks


def validate_on_chip(out_path: str | None = VALIDATE_OUT, device="cuda") -> int:
    """Forward and gradient of each kernel of the training step against its
    plain version on the card (the JAX bench's ``validate_on_chip``): the
    correlation (fwd, df1, df2; float32 within 1e-5, bfloat16 2e-2), the
    photometric pack (``s_dw``, ``s_cl``, ``s_w``, ``weights`` and both
    flows' gradients under one cotangent on ``s_dw`` and ``s_cl``; float32
    images 1e-4, bfloat16 images 2e-2) and the regularizer pack (``s_sx``,
    ``s_sy``, ``s_consis`` and both flows' gradients; float32 1e-4), each at
    batch 2, 32x104 (the recipe's third decoder level; 64 channels for the
    correlation), on ``RandomState(0)``'s draws in the JAX bench's order,
    cotangents from ``RandomState(1)``, ``(2)`` and ``(7 + i)``.  The error is
    ``rel_err``.

    The bfloat16-image photometric kernel loads bfloat16 and computes in
    float32, never rounding the warped image; ``photometric_pack_reference``
    on bfloat16 images rounds it (``bilinear_warp``), and where the L1
    term's argument is within that rounding of zero its gradient's sign
    flips.  So the kernel is held on every output to the plain version on
    the same images widened to float32, and its sums and weights also to the
    plain version in bfloat16 (``max_rel_err_vs_bf16_plain``).

    Prints one JSON line, writes the report (checks, the card, the kernels'
    launches) to ``out_path`` when given, and returns 1 when a check fails.
    Raises without a CUDA device: on the CPU both sides would be plain."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"--validate holds the CUDA kernels against their plain versions on "
                           f"a CUDA card; asked for {device}, and CUDA is "
                           f"{'available' if torch.cuda.is_available() else 'not available'}")
    before = launch_counts()
    checks = _checks(device)
    ok = all(v["ok"] for v in checks.values())
    worst = max(e for v in checks.values() for e in check_errors(v))
    report = {"validate": "kernels-on-card", "platform": "gpu", "ok": ok,
              "device": device_name(device), "checks": checks,
              "launches": {k: int(v) for k, v in launches_since(before).items() if v}}
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps({"validate": report["validate"], "ok": ok, "platform": "gpu",
                      "worst": worst}))
    return 0 if ok else 1


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="train or inference throughput on one card, "
                                            "or the kernels against their plain versions")
    p.add_argument("--batch", type=int, default=RECIPE_BATCH)
    # 4 windows of 10: the median holds against one slow window
    p.add_argument("--iters", type=int, default=40)
    p.add_argument("--hw", type=int, nargs=2, default=RECIPE_HW,
                   help="image height and width, each divisible by 64")
    p.add_argument("--fp32", action="store_true", help="float32 (default bfloat16)")
    p.add_argument("--infer", action="store_true", help="inference pairs/s instead of training")
    p.add_argument("--validate", action="store_true",
                   help="the kernels against their plain versions on the card instead of "
                        "the throughput bench")
    p.add_argument("--validate-out", default=VALIDATE_OUT)
    p.add_argument("--scan-steps", type=int, default=8,
                   help="K train steps a dispatch (on the card one CUDA graph of the K "
                        "steps); 0 runs the eager single step")
    p.add_argument("--device", default="cuda", help="cuda (raises without a GPU) or cpu")
    return p


def main(argv=None) -> int:
    p = build_arg_parser()
    args = p.parse_args(argv)
    if args.validate:
        return validate_on_chip(args.validate_out, args.device)
    if any(n <= 0 or n % 64 for n in args.hw):
        p.error(f"--hw {args.hw[0]} {args.hw[1]}: each must be a positive multiple of 64")
    if args.scan_steps < 0:
        p.error(f"--scan-steps must be at least 0, got {args.scan_steps}")
    device = resolve_device(args.device)
    precision = "float32" if args.fp32 else "bfloat16"
    with contextlib.redirect_stdout(sys.stderr):  # stdout holds the result line alone
        set_float32_precision(device, precision)
    hw = tuple(args.hw)
    if args.infer:
        res = bench_infer(args.batch, hw, args.iters, precision, device)
    else:
        res = bench_train(args.batch, hw, args.iters, precision, args.scan_steps, device)
    print(json.dumps(res), file=sys.stderr)
    print(json.dumps(result_line(args.batch, hw, res["value"], args.infer, args.scan_steps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
