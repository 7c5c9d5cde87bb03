"""Occlusion-aware learning benchmark: piecewise motion with real occlusions.

The port's counterpart of ``benchmarks/synthetic_epe.py``.  A textured
foreground rectangle moves over a differently moving background, so every
snippet holds occlusion and disocclusion bands where no photometric match
exists; the softmax occlusion weights must gate them out for training to
converge.  The ground truth is analytic (integer translations), so the run
reports true EPE over all, non-occluded and occluded pixels, per region
(foreground and background) and the KITTI outlier rate, on a fixed held-out
set, beside the same numbers for a zero-flow prediction (the bar a run must
go under), and the slopes of the mean predicted flow against the background
motion (``prediction_probe``: about 1 when the net tracks its input, about 0
when it predicts a constant).

    python -m unopticalflow_tpu_torch.benchmarks.synthetic_epe [--iters 4000] \
        [--device cuda] [--lr-schedule cosine] [--eval-every 500] \
        [--steps-per-dispatch 8] ...

The generator is the JAX module's numpy path (it uses cv2 when it can, for
speed; the two paths agree within 2.4e-7 and give the same flows and masks),
so the same seeds give the same training stream and the same held-out set.
The weights come from the ``--init`` scheme and a generator seeded with 0,
as the JAX harness seeds its init with ``PRNGKey(0)``.  One optimizer step
per iteration: an evaluation point labelled ``iter i`` scores the model
after the step of iteration ``i``, as the JAX harness does at one step per
dispatch, so the two packages' curves line up point for point.  ``--save``
stores the number of steps taken, so ``--load`` resumes at the next step,
with the cosine schedule restarted at that count (the JAX harness stores the
eval point's label, one step short).

``--steps-per-dispatch K`` runs K steps a dispatch through
``training.make_multi_train_step`` on K stacked batches: on CUDA one replay
of a CUDA graph of the K steps, whose cosine learning rate is computed on
the device from a step count inside the graph (``cosine_decay_lr_tensor``;
a Python float would be frozen into it), on the CPU K eager steps.  As in
the JAX harness, K > 1 refuses ``--supervised`` and an ``--eval-every`` that
is no multiple of K; unlike it, it refuses an ``--iters`` (less a
``--load``'s iteration) that is no multiple of K, where the JAX loop's last
dispatch overshoots, and an evaluation after the dispatch that starts on the
grid is labelled with the dispatch's last sub-step, whose model it scores
(the JAX harness labels it with the first).

``--device-gen`` draws every training batch on the device
(``synth_device_gen.make_device_batch``, a ``torch.Generator`` seeded with
0), ``--pool-device`` uploads the ``--pool`` once and samples, mirrors and
casts its batches on the device (a generator seeded with 123), as the JAX
harness does with ``PRNGKey(0)`` and ``PRNGKey(123)``; the held-out sets stay
on the host generator.  On the card a K-step dispatch draws its K batches
outside the CUDA graph (a generator's state does not advance inside a
replay) and the graph copies them into its slots.  The pool must fit in half
of the device's free memory (``torch.cuda.mem_get_info``), the other half
left to the step.

Left out: ``--no-pallas-corr`` and ``--no-pallas-photo``: on the card the
port always takes its kernels, a CUDA tensor has no plain fallback.

Host batches are drawn in a background thread (``data.loader.background``:
one producer, so the draws keep their order) and copied to the device ahead
of the step.  Prints the zero-flow line, a line every 250 iterations, a JSON
line per evaluation point, then one JSON line with the JAX harness's keys
(``platform`` is ``cuda`` or ``cpu``), ``device``, ``ms_per_step`` (median
time between consecutive dispatches' ends over K: CUDA events on the card,
the host clock on the CPU), ``steps_per_dispatch``, ``lr_max_rel_err``
and ``lr_last`` (the learning rate every step took, in a CUDA graph read
back from the device, against ``cosine_decay_lr`` or the constant: the
largest relative gap, and the last step's rate) and ``eval_points``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import sys
import time

import numpy as np
import torch

from unopticalflow_tpu_torch.benchmarks import StepClock, device_name
from unopticalflow_tpu_torch.benchmarks.synth_device_gen import make_device_batch
from unopticalflow_tpu_torch.data.loader import background, device_prefetch, stack_batches
from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, inference_flow
from unopticalflow_tpu_torch.training import (
    make_multi_train_step,
    make_optimizer,
    set_capturable,
    train_step,
)
from unopticalflow_tpu_torch.utils.checkpoint import (
    load_pretrained,
    restore_checkpoint,
    save_checkpoint,
)
from unopticalflow_tpu_torch.utils.device import resolve_device, set_float32_precision

EVAL_SEED = 12345  # the held-out set: every evaluation scores the same snippets
PROBE_SEED = 777
PROBE_SNIPPETS = 64
DEVICE_GEN_SEED = 0  # --device-gen's generator (the JAX harness's PRNGKey(0))
POOL_DEVICE_SEED = 123  # --pool-device's sampler (its PRNGKey(123))
POOL_FREE_SHARE = 0.5  # --pool-device: the pool's share of the device's free memory


def _texture(rng, h, w, octaves, power=0.5):
    """Multi-octave (1/f-like) texture: structure at every pyramid scale.

    Smoothed white noise averages to flat grey at the coarse pyramid levels,
    which deletes the coarse-to-fine photometric signal that PWC-style
    training starts from; summing nearest-neighbour-upsampled noise octaves
    (amplitude ``s ** power``) keeps a signal at every decoder level.
    ``power`` 0.5 is the original benchmark texture, 1.0 natural-image-like.
    The rng draws, in this order and shape, are the data's identity.
    """
    t = np.zeros((h, w, 3), np.float32)
    for o in range(octaves):
        s = 2**o
        small = rng.rand(h // s + 2, w // s + 2, 3).astype(np.float32)
        if s == 1:
            up = small[:h, :w]
        else:
            up = np.repeat(np.repeat(small, s, 0), s, 1)[:h, :w]
        t += (s**power) * up
    # a light cross-shaped box smooth with wrap-around, so block edges do not
    # alias under bilinear warps
    t = (
        t
        + np.roll(t, 1, 0) + np.roll(t, -1, 0)
        + np.roll(t, 1, 1) + np.roll(t, -1, 1)
    ) / 5.0
    # renormalise the contrast so photometric gradients stay informative
    t -= t.min()
    t /= max(t.max(), 1e-6)
    return t


def make_snippet(rng, h, w, max_bg=4, max_fg=8, tex_power=0.5, fg_bias=0.0):
    """One 3-frame snippet, the centre frame's flow and its visibility.

    The background translates by integer (u_b, v_b), a foreground rectangle
    by (u_f, v_f); the frames are times t-1, t, t+1 of that linear motion.
    Returns ``stacked`` (3h, w, 3) float32 in [0, 1], ``flow_gt`` (h, w, 2)
    the centre frame's forward flow (u, v), and ``nonocc`` (h, w) bool, the
    centre pixels still visible at t+1.  ``fg_bias`` lifts the foreground's
    brightness into [fg_bias, 1], so its boundary is an intensity edge.
    """
    max_fg = min(max_fg, h // 8, w // 8)  # keep the rectangle placeable
    pad = 2 * max(max_bg, max_fg) + 2
    big = _texture(rng, h + 2 * pad, w + 2 * pad, octaves=6, power=tex_power)
    u_b, v_b = rng.randint(-max_bg, max_bg + 1, size=2)
    u_f, v_f = rng.randint(-max_fg, max_fg + 1, size=2)

    rh = rng.randint(h // 4, h // 2 + 1)
    rw = rng.randint(w // 6, w // 3 + 1)
    fg_tex = _texture(rng, rh, rw, octaves=4, power=tex_power)
    if fg_bias:
        fg_tex = fg_bias + (1.0 - fg_bias) * fg_tex
    # the rectangle stays inside the frame at every time step (k = -1, 0, +1)
    ry = rng.randint(abs(v_f) + 1, h - rh - abs(v_f))
    rx = rng.randint(abs(u_f) + 1, w - rw - abs(u_f))

    frames = []
    fg_masks = []
    for k in (-1, 0, 1):
        y0 = pad - k * v_b
        x0 = pad - k * u_b
        fr = big[y0:y0 + h, x0:x0 + w].copy()
        fy, fx = ry + k * v_f, rx + k * u_f
        fr[fy:fy + rh, fx:fx + rw] = fg_tex
        m = np.zeros((h, w), bool)
        m[fy:fy + rh, fx:fx + rw] = True
        frames.append(fr)
        fg_masks.append(m)

    flow_gt = np.empty((h, w, 2), np.float32)
    flow_gt[..., 0] = u_b
    flow_gt[..., 1] = v_b
    flow_gt[fg_masks[1]] = (u_f, v_f)

    # centre background pixels whose destination the foreground covers at
    # t+1, or that leave the frame, are occluded; the foreground stays visible
    ys, xs = np.mgrid[0:h, 0:w]
    dst_y = ys + flow_gt[..., 1].astype(int)
    dst_x = xs + flow_gt[..., 0].astype(int)
    inside = (dst_y >= 0) & (dst_y < h) & (dst_x >= 0) & (dst_x < w)
    covered = np.zeros((h, w), bool)
    ok = inside & ~fg_masks[1]
    covered[ok] = fg_masks[2][dst_y[ok], dst_x[ok]]
    nonocc = inside & ~covered

    return np.concatenate(frames, axis=0), flow_gt, nonocc


def make_batch(rng, batch, h, w, **kw):
    out = [make_snippet(rng, h, w, **kw) for _ in range(batch)]
    return (
        np.stack([o[0] for o in out]),
        np.stack([o[1] for o in out]),
        np.stack([o[2] for o in out]),
    )


def evaluate(infer, hw, batch, n_snippets, gen_kw, zero_flow=False) -> dict:
    """Held-out EPE on ``n_snippets`` snippets from ``RandomState(12345)``,
    ``batch`` at a time through ``infer(img1, img2) -> (n, h, w, 2)``.

    ``zero_flow=True`` scores a zero prediction on the same set instead: the
    bar a learned run must go under (part of an early drop of epe_all is
    only unlearning the init's constant bias).
    """
    h, w = hw
    erng = np.random.RandomState(EVAL_SEED)
    epe_all, epe_noc, epe_occ, epe_fg, epe_bg, outlier = [], [], [], [], [], []
    done = 0
    while done < n_snippets:
        n = min(batch, n_snippets - done)
        stacked, gt, noc = make_batch(erng, n, h, w, **gen_kw)
        if zero_flow:
            flow = np.zeros_like(gt)
        else:
            flow = np.asarray(infer(stacked[:, h:2 * h], stacked[:, 2 * h:]), np.float32)
        err = np.linalg.norm(flow - gt, axis=-1)  # (n, h, w)
        fg = np.linalg.norm(gt - gt[:, :1, :1], axis=-1) > 0  # the corner is background
        for i in range(n):
            epe_all.append(err[i].mean())
            epe_noc.append(err[i][noc[i]].mean())
            if (~noc[i]).any():
                epe_occ.append(err[i][~noc[i]].mean())
            if fg[i].any():
                epe_fg.append(err[i][fg[i]].mean())
                epe_bg.append(err[i][~fg[i]].mean())
            mag = np.linalg.norm(gt[i], axis=-1)
            outlier.append(
                ((err[i] > 3.0) & (err[i] > 0.05 * np.maximum(mag, 1e-6))).mean()
            )
        done += n
    return {
        "epe_all": round(float(np.mean(epe_all)), 3),
        "epe_nonoccluded": round(float(np.mean(epe_noc)), 3),
        "epe_occluded": round(float(np.mean(epe_occ)), 3) if epe_occ else None,
        "epe_fg": round(float(np.mean(epe_fg)), 3) if epe_fg else None,
        "epe_bg": round(float(np.mean(epe_bg)), 3) if epe_bg else None,
        "outlier_rate_kitti": round(float(np.mean(outlier)), 4),
    }


def prediction_probe(infer, hw, batch, gen_kw) -> dict:
    """Does the net condition on its input, or predict a bias?

    Regresses the mean predicted flow of each of 64 fresh snippets
    (``RandomState(777)``) on its background motion: a slope near 1 tracks
    per-sample motion, near 0 is a constant predictor; a flat epe_all curve
    cannot tell the two apart.
    """
    h, w = hw
    prng = np.random.RandomState(PROBE_SEED)
    preds, gts = [], []
    done = 0
    while done < PROBE_SNIPPETS:
        n = min(batch, PROBE_SNIPPETS - done)
        stacked, gt, _ = make_batch(prng, n, h, w, **gen_kw)
        flow = np.asarray(infer(stacked[:, h:2 * h], stacked[:, 2 * h:]), np.float32)
        preds.append(flow.reshape(n, -1, 2).mean(1))
        gts.append(gt[:, 0, 0])  # the corner pixel is always background
        done += n
    p = np.concatenate(preds)  # (64, 2) mean predicted flow
    g = np.concatenate(gts)  # (64, 2) background motion
    out = {}
    for i, ax in enumerate("uv"):
        gc = g[:, i] - g[:, i].mean()
        slope = float((gc * p[:, i]).sum() / max((gc**2).sum(), 1e-9))
        out[f"slope_{ax}"] = round(slope, 3)
    out["pred_mean"] = [round(float(x), 3) for x in p.mean(0)]
    out["pred_std"] = [round(float(x), 3) for x in p.std(0)]
    return out


def cosine_decay_lr(lr: float, decay_steps: int, alpha: float, count: int) -> float:
    """``optax.cosine_decay_schedule(lr, decay_steps, alpha)`` at update ``count``
    (0 for the first update), held at its floor after ``decay_steps``."""
    count = min(count, decay_steps)
    cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
    return lr * ((1 - alpha) * cosine + alpha)


def cosine_decay_lr_tensor(lr: float, decay_steps: int, alpha: float,
                           count: torch.Tensor) -> torch.Tensor:
    """``cosine_decay_lr`` of a float64 ``count`` tensor, computed with tensor
    operations on its device (so a CUDA graph can hold it), as float32."""
    count = torch.clamp(count, max=float(decay_steps))
    cosine = 0.5 * (1 + torch.cos(math.pi * count / decay_steps))
    return (lr * ((1 - alpha) * cosine + alpha)).float()


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="occlusion-aware EPE of unsupervised training")
    p.add_argument("--iters", type=int, default=4000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--hw", type=int, nargs=2, default=(128, 256))  # divisible by 64
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr-schedule", choices=["const", "cosine"], default="const",
                   help="cosine: decay --lr to --lr-final-frac of itself over --iters "
                        "(optax.cosine_decay_schedule)")
    p.add_argument("--lr-final-frac", type=float, default=0.05,
                   help="the cosine floor as a fraction of --lr")
    p.add_argument("--supervised", action="store_true",
                   help="diagnostic: train on the analytic ground truth (L1 of "
                        "inference_flow) instead of the unsupervised loss stack, "
                        "on fresh snippets even with --pool, as the JAX harness does")
    p.add_argument("--smooth-weight", type=float, default=10.0,
                   help="loss_flow_smooth weight (KITTI recipe: 10.0)")
    p.add_argument("--w-pixel", type=float, default=0.15,
                   help="loss_pixel weight (KITTI recipe: 0.15)")
    p.add_argument("--w-ssim", type=float, default=0.85,
                   help="loss_ssim weight (KITTI recipe: 0.85)")
    p.add_argument("--max-bg", type=int, default=4, help="max |background translation| in px")
    p.add_argument("--max-fg", type=int, default=8,
                   help="max |foreground translation| in px (0: global translation only)")
    p.add_argument("--eval-snippets", type=int, default=32)
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="K optimizer steps per dispatch (on CUDA one replay of a CUDA "
                        "graph of the K steps); --iters and --eval-every must be "
                        "multiples of K")
    p.add_argument("--eval-every", type=int, default=0,
                   help="also evaluate after the step of every N-th iteration "
                        "(0: only at the end)")
    p.add_argument("--pool", type=int, default=0,
                   help="pregenerate N snippets and sample batches from them with "
                        "random horizontal flips instead of fresh data every step")
    p.add_argument("--pool-dtype", choices=["uint8", "float32"], default="uint8",
                   help="the pool's storage dtype (float32: no 8-bit rounding)")
    p.add_argument("--pool-device", action="store_true",
                   help="with --pool: upload the pool to the device once and sample, "
                        "mirror and cast its batches there")
    p.add_argument("--device-gen", action="store_true",
                   help="draw fresh training batches on the device (synth_device_gen): "
                        "the same distribution at the device's speed; the held-out "
                        "sets stay on the host generator")
    p.add_argument("--pool-file", default="",
                   help="with --pool: cache the pool in this .npy and reuse it")
    p.add_argument("--no-flip", action="store_true",
                   help="diagnostic: no mirror augmentation of pool batches")
    p.add_argument("--quantize-fresh", action="store_true",
                   help="round fresh batches through uint8 (cast back on the device)")
    p.add_argument("--fp32", action="store_true",
                   help="float32 throughout (default: bfloat16 convolutions, cost "
                        "volume and loss stack)")
    p.add_argument("--loss-fp32", action="store_true",
                   help="bfloat16 convolutions and cost volume, float32 loss stack")
    p.add_argument("--no-occlusion-weights", action="store_true",
                   help="ablation: the warp-validity mask alone in place of the "
                        "softmax occlusion weights (the unfused plain loss path)")
    p.add_argument("--fg-bias", type=float, default=0.0,
                   help="lift the foreground's brightness into [bias, 1]")
    p.add_argument("--tex-power", type=float, default=0.5,
                   help="texture spectral slope: amplitude ~ scale**power")
    p.add_argument("--save", default="",
                   help=".pth to write at every evaluation point and at the end")
    p.add_argument("--load", default="",
                   help=".pth (or the JAX package's .ckpt) to resume the weights, "
                        "optimizer and iteration from")
    p.add_argument("--load-params-only", action="store_true",
                   help="with --load: the weights only (fresh optimizer, iteration 0)")
    p.add_argument("--init", choices=["torch", "pwc"], default="pwc",
                   help="weight init scheme ('torch' leaves the net nearly input-blind)")
    p.add_argument("--device", default="cuda", help="cuda (raises without a GPU) or cpu")
    return p


def make_pool_array(rng, n: int, h: int, w: int, dtype: str, gen_kw: dict,
                    progress=None) -> np.ndarray:
    """(n, 3h, w, 3) snippets of ``make_snippet`` drawn from ``rng``, stored as
    ``dtype``: uint8 rounds ``img * 255``, float32 keeps them.
    ``progress(i)``, when given, is called after each snippet."""
    pool = np.empty((n, 3 * h, w, 3), np.dtype(dtype))
    for i in range(n):
        img = make_snippet(rng, h, w, **gen_kw)[0]
        pool[i] = np.round(img * 255.0).astype(np.uint8) if dtype == "uint8" else img
        if progress is not None:
            progress(i)
    return pool


def _check_pool_fits(args, device, h: int, w: int) -> None:
    """``--pool-device``: the pool's bytes within ``POOL_FREE_SHARE`` of the
    device's free memory (the rest is the step's); not checked on the CPU."""
    if device.type != "cuda":
        return
    need = args.pool * 3 * h * w * 3 * (1 if args.pool_dtype == "uint8" else 4)
    free, _ = torch.cuda.mem_get_info(device)
    if need > POOL_FREE_SHARE * free:
        raise SystemExit(f"--pool-device: the pool needs {need / 2**30:.2f} GiB, more than "
                         f"{POOL_FREE_SHARE:.0%} of the device's free {free / 2**30:.2f} GiB "
                         "(the step needs the rest): use --pool-dtype uint8 or a smaller "
                         "--pool")


def _pool(args, rng, h, w, gen_kw) -> np.ndarray:
    """The pregenerated snippets, (N, 3h, w, 3) in ``--pool-dtype``."""
    if args.pool_file and os.path.exists(args.pool_file):
        pool = np.load(args.pool_file)
        if pool.dtype != np.dtype(args.pool_dtype) or pool.shape != (args.pool, 3 * h, w, 3):
            raise ValueError(f"{args.pool_file} holds {pool.dtype} {pool.shape}, not "
                             f"{args.pool_dtype} {(args.pool, 3 * h, w, 3)}")
        print(f"loaded {args.pool}-snippet pool from {args.pool_file}", flush=True)
        return pool
    print(f"pregenerating {args.pool}-snippet pool ...", flush=True)
    pool = make_pool_array(rng, args.pool, h, w, args.pool_dtype, gen_kw)
    if args.pool_file:
        np.save(args.pool_file, pool)
        print(f"saved pool to {args.pool_file}", flush=True)
    return pool


def _check_dispatch(args, it0: int = 0) -> int:
    """``--steps-per-dispatch``: what the JAX harness refuses (SystemExit, its
    messages), and an iteration count that the K-step dispatches overshoot;
    ``--pool-device`` without ``--pool`` and ``--device-gen`` with
    ``--fg-bias``, which the JAX device generator lacks.  Returns K."""
    k = args.steps_per_dispatch
    if k < 1:
        raise SystemExit("--steps-per-dispatch must be >= 1")
    if args.pool_device and not args.pool:
        raise SystemExit("--pool-device needs --pool")
    if args.device_gen and args.fg_bias:
        raise SystemExit("--device-gen draws no --fg-bias foreground (nor does the JAX "
                         "device generator)")
    if k > 1:
        if args.supervised:
            raise SystemExit("--steps-per-dispatch>1 not supported with --supervised "
                             "(diagnostic path stays K=1)")
        if args.eval_every and args.eval_every % k:
            raise SystemExit("--eval-every must be divisible by --steps-per-dispatch")
        if (args.iters - it0) % k:
            raise SystemExit(f"--iters {args.iters} less the start iteration {it0} must be "
                             f"divisible by --steps-per-dispatch {k}")
    return k


def run(args) -> dict:
    """Train and evaluate as ``args`` (``build_arg_parser``'s namespace) says."""
    k = _check_dispatch(args)
    device = resolve_device(args.device)
    prec = "float32" if args.fp32 else "bfloat16"
    loss_prec = "float32" if (args.fp32 or args.loss_fp32) else "bfloat16"
    set_float32_precision(device, prec)
    cfg = FlowModelConfig(num_scales=3, compute_dtype=prec, loss_dtype=loss_prec,
                          use_occlusion_weights=not args.no_occlusion_weights)
    weights = {  # the KITTI recipe's table (config/kitti.yaml)
        "loss_pixel": args.w_pixel,
        "loss_ssim": args.w_ssim,
        "loss_flow_smooth": args.smooth_weight,
        "loss_flow_consis": 0.01,
    }
    model = FlowModel(cfg, device=device, scheme=args.init,
                      generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model, args.lr)
    it0 = 0
    if args.load:
        if args.load_params_only:
            src = load_pretrained(model, args.load)
            print(f"warm-started params from {args.load} (source iter {src}; "
                  "fresh optimizer)", flush=True)
        else:
            it0 = restore_checkpoint(args.load, model, opt)
            print(f"resumed from {args.load} at iter {it0}", flush=True)

    _check_dispatch(args, it0)
    graph = k > 1 and device.type == "cuda"
    if graph:
        set_capturable(opt)  # after the load: the graph captures its state

    def lr_at(count):
        if args.lr_schedule == "cosine":
            return cosine_decay_lr(args.lr, args.iters, args.lr_final_frac, count)
        return args.lr

    taken = []  # the learning rate of each step: floats, or a graph's (K,) tensors

    def set_lr(count):
        for group in opt.param_groups:
            group["lr"] = lr_at(count)
        taken.append(lr_at(count))

    for group in opt.param_groups:  # a --load restores the lr it stored
        group["lr"] = lr_at(it0)
    # before each sub-step of a K-step dispatch: a Python float per step on
    # the CPU; in a CUDA graph the schedule of a step count on the device,
    # each sub-step's rate also written to its slot of lr_hist (the slot is
    # fixed when the graph is captured), which is read back after the run
    pre_step, lr_hist = None, None
    if graph and args.lr_schedule == "cosine":
        count_t = torch.tensor(float(it0), dtype=torch.float64, device=device)
        lr_t = torch.tensor(lr_at(it0), dtype=torch.float32, device=device)
        lr_hist = torch.empty(k, dtype=torch.float32, device=device)
        slot = itertools.count()
        for group in opt.param_groups:
            group["lr"] = lr_t

        def pre_step():
            lr_t.copy_(cosine_decay_lr_tensor(args.lr, args.iters, args.lr_final_frac, count_t))
            lr_hist[next(slot) % k].copy_(lr_t)
            count_t.add_(1)
    elif k > 1 and not graph:
        count = [it0]

        def pre_step():
            set_lr(count[0])
            count[0] += 1

    h, w = args.hw
    rng = np.random.RandomState(0)
    gen_kw = dict(max_bg=args.max_bg, max_fg=args.max_fg, tex_power=args.tex_power)
    if args.fg_bias:
        gen_kw["fg_bias"] = args.fg_bias
    on_device = False  # next_batch gives device tensors
    if args.device_gen:
        on_device = True
        gen = torch.Generator(device=device).manual_seed(DEVICE_GEN_SEED)

        def next_batch():
            return make_device_batch(gen, args.batch, h, w, **gen_kw)[0]
    elif args.pool and args.pool_device:
        _check_pool_fits(args, device, h, w)
        pool = _pool(args, rng, h, w, gen_kw)
        t_up = time.perf_counter()
        pool_dev = torch.from_numpy(pool).to(device)
        is_u8 = pool.dtype == np.uint8
        del pool  # the evaluation uses the fresh host generator
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"uploaded pool to the device ({pool_dev.nbytes / 1e9:.2f} GB, "
              f"{time.perf_counter() - t_up:.1f}s)", flush=True)
        on_device = True
        gen = torch.Generator(device=device).manual_seed(POOL_DEVICE_SEED)

        def next_batch():
            idx = torch.randint(0, args.pool, (args.batch,), generator=gen, device=device)
            b = pool_dev[idx].float()
            if is_u8:
                b = b / 255.0
            if not args.no_flip:
                flip = torch.rand(args.batch, generator=gen, device=device) < 0.5
                b = torch.where(flip[:, None, None, None], b.flip(2), b)
            return b
    elif args.pool:
        pool = _pool(args, rng, h, w, gen_kw)

        def next_batch():
            b = pool[rng.randint(0, args.pool, size=args.batch)]
            if not args.no_flip:
                flip = rng.rand(len(b)) < 0.5  # a mirrored motion is a new snippet
                b[flip] = b[flip, :, ::-1]
            return b
    else:
        def next_batch():
            b = make_batch(rng, args.batch, h, w, **gen_kw)[0]
            if args.quantize_fresh:
                b = np.round(b * 255.0).astype(np.uint8)
            return b
    if args.supervised:  # fresh host snippets and their flows, after any pool
        on_device = False

        def next_batch():
            stacked, gt, _ = make_batch(rng, args.batch, h, w, **gen_kw)
            return stacked, gt

    def infer(img1, img2):
        with torch.no_grad():
            flow = inference_flow(model, torch.from_numpy(img1).to(device),
                                  torch.from_numpy(img2).to(device))
        return flow.cpu().numpy()

    def evaluate_model():
        return evaluate(infer, (h, w), args.batch, args.eval_snippets, gen_kw)

    def save(steps):
        if args.save:
            save_checkpoint([args.save], steps, model, opt)

    # the bar every curve is judged against, on the same held-out set
    zf = evaluate(None, (h, w), args.batch, args.eval_snippets, gen_kw, zero_flow=True)
    print(json.dumps({"zero_flow": zf}), flush=True)

    clock = StepClock(device)
    points = []
    t0 = time.perf_counter()
    if on_device:
        # drawn in order on the device, K of them stacked for a dispatch (a
        # CUDA graph copies them into its slots: the draws stay outside it)
        batches = (torch.stack([next_batch() for _ in range(k)]) if k > 1 else next_batch()
                   for _ in range(it0, args.iters, k))
    else:
        host = background(next_batch() for _ in range(it0, args.iters))
        batches = device_prefetch(stack_batches(host, k) if k > 1 else host, device)
    if k > 1:
        multi_step = make_multi_train_step(model, opt, cfg, weights, k, pre_step=pre_step)
    # a dispatch covers iterations [it, it + k); its last sub-step is `last`
    for it in range(it0, args.iters, k):
        b = next(batches)
        last = it + k - 1
        if args.supervised:
            set_lr(it)
            m = _supervised_step(model, opt, *b, h)
        elif k > 1:
            m = {name: v[-1] for name, v in multi_step(b).items()}
            if graph:  # a constant rate is a float held in the graph
                taken.append(lr_hist.clone() if lr_hist is not None else [args.lr] * k)
        else:
            set_lr(it)
            m = train_step(model, opt, b, weights, cfg)
        clock.mark()
        if it % 250 < k or last >= args.iters - 1:
            print(f"iter {last}: total {float(m['loss_total']):.4f} "
                  f"pixel {float(m['loss_pixel']):.4f} "
                  f"ssim {float(m['loss_ssim']):.4f} ({time.perf_counter() - t0:.0f}s)",
                  flush=True)
        if args.eval_every and it % args.eval_every == 0:
            # iteration 0 included: the near-init point anchors the curve; the
            # label is the step whose model is scored, the dispatch's last
            points.append({"iter": last, **evaluate_model()})
            print(json.dumps(points[-1]), flush=True)
            save(last + 1)
    save(args.iters)
    lrs = torch.cat([torch.as_tensor(x, dtype=torch.float64).reshape(-1).cpu() for x in taken])
    want_lrs = torch.tensor([lr_at(i) for i in range(it0, args.iters)], dtype=torch.float64)

    result = {
        "benchmark": "synthetic piecewise-motion EPE (occlusion-aware)",
        "iters": args.iters,
        "hw": list(args.hw),
        "precision": prec,
        "loss_precision": loss_prec,
        "lr": args.lr,
        "lr_schedule": args.lr_schedule,
        "init": args.init,
        "smooth_weight": args.smooth_weight,
        "w_pixel": args.w_pixel,
        "w_ssim": args.w_ssim,
        "supervised": args.supervised,
        "batch": args.batch,
        "eval_snippets": args.eval_snippets,
        "max_bg": args.max_bg,
        "max_fg": args.max_fg,
        "tex_power": args.tex_power,
        "occlusion_weights": not args.no_occlusion_weights,
        "device_gen": args.device_gen,
        "pool_device": bool(args.pool and args.pool_device),
        "platform": device.type,
        "device": device_name(device),
        **evaluate_model(),
        "zero_flow": zf,
        "pred_probe": prediction_probe(infer, (h, w), args.batch, gen_kw),
        "ms_per_step": None if (ms := clock.median_ms()) is None else ms / k,
        "steps_per_dispatch": k,
        # the rate each step took against cosine_decay_lr (or the constant):
        # in a CUDA graph the float32 rates the graph computed, read back
        "lr_max_rel_err": float(((lrs - want_lrs).abs() / want_lrs).max()) if len(lrs) else 0.0,
        "lr_last": float(lrs[-1]) if len(lrs) else None,
        "eval_points": points,
    }
    result["train_seconds"] = round(time.perf_counter() - t0, 1)
    return result


def _supervised_step(model, opt, stacked, gt, h) -> dict:
    """One Adam step on the L1 distance of ``inference_flow`` to the ground truth."""
    opt.zero_grad(set_to_none=True)
    flow = inference_flow(model, stacked[:, h:2 * h], stacked[:, 2 * h:])
    loss = (flow - gt).abs().mean()
    loss.backward()
    opt.step()
    zero = torch.zeros_like(loss)
    return {"loss_total": loss.detach(), "loss_pixel": zero, "loss_ssim": zero}


def main(argv=None) -> int:
    print(json.dumps(run(build_arg_parser().parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
