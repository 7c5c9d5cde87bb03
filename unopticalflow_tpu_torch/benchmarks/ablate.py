"""Ablations of the train step: where do its milliseconds go?

The port's counterpart of ``benchmarks/ablate.py``: variants of the
KITTI-recipe step with a part stubbed out, each patched into the port's own
modules for the variant's run and restored after it.

* ``full``         the real step
* ``no-warp``      the decoder's feature warps (``ops/warp.py``'s
                   ``bilinear_warp`` as ``models/pwc_decoder.py`` and
                   ``models/flow_model.py`` call it) replaced by the target
                   plus 0 x the flow's mean
* ``no-corr``      the decoder's cost volume (``DenseOps.corr``) replaced by
                   the channel mean of f1 * f2 broadcast to 81 channels
* ``no-warp+corr`` both
* ``no-ssim``      ``ops/ssim.py``'s ``ssim`` replaced by x - y where the
                   port's losses call it
* ``convs-only``   ``training/train_step.py``'s forward replaced by the
                   encoder and decoder passes alone, the loss the mean |flow|
* ``no-context``   the decoder's dilated context convolutions
                   (``models/pwc_decoder.py``) replaced by a channel slice

On the port's main path the loss stack's warps and SSIM run inside the
photometric kernels (``ops/photometric.py``), which take the images
themselves: ``no-warp`` removes only the decoder's four warps, and
``no-ssim`` leaves the kernel path as it is (its time is the full step's,
and the photometric kernels still launch).  ``no-corr`` launches none of
the correlation kernels.

The bfloat16 step is host-bound when it runs eagerly, so each variant is
timed as a K = 8 dispatch (on the card one CUDA graph of 8 steps; its
steady state is the median of ``--replays`` replays after the eager
dispatch and the capture, CUDA events), with the K = 1 eager step's
ms/step (median of ``--eager-steps``) beside it, and the training kernels'
launches a step.  A variant that fails fails the run.

    python -m unopticalflow_tpu_torch.benchmarks.ablate [--batch 8] [--hw 256 832] \
        [--fp32] [--steps-per-dispatch 8] [--replays 3] [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import sys
import time
from unittest import mock

import numpy as np
import torch
from torch import nn

from unopticalflow_tpu_torch.benchmarks import (
    device_name,
    last_loss,
    launch_counts,
    launches_since,
    recipe_step,
    time_ms,
)
from unopticalflow_tpu_torch.models import flow_model as fm
from unopticalflow_tpu_torch.models import losses as ls
from unopticalflow_tpu_torch.models import pwc_decoder as pwc
from unopticalflow_tpu_torch.models.flow_model import FlowModelConfig
from unopticalflow_tpu_torch.ops import photometric
from unopticalflow_tpu_torch.utils.device import resolve_device, set_float32_precision

# the module (the package's ``train_step`` attribute is its function)
ts = importlib.import_module("unopticalflow_tpu_torch.training.train_step")

VARIANTS = ("full", "no-warp", "no-corr", "no-warp+corr", "no-ssim", "convs-only",
            "no-context")


def fake_warp(img, flow, use_mask=False, row0=0):
    """``bilinear_warp``'s shape and dtype with no gather: the target plus 0 x
    the flow's channel mean, so the flow stays in the graph."""
    return (img + 0.0 * flow.mean(1, keepdim=True)).to(img.dtype)


def fake_corr(self, f1, f2):
    """``DenseOps.corr``'s (B, 81, H, W) with no correlation: the channel mean
    of f1 * f2 broadcast over the 81 displacements."""
    nd = (2 * pwc.MAX_DISPLACEMENT + 1) ** 2
    base = (f1 * f2).mean(1, keepdim=True)
    return base.expand(f1.shape[0], nd, *f1.shape[2:])


def fake_ssim(x, y):
    """``ssim``'s float32 map of the shape of x, computed as x - y."""
    return x.float() - y.float()


_real_conv = pwc.DenseOps.conv


def skip_dilated(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``DenseOps.conv`` with the dilated context convolutions replaced by the
    first ``out_channels`` channels of their input."""
    conv = layer[0] if isinstance(layer, nn.Sequential) else layer
    if conv.dilation[0] > 1 and x.shape[1] >= conv.out_channels:
        return x[:, :conv.out_channels]
    return _real_conv(layer, x)


def flows_only(model, cfg, images, **fns):
    """The training forward without its loss stack: the encoder at 3B and
    the decoder at 2B as ``forward`` runs them, each loss the per-sample
    sum of the flows' mean |flow| over both directions."""
    b, h3, w = images.shape[:3]
    h = h3 // 3
    x = images.permute(0, 3, 1, 2)
    imgl, img, imgr = (x[:, :, i * h:(i + 1) * h].contiguous() for i in range(3))
    feats = model.fpyramid(torch.cat([img, imgl, imgr], 0))
    feats_cc = [torch.cat([f[:b], f[:b]], 0) for f in feats]
    flows = model.pwc_model(feats_cc, [f[b:] for f in feats], (h, w))
    z = sum(f.float().abs().mean((1, 2, 3)) for f in flows)
    z = z[:b] + z[b:]
    return {"loss_pixel": z, "loss_ssim": z, "loss_flow_smooth": z, "loss_flow_consis": z}


def patches(variant: str) -> list:
    """The ``mock.patch`` objects of ``variant`` (not yet started)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} ({', '.join(VARIANTS)})")
    out = []
    if "warp" in variant:
        out += [mock.patch.object(pwc, "bilinear_warp", fake_warp),
                mock.patch.object(fm, "bilinear_warp", fake_warp)]
    if "corr" in variant:
        out.append(mock.patch.object(pwc.DenseOps, "corr", fake_corr))
    if variant == "no-ssim":
        out += [mock.patch.object(ls, "ssim", fake_ssim),
                mock.patch.object(photometric, "ssim", fake_ssim)]
    if variant == "convs-only":
        out.append(mock.patch.dict(ts.FORWARDS, {("flow", 3): flows_only}))
    if variant == "no-context":
        out.append(mock.patch.object(pwc.DenseOps, "conv", staticmethod(skip_dilated)))
    return out


@contextlib.contextmanager
def patched(variant: str):
    """Run the block with ``variant``'s stubs in place; restored on exit."""
    with contextlib.ExitStack() as stack:
        for p in patches(variant):
            stack.enter_context(p)
        yield


def run_variant(variant: str, cfg: FlowModelConfig, imgs: torch.Tensor, k: int,
                replays: int, eager_steps: int, seed: int = 0) -> dict:
    """Time one variant (see the module): K = 1 eager, then K steps a dispatch."""
    device = imgs.device
    with patched(variant):
        _, _, step = recipe_step(cfg, device, 1, seed)
        before = launch_counts()
        first_loss = last_loss(step(imgs))
        launches = launches_since(before)
        ms_eager = time_ms(step, (imgs,), device, eager_steps, warmup=1)
        _, _, multi = recipe_step(cfg, device, k, seed)
        xs = imgs[None].expand(k, *imgs.shape)
        # the eager dispatch and the capture, then the replays' steady state
        ms_dispatch = time_ms(lambda: last_loss(multi(xs)), (), device, replays, warmup=2)
    if not math.isfinite(first_loss):
        raise AssertionError(f"{variant}: the loss is not finite ({first_loss})")
    return {"variant": variant, "ms_step_graph": ms_dispatch / k, "k": k,
            "ms_step_eager_k1": ms_eager, "snippets_per_s": imgs.shape[0] / ms_dispatch * k * 1e3,
            "first_loss": first_loss, "launches_per_step": launches}


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="train-step ablations")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--hw", type=int, nargs=2, default=(256, 832))
    p.add_argument("--fp32", action="store_true", help="float32 (default bfloat16)")
    p.add_argument("--steps-per-dispatch", type=int, default=8)
    p.add_argument("--replays", type=int, default=3, help="timed dispatches (>= 3)")
    p.add_argument("--eager-steps", type=int, default=5, help="timed K = 1 eager steps")
    p.add_argument("--variants", nargs="+", choices=VARIANTS, default=list(VARIANTS))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (raises without a GPU) or cpu")
    return p


def run(args) -> list[dict]:
    device = resolve_device(args.device)
    precision = "float32" if args.fp32 else "bfloat16"
    set_float32_precision(device, precision)
    cfg = FlowModelConfig(num_scales=3, compute_dtype=precision, loss_dtype=precision)
    h, w = args.hw
    imgs = torch.from_numpy(
        np.random.RandomState(args.seed).rand(args.batch, 3 * h, w, 3).astype(np.float32)
    ).to(device)
    out = []
    for variant in args.variants:
        t0 = time.perf_counter()
        rec = run_variant(variant, cfg, imgs, args.steps_per_dispatch, args.replays,
                          args.eager_steps, args.seed)
        rec.update(precision=precision, device=device_name(device))
        out.append(rec)
        print(f"{variant:>14}: {rec['ms_step_graph']:8.2f} ms/step at K = "
              f"{args.steps_per_dispatch} ({rec['snippets_per_s']:6.1f} snippets/s), "
              f"K = 1 eager {rec['ms_step_eager_k1']:8.2f} ms/step, launches a step "
              f"{ {n: v for n, v in rec['launches_per_step'].items() if v} } "
              f"[{time.perf_counter() - t0:.0f}s]", flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    print(json.dumps({"ablations": run(build_arg_parser().parse_args(argv))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
