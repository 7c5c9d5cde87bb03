"""End-to-end learning check: does the port learn a known constant flow?

The port's counterpart of ``benchmarks/sanity_train.py``.  It trains from
scratch on synthetic 3-frame snippets whose centre frame is the previous
frame shifted by ``--shift`` pixels to the right (and the next frame by as
much again), then measures the EPE of ``inference_flow`` against that known
(shift, 0) flow over the interior of a fresh batch.  One step is
``training.train_step``: 5 correlation forwards, 5 + 5 correlation
backwards, 3 photometric forwards and 3 backwards on the card.

    python -m unopticalflow_tpu_torch.benchmarks.sanity_train [--iters 600] \
        [--batch 4] [--hw 64 128] [--shift 3] [--lr 1e-4] [--bf16] \
        [--device cuda] [--seed 0]

Same flags, model configuration (3 loss scales; float32, or bfloat16
convolutions and loss stack with ``--bf16``), loss weights (0.15 / 0.85 /
10.0 / 0.01), data and Adam as the JAX harness; the weights are the port's
``"torch"`` init scheme from a generator seeded with ``--seed``, which also
seeds the snippets (the JAX harness uses ``PRNGKey(0)`` and
``RandomState(0)``).  The JAX harness's ``--quant-warps`` is left out: it
selects ``quantize_loss_warps``, a TPU layout option the port does not have.

Prints a line every 100 iterations, the EPE line, then one JSON line with
``epe``, ``zero_flow_epe``, ``mean_u``, ``mean_v``, ``iters``,
``precision``, ``ms_per_step`` (median time between consecutive steps' ends:
CUDA events on the card, the host clock on the CPU), ``train_seconds`` and
the device's name.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from unopticalflow_tpu_torch.benchmarks import StepClock, device_name
from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, inference_flow
from unopticalflow_tpu_torch.training import make_optimizer, train_step
from unopticalflow_tpu_torch.utils.device import resolve_device, set_float32_precision

WEIGHTS = {"loss_pixel": 0.15, "loss_ssim": 0.85, "loss_flow_smooth": 10.0,
           "loss_flow_consis": 0.01}
BORDER = 8  # rows and columns left out of the EPE, besides the shift's columns


def make_batch(rng, batch, h, w, shift=3):
    """Smooth random textures; frames translate rightward by ``shift`` px."""
    big = rng.rand(batch, h + 2, w + 2 * shift + 2, 3).astype(np.float32)
    for _ in range(3):  # smooth so photometric gradients are informative
        big = (
            big
            + np.roll(big, 1, 1) + np.roll(big, -1, 1)
            + np.roll(big, 1, 2) + np.roll(big, -1, 2)
        ) / 5.0
    big = big[:, 1:-1, 1:-1]
    f0 = big[:, :, 2 * shift:]
    f1 = big[:, :, shift:shift + w]
    f2 = big[:, :, :w]
    return np.concatenate([f0, f1, f2], axis=1), float(shift)


def run(iters: int = 600, batch: int = 4, hw=(64, 128), shift: int = 3, lr: float = 1e-4,
        bf16: bool = False, device: str = "cuda", seed: int = 0) -> dict:
    """Train ``iters`` steps, then score ``inference_flow`` on a fresh batch."""
    device = resolve_device(device)
    prec = "bfloat16" if bf16 else "float32"
    set_float32_precision(device, prec)
    cfg = FlowModelConfig(num_scales=3, compute_dtype=prec, loss_dtype=prec)
    model = FlowModel(cfg, device=device, scheme="torch",
                      generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer(model, lr)
    h, w = hw
    rng = np.random.RandomState(seed)
    clock = StepClock(device)
    t0 = time.perf_counter()
    for it in range(iters):
        snippets, _ = make_batch(rng, batch, h, w, shift)
        m = train_step(model, opt, torch.from_numpy(snippets).to(device), WEIGHTS, cfg)
        clock.mark()
        if it % 100 == 0 or it == iters - 1:
            print(f"iter {it}: total {float(m['loss_total']):.4f} "
                  f"pixel {float(m['loss_pixel']):.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    ms_per_step = clock.median_ms()
    train_seconds = time.perf_counter() - t0

    # the centre frame's content sits ``shift`` columns to the right in the
    # next frame, so inference_flow(centre, next) should be (+shift, 0)
    snippets, shift_px = make_batch(rng, batch, h, w, shift)
    x = torch.from_numpy(snippets).to(device)
    with torch.no_grad():
        flow = inference_flow(model, x[:, h:2 * h], x[:, 2 * h:]).cpu().numpy()
    interior = flow[:, BORDER:-BORDER, BORDER + shift:-BORDER - shift]
    epe = float(np.sqrt((interior[..., 0] - shift_px) ** 2 + interior[..., 1] ** 2).mean())
    mean_u, mean_v = float(interior[..., 0].mean()), float(interior[..., 1].mean())
    print(f"EPE vs known ({shift_px}, 0) flow: {epe:.3f} px "
          f"(mean u={mean_u:.3f}, v={mean_v:.3f})", flush=True)
    return {"epe": epe, "zero_flow_epe": shift_px, "mean_u": mean_u, "mean_v": mean_v,
            "iters": iters, "precision": prec, "ms_per_step": ms_per_step,
            "train_seconds": train_seconds, "device": device_name(device)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="learn a known constant flow from scratch")
    p.add_argument("--iters", type=int, default=600)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--hw", type=int, nargs=2, default=(64, 128))
    p.add_argument("--shift", type=int, default=3)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 convolutions, cost volume and loss stack")
    p.add_argument("--device", default="cuda", help="cuda (raises without a GPU) or cpu")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    res = run(iters=args.iters, batch=args.batch, hw=tuple(args.hw), shift=args.shift,
              lr=args.lr, bf16=args.bf16, device=args.device, seed=args.seed)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
