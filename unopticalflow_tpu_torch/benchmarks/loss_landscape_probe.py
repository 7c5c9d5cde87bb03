"""Loss-landscape probe: the unsupervised loss stack at flow = alpha x the
true flow (an alpha sweep) and at a constant flow (c, 0), without the network.

The port's counterpart of ``benchmarks/loss_landscape_probe.py`` (which
computes at import with its sizes as constants; here they are ``run``'s
arguments, the JAX constants by default: 128x256, batch 8, the snippets of
``RandomState(5)`` at max_bg 8, max_fg 16, tex_power 1.0, 3 scales).  If the
objective is least near alpha = 1 with a clean descent from 0, the loss
rewards the true flow and a failure to learn is the optimisation's; if it
is flat or prefers alpha = 0, the objective cannot learn on this texture.

Each point packs the flows [bwd; fwd] = [-f; f] at every scale (f
subsampled and scaled), as the 3-frame training forward does, and sums over
the scales the port's terms: the photometric pack (``ops/photometric.py``:
warp, occlusion weights, masked L1 and SSIM; on the card the photometric
kernels, ``photo_fn`` to replace them) and the second-order smoothness of
``models/losses.py`` over ``ops/pyramid.py``'s pyramids.  ``total`` is
0.15 pixel + 0.85 ssim + 10 smooth.

    python -m unopticalflow_tpu_torch.benchmarks.loss_landscape_probe [--hw 128 256] \
        [--batch 8] [--seed 5] [--dtype float32] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from unopticalflow_tpu_torch.benchmarks.synthetic_epe import make_batch
from unopticalflow_tpu_torch.models import losses
from unopticalflow_tpu_torch.ops.photometric import photometric_pack
from unopticalflow_tpu_torch.ops.pyramid import avg_pool_pyramid
from unopticalflow_tpu_torch.utils.device import resolve_device

NS = 3  # loss scales
ALPHAS = (0.0, 0.25, 0.5, 0.75, 0.9, 1.0, 1.1, 1.25)
CONSTANTS = (-2.0, -1.0, 0.0, 1.0, 2.0)
GEN_KW = dict(max_bg=8, max_fg=16, tex_power=1.0)


def loss_at(frames, flow_fwd: torch.Tensor, photo_fn=photometric_pack, w_pixel: float = 0.15,
            w_ssim: float = 0.85, w_smooth: float = 10.0) -> dict:
    """The terms at ``flow_fwd`` (B, 2, H, W) float32, the backward flow its
    negative; ``frames`` = (imgl, img, imgr), each (B, 3, H, W)."""
    imgl, img, imgr = frames
    b = img.shape[0]
    pyr_c = avg_pool_pyramid(img, NS)
    pyr_lr = avg_pool_pyramid(torch.cat([imgl, imgr], 0), NS)
    pixel = ssim = 0.0
    flows = []
    for s in range(NS):
        f_s = (flow_fwd[:, :, ::2**s, ::2**s] / (2**s)).contiguous()
        flows.append(torch.cat([-f_s, f_s], 0))
        out = photo_fn(pyr_lr[s][:b], pyr_lr[s][b:], -f_s, f_s, pyr_c[s])
        hw = pyr_c[s].shape[2] * pyr_c[s].shape[3]
        mean_w = out["s_w"] / hw + losses.EPS_DIV
        pixel = pixel + (out["s_dw"] / hw) / mean_w
        ssim = ssim + (out["s_cl"] / hw) / mean_w
    smooth = losses.flow_smooth_loss(flows, pyr_c, NS)
    r = {name: float((v[:b] + v[b:]).mean())
         for name, v in (("pixel", pixel), ("ssim", ssim), ("smooth", smooth))}
    r["total"] = w_pixel * r["pixel"] + w_ssim * r["ssim"] + w_smooth * r["smooth"]
    return r


def run(hw=(128, 256), batch: int = 8, seed: int = 5, device="cpu", dtype: str = "float32",
        photo_fn=photometric_pack, verbose: bool = True) -> dict:
    """Both sweeps on ``batch`` snippets of ``RandomState(seed)``, the images
    in ``dtype``: {"alpha": [{a, total, pixel, ssim, smooth}], "constant":
    [{c, ...}]}."""
    h, w = hw
    stacked, gt, _ = make_batch(np.random.RandomState(seed), batch, h, w, **GEN_KW)
    x = torch.from_numpy(stacked).to(device).permute(0, 3, 1, 2).to(getattr(torch, dtype))
    frames = tuple(x[:, :, i * h:(i + 1) * h].contiguous() for i in range(3))
    gt = torch.from_numpy(gt).to(device).permute(0, 3, 1, 2).contiguous()
    out = {"alpha": [], "constant": []}
    if verbose:
        print("alpha sweep (flow = alpha * gt):")
    for a in ALPHAS:
        r = loss_at(frames, a * gt, photo_fn)
        out["alpha"].append({"a": a, **r})
        if verbose:
            print(f"  a={a:4.2f}  total {r['total']:.4f}  pixel {r['pixel']:.4f} "
                  f"ssim {r['ssim']:.4f}  smooth {r['smooth']:.5f}")
    if verbose:
        print("constant-flow sweep (flow = (c, 0)):")
    for c in CONSTANTS:
        f = torch.zeros_like(gt)
        f[:, 0] = c
        r = loss_at(frames, f, photo_fn)
        out["constant"].append({"c": c, **r})
        if verbose:
            print(f"  c={c:4.1f}  total {r['total']:.4f}  pixel {r['pixel']:.4f} "
                  f"ssim {r['ssim']:.4f}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the loss stack along flow sweeps")
    p.add_argument("--hw", type=int, nargs=2, default=(128, 256))
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                   help="the images' dtype (the loss stack's)")
    p.add_argument("--device", default="cuda", help="cuda (raises without a GPU) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print(json.dumps(run(tuple(args.hw), args.batch, args.seed, device, args.dtype)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
