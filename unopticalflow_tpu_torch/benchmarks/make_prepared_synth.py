"""Write a KITTI-style prepared directory from the synthetic generator.

The port's counterpart of ``benchmarks/make_prepared_synth.py``: N stacked
(3H, W, 3) uint8 PNG snippets in the layout that ``data/preparers.py``
writes and ``data.KITTI_Prepared`` reads, ``2011_09_26/drive_0001/%010d.png``,
with ``2011_09_26/calib_cam_to_cam.txt`` (one ``P_rect_02`` line) and
``train.txt``.  The trainer then runs from it at production shape with no
dataset on disk (the whole host pipeline: PNG decode, resize, flip, batch,
copy to the device):

    python -m unopticalflow_tpu_torch.benchmarks.make_prepared_synth --out /tmp/prep832 \
        --n 200 --hw 256 832
    # a yaml with prepared_base_dir: /tmp, and --prepared_save_dir prep832
    python -m unopticalflow_tpu_torch.train -c cfg.yaml --prepared_save_dir prep832 ...

Snippets come from ``synthetic_epe.make_snippet`` on ``RandomState(--seed)``,
quantised as ``clip(img * 255 + 0.5, 0, 255)``; the PNGs hold the same
pixels as the JAX tool's (which PIL writes in RGB order), written by the
port's encoder (``utils/imageio.py``, cv2's BGR convention).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from unopticalflow_tpu_torch.benchmarks.synthetic_epe import make_snippet
from unopticalflow_tpu_torch.utils import imageio

DRIVE = os.path.join("2011_09_26", "drive_0001")
CALIB = os.path.join("2011_09_26", "calib_cam_to_cam.txt")
# fx 0 cx 0 / 0 fy cy 0 / 0 0 1 0, shaped as the P_rect_02 lines the preparers write
P_RECT_02 = "P_rect_02: 700.0 0.0 416.0 0.0 0.0 700.0 128.0 0.0 0.0 0.0 1.0 0.0\n"


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="a prepared KITTI-style tree of synthetic snippets")
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--hw", type=int, nargs=2, default=(256, 832))
    p.add_argument("--max-bg", type=int, default=16)
    p.add_argument("--max-fg", type=int, default=32)
    p.add_argument("--tex-power", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    return p


def write_tree(out: str, n: int, hw, max_bg: int = 16, max_fg: int = 32,
               tex_power: float = 1.0, seed: int = 0, progress=None) -> str:
    """Write the tree under ``out`` (see the module); returns ``out``."""
    h, w = hw
    os.makedirs(os.path.join(out, DRIVE), exist_ok=True)
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        stacked, _, _ = make_snippet(rng, h, w, max_bg=max_bg, max_fg=max_fg,
                                     tex_power=tex_power)
        u8 = np.clip(stacked * 255.0 + 0.5, 0, 255).astype(np.uint8)
        name = f"{i:010d}.png"
        # the encoder takes cv2's BGR order: reversed, the file holds u8 as RGB
        imageio.imwrite(os.path.join(out, DRIVE, name), np.ascontiguousarray(u8[..., ::-1]))
        lines.append(f"2011_09_26/drive_0001/{name} 2011_09_26/calib_cam_to_cam.txt\n")
        if progress is not None:
            progress(i)
    with open(os.path.join(out, CALIB), "w") as f:
        f.write(P_RECT_02)
    with open(os.path.join(out, "train.txt"), "w") as f:
        f.writelines(lines)
    return out


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    def progress(i):
        if (i + 1) % 25 == 0:
            print(f"{i + 1}/{args.n}", flush=True)

    write_tree(args.out, args.n, args.hw, args.max_bg, args.max_fg, args.tex_power,
               args.seed, progress)
    print("done:", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
