"""Pre-generate a snippet pool file for ``synthetic_epe --pool N --pool-file F``.

The port's counterpart of ``benchmarks/make_pool.py``: it builds exactly the
array that the port's ``synthetic_epe --pool N --pool-dtype D --pool-file F``
builds with the same generator flags (``synthetic_epe.make_pool_array``: the
host generator, the ``RandomState(0)`` stream, uint8 as ``round(img * 255)``),
so a later run on the card loads it instead of generating it.  Every
generator flag of ``synthetic_epe`` passes through, ``--fg-bias`` included
(the JAX tool has none, so its pool silently lacks a requested bias).
Numpy only: it needs no device.

    python -m unopticalflow_tpu_torch.benchmarks.make_pool --out /tmp/pool.npy \
        --n 6000 --hw 256 832 --max-bg 16 --max-fg 32 --tex-power 1.0
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from unopticalflow_tpu_torch.benchmarks.synthetic_epe import make_pool_array


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="pre-generate a synthetic_epe snippet pool")
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, required=True)
    p.add_argument("--hw", type=int, nargs=2, default=(256, 832))
    p.add_argument("--max-bg", type=int, default=16)
    p.add_argument("--max-fg", type=int, default=32)
    p.add_argument("--tex-power", type=float, default=1.0)
    p.add_argument("--fg-bias", type=float, default=0.0,
                   help="lift the foreground's brightness into [bias, 1], as "
                        "synthetic_epe --fg-bias")
    p.add_argument("--dtype", choices=["float32", "uint8"], default="float32")
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    h, w = args.hw
    gen_kw = dict(max_bg=args.max_bg, max_fg=args.max_fg, tex_power=args.tex_power)
    if args.fg_bias:
        gen_kw["fg_bias"] = args.fg_bias
    t0 = time.time()

    def progress(i):
        if (i + 1) % 500 == 0:
            print(f"{i + 1}/{args.n} ({time.time() - t0:.0f}s)", flush=True)

    # synthetic_epe's pool stream: RandomState(0), drawn before anything else
    pool = make_pool_array(np.random.RandomState(0), args.n, h, w, args.dtype, gen_kw,
                           progress)
    np.save(args.out, pool)
    print(f"wrote {args.out}: {pool.shape} {pool.dtype} "
          f"({pool.nbytes / 1e9:.1f} GB, {time.time() - t0:.0f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
