"""Probe formulations of the warp's row gather on the card.

The port's counterpart of ``benchmarks/gather_probe.py``, with the same
flags, modes and variants written in PyTorch:

  taa            torch.gather of (B, HW, C) rows by the (B, HW, 1) index
  taa_f32        the same in float32
  flat           one index_select over (B*N, C) with batch-offset indices
  taa_pad16      channels zero-padded 12 -> 16 (F.pad)
  taa_pad128     channels zero-padded 12 -> 128
  taa_u32x6      channel pairs viewed as int32: half the elements per row
  flat_u32*      the flat take of those int32 rows: padded to 8 words, split
                 in 2, 4, 8 or 16 takes, or with sorted indices (torch.sort)
  taa_chunk{k}   the gather in k chunks of rows
  row_gather     the hand-written kernel (csrc/gather.cu), in place of the
                 JAX probe's pallas_loop; checked equal to taa first

``--widths``: flat takes of int32 rows 1 to 16 words wide and of a uint8 row
of 12; ``--layout``: row-major against channel-major operands and outputs;
``--diffwarp``: the decoder warp's forward take and its scatter backward
(``index_add_``, ``scatter_add_``), row-major against channel-major.  The
JAX probe's u32 bitcasts are int32 views here (``torch.uint32`` has few CUDA
operations); torch.gather and scatter_add_ take the int64 index they need,
made once outside the timing.

    python -m unopticalflow_tpu_torch.benchmarks.gather_probe [--batch 16] \
        [--hw 256 832] [--ch 12] [--widths | --layout | --diffwarp] \
        [--device cuda] [--iters 30] [--warmup 8]

Each variant's time is the median of ``--iters`` calls after ``--warmup``:
CUDA events on the card, the host clock on the CPU (the JAX probe's
subtraction of a sync's cost was for a remote TPU).  The probe prints the
JAX probe's lines (name, ms, ns per gathered row), then one JSON line with
every variant, the shapes and the device.  A library variant that fails
prints FAIL; the kernel's failure raises.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from unopticalflow_tpu_torch.benchmarks import device_name, time_ms
from unopticalflow_tpu_torch.ops.gather import row_gather
from unopticalflow_tpu_torch.utils.device import resolve_device


def _main_variants(img, idx, b, hw, c, src_n):
    """{name: (fn, args)} of the default mode; every fn returns the gathered rows."""
    dev = img.device
    idx64 = idx.long()
    off = (torch.arange(b, dtype=torch.int32, device=dev) * src_n)[:, None, None]
    w = c // 2  # int32 words per row

    def taa(img, ix):
        return torch.gather(img, 1, ix.expand(-1, -1, img.shape[2]))

    def taa_f32(img, ix):
        return taa(img.float(), ix)

    def flat(img, idx):
        return img.reshape(b * src_n, c).index_select(0, (idx + off).reshape(-1))

    def taa_pad(width):
        return lambda img, ix: taa(F.pad(img, (0, width - c)), ix)

    def words(img):
        return img.view(torch.int32).reshape(b * src_n, w)

    def rows_of(out):
        return out.view(torch.bfloat16).reshape(b, hw, c)

    def flat_u32(img, idx):
        return rows_of(words(img).index_select(0, (idx + off).reshape(-1)))

    def flat_u32_pad8(img, idx):
        u = F.pad(words(img), (0, 8 - w))
        return rows_of(u.index_select(0, (idx + off).reshape(-1))[:, :w])

    def flat_split(k):
        def flat_u32_kx(img, idx):
            fi, fidx = words(img), (idx + off).reshape(-1)
            n = fidx.shape[0] // k
            return rows_of(torch.cat([fi.index_select(0, fidx[i * n:(i + 1) * n])
                                      for i in range(k)]))
        return flat_u32_kx

    def flat_u32_sorted(img, idx):
        # does index order matter at all for the flat take?
        fidx = torch.sort((idx + off).reshape(-1)).values
        return rows_of(words(img).index_select(0, fidx))

    def taa_u32x6(img, ix):
        return rows_of(taa(img.view(torch.int32), ix))

    def chunked(k):
        def taa_chunked(img, ix):
            n = hw // k
            return torch.cat([taa(img, ix[:, i * n:(i + 1) * n]) for i in range(k)], 1)
        return taa_chunked

    variants = {
        "taa": (taa, (img, idx64)),
        "taa_f32": (taa_f32, (img, idx64)),
        "flat": (flat, (img, idx)),
        "taa_pad16": (taa_pad(16), (img, idx64)),
        "taa_pad128": (taa_pad(128), (img, idx64)),
        "taa_u32x6": (taa_u32x6, (img, idx64)),
        "flat_u32": (flat_u32, (img, idx)),
        "flat_u32_pad8": (flat_u32_pad8, (img, idx)),
        "flat_u32_2x": (flat_split(2), (img, idx)),
        "flat_u32_sorted": (flat_u32_sorted, (img, idx)),
    }
    for k in (4, 8, 16):
        variants[f"flat_u32_{k}x"] = (flat_split(k), (img, idx))
    for k in (4, 16):
        variants[f"taa_chunk{k}"] = (chunked(k), (img, idx64))
    return variants


def _diffwarp_variants(rng, dev):
    """Decoder feature-warp geometry, level 2: 2B = 16 images at (64, 208),
    C = 32 features packed 4C = 128 bf16 per row; the forward take and the
    scatter backward, row-major against channel-major."""
    bb, hh, ww, cc = 16, 64, 208, 32
    sn = (hh + 1) * (ww + 1)
    nn = bb * hh * ww

    def put(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return t if dtype is None else t.to(dtype)

    fidx = put((rng.randint(0, sn, (bb, hh * ww)) + (np.arange(bb) * sn)[:, None])
               .reshape(-1).astype(np.int32))
    bidx = put(rng.randint(0, sn, (bb, hh * ww)).astype(np.int32))
    op_rm = put(rng.randn(bb * sn, 4 * cc).astype(np.float32), torch.bfloat16)
    op_cm = put(rng.randn(4 * cc, bb * sn).astype(np.float32), torch.bfloat16)
    g_rm = put(rng.randn(nn, 4 * cc).astype(np.float32), torch.bfloat16)
    g_cm = put(rng.randn(4 * cc, nn).astype(np.float32), torch.bfloat16)
    g_b = g_rm.reshape(bb, hh * ww, 4 * cc)
    bidx64 = bidx.long()[:, :, None].expand(-1, -1, 4 * cc)

    def rm_fwd(op, idx):
        return op.index_select(0, idx)

    def cm_fwd(op, idx):
        return op.index_select(1, idx)

    def rm_bwd_batched(g, idx):  # the take_along_axis adjoint, per image
        return torch.zeros((bb, sn, 4 * cc), dtype=g.dtype, device=dev).scatter_add_(1, idx, g)

    def cm_bwd(g, idx):  # channel-major scatter over the flat source
        return torch.zeros((4 * cc, bb * sn), dtype=g.dtype, device=dev).index_add_(1, idx, g)

    def rm_bwd_flat(g, idx):  # the flat scatter, for reference
        return torch.zeros((bb * sn, 4 * cc), dtype=g.dtype, device=dev).index_add_(0, idx, g)

    variants = {
        "rm_fwd": (rm_fwd, (op_rm, fidx)),
        "cm_fwd": (cm_fwd, (op_cm, fidx)),
        "rm_bwd_batched": (rm_bwd_batched, (g_b, bidx64)),
        "cm_bwd": (cm_bwd, (g_cm, fidx)),
        "rm_bwd_flat": (rm_bwd_flat, (g_rm, fidx)),
    }
    shapes = {"op_rm": [bb * sn, 4 * cc], "op_cm": [4 * cc, bb * sn], "idx": [nn]}
    return variants, nn, shapes, f"rows={nn} ({bb}x{hh}x{ww}, {4 * cc}ch bf16) decoder-warp probe"


def _layout_variants(rng, fidx, n_src):
    """Row-major (R, 6) int32 rows against a channel-major (6, R) operand."""
    op_rm = torch.from_numpy(rng.randint(0, 255, (n_src, 6)).astype(np.int32)).to(fidx.device)
    op_cm = op_rm.T.contiguous()

    def rm_take(op, fidx):
        return op.index_select(0, fidx)

    def cm_take(op, fidx):  # channel-major in and out
        return op.index_select(1, fidx)

    def cm_take_out_t(op, fidx):  # channel-major in, row-major out
        return op.index_select(1, fidx).T.contiguous()

    def rm_take_in_t(op, fidx):  # row-major in, transposed on the card; channel-major out
        return op.T.contiguous().index_select(1, fidx)

    def cm_per_ch(op, fidx):  # one 1-D take per channel
        return torch.stack([op[k].index_select(0, fidx) for k in range(op.shape[0])])

    return {
        "rm_take": (rm_take, (op_rm, fidx)),
        "cm_take": (cm_take, (op_cm, fidx)),
        "cm_take_out_t": (cm_take_out_t, (op_cm, fidx)),
        "rm_take_in_t": (rm_take_in_t, (op_rm, fidx)),
        "cm_per_ch": (cm_per_ch, (op_cm, fidx)),
    }


def _width_variants(rng, fidx, n_src):
    """Flat takes of int32 rows k words wide, and a uint8 row of 12 (the
    bytes of 3 words): is the take bound by its indices or its bytes?"""
    def take(op, fidx):
        return op.index_select(0, fidx)

    variants = {}
    for k in (1, 2, 3, 4, 6, 8, 16):
        op = torch.from_numpy(rng.randint(0, 255, (n_src, k)).astype(np.int32)).to(fidx.device)
        variants[f"flat_u32_w{k}"] = (take, (op, fidx))
    op8 = torch.from_numpy(rng.randint(0, 255, (n_src, 12)).astype(np.uint8)).to(fidx.device)
    variants["flat_u8_w12"] = (take, (op8, fidx))
    return variants


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="time formulations of the warp's row gather")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--hw", type=int, nargs=2, default=(256, 832))
    p.add_argument("--ch", type=int, default=12)
    p.add_argument("--widths", action="store_true",
                   help="row-width sweep of the flat int32 take only")
    p.add_argument("--layout", action="store_true",
                   help="channel-major operand/output layout probe")
    p.add_argument("--diffwarp", action="store_true",
                   help="decoder-warp geometry: fwd gather + scatter backward in "
                        "row-major vs channel-major layout (wide bf16 rows)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--warmup", type=int, default=8)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    b = args.batch
    h, w = args.hw
    c = args.ch
    hw = h * w
    src_n = (h + 1) * (w + 1)
    n_rows = b * hw
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.rand(b, src_n, c).astype(np.float32)).to(device, torch.bfloat16)
    idx = torch.from_numpy(rng.randint(0, src_n, (b, hw, 1)).astype(np.int32)).to(device)
    shapes = {"img": [b, src_n, c], "idx": [b, hw, 1]}

    kernel = None
    if args.diffwarp:
        mode = "diffwarp"
        variants, n_rows, shapes, header = _diffwarp_variants(rng, device)
    else:
        off = (torch.arange(b, dtype=torch.int32, device=device) * src_n)[:, None, None]
        fidx = (idx + off).reshape(-1)
        if args.layout:
            mode, header = "layout", f"rows={n_rows} ({b}x{h}x{w}) layout probe (w6 u32)"
            variants = _layout_variants(rng, fidx, b * src_n)
        elif args.widths:
            mode, header = "widths", f"rows={n_rows} ({b}x{h}x{w}) width sweep"
            variants = _width_variants(rng, fidx, b * src_n)
        else:
            mode, header = "default", f"rows={n_rows} ({b}x{h}x{w}, {c}ch)"
            variants = _main_variants(img, idx, b, hw, c, src_n)
            kernel = (row_gather, (img, idx))

    results = {}
    for name, (fn, fn_args) in variants.items():
        try:
            results[name] = time_ms(fn, fn_args, device, args.iters, args.warmup)
        except Exception as e:  # noqa: BLE001 -- a library variant may fail, as in JAX
            results[name] = f"FAIL {type(e).__name__}: {str(e)[:160]}"
    if kernel is not None:
        fn, fn_args = kernel
        taa, taa_args = variants["taa"]
        if not torch.equal(fn(*fn_args), taa(*taa_args)):
            raise AssertionError("row_gather differs from torch.gather")
        results["row_gather"] = time_ms(fn, fn_args, device, args.iters, args.warmup)

    print(header)
    for k, v in results.items():
        if isinstance(v, float):
            print(f"  {k:16s} {v:9.4f} ms   {v * 1e6 / n_rows:7.3f} ns/row")
        else:
            print(f"  {k:16s} {v}")
    print(json.dumps({
        "probe": "gather_probe", "mode": mode, "device": device_name(device),
        "rows": n_rows, "shapes": shapes, "iters": args.iters, "warmup": args.warmup,
        "results": {k: ({"ms": v, "ns_per_row": v * 1e6 / n_rows} if isinstance(v, float)
                        else v) for k, v in results.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
