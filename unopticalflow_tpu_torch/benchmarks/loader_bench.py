"""Host input-pipeline throughput: can the loader feed the device?

The port's counterpart of ``benchmarks/loader_bench.py``.  Every training
snippet comes off disk as a stacked 3-frame PNG at raw KITTI resolution and
is decoded, split, resized to 256x832, flipped and normalised
(``data/datasets.py``); a device that steps faster than the host decodes
waits for it.  This measures what the host sustains:

  * ``BatchLoader``'s thread-pool decode at 1 and 4 workers,
  * the ``--cache_decoded`` path (decoded, resized uint8 ``.npy``, mmap
    reads): the fill pass (each source decoded once) and then warm,
  * the warm cache emitting uint8 (the trainer's default: the /255 cast
    runs on the device),

against the device's rate.  The JAX tool's default rate is a TPU's; the
port has none: unless ``--device-rate`` is given, it measures the card's
rate itself with one short bfloat16 run of ``make_multi_train_step`` at
K = 8 (a CUDA graph of the KITTI-recipe step) at ``--batch``, and the JSON
says which (``device_rate_source``).

It builds its own prepared directory at raw KITTI scale (textured frames, so
that a PNG costs what a real one does), with the port's PNG encoder, and
prints one JSON line.

    python -m unopticalflow_tpu_torch.benchmarks.loader_bench [--snippets 48] \
        [--batches 30] [--device-rate R]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from unopticalflow_tpu_torch.benchmarks import device_name, last_loss, recipe_step
from unopticalflow_tpu_torch.benchmarks.synthetic_epe import _texture
from unopticalflow_tpu_torch.data.datasets import KITTI_Prepared
from unopticalflow_tpu_torch.data.loader import BatchLoader
from unopticalflow_tpu_torch.utils import imageio
from unopticalflow_tpu_torch.utils.device import resolve_device

RAW_H, RAW_W = 370, 1226  # KITTI raw camera frames (rounded)
IMG_HW = (256, 832)  # config/kitti.yaml
RATE_K = 8  # the device rate's steps a dispatch
RATE_DISPATCHES = 3  # timed dispatches of the device rate, after the eager one and the capture


def build_prepared_dir(root: str, n: int) -> str:
    """A prepared dir of ``n`` stacked (3 * RAW_H, RAW_W) textured PNGs."""
    drive = os.path.join(root, "2011_09_26", "drive_0001")
    os.makedirs(drive, exist_ok=True)
    rng = np.random.RandomState(0)
    lines = []
    for i in range(n):
        tex = _texture(rng, 3 * RAW_H, RAW_W, octaves=6)
        img = np.round(tex * 255.0).astype(np.uint8)
        name = f"{i:010d}.png"
        imageio.imwrite(os.path.join(drive, name), img)
        lines.append(f"2011_09_26/drive_0001/{name} 2011_09_26/calib_cam_to_cam.txt\n")
    with open(os.path.join(root, "2011_09_26", "calib_cam_to_cam.txt"), "w") as f:
        f.write("P_rect_02: 700.0 0.0 600.0 0.0 0.0 700.0 180.0 0.0 0.0 0.0 1.0 0.0\n")
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.writelines(lines)
    return root


def measure(dataset, batch: int, workers: int, n_batches: int) -> float:
    """Sustained snippets/s over ``n_batches`` (after a 2-batch warm-up)."""
    it = iter(BatchLoader(dataset, batch_size=batch, num_workers=workers))
    for _ in range(2):
        next(it)
    t0 = time.perf_counter()
    done = 0
    for _ in range(n_batches):
        b = next(it)
        done += (b[0] if isinstance(b, tuple) else b).shape[0]
    dt = time.perf_counter() - t0
    it.close()  # stops the producer thread
    return done / dt


def measure_device_rate(device: torch.device, batch: int, seed: int = 0) -> float:
    """The card's training snippets/s: bfloat16, K = 8 steps a dispatch as one
    CUDA graph of the KITTI-recipe step (``make_multi_train_step``) at
    ``batch``, 256x832, on in-memory random images; the median of
    ``RATE_DISPATCHES`` replays after the eager dispatch and the capture."""
    from unopticalflow_tpu_torch.benchmarks import time_ms
    from unopticalflow_tpu_torch.models import FlowModelConfig

    if device.type != "cuda":
        raise ValueError("the device rate is measured on the card: on the CPU give "
                         "--device-rate")
    h, w = IMG_HW
    cfg = FlowModelConfig(compute_dtype="bfloat16", loss_dtype="bfloat16")
    _, _, step = recipe_step(cfg, device, RATE_K, seed)
    imgs = np.random.RandomState(seed).rand(batch, 3 * h, w, 3).astype(np.float32)
    xs = torch.from_numpy(imgs).to(device)[None].expand(RATE_K, *imgs.shape)
    ms = time_ms(lambda: last_loss(step(xs)), (), device, RATE_DISPATCHES, warmup=2)
    return batch / (ms / RATE_K) * 1e3


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="host input pipeline against the device's rate")
    p.add_argument("--snippets", type=int, default=48)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--batches", type=int, default=30)
    p.add_argument("--dir", default=os.path.join(tempfile.gettempdir(), "unflow_loader_bench"))
    p.add_argument("--device-rate", type=float, default=None,
                   help="device snippets/s to compare against (default: measured on the "
                        "card, bfloat16 K = 8 graph at --batch)")
    p.add_argument("--device", default="cuda",
                   help="where the device rate is measured: cuda (raises without a GPU); "
                        "with cpu give --device-rate")
    return p


def run(args) -> dict:
    device = resolve_device(args.device)
    if args.device_rate is None and device.type != "cuda":
        raise SystemExit("--device cpu: give --device-rate (the device rate is measured "
                         "on the card)")
    if not os.path.exists(os.path.join(args.dir, "train.txt")):
        print(f"building {args.snippets}-snippet prepared dir (raw KITTI scale) ...",
              flush=True)
        build_prepared_dir(args.dir, args.snippets)

    n_samples = (args.batches + 4) * args.batch  # len(ds) = num_iterations
    cache_dir = os.path.join(args.dir, f"decoded_cache_{IMG_HW[0]}x{IMG_HW[1]}")

    def make(cache, u8=False):
        return KITTI_Prepared(args.dir, img_hw=IMG_HW, num_iterations=n_samples,
                              cache_dir=cache_dir if cache else None, emit_uint8=u8)

    res = {
        "benchmark": "host input pipeline (stacked-PNG decode -> 256x832)",
        "host_cpus": os.cpu_count(),
        "raw_frame_hw": [RAW_H, RAW_W],
        "batch": args.batch,
    }
    res["decode_w1_snippets_per_s"] = round(measure(make(False), args.batch, 1, args.batches), 1)
    res["decode_w4_snippets_per_s"] = round(measure(make(False), args.batch, 4, args.batches), 1)
    # the cache's fill pass (each source decoded once), then the mmap path
    ds = make(True)
    t0 = time.perf_counter()
    for i in range(ds.count()):
        ds._resized_uint8(i)
    fill_s = time.perf_counter() - t0
    res["cache_fill_s"] = round(fill_s, 1)
    res["cache_fill_snippets_per_s"] = round(ds.count() / fill_s, 1)
    res["cached_w4_snippets_per_s"] = round(measure(make(True), args.batch, 4, args.batches), 1)
    # uint8 emission (the trainer's): the /255 cast runs on the device
    # (training/train_step.py::loss_fn), so the host touches 4x fewer bytes
    res["cached_w4_uint8_snippets_per_s"] = round(
        measure(make(True, u8=True), args.batch, 4, args.batches), 1)
    if args.device_rate is None:
        rate = measure_device_rate(device, args.batch)
        res["device_rate_source"] = (f"measured: bfloat16 K = {RATE_K} CUDA graph of the "
                                     f"KITTI-recipe step, batch {args.batch}, on "
                                     f"{device_name(device)}")
    else:
        rate = args.device_rate
        res["device_rate_source"] = "--device-rate"
    res["device_rate_snippets_per_s"] = round(rate, 1)
    best = max(res["decode_w4_snippets_per_s"], res["cached_w4_snippets_per_s"],
               res["cached_w4_uint8_snippets_per_s"])
    res["sustains_device_rate"] = bool(best >= rate)
    res["recipe_note"] = ("--cache_decoded required on few-core hosts"
                          if res["decode_w4_snippets_per_s"] < rate
                          else "raw decode path sufficient")
    return res


def main(argv=None) -> int:
    print(json.dumps(run(build_arg_parser().parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
