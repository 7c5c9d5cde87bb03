"""Evaluation entry point of the port: KITTI flow metrics (``--task kitti_flow``).

    python -m unopticalflow_tpu_torch.test -c config/kitti.yaml --mode flow \
        --task kitti_flow --pretrained_model model.pth [--precision float32] \
        [--device cuda]

Port of the root ``test.py`` for ``--mode flow --task kitti_flow`` (same
flags).  Pairs go through ``inference_flow`` in fixed batches of 8 on the
device (5 correlation kernels per batch); the metrics are
``evaluation.eval_flow_avg``'s, against the ground truth of ``gt_2015_dir``.
``test_kitti_2012``/``test_kitti_2015`` are also the trainer's interleaved
evaluation.

Not here yet: ``--task sintel_flow``, ``demo``, ``export_pth`` and
``kitti_odo`` (and ``--mode flowposenet``), which wait for later slices of
the port.
"""

from __future__ import annotations

import argparse
import os
from typing import NamedTuple

import numpy as np
import torch

from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, inference_flow
from unopticalflow_tpu_torch.utils.device import gpu_device, resolve_device, set_float32_precision

LATER_TASKS = {
    "sintel_flow": "the Sintel evaluation slice",
    "demo": "the demo slice (VisualizerDebug)",
    "export_pth": "the checkpoint slice (the flax .ckpt reader)",
    "kitti_odo": "the flowposenet slice",
}


class EvalSet(NamedTuple):
    """One benchmark's evaluation data, as ``test_kitti_*`` takes it.

    ``pairs``: anything with ``__len__`` and ``__getitem__`` giving (2H, W,
    3) float32 pair stacks in [0, 1] at the network's ``img_hw``;
    ``gt_flows``: (h, w, 3) [u, v, valid]; ``noc_masks``: (h, w);
    ``moving_masks``: (h, w) object maps, KITTI 2015 only.
    """

    pairs: object
    gt_flows: list
    noc_masks: list
    moving_masks: list | None = None


def make_infer(model: FlowModel):
    """(B, H, W, 3) x 2 device tensors -> (B, H, W, 2) flow, without autograd."""

    def infer(img1, img2):
        with torch.inference_mode():
            return inference_flow(model, img1, img2)

    return infer


def _batched_flows(infer_fn, stacks_iter, n: int, device, batch: int = 8) -> list:
    """All ``n`` pair flows, as (H, W, 2) float32 tensors on ``device``.

    Chunks of ``batch`` pairs share one call of a single shape: the last
    chunk pads by repeating its last pair and drops the extras.
    """
    it = iter(stacks_iter)
    flows = []
    done = 0
    while done < n:
        stacks = [np.asarray(next(it), dtype=np.float32) for _ in range(min(batch, n - done))]
        k = len(stacks)
        if k < batch:
            stacks += [stacks[-1]] * (batch - k)
        arr = torch.from_numpy(np.stack(stacks)).to(device)  # (batch, 2H, W, 3)
        img_h = arr.shape[1] // 2
        out = infer_fn(arr[:, :img_h], arr[:, img_h:])
        flows.extend(out[:k].unbind(0))
        done += k
    return flows


def _evaluate(name, cfg, infer_fn, data: EvalSet, device) -> str:
    from unopticalflow_tpu_torch.evaluation import eval_flow_avg

    pairs = data.pairs
    flow_list = _batched_flows(infer_fn, (pairs[i] for i in range(len(pairs))), len(pairs),
                               device)
    res = eval_flow_avg(data.gt_flows, data.noc_masks, flow_list, cfg,
                        moving_masks=data.moving_masks)
    print(f"CONFIG: {getattr(cfg, 'config_file', None)}, mode: {cfg.mode}")
    print(f"[EVAL] [{name}]")
    print(res)
    return res


def load_kitti_2012(cfg) -> EvalSet:
    from unopticalflow_tpu_torch.data import KITTI_2012
    from unopticalflow_tpu_torch.evaluation import load_gt_flow_kitti

    gt_flows, noc_masks = load_gt_flow_kitti(cfg.gt_2012_dir, "kitti_2012")
    return EvalSet(KITTI_2012(cfg.gt_2012_dir, img_hw=cfg.img_hw), gt_flows, noc_masks)


def load_kitti_2015(cfg) -> EvalSet:
    from unopticalflow_tpu_torch.data import KITTI_2015
    from unopticalflow_tpu_torch.evaluation import load_gt_flow_kitti, load_gt_mask

    gt_flows, noc_masks = load_gt_flow_kitti(cfg.gt_2015_dir, "kitti_2015")
    return EvalSet(KITTI_2015(cfg.gt_2015_dir, img_hw=cfg.img_hw), gt_flows, noc_masks,
                   load_gt_mask(cfg.gt_2015_dir))


def test_kitti_2012(cfg, infer_fn, data: EvalSet, device) -> str:
    """EPE/outlier evaluation on KITTI 2012 train."""
    return _evaluate("KITTI 2012", cfg, infer_fn, data, device)


def test_kitti_2015(cfg, infer_fn, data: EvalSet, device) -> str:
    """EPE/outlier/moving-static evaluation on KITTI 2015."""
    return _evaluate("KITTI 2015", cfg, infer_fn, data, device)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="flow evaluation (PyTorch/CUDA port)")
    p.add_argument("-c", "--config_file", default=None)
    p.add_argument("--mode", type=str, default="flow")
    p.add_argument("--task", type=str, default="kitti_flow")
    p.add_argument("--pretrained_model", type=str, default=None,
                   help="reference-format .pth (the port's trainer writes them)")
    p.add_argument("--precision", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("-g", "--gpu", type=str, default=None,
                   help="index of the CUDA device (the reference CLI's flag): --device "
                        "cuda becomes cuda:<gpu>.")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (raises without a GPU) or cpu.")
    return p


def main(argv=None) -> str:
    args = build_arg_parser().parse_args(argv)
    if not args.config_file or not os.path.exists(args.config_file):
        raise ValueError("config file not found.")
    if args.mode != "flow":
        raise ValueError(f"--mode {args.mode}: the port evaluates --mode flow only; "
                         "flowposenet is a later slice of the port")
    if args.task in LATER_TASKS:
        raise ValueError(f"--task {args.task} waits for {LATER_TASKS[args.task]} of the port")
    if args.task != "kitti_flow":
        raise ValueError(f"unknown task {args.task!r}")
    from unopticalflow_tpu_torch.utils.checkpoint import load_pretrained
    from unopticalflow_tpu_torch.utils.config import load_yaml_config, merge_cli_args

    cfg = merge_cli_args(load_yaml_config(args.config_file), args)
    device = resolve_device(gpu_device(args.device, args.gpu))
    set_float32_precision(device, args.precision)
    model = FlowModel(FlowModelConfig(compute_dtype=args.precision), device=device)
    if args.pretrained_model:
        load_pretrained(model, args.pretrained_model)
        print("Model Loaded.")
    return test_kitti_2015(cfg, make_infer(model), load_kitti_2015(cfg), device)


if __name__ == "__main__":
    main()
