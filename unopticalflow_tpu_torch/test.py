"""Evaluation entry point of the port: KITTI and Sintel flow metrics, the
flow demo, the export to a reference ``.pth``, and KITTI odometry poses.

    python -m unopticalflow_tpu_torch.test -c config/kitti.yaml --mode flow \
        --task kitti_flow --pretrained_model model.pth [--precision float32] \
        [--device cuda]
    ... --task sintel_flow [--sintel_dir <MPI-Sintel training/>]
    ... --task demo --image_path a.png --image_path2 b.png [--result_dir DIR]
    ... --task export_pth --pretrained_model last.ckpt [--output_pth out.pth]
    ... --mode flowposenet --task kitti_odo --seq_dir <sequence with image_2/> \
        [--result_txt poses.txt]

Port of the root ``test.py`` (same flags).  ``--mode flowposenet`` reads a
flow + pose checkpoint: the flow tasks run its flow branch, ``export_pth``
writes the flow branch, and ``kitti_odo`` runs its pose net over a
sequence's consecutive frames (``test_kitti_odo``).
``--pretrained_model`` takes a ``.pth`` or the JAX package's ``.ckpt``.
Pairs go through ``inference_flow`` in fixed batches of 8 on the device (5
correlation kernels per batch); the metrics are
``evaluation.eval_flow_avg``'s, against the ground truth of ``gt_2015_dir``
(``kitti_flow``) or of the Sintel tree's ``clean`` and ``final`` passes
(``sintel_flow``, the yaml's ``sintel_training_dir`` unless
``--sintel_dir``).  ``demo`` writes ``<result_dir>/demo_flow.png``, the
colour wheel of one pair's flow; ``export_pth`` writes the weights as the
reference's ``{"iteration", "model_state_dict"}``.  Frames are read and
resized by ``utils/imageio.py``, as cv2 reads and resizes them: PNG at every
bit depth (with ``tRNS``, an Exif orientation, and an APNG's first frame),
JPEG, BMP, PNM, Sun raster, HDR, TIFF, WebP, JPEG 2000 and GIF; ``kitti_odo``
lists a sequence's ``.png`` and ``.jpg`` frames only, as the JAX package's
``test.py`` lists them.
``test_kitti_2012``/``test_kitti_2015`` are also the trainer's interleaved
evaluation.
"""

from __future__ import annotations

import argparse
import os
from typing import NamedTuple

import numpy as np
import torch

from unopticalflow_tpu_torch.models import (
    FlowModel,
    FlowModelConfig,
    FlowPoseModel,
    inference_flow,
    inference_pose,
)
from unopticalflow_tpu_torch.utils import imageio
from unopticalflow_tpu_torch.utils.device import gpu_device, resolve_device, set_float32_precision

TASKS = ("kitti_flow", "sintel_flow", "demo", "export_pth", "kitti_odo")
MODES = ("flow", "flowposenet")


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


def _first(pairs, limit: int | None):
    """The pair dataset cut to its first ``limit`` frames (all with None)."""
    if limit is not None:
        pairs.data_list = pairs.data_list[:limit]
    return pairs


def load_kitti_2012(cfg, limit: int | None = None) -> EvalSet:
    """KITTI 2012's 194 frames, or the first ``limit`` (a small test tree)."""
    from unopticalflow_tpu_torch.data import KITTI_2012
    from unopticalflow_tpu_torch.evaluation import load_gt_flow_kitti

    gt_flows, noc_masks = load_gt_flow_kitti(cfg.gt_2012_dir, "kitti_2012", num_gt=limit)
    return EvalSet(_first(KITTI_2012(cfg.gt_2012_dir, img_hw=cfg.img_hw), limit), gt_flows,
                   noc_masks)


def load_kitti_2015(cfg, limit: int | None = None) -> EvalSet:
    """KITTI 2015's 200 frames, or the first ``limit``."""
    from unopticalflow_tpu_torch.data import KITTI_2015
    from unopticalflow_tpu_torch.evaluation import load_gt_flow_kitti, load_gt_mask

    gt_flows, noc_masks = load_gt_flow_kitti(cfg.gt_2015_dir, "kitti_2015", num_gt=limit)
    return EvalSet(_first(KITTI_2015(cfg.gt_2015_dir, img_hw=cfg.img_hw), limit), gt_flows,
                   noc_masks, load_gt_mask(cfg.gt_2015_dir, num_gt=limit))


def test_kitti_2012(cfg, infer_fn, data: EvalSet, device) -> str:
    """EPE/outlier evaluation on KITTI 2012 train."""
    return _evaluate("KITTI 2012", cfg, infer_fn, data, device)


def test_kitti_2015(cfg, infer_fn, data: EvalSet, device) -> str:
    """EPE/outlier/moving-static evaluation on KITTI 2015."""
    return _evaluate("KITTI 2015", cfg, infer_fn, data, device)


def read_pair(paths, img_hw) -> np.ndarray:
    """(2H, W, 3) float32 stack in [0, 1] of two frames resized to ``img_hw``."""
    h, w = img_hw
    imgs = []
    for p in paths:
        img = imageio.imread(p)
        if img is None:
            raise FileNotFoundError(p)
        imgs.append(imageio.resize(img, (w, h)).astype(np.float32) / 255.0)
    return np.concatenate(imgs, 0)


def test_sintel_flow(cfg, infer_fn, sintel_dir, device, passes=("clean", "final")) -> dict:
    """EPE evaluation on the MPI-Sintel training set, per render pass."""
    from unopticalflow_tpu_torch.evaluation import eval_flow_avg, load_gt_flow_sintel

    results = {}
    for pass_name in passes:
        gt_flows, noc_masks, pairs = load_gt_flow_sintel(sintel_dir, pass_name)
        if not gt_flows:
            print(f"[EVAL] [SINTEL {pass_name}] no frames found, skipping")
            continue
        flow_list = _batched_flows(infer_fn, (read_pair(p, cfg.img_hw) for p in pairs),
                                   len(pairs), device)
        res = eval_flow_avg(gt_flows, noc_masks, flow_list, cfg)
        print(f"CONFIG: {getattr(cfg, 'config_file', None)}, mode: {cfg.mode}")
        print(f"[EVAL] [SINTEL {pass_name}] ({len(flow_list)} pairs)")
        print(res)
        results[pass_name] = res
    return results


def make_pose_fn(model: FlowPoseModel):
    """(B, H, W, 3) x 2 device tensors -> (B, 6) pose, without autograd."""

    def pose_fn(img1, img2):
        with torch.inference_mode():
            return inference_pose(model, img1, img2)

    return pose_fn


def test_kitti_odo(cfg, pose_fn, seq_dir, result_txt, device) -> str:
    """Pose-net odometry over an image sequence -> a KITTI pose file.

    Consecutive frames (``image_2/`` of ``seq_dir``, else ``seq_dir``;
    sorted ``.png``/``.jpg``) are read and resized to ``img_hw`` as cv2 does; each
    pair's pose (frame t+1's camera into frame t's) becomes [R | t] in
    float32 (``ops/geometry.py::pose_vec2mat``) and is chained in float64
    into camera-to-world matrices, written as 12 numbers a line (the first
    the identity).  Translations are written raw: the monocular scale is one
    global unknown, which ``eval_odom``'s Sim(3) alignment recovers.
    """
    from unopticalflow_tpu_torch.ops.geometry import pose_vec2mat

    img_dir = os.path.join(seq_dir, "image_2")
    if not os.path.isdir(img_dir):
        img_dir = seq_dir
    names = sorted(n for n in os.listdir(img_dir) if n.endswith((".png", ".jpg")))
    if len(names) < 2:
        raise ValueError(f"need >= 2 frames in {img_dir}")
    h, w = cfg.img_hw

    def load(n):
        img = imageio.imread(os.path.join(img_dir, n))
        if img is None:
            raise FileNotFoundError(os.path.join(img_dir, n))
        frame = imageio.resize(img, (w, h)).astype(np.float32)[None] / 255.0
        return torch.from_numpy(frame).to(device)

    t_wc = np.eye(4)
    lines = [" ".join(f"{v:.6e}" for v in t_wc[:3].reshape(-1))]
    prev = load(names[0])
    for n in names[1:]:
        cur = load(n)
        pose = pose_fn(prev, cur).float().cpu()  # (1, 6), cam_cur -> cam_prev
        rel = np.eye(4)
        rel[:3] = pose_vec2mat(pose).numpy()[0]
        t_wc = t_wc @ rel
        lines.append(" ".join(f"{v:.6e}" for v in t_wc[:3].reshape(-1)))
        prev = cur
    os.makedirs(os.path.dirname(os.path.abspath(result_txt)), exist_ok=True)
    with open(result_txt, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"odometry: {len(lines)} poses -> {result_txt}")
    print("evaluate with: python -m unopticalflow_tpu_torch.evaluation.eval_odom "
          f"--gt_txt <gt poses> --result_txt {result_txt}")
    return result_txt


def test_single_pair(cfg, infer_fn, img1_path, img2_path, device, save_dir="./") -> np.ndarray:
    """The flow demo on one pair: saves ``<save_dir>/demo_flow.png`` and
    returns the (H, W, 2) float32 flow."""
    from unopticalflow_tpu_torch.utils.visualizer import VisualizerDebug

    stack = torch.from_numpy(read_pair((img1_path, img2_path), cfg.img_hw)).to(device)
    h = stack.shape[0] // 2
    flow = infer_fn(stack[None, :h], stack[None, h:])[0].cpu().numpy()
    VisualizerDebug(dump_dir=save_dir).save_flow_img(flow, "demo")
    print("Flow prediction saved in " + save_dir)
    return flow


def export_pth(path: str, model: FlowModel, iteration: int = 0) -> str:
    """Write the reference's ``{"iteration", "model_state_dict"}`` (float32, CPU)."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"iteration": int(iteration), "model_state_dict": state}, path)
    return path


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="flow evaluation (PyTorch/CUDA port)")
    p.add_argument("-c", "--config_file", default=None)
    p.add_argument("--mode", type=str, default="flow", help="flow | flowposenet")
    p.add_argument("--task", type=str, default="kitti_flow",
                   help="kitti_flow | sintel_flow | demo (one pair) | export_pth "
                        "(write a reference-loadable .pth) | kitti_odo (flowposenet)")
    p.add_argument("--output_pth", type=str, default=None,
                   help="output path for --task export_pth")
    p.add_argument("--sintel_dir", type=str, default=None,
                   help="MPI-Sintel training/ dir for --task sintel_flow (defaults to "
                        "the yaml's sintel_training_dir)")
    p.add_argument("--seq_dir", type=str, default=None,
                   help="odometry sequence dir (with image_2/) for --task kitti_odo")
    p.add_argument("--result_txt", type=str, default=None,
                   help="output pose file for --task kitti_odo")
    p.add_argument("--image_path", type=str, default=None)
    p.add_argument("--image_path2", type=str, default=None)
    p.add_argument("--result_dir", type=str, default=None)
    p.add_argument("--pretrained_model", type=str, default=None,
                   help="a reference-format .pth or the JAX package's .ckpt")
    p.add_argument("--precision", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("-g", "--gpu", type=str, default=None,
                   help="index of the CUDA device (the reference CLI's flag): --device "
                        "cuda becomes cuda:<gpu>.")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (raises without a GPU) or cpu.")
    return p


def main(argv=None):
    """Run ``--task``; returns its result: the metric string (``kitti_flow``),
    {pass: metric string} (``sintel_flow``), the flow (``demo``) or the
    written path (``export_pth``, ``kitti_odo``)."""
    args = build_arg_parser().parse_args(argv)
    if not args.config_file or not os.path.exists(args.config_file):
        raise ValueError("config file not found.")
    if args.mode not in MODES:
        raise ValueError(f"--mode {args.mode}: the port evaluates --mode {' or '.join(MODES)}")
    if args.task not in TASKS:
        raise ValueError(f"unknown task {args.task!r}")
    if args.task == "kitti_odo" and args.mode != "flowposenet":
        raise ValueError("--task kitti_odo needs --mode flowposenet")
    if args.task == "kitti_odo" and not args.seq_dir:
        raise ValueError("--task kitti_odo needs --seq_dir")
    from unopticalflow_tpu_torch.utils.checkpoint import load_pretrained
    from unopticalflow_tpu_torch.utils.config import load_yaml_config, merge_cli_args

    cfg = merge_cli_args(load_yaml_config(args.config_file), args)
    device = resolve_device(gpu_device(args.device, args.gpu))
    set_float32_precision(device, args.precision)
    flowpose = args.mode == "flowposenet"
    model = (FlowPoseModel if flowpose else FlowModel)(
        FlowModelConfig(compute_dtype=args.precision), device=device)
    flow_model = model.flow if flowpose else model
    iteration = 0
    if args.pretrained_model:
        iteration = load_pretrained(model, args.pretrained_model)
        print("Model Loaded.")

    if args.task == "export_pth":
        out = args.output_pth or os.path.join(args.result_dir or ".", "exported_model.pth")
        export_pth(out, flow_model, iteration)
        print(f"wrote reference-format checkpoint: {out}")
        return out
    if args.task == "kitti_odo":
        out = args.result_txt or os.path.join(args.result_dir or ".", "odometry_result.txt")
        return test_kitti_odo(cfg, make_pose_fn(model), args.seq_dir, out, device)
    infer = make_infer(flow_model)
    if args.task == "kitti_flow":
        return test_kitti_2015(cfg, infer, load_kitti_2015(cfg), device)
    if args.task == "sintel_flow":
        sintel_dir = args.sintel_dir or getattr(cfg, "sintel_training_dir", None)
        if not sintel_dir:
            raise ValueError("--task sintel_flow needs --sintel_dir or a sintel_training_dir "
                             "yaml key")
        return test_sintel_flow(cfg, infer, sintel_dir, device)
    if not (args.image_path and args.image_path2):
        raise ValueError("--task demo needs --image_path and --image_path2")
    return test_single_pair(cfg, infer, args.image_path, args.image_path2, device,
                            save_dir=args.result_dir or "./")


if __name__ == "__main__":
    main()
