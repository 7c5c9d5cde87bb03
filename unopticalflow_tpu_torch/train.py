"""Training entry point of the port: unsupervised flow training (``--mode
flow``) and flow + pose training (``--mode flowposenet``).

    python -m unopticalflow_tpu_torch.train -c config/kitti.yaml --mode flow \
        [--test_interval 2000 | --no_test] [--flow_pretrained_model last.ckpt] \
        [--resume] [--cache_decoded] [--steps_per_dispatch auto] --device cuda
    python -m unopticalflow_tpu_torch.train -c config/odo.yaml --mode flowposenet \
        [--freeze_flow] ...
    python -m unopticalflow_tpu_torch.train -c config/nyu_posenet_192.yaml \
        --mode flowposenet ...

Port of the root ``train.py`` for the flags below (same names and
defaults).  One step is ``training.train_step``: the training forward (5
correlation kernels in the decoder, 3 photometric kernels over the loss
scales, and 3 regularizer kernels with ``use_pallas_reg``), autograd (5 + 5
correlation-backward kernels, 3 photometric and 3 regularizer backward
kernels) and Adam.  ``--mode flowposenet`` trains ``FlowPoseModel``: the
same flow step plus the pose net and ``loss_pose_epipolar`` (plain
convolutions and geometry, no kernel of their own); ``--freeze_flow`` keeps
the flow branch as loaded and skips its backward (5 correlation forwards and
3 photometric forwards a step, no backward kernel).  The 2-frame NYU
snippets (``dataset: nyuv2``) take the 2-frame forward: 5 + 5 + 5
correlation kernels a step and no photometric kernel (the plain losses, as
in the JAX package).  Batches come from ``data.KITTI_Prepared`` (``dataset``
kitti_depth or kitti_odo; with the intrinsics in flowposenet mode) or
``data.SINTEL_Prepared`` (sintel_raw), uint8 and cast on the device, or
``data.NYU_v2`` (nyuv2: undistorted float32 stacks and per-scale
intrinsics, of which the pose branch takes scale 0), through
``BatchLoader`` and ``device_prefetch``.  When the prepared tree has no
``train.txt``, the raw data under ``raw_base_dir`` is prepared first
(``data/preparers.py``; NYU with ``nyu_test_dir``'s split, stride 10).
``--cache_decoded`` keeps decoded, resized frames as ``.npy`` under
``<prepared dir>/decoded_cache_<H>x<W>``, the JAX trainer's directory.

``--steps_per_dispatch K`` (default ``auto``: the largest K in {8, 4, 2, 1}
that divides ``--log_interval``, ``--save_interval``, ``--test_interval``
and ``num_iterations - iter_start``, the JAX trainer's rule; 4 at the
defaults, 100 = 4 x 25) runs K steps a dispatch through
``training.make_multi_train_step`` on K batches stacked on the host
(``data.stack_batches``): on CUDA one
replay of a CUDA graph of the K whole steps (the first dispatch runs them
eagerly, the second captures the graph), Adam in its capturable form; on
the CPU K eager steps.  With K > 1 the three intervals and the iteration
count must be multiples of K, and the loop works a dispatch at a time, as
the JAX trainer's: the evaluation runs at the top of the dispatch whose last
sub-step reaches the test grid (so it sees parameters K - 1 steps staler
than a K = 1 run at the same grid point), the log line shows the first
sub-step, saves and the preemption check fall on dispatch boundaries, and a
save names the dispatch's last sub-step.

Interleaved evaluation (of the flow branch in flowposenet mode): unless
``--no_test``, KITTI 2012 and 2015 (the yaml's ``gt_2012_dir``/
``gt_2015_dir``, read once at start) are evaluated with
``test.test_kitti_2012``/``test_kitti_2015`` at the top of every dispatch
whose count of steps from the start of the run, at its end, is a multiple of
``--test_interval``; the result strings go to ``log.pkl`` as
``eval_2012_res``/``eval_2015_res``.

Checkpoints: ``iter_<n>.pth`` and ``last.pth`` every ``--save_interval``
iterations, and ``last.pth`` at loop exit when ``num_iterations`` is off that
grid, written by ``AsyncCheckpointer`` off the loop's thread (no step is
saved twice).  ``--resume`` restores model, optimizer and iteration from
``iter_<iter_start>.pth`` (or ``last.pth``), or from the JAX trainer's
``iter_<iter_start>.ckpt`` (``last.ckpt``) where the model dir holds only
that, and restarts at the stored iteration; a checkpoint saved under the
other ``--freeze_flow`` is refused.  ``--flow_pretrained_model``
warm-starts the flow weights from a ``.pth`` or a JAX ``.ckpt`` (in
flowposenet mode the flow branch only; the pose net keeps its init).
SIGTERM or SIGINT: the step (the dispatch) in flight finishes, the last
finished iteration is saved, the saver drains and ``main`` returns 0; a second signal meets the
handler that was there before.  Log lines are the JAX trainer's ``iter: N,
loss_pixel: ...``, with ``snippets_per_sec`` between log points.

The port runs one device: the JAX trainer's ``--multi_gpu`` and
``--multi_host`` are not taken.
"""

from __future__ import annotations

import argparse
import os
import pickle
import shutil
import signal
import sys
import time
import traceback
import types
from typing import NamedTuple

import torch

from unopticalflow_tpu_torch.data import (
    BatchLoader,
    KITTI_Prepared,
    NYU_v2,
    SINTEL_Prepared,
    device_prefetch,
    stack_batches,
)
from unopticalflow_tpu_torch.models.flow_model import FlowModel, FlowModelConfig
from unopticalflow_tpu_torch.models.flowpose_model import FlowPoseModel
from unopticalflow_tpu_torch.test import (
    load_kitti_2012,
    load_kitti_2015,
    make_infer,
    test_kitti_2012,
    test_kitti_2015,
)
from unopticalflow_tpu_torch.training import (
    loss_weights_from_config,
    make_multi_train_step,
    make_optimizer,
    set_capturable,
    train_step,
)
from unopticalflow_tpu_torch.utils import checkpoint as ckpt
from unopticalflow_tpu_torch.utils.device import gpu_device, resolve_device, set_float32_precision
from unopticalflow_tpu_torch.utils.visualizer import Visualizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the prepared datasets by the yaml's ``dataset`` (the JAX trainer's choice;
# sintel_raw is evaluated on KITTI while it trains, as there; nyuv2 is the
# 2-frame one)
PREPARED = {"kitti_depth": KITTI_Prepared, "kitti_odo": KITTI_Prepared,
            "sintel_raw": SINTEL_Prepared, "nyuv2": NYU_v2}
MODES = ("flow", "flowposenet")


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="unsupervised flow training (PyTorch/CUDA port)")
    p.add_argument("-c", "--config_file", default=None, help="config file.")
    p.add_argument("--mode", type=str, default="flow", help="flow | flowposenet")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--iter_start", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--log_interval", type=int, default=100)
    p.add_argument("--save_interval", type=int, default=2000)
    p.add_argument("--test_interval", type=int, default=2000)
    p.add_argument("--model_dir", type=str, default=None)
    p.add_argument("--prepared_save_dir", type=str, default="data_s1")
    p.add_argument("--flow_pretrained_model", type=str, default=None,
                   help="warm start: a .pth or the JAX package's .ckpt")
    p.add_argument("--depth_pretrained_model", type=str, default=None,
                   help="accepted and ignored, as the JAX trainer does: no mode of "
                        "either package trains or loads a depth net")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--freeze_flow", action="store_true",
                   help="flowposenet: train only the pose branch (the flow branch stays "
                        "as loaded, e.g. from --flow_pretrained_model).")
    p.add_argument("--no_test", action="store_true")
    p.add_argument("--precision", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype of the convolutions and the cost volume, and "
                        "the loss stack's unless --loss_precision says otherwise.")
    p.add_argument("--loss_precision", type=str, default=None,
                   choices=["float32", "bfloat16"],
                   help="dtype of the image-space loss stack.")
    p.add_argument("--steps_per_dispatch", default="auto",
                   help="K optimizer steps per dispatch (on CUDA one replay of a CUDA graph "
                        "of the K steps): the log, save and test intervals and the "
                        "iteration count must be multiples of K.  'auto' picks the "
                        "largest K in {8,4,2,1} dividing every one.  Interleaved eval "
                        "at K>1 sees params K-1 steps staler than a K=1 run at the "
                        "same grid point.")
    p.add_argument("--cache_decoded", action="store_true",
                   help="cache decoded and resized frames as uint8 .npy under the "
                        "prepared dir.")
    p.add_argument("--init_scheme", type=str, default="torch", choices=["torch", "pwc"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-g", "--gpu", type=str, default=None,
                   help="index of the CUDA device (the reference CLI's flag): --device "
                        "cuda becomes cuda:<gpu>.")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (raises without a GPU) or cpu.")
    return p


def recipe_config(**over) -> types.SimpleNamespace:
    """The KITTI recipe as ``main`` would merge it, for callers without yaml.

    ``config/kitti.yaml``: img_hw [256, 832], num_scales 3, w_ssim 0.85,
    w_flow_smooth 10.0, w_flow_consis 0.01; the flags at their defaults
    (batch 8, lr 1e-4, float32), with ``--no_test``.  ``over`` replaces any
    of them.
    """
    cfg = vars(build_arg_parser().parse_args(["--no_test"]))
    cfg.update(dataset="kitti_depth", num_scales=3, img_hw=(256, 832), num_iterations=200000,
               w_ssim=0.85, w_flow_smooth=10.0, w_flow_consis=0.01, log_dump_dir=None)
    cfg.update(over)
    return types.SimpleNamespace(**cfg)


class TrainResult(NamedTuple):
    model: FlowModel | FlowPoseModel
    optimizer: torch.optim.Optimizer
    step: int  # iterations done, counting those before a resume


def _get(cfg, key, default=None):
    return getattr(cfg, key, default)


def _load_eval_sets(cfg) -> dict:
    """KITTI 2012 and 2015 evaluation sets from the yaml's ground-truth dirs."""
    for key in ("gt_2012_dir", "gt_2015_dir"):
        path = _get(cfg, key)
        if not path or not os.path.isdir(path):
            raise FileNotFoundError(
                f"{key}={path!r} is not a directory: the interleaved KITTI evaluation "
                "needs the 2012 and 2015 ground truth (pass --no_test to train without it)"
            )
    return {"2012": load_kitti_2012(cfg), "2015": load_kitti_2015(cfg)}


class StopOnSignal:
    """SIGTERM and SIGINT handlers for a graceful stop (main thread only).

    The first signal sets ``signum`` and puts the handlers that were there
    before back at once, so a second signal stops the process even in a step
    that hangs.  ``restore()`` puts them back on every exit path.  Off the
    main thread nothing is installed and ``signum`` stays None.
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self.signum = None
        self._prev = {}
        try:
            for s in self.SIGNALS:
                self._prev[s] = signal.signal(s, self._on_signal)
        except ValueError:  # not the main thread
            self._prev = {}

    def _on_signal(self, signum, frame):
        self.signum = signum
        self.restore()

    def restore(self) -> None:
        prev, self._prev = self._prev, {}
        for s, h in prev.items():
            signal.signal(s, h)


def resume_path(model_dir: str, iter_start: int) -> str:
    """``iter_<n>.pth`` (``last.pth`` at n = 0), or the JAX trainer's
    ``iter_<n>.ckpt`` (``last.ckpt``) where only that exists."""
    stem = os.path.join(model_dir, f"iter_{iter_start}" if iter_start > 0 else "last")
    if not os.path.exists(stem + ".pth") and os.path.exists(stem + ".ckpt"):
        return stem + ".ckpt"
    return stem + ".pth"


def decoded_cache_dir(cfg, data_dir: str) -> str | None:
    """``--cache_decoded``'s directory, the JAX trainer's name for it."""
    if not _get(cfg, "cache_decoded"):
        return None
    return os.path.join(data_dir, f"decoded_cache_{cfg.img_hw[0]}x{cfg.img_hw[1]}")


def prepare_raw_data(cfg, data_dir: str) -> None:
    """Prepare ``raw_base_dir`` into ``data_dir`` (the trainer's first run)."""
    from unopticalflow_tpu_torch.data import preparers

    if cfg.dataset == "kitti_depth":
        preparers.KITTI_RAW(cfg.raw_base_dir, cfg.static_frames_txt,
                            cfg.test_scenes_txt).prepare_data_mp(data_dir, stride=1)
    elif cfg.dataset == "sintel_raw":
        preparers.SINTEL_RAW(cfg.raw_base_dir).prepare_data_mp(data_dir, cfg.stride)
    elif cfg.dataset == "kitti_odo":
        preparers.KITTI_Odo(cfg.raw_base_dir).prepare_data_mp(data_dir, stride=1)
    elif cfg.dataset == "nyuv2":
        preparers.NYU_Prepare(cfg.raw_base_dir, cfg.nyu_test_dir).prepare_data_mp(
            data_dir, stride=10)


def make_dataset(cfg, data_dir: str, n_samples: int):
    """The prepared dataset of ``cfg.dataset`` as the JAX trainer builds it
    (sintel_raw, which has no calibration, refuses flowposenet mode)."""
    if cfg.dataset == "nyuv2":
        return NYU_v2(data_dir, num_scales=cfg.num_scales, img_hw=cfg.img_hw,
                      num_iterations=n_samples)
    return PREPARED[cfg.dataset](data_dir, num_scales=cfg.num_scales, img_hw=cfg.img_hw,
                                 num_iterations=n_samples,
                                 cache_dir=decoded_cache_dir(cfg, data_dir), emit_uint8=True,
                                 return_intrinsics=cfg.mode == "flowposenet")


def model_inputs(cfg, batch, stacked: bool = False):
    """A loader batch -> the step's: NYU's ``(img, K_ms, K_inv_ms)`` becomes
    the images (flow mode) or ``(img, K_ms[:, 0], K_inv_ms[:, 0])``, the
    scale axis one deeper in a ``stacked`` (K, B, ...) batch."""
    if cfg.dataset != "nyuv2":
        return batch
    imgs, k_ms, k_inv_ms = batch
    if cfg.mode != "flowposenet":
        return imgs
    scale0 = (slice(None), slice(None), 0) if stacked else (slice(None), 0)
    return imgs, k_ms[scale0], k_inv_ms[scale0]


def steps_per_dispatch(cfg) -> int:
    """``--steps_per_dispatch`` as the JAX trainer reads it: ``auto`` is the
    largest K in {8, 4, 2, 1} dividing the log, save and test intervals and
    ``num_iterations - iter_start`` (printed), and a K > 1 that one of them
    is no multiple of raises ``ValueError``."""
    spd = _get(cfg, "steps_per_dispatch", 1) or 1
    remaining = int(cfg.num_iterations - cfg.iter_start)
    if isinstance(spd, str) and spd.strip().lower() == "auto":
        grids = [int(cfg.log_interval), int(cfg.save_interval),
                 int(_get(cfg, "test_interval", 2000)), remaining]
        spd = next(k for k in (8, 4, 2, 1) if all(g % k == 0 for g in grids))
        print(f"steps_per_dispatch auto -> {spd}")
    spd = int(spd)
    if spd < 1:
        raise ValueError(f"--steps_per_dispatch must be >= 1, got {spd}")
    if spd > 1:
        for name in ("log_interval", "save_interval", "test_interval"):
            interval = int(_get(cfg, name, 2000))
            if interval % spd:
                raise ValueError(f"--{name}={interval} must be a multiple of "
                                 f"--steps_per_dispatch={spd}")
        if remaining % spd:
            raise ValueError(f"num_iterations - iter_start = {remaining} must be a multiple "
                             f"of --steps_per_dispatch={spd}")
    return spd


def train(cfg, dataset=None, device=None, on_step=None, model_overrides=None,
          eval_sets=None) -> TrainResult:
    """Train by ``cfg`` (the merged YAML + flags; any attribute object).

    ``dataset`` replaces the prepared directory (anything with ``__len__``
    and ``__getitem__`` giving what the prepared dataset of ``cfg.dataset``
    gives in ``cfg.mode``: (3H, W, 3) uint8 or [0, 1] float snippets, with
    (K, K_inv) in flowposenet mode, and ``num_frames`` where it is not 3);
    ``device`` overrides ``cfg.device``.  ``on_step(iteration,
    metrics)`` is called once for each step, in order, with its device-tensor
    metrics (with K > 1 steps a dispatch, after the dispatch, each sub-step's
    own, out of a copy of the graph's buffer).
    ``model_overrides`` replaces fields of the ``FlowModelConfig`` built from
    ``cfg`` (e.g. ``{"use_pallas_reg": True}``).  ``eval_sets`` ({"2012",
    "2015"}: ``test.EvalSet``) replaces the ground-truth directories of the
    interleaved evaluation.
    """
    device = resolve_device(device or gpu_device(_get(cfg, "device", "cuda"), _get(cfg, "gpu")))
    if cfg.mode not in MODES:
        raise ValueError(f"--mode {cfg.mode}: the port trains --mode {' or '.join(MODES)}")
    if dataset is None and cfg.dataset not in PREPARED:
        raise NotImplementedError(f"dataset {cfg.dataset!r}: the port trains on "
                                  f"{', '.join(sorted(PREPARED))}")
    flowpose = cfg.mode == "flowposenet"
    freeze_flow = bool(_get(cfg, "freeze_flow")) and flowpose
    # the JAX trainer's rule: evaluate while training on the raw-video datasets
    if cfg.no_test or cfg.dataset not in ("kitti_depth", "kitti_odo", "sintel_raw"):
        eval_sets = None
    elif eval_sets is None:
        eval_sets = _load_eval_sets(cfg)
    precision = _get(cfg, "precision", "float32")
    set_float32_precision(device, precision)
    model_cfg = FlowModelConfig(
        num_scales=int(cfg.num_scales),
        compute_dtype=precision,
        loss_dtype=_get(cfg, "loss_precision") or precision,
    )._replace(**(model_overrides or {}))
    model = (FlowPoseModel if flowpose else FlowModel)(
        model_cfg, device=device, scheme=_get(cfg, "init_scheme", "torch"),
        generator=torch.Generator().manual_seed(int(_get(cfg, "seed", 0))))
    flow_model = model.flow if flowpose else model
    if freeze_flow:
        # autograd skips the frozen branch: no correlation- or photometric-backward kernel
        model.flow.requires_grad_(False)
    opt = make_optimizer(model, cfg.lr, freeze_flow=freeze_flow)

    if cfg.resume:
        path = resume_path(cfg.model_dir, cfg.iter_start)
        cfg.iter_start = ckpt.restore_checkpoint(path, model, opt)
        print(f"resumed from {path} at iteration {cfg.iter_start}.")
    elif _get(cfg, "flow_pretrained_model"):
        ckpt.load_pretrained(flow_model, cfg.flow_pretrained_model)
        print("Load Flow Pretrained Model from " + cfg.flow_pretrained_model)

    spd = steps_per_dispatch(cfg)
    weights = loss_weights_from_config(cfg)
    visualizer = Visualizer(weights, _get(cfg, "log_dump_dir"))

    n_samples = (cfg.num_iterations - cfg.iter_start) * cfg.batch_size
    if dataset is None:
        data_dir = os.path.join(cfg.prepared_base_dir, cfg.prepared_save_dir)
        if not os.path.exists(os.path.join(data_dir, "train.txt")):
            prepare_raw_data(cfg, data_dir)
        dataset = make_dataset(cfg, data_dir, n_samples)
    snippet_frames = getattr(dataset, "num_frames", 3)
    loader = BatchLoader(dataset, batch_size=cfg.batch_size, num_workers=cfg.num_workers)
    stream = device_prefetch(stack_batches(loader, spd) if spd > 1 else iter(loader), device)
    if spd > 1:
        if device.type == "cuda":
            set_capturable(opt)  # after a resume's load: the graph captures its state
        multi_step = make_multi_train_step(model, opt, model_cfg, weights, spd, cfg.mode,
                                           snippet_frames, freeze_flow)

    def dispatch(batch) -> list[dict]:
        """One dispatch's steps; each sub-step's metrics."""
        if spd == 1:
            return [train_step(model, opt, model_inputs(cfg, batch), weights, model_cfg,
                               cfg.mode, snippet_frames)]
        stacked = multi_step(model_inputs(cfg, batch, stacked=True))
        return [{k: v[j] for k, v in stacked.items()} for j in range(spd)]

    def evaluate():
        infer = make_infer(flow_model)
        res_2012 = test_kitti_2012(cfg, infer, eval_sets["2012"], device)
        res_2015 = test_kitti_2015(cfg, infer, eval_sets["2015"], device)
        visualizer.add_log_pack({"eval_2012_res": res_2012, "eval_2015_res": res_2015})
        visualizer.dump_log(os.path.join(cfg.model_dir, "log.pkl"))

    test_interval = int(_get(cfg, "test_interval", 2000))
    saver = ckpt.AsyncCheckpointer()
    last_saved = None

    def save(iteration):
        nonlocal last_saved
        if last_saved == iteration:  # a preemption right after a grid save
            return
        last_saved = iteration
        saver.save([os.path.join(cfg.model_dir, f"iter_{iteration}.pth"),
                    os.path.join(cfg.model_dir, "last.pth")], iteration, model, opt)

    print(f"starting iteration: {cfg.iter_start}.")
    model.train()
    log_t, log_it = None, 0
    done = cfg.iter_start - 1  # the last finished iteration
    loop_failed = False
    stop = StopOnSignal()
    try:
        for d, batch in enumerate(stream):
            if stop.signum is not None:  # before an evaluation, too
                break
            # the dispatch covers iterations [it, it + spd); every interval is a
            # multiple of spd, so the K = 1 conditions hold at its last sub-step
            i = d * spd
            it = cfg.iter_start + i
            # counted from the start of this run, as the JAX trainer counts
            if eval_sets is not None and (i + spd) % test_interval == 0:
                evaluate()
            steps = dispatch(batch)
            done = it + spd - 1
            if on_step is not None:
                for j, metrics in enumerate(steps):
                    on_step(it + j, metrics)
            if it % cfg.log_interval == 0:
                # reading the losses waits for the device, so the interval's
                # rate covers everything between two log points
                pack = {k: float(v) for k, v in steps[0].items() if k != "loss_total"}
                now = time.perf_counter()
                if log_t is not None and now > log_t:
                    pack["snippets_per_sec"] = cfg.batch_size * (it - log_it) / (now - log_t)
                log_t, log_it = now, it
                visualizer.print_loss(pack, iter_=it)
            if (done + 1) % cfg.save_interval == 0:
                save(done)
            if stop.signum is not None:
                break
        if stop.signum is not None:
            last = done if done >= cfg.iter_start else None
            print(f"preemption signal {stop.signum}: checkpointing at iteration {last} "
                  "and exiting.")
            if last is not None:
                save(last)
        # the reference saves only on the grid; keep the last iteration's weights too
        elif cfg.num_iterations > cfg.iter_start and cfg.num_iterations % cfg.save_interval:
            save(cfg.num_iterations - 1)
    except BaseException:
        loop_failed = True
        raise
    finally:
        # on every exit path: the handlers back, the loader stopped, the
        # queued checkpoints written (a saver error must not hide the loop's)
        stop.restore()
        stream.close()
        try:
            saver.close()
        except Exception:
            if not loop_failed:
                raise
            traceback.print_exc()
    return TrainResult(model, opt, done + 1)


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.config_file is None:
        raise ValueError("config file needed. -c --config_file.")
    if not os.path.exists(args.config_file):
        raise ValueError("config file not found.")
    from unopticalflow_tpu_torch.utils.config import load_yaml_config, merge_cli_args

    if args.model_dir is None:
        args.model_dir = os.path.join(
            "models", os.path.splitext(os.path.basename(args.config_file))[0])
    args.model_dir = os.path.join(REPO, args.model_dir, args.mode)
    os.makedirs(args.model_dir, exist_ok=True)
    cfg_dict = load_yaml_config(args.config_file)
    cfg_dict["log_dump_dir"] = os.path.join(args.model_dir, "log.pkl")
    shutil.copy(args.config_file, args.model_dir)
    cfg = merge_cli_args(cfg_dict, args)
    with open(os.path.join(args.model_dir, "config.pkl"), "wb") as f:
        pickle.dump(cfg.to_dict(), f)
    train(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
