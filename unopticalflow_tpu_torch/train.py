"""Training entry point of the port: unsupervised flow training (``--mode
flow``) and flow + pose training (``--mode flowposenet``).

    python -m unopticalflow_tpu_torch.train -c config/kitti.yaml --mode flow \
        [--test_interval 2000 | --no_test] [--flow_pretrained_model last.ckpt] \
        [--resume] [--cache_decoded] [--steps_per_dispatch auto] --device cuda
    python -m unopticalflow_tpu_torch.train -c config/kitti.yaml --multi_gpu ...
    python -m unopticalflow_tpu_torch.train -c config/kitti.yaml --multi_host \
        --coordinator_address host0:29500 --num_processes N --process_id P ...
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

Data parallelism (``parallel/mesh.py``; one process drives one card).
``--multi_host`` joins a ``torch.distributed`` job: ``--coordinator_address``
(host:port of process 0), ``--num_processes`` and ``--process_id``, or
torchrun's ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``;
NCCL on the card ``LOCAL_RANK`` (else ``process_id % device_count``), gloo
with ``--device cpu``.  ``--multi_gpu`` on one host starts one such process a
visible card (``torch.multiprocessing``, spawn, a free localhost port) and
raises without a CUDA card.  Both apply the reference's rule: batch x N and
``int(num_iterations / N)`` over the N processes, so ``--batch_size`` stays
the batch of one card.  Every rank builds the same global schedule and
loads its block of each global batch (``BatchLoader(process_index,
process_count)``), starts from rank 0's state (broadcast after the weights
are built, warm-started or resumed), and pmean-reduces the gradients and the
losses in each step (``train_step(group=...)``; under NCCL inside the K-step
graph).  Rank 0 alone prepares the raw data (the others wait for
``train.txt`` up to the yaml's ``prep_timeout_s``, 3600 s by default, then
raise), copies the yaml and writes ``config.pkl``, saves checkpoints, prints
the log and evaluates, while the others wait at a barrier.  A stop signal is
agreed at iteration-deterministic points (every 20 iterations, and before
an evaluation): all ranks stop at the same dispatch and rank 0 saves.
"""

from __future__ import annotations

import argparse
import os
import pickle
import shutil
import signal
import socket
import sys
import time
import traceback
import types
from typing import NamedTuple

import torch
import torch.distributed as dist

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
from unopticalflow_tpu_torch.parallel.mesh import (
    data_parallel_world,
    initialize_multi_host,
    replicate,
)
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
# data parallel: agree on a stop every this many iterations (the JAX trainer's)
PREEMPT_CHECK_EVERY = 20


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
    # the JAX trainer's help texts, with torch.distributed for jax.distributed
    p.add_argument("--multi_gpu", action="store_true",
                   help="data-parallel over all devices (one process a CUDA card).")
    p.add_argument("--multi_host", action="store_true",
                   help="multi-host data parallelism: torch.distributed over "
                        "all hosts, DP over the GLOBAL device set (one process a "
                        "card); implies --multi_gpu semantics (batch x N_dev, "
                        "iterations / N_dev). Run the same command on every "
                        "host, or under torchrun.")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0 for --multi_host (omit under "
                        "torchrun: MASTER_ADDR and MASTER_PORT).")
    p.add_argument("--num_processes", type=int, default=None,
                   help="total process count for --multi_host (WORLD_SIZE under torchrun).")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's id for --multi_host (RANK under torchrun).")
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


def steps_per_dispatch(cfg, announce: bool = True) -> int:
    """``--steps_per_dispatch`` as the JAX trainer reads it: ``auto`` is the
    largest K in {8, 4, 2, 1} dividing the log, save and test intervals and
    ``num_iterations - iter_start`` (printed where ``announce``), and a K > 1
    that one of them is no multiple of raises ``ValueError``."""
    spd = _get(cfg, "steps_per_dispatch", 1) or 1
    remaining = int(cfg.num_iterations - cfg.iter_start)
    if isinstance(spd, str) and spd.strip().lower() == "auto":
        grids = [int(cfg.log_interval), int(cfg.save_interval),
                 int(_get(cfg, "test_interval", 2000)), remaining]
        spd = next(k for k in (8, 4, 2, 1) if all(g % k == 0 for g in grids))
        if announce:
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


def wait_for_prepared(data_dir: str, timeout_s: float, poll_s: float = 2.0) -> None:
    """A rank other than 0 waits for rank 0 to prepare ``data_dir``: bounded,
    so that a rank 0 that failed fails the job instead of hanging it."""
    deadline = time.monotonic() + float(timeout_s)
    while not os.path.exists(os.path.join(data_dir, "train.txt")):
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"timed out waiting for {data_dir}/train.txt — process 0 "
                "likely failed during data preparation; check its log"
            )
        time.sleep(poll_s)


def _barrier(group, device: torch.device) -> None:
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[device.index])
    else:
        dist.barrier(group=group)


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

    ``cfg.multi_host``: this process is one rank of a data-parallel job over
    the default process group, which the caller has joined
    (``parallel.initialize_multi_host``, as ``main`` does; with
    ``backend="gloo"`` two ranks can share one card), and
    ``cfg.batch_size`` and ``cfg.num_iterations`` are the global batch and
    the job's iterations (``main`` applies the batch x N rule before this).
    ``on_step`` sees the pmean-reduced, global metrics.
    """
    device = resolve_device(device or gpu_device(_get(cfg, "device", "cuda"), _get(cfg, "gpu")))
    if cfg.mode not in MODES:
        raise ValueError(f"--mode {cfg.mode}: the port trains --mode {' or '.join(MODES)}")
    if dataset is None and cfg.dataset not in PREPARED:
        raise NotImplementedError(f"dataset {cfg.dataset!r}: the port trains on "
                                  f"{', '.join(sorted(PREPARED))}")
    if _get(cfg, "multi_host") and not dist.is_initialized():
        raise RuntimeError("multi_host: no process group; join one first "
                           "(parallel.initialize_multi_host)")
    group = dist.group.WORLD if _get(cfg, "multi_host") else None
    rank, world = data_parallel_world(group) if group is not None else (0, 1)
    is_main = rank == 0
    flowpose = cfg.mode == "flowposenet"
    freeze_flow = bool(_get(cfg, "freeze_flow")) and flowpose
    # the JAX trainer's rule: evaluate while training on the raw-video
    # datasets; rank 0 evaluates, the other ranks wait for it
    evaluating = not cfg.no_test and cfg.dataset in ("kitti_depth", "kitti_odo", "sintel_raw")
    if not (evaluating and is_main):
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
        if is_main:
            print(f"resumed from {path} at iteration {cfg.iter_start}.")
    elif _get(cfg, "flow_pretrained_model"):
        ckpt.load_pretrained(flow_model, cfg.flow_pretrained_model)
        if is_main:
            print("Load Flow Pretrained Model from " + cfg.flow_pretrained_model)
    if group is not None:
        # every rank starts from rank 0's weights and Adam state
        replicate(model, group=group)
        replicate(opt, group=group)
        if is_main:
            print(f"data parallel over {world} processes ({dist.get_backend(group)}), "
                  f"global batch {cfg.batch_size}")

    spd = steps_per_dispatch(cfg, announce=is_main)
    weights = loss_weights_from_config(cfg)
    visualizer = Visualizer(weights, _get(cfg, "log_dump_dir"))

    n_samples = (cfg.num_iterations - cfg.iter_start) * cfg.batch_size
    if dataset is None:
        data_dir = os.path.join(cfg.prepared_base_dir, cfg.prepared_save_dir)
        if not is_main:
            wait_for_prepared(data_dir, _get(cfg, "prep_timeout_s", 3600))
        elif not os.path.exists(os.path.join(data_dir, "train.txt")):
            prepare_raw_data(cfg, data_dir)
        dataset = make_dataset(cfg, data_dir, n_samples)
    snippet_frames = getattr(dataset, "num_frames", 3)
    loader = BatchLoader(dataset, batch_size=cfg.batch_size, num_workers=cfg.num_workers,
                         process_index=rank, process_count=world)
    stream = device_prefetch(stack_batches(loader, spd) if spd > 1 else iter(loader), device)
    if spd > 1:
        if device.type == "cuda":
            set_capturable(opt)  # after a resume's load: the graph captures its state
        multi_step = make_multi_train_step(model, opt, model_cfg, weights, spd, cfg.mode,
                                           snippet_frames, freeze_flow, group=group)

    def dispatch(batch) -> list[dict]:
        """One dispatch's steps; each sub-step's metrics."""
        if spd == 1:
            return [train_step(model, opt, model_inputs(cfg, batch), weights, model_cfg,
                               cfg.mode, snippet_frames, group)]
        if saver is not None and multi_step.captures_next:
            # the writer copies to the host on a pool stream, which can be the
            # capture's: no copy may run while the graph is recorded
            saver.wait()
        stacked = multi_step(model_inputs(cfg, batch, stacked=True))
        return [{k: v[j] for k, v in stacked.items()} for j in range(spd)]

    def evaluate():
        infer = make_infer(flow_model)
        res_2012 = test_kitti_2012(cfg, infer, eval_sets["2012"], device)
        res_2015 = test_kitti_2015(cfg, infer, eval_sets["2015"], device)
        visualizer.add_log_pack({"eval_2012_res": res_2012, "eval_2015_res": res_2015})
        visualizer.dump_log(os.path.join(cfg.model_dir, "log.pkl"))

    test_interval = int(_get(cfg, "test_interval", 2000))
    saver = ckpt.AsyncCheckpointer() if is_main else None
    last_saved = None

    def save(iteration):
        nonlocal last_saved
        if not is_main or last_saved == iteration:  # a preemption right after a grid save
            return
        last_saved = iteration
        saver.save([os.path.join(cfg.model_dir, f"iter_{iteration}.pth"),
                    os.path.join(cfg.model_dir, "last.pth")], iteration, model, opt)

    def stop_agreed(check: bool) -> bool:
        """Whether to stop here.  Data parallel, every rank's flag is
        gathered (a max) where ``check`` holds, a condition that is the same
        on every rank, so that all stop at the same dispatch or none does."""
        flag = stop.signum is not None
        if world == 1:
            return flag
        if not check:
            return False
        t = torch.tensor([float(flag)],
                         device=device if dist.get_backend(group) == "nccl" else "cpu")
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return bool(t.item())

    if is_main:
        print(f"starting iteration: {cfg.iter_start}.")
    model.train()
    log_t, log_it = None, 0
    done = cfg.iter_start - 1  # the last finished iteration
    stopped = False
    loop_failed = False
    stop = StopOnSignal()
    try:
        for d, batch in enumerate(stream):
            # the dispatch covers iterations [it, it + spd); every interval is a
            # multiple of spd, so the K = 1 conditions hold at its last sub-step
            i = d * spd
            it = cfg.iter_start + i
            # counted from the start of this run, as the JAX trainer counts
            will_eval = evaluating and (i + spd) % test_interval == 0
            if stop_agreed(i % PREEMPT_CHECK_EVERY == 0 or will_eval):  # before an evaluation
                stopped = True
                break
            if will_eval:
                if is_main:
                    evaluate()
                if world > 1:
                    _barrier(group, device)
            steps = dispatch(batch)
            done = it + spd - 1
            if on_step is not None:
                for j, metrics in enumerate(steps):
                    on_step(it + j, metrics)
            if is_main and it % cfg.log_interval == 0:
                # reading the losses waits for the device, so the interval's
                # rate covers everything between two log points
                pack = {k: float(v) for k, v in steps[0].items() if k != "loss_total"}
                now = time.perf_counter()
                if log_t is not None and now > log_t:
                    # cfg.batch_size is the global batch
                    pack["snippets_per_sec"] = cfg.batch_size * (it - log_it) / (now - log_t)
                log_t, log_it = now, it
                visualizer.print_loss(pack, iter_=it)
            if (done + 1) % cfg.save_interval == 0:
                save(done)
            if stop_agreed((it + spd) % PREEMPT_CHECK_EVERY == 0):
                stopped = True
                break
        if stopped:
            last = done if done >= cfg.iter_start else None
            if is_main:
                sig = "on another process" if stop.signum is None else stop.signum
                print(f"preemption signal {sig}: checkpointing at iteration {last} "
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
            if saver is not None:
                saver.close()
        except Exception:
            if not loop_failed:
                raise
            traceback.print_exc()
    return TrainResult(model, opt, done + 1)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _multi_gpu_worker(rank: int, argv: list[str], world: int, address: str) -> None:
    """Process ``rank`` of ``--multi_gpu``: ``--multi_host`` on this host."""
    main([*argv, "--multi_host", "--coordinator_address", address, "--num_processes",
          str(world), "--process_id", str(rank)])


def launch_multi_gpu(argv: list[str]) -> int:
    """``--multi_gpu``: one ``--multi_host`` process a visible CUDA card, on a
    free localhost port, each on card ``cuda:<rank>``; raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("--multi_gpu runs one process a CUDA card, and CUDA is not "
                           "available")
    # the worker by its module's name, also when this module runs as __main__
    from unopticalflow_tpu_torch.train import _multi_gpu_worker as worker

    world = torch.cuda.device_count()
    print(f"--multi_gpu: {world} process(es), one a card")
    torch.multiprocessing.spawn(worker,
                                args=(list(argv), world, f"127.0.0.1:{_free_port()}"),
                                nprocs=world, join=True, start_method="spawn")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_arg_parser().parse_args(argv)
    if args.config_file is None:
        raise ValueError("config file needed. -c --config_file.")
    if not os.path.exists(args.config_file):
        raise ValueError("config file not found.")
    if args.multi_gpu and not args.multi_host:
        if torch.device(args.device).type != "cuda":
            raise RuntimeError(f"--multi_gpu runs one process a CUDA card, not on "
                               f"--device {args.device}")
        return launch_multi_gpu(argv)
    from unopticalflow_tpu_torch.utils.config import load_yaml_config, merge_cli_args

    device = None
    if args.multi_host:
        # before anything else touches a device, on every process
        device = initialize_multi_host(args.coordinator_address, args.num_processes,
                                       args.process_id,
                                       device=gpu_device(args.device, args.gpu))
        args.multi_gpu = True  # data parallel over the global process set
    try:
        is_main = data_parallel_world()[0] == 0
        if args.model_dir is None:
            args.model_dir = os.path.join(
                "models", os.path.splitext(os.path.basename(args.config_file))[0])
        args.model_dir = os.path.join(REPO, args.model_dir, args.mode)
        os.makedirs(args.model_dir, exist_ok=True)
        cfg_dict = load_yaml_config(args.config_file)
        cfg_dict["log_dump_dir"] = os.path.join(args.model_dir, "log.pkl")
        if is_main:
            shutil.copy(args.config_file, args.model_dir)
        cfg = merge_cli_args(cfg_dict, args)
        if cfg.multi_gpu:
            # the reference's rule over the global process (card) count
            n = data_parallel_world()[1]
            cfg.batch_size = cfg.batch_size * n
            cfg.num_iterations = int(cfg.num_iterations / n)
        if is_main:
            with open(os.path.join(args.model_dir, "config.pkl"), "wb") as f:
                pickle.dump(cfg.to_dict(), f)
        train(cfg, device=device)
    finally:
        if args.multi_host:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
