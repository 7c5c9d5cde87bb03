"""The port's trainer as a data-parallel job on the CPU: the counterpart of
``tests/test_multihost.py`` for ``unopticalflow_tpu_torch.train``.

Two ``python -m unopticalflow_tpu_torch.train --multi_host --device cpu``
processes (gloo; a ``file://`` rendezvous under ``tmp_path``, so that test
workers never share a port) train on a synthetic prepared KITTI tree:

- they end at the weights of one process running the same global recipe,
  after the reference's rule (``--batch_size`` x 2, ``num_iterations`` / 2);
- only rank 0 writes the yaml's copy, ``config.pkl``, checkpoints, log lines
  and ``log.pkl``; it evaluates on the KITTI-shaped tree while rank 1 waits;
- a rank that waits for rank 0's ``train.txt`` times out with the JAX
  trainer's message; a stop signal to one rank stops both at the same agreed
  iteration, and rank 0 saves it;
- torchrun starts the ranks by its variables alone;
- ``--multi_gpu`` without a CUDA card raises.
"""

import os
import pickle
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from unopticalflow_tpu_torch import train as train_mod
from unopticalflow_tpu_torch.evaluation.flowlib import flow_png_samples
from unopticalflow_tpu_torch.utils import imageio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME_HW = (40, 70)  # source frames, resized to the yaml's img_hw [64, 64]
N_GT = 200  # KITTI 2015's frame count (2012 reads the first 194)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A prepared KITTI directory of 4 stacked snippets and a KITTI-shaped
    evaluation tree (ground truth at 20x36), by the port's PNG writer."""
    root = tmp_path_factory.mktemp("multihost")
    prep = root / "prepared" / "data_s1"
    (prep / "d" / "r").mkdir(parents=True)
    rng = np.random.RandomState(0)
    h, w = FRAME_HW
    lines = []
    for i in range(4):
        base = rng.randint(0, 255, (h + 4, w, 3)).astype(np.uint8)
        tri = np.concatenate([base[:h], base[2:h + 2], base[4:h + 4]], 0)
        (prep / "d" / "r" / f"{i:010d}.png").write_bytes(imageio.encode_png(tri))
        lines.append(f"d/r/{i:010d}.png d/calib.txt\n")
    (prep / "d" / "calib.txt").write_text(
        "P_rect_02: 30.0 0.0 16.0 0.0 0.0 30.0 16.0 0.0 0.0 0.0 1.0 0.0\n")
    (prep / "train.txt").write_text("".join(lines))
    gt = root / "kitti"
    for sub in ("image_2", "flow_occ", "flow_noc", "obj_map"):
        (gt / sub).mkdir(parents=True)
    gh, gw = 20, 36
    for i in range(N_GT):
        for suffix in ("_10", "_11"):
            (gt / "image_2" / f"{i:06d}{suffix}.png").write_bytes(imageio.encode_png(
                rng.randint(0, 255, (gh, gw, 3)).astype(np.uint8)))
        flow = np.zeros((gh, gw, 3), np.float64)
        flow[:, :, :2] = np.round(rng.uniform(-4, 4, (gh, gw, 2)) * 64) / 64
        flow[:, :, 2] = rng.rand(gh, gw) > 0.2
        png = imageio.encode_png(flow_png_samples(flow))
        (gt / "flow_occ" / f"{i:06d}_10.png").write_bytes(png)
        (gt / "flow_noc" / f"{i:06d}_10.png").write_bytes(png)
        (gt / "obj_map" / f"{i:06d}_10.png").write_bytes(
            imageio.encode_png((rng.rand(gh, gw) > 0.5).astype(np.uint8)))
    return root


def _yaml(tree, path, num_iterations, prepared="prepared", **extra):
    lines = [f"prepared_base_dir: '{tree / prepared}'", f"gt_2012_dir: '{tree / 'kitti'}'",
             f"gt_2015_dir: '{tree / 'kitti'}'", "dataset: 'kitti_depth'", "num_scales: 3",
             f"num_iterations: {num_iterations}", "w_ssim: 0.85", "w_flow_smooth: 10.0",
             "w_flow_consis: 0.01", "img_hw: [64, 64]"]
    lines += [f"{k}: {v}" for k, v in extra.items()]
    path.write_text("\n".join(lines) + "\n")
    return path


def _argv(cfg, model_dir, *extra):
    return ["-c", str(cfg), "--device", "cpu", "--num_workers", "1", "--log_interval", "1",
            "--init_scheme", "pwc", "--model_dir", str(model_dir), *extra]


def _env():
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                OMP_NUM_THREADS="1")


def _ranks(tmp_path, argvs, timeout=120):
    """Start one ``python -m unopticalflow_tpu_torch.train --multi_host``
    process a rank (``argvs[r]``); (return codes, outputs)."""
    store = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "unopticalflow_tpu_torch.train", *argv, "--multi_host",
         "--coordinator_address", store, "--num_processes", str(len(argvs)),
         "--process_id", str(r)], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r, argv in enumerate(argvs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return [p.returncode for p in procs], outs


def _losses(out):
    return [[float(x) for x in re.findall(r"loss_\w+: ([0-9.]+)", ln)]
            for ln in out.splitlines() if ln.startswith("iter: ")]


def test_two_ranks_end_at_one_process_weights(tree, tmp_path, capsys):
    """2 steps of a global batch of 2 (``--batch_size 1`` on each of 2
    processes, ``num_iterations`` 4 / 2), with an interleaved evaluation at
    the second step on rank 0, against one process at ``--batch_size 2``
    for 2 iterations: the weights to JAX's DP tolerances (rtol 5e-3, atol
    3e-4), the logged losses to rtol 1e-4.  Rank 1 writes nothing."""
    cfg = _yaml(tree, tmp_path / "dp.yaml", 4)
    dirs = [tmp_path / f"rank{r}" for r in range(2)]
    rcs, outs = _ranks(tmp_path, [_argv(cfg, d, "--batch_size", "1", "--save_interval", "1",
                                        "--test_interval", "2") for d in dirs])
    assert rcs == [0, 0], "\n".join(outs)
    one = tmp_path / "one"
    assert train_mod.main(_argv(_yaml(tree, tmp_path / "one.yaml", 2), one, "--batch_size",
                                "2", "--save_interval", "1", "--no_test")) == 0
    single = capsys.readouterr().out

    # the reference's rule over 2 processes
    with open(dirs[0] / "flow" / "config.pkl", "rb") as f:
        saved = pickle.load(f)
    assert (saved["batch_size"], saved["num_iterations"], saved["multi_gpu"]) == (2, 2, True)
    assert "data parallel over 2 processes (gloo), global batch 2" in outs[0]
    assert [ln.split(",")[0] for ln in outs[0].splitlines() if ln.startswith("iter: ")] == \
        ["iter: 0", "iter: 1"]
    np.testing.assert_allclose(_losses(outs[0]), _losses(single), rtol=1e-4)
    # rank 0 writes, rank 1 does not
    files = set(os.listdir(dirs[0] / "flow"))
    assert {"iter_0.pth", "iter_1.pth", "last.pth", "config.pkl", "dp.yaml",
            "log.pkl"} <= files, files
    assert os.listdir(dirs[1] / "flow") == []
    assert "iter: " not in outs[1] and "starting iteration" not in outs[1]
    with open(dirs[0] / "flow" / "log.pkl", "rb") as f:
        log = pickle.load(f)
    assert len(log) == 1 and set(log[0]) == {"eval_2012_res", "eval_2015_res"}
    assert "[EVAL] [KITTI 2015]" in outs[0] and "[EVAL]" not in outs[1]

    got = torch.load(dirs[0] / "flow" / "last.pth", weights_only=True)
    want = torch.load(one / "flow" / "last.pth", weights_only=True)
    assert got["iteration"] == want["iteration"] == 1
    for n, v in want["model_state_dict"].items():
        np.testing.assert_allclose(got["model_state_dict"][n].numpy(), v.numpy(), rtol=5e-3,
                                   atol=3e-4, err_msg=n)
    assert got["optimizer_state_dict"]["state"][0]["step"] == 2


def test_a_waiting_rank_times_out_with_the_jax_message(tree, tmp_path):
    """Rank 0 fails preparing the raw data (there is none); rank 1 waits for
    ``train.txt`` for ``prep_timeout_s`` and raises the JAX trainer's error."""
    cfg = _yaml(tree, tmp_path / "raw.yaml", 4, prepared="missing",
                raw_base_dir=f"'{tmp_path / 'no_raw'}'", prep_timeout_s=3)
    rcs, outs = _ranks(tmp_path, [_argv(cfg, tmp_path / f"m{r}", "--batch_size", "1",
                                        "--no_test") for r in range(2)])
    assert rcs[0] != 0 and rcs[1] != 0
    data_dir = tree / "missing" / "data_s1"
    assert (f"RuntimeError: timed out waiting for {data_dir}/train.txt — process 0 likely "
            "failed during data preparation; check its log") in outs[1], outs[1]
    assert "timed out waiting" not in outs[0]


def test_a_signal_to_one_rank_stops_both_at_the_agreed_iteration(tree, tmp_path):
    """SIGTERM to rank 1 alone: the ranks agree to stop every 20 iterations,
    so both finish iteration 19, rank 0 saves it and both exit 0."""
    cfg = _yaml(tree, tmp_path / "long.yaml", 20000)
    store = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "unopticalflow_tpu_torch.train",
         *_argv(cfg, tmp_path / "m", "--batch_size", "1", "--no_test", "--save_interval",
                "1000", "--steps_per_dispatch", "1"),
         "--multi_host", "--coordinator_address", store, "--num_processes", "2",
         "--process_id", str(r)], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        seen, sent = [], False
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = procs[0].stdout.readline()
            if not line:
                break
            seen.append(line)
            if line.startswith("iter: 3,"):
                procs[1].send_signal(signal.SIGTERM)
                sent = True
                break
        assert sent, "".join(seen[-20:])
        outs = [procs[0].communicate(timeout=120)[0], procs[1].communicate(timeout=120)[0]]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    out0 = "".join(seen) + outs[0]
    assert [p.returncode for p in procs] == [0, 0], out0 + outs[1]
    assert "preemption signal on another process: checkpointing at iteration 19 and " \
           "exiting." in out0
    iters = [int(m) for m in re.findall(r"^iter: (\d+),", out0, flags=re.M)]
    assert iters == list(range(20))
    data = torch.load(tmp_path / "m" / "flow" / "last.pth", weights_only=True)
    assert data["iteration"] == 19


def test_torchrun_starts_the_ranks_by_its_variables(tree, tmp_path):
    """``torchrun --standalone --nproc_per_node 2 -m ... --multi_host``: the
    ranks join by MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK alone."""
    cfg = _yaml(tree, tmp_path / "tr.yaml", 4)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "unopticalflow_tpu_torch.train",
         *_argv(cfg, tmp_path / "m", "--batch_size", "1", "--no_test", "--save_interval",
                "1000"), "--multi_host"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "data parallel over 2 processes (gloo), global batch 2" in proc.stdout
    data = torch.load(tmp_path / "m" / "flow" / "last.pth", weights_only=True)
    assert data["iteration"] == 1


def test_multi_gpu_without_a_card_raises(tree, tmp_path, monkeypatch):
    cfg = _yaml(tree, tmp_path / "g.yaml", 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--multi_gpu runs one process a CUDA card, and "
                                           "CUDA is not available"):
        train_mod.main(["-c", str(cfg), "--multi_gpu", "--model_dir", str(tmp_path / "m")])
    with pytest.raises(RuntimeError, match="--multi_gpu runs one process a CUDA card, not on "
                                           "--device cpu"):
        train_mod.main(["-c", str(cfg), "--multi_gpu", "--device", "cpu"])
    assert not (tmp_path / "m").exists()


def test_parser_takes_the_five_flags():
    args = train_mod.build_arg_parser().parse_args(
        ["-c", "x.yaml", "--multi_gpu", "--multi_host", "--coordinator_address", "h:1",
         "--num_processes", "4", "--process_id", "3"])
    assert (args.multi_gpu, args.multi_host, args.coordinator_address, args.num_processes,
            args.process_id) == (True, True, "h:1", 4, 3)
    args = train_mod.build_arg_parser().parse_args([])
    assert (args.multi_gpu, args.multi_host, args.coordinator_address, args.num_processes,
            args.process_id) == (False, False, None, None, None)
