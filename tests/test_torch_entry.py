"""The port's entry points as a user runs them, held to pyyaml and cv2.

``train.main`` and ``test.main`` on the CPU, from a YAML file and PNG trees
written by the port's own writer with libpng's row filters, first with the
port's readers swapped for pyyaml and cv2 (the reference) and then through
the port's own, with yaml and cv2 blocked (``sys.modules[name] = None``, as
on a machine that lacks them): the same losses, the same checkpoint and the
same metric string.  Also: ``dataset: sintel_raw`` trains on a prepared
Sintel directory, ``-g 0`` is accepted, and ``set_float32_precision`` turns
TF32 off for cuDNN and matmul.

The entry points against the JAX package: a warm start and a resume from
the JAX ``save_checkpoint``'s ``.ckpt`` (the same steps as from the ``.pth``
the JAX ``export_torch_checkpoint`` writes, and as from the port's ``.pth``
of the restored state), the server's weights from such a ``.ckpt``,
``--cache_decoded`` (the same batches as without
it, in the JAX trainer's cache directory), a SIGTERM to a trainer process
(exit 0, ``last.pth`` at the last finished step, a resume from it), and
``--task sintel_flow`` and ``demo`` with the weights of a JAX ``.ckpt``
(the JAX ``test_sintel_flow``'s metrics under test_torch_eval.py's rule, the
JAX ``test_single_pair``'s flow under test_torch_inference.py's
tolerance), each with yaml and cv2 blocked.
"""

import os
import re
import selectors
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

from unopticalflow_tpu_torch import test as port_test
from unopticalflow_tpu_torch import train as train_mod
from unopticalflow_tpu_torch.evaluation.flowlib import flow_png_samples, write_flow_png
from unopticalflow_tpu_torch.utils import config, imageio
from unopticalflow_tpu_torch.utils.device import gpu_device, set_float32_precision


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the suite runs in several workers on one machine's cores, where torch's
    # spinning thread pools (one thread a core in every worker) made the model
    # runs here up to ~70 times slower than alone (a 7 s test took 504 s)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FRAME_HW = (40, 70)  # source frames, resized to the yaml's img_hw [64, 64]
N_GT = 200  # KITTI 2015's frame count


def _prepared(root, n, calib):
    """A prepared directory of stacked 3-frame PNGs and its train.txt."""
    drive = root / "d" / "r"
    drive.mkdir(parents=True)
    rng = np.random.RandomState(0)
    h, w = FRAME_HW
    lines = []
    for i in range(n):
        base = rng.randint(0, 255, (h + 4, w, 3)).astype(np.uint8)
        tri = np.concatenate([base[:h], base[2:h + 2], base[4:h + 4]], 0)
        (drive / f"{i:010d}.png").write_bytes(imageio.encode_png(tri))
        lines.append(f"d/r/{i:010d}.png" + (" d/calib.txt" if calib else "") + "\n")
    if calib:
        (root / "d" / "calib.txt").write_text(
            "P_rect_02: 30.0 0.0 16.0 0.0 0.0 30.0 16.0 0.0 0.0 0.0 1.0 0.0\n")
    (root / "train.txt").write_text("".join(lines))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A prepared KITTI directory and a KITTI 2015-shaped evaluation tree
    (200 pairs; ground truth at 20x36, a reduced size), all written by the
    port's own PNG writer."""
    root = tmp_path_factory.mktemp("entry")
    _prepared(root / "prepared" / "data_s1", 4, calib=True)
    gt = root / "kitti2015"
    for sub in ("image_2", "flow_occ", "flow_noc", "obj_map"):
        (gt / sub).mkdir(parents=True)
    rng = np.random.RandomState(5)
    gh, gw = 20, 36
    for i in range(N_GT):
        for suffix in ("_10", "_11"):
            (gt / "image_2" / f"{i:06d}{suffix}.png").write_bytes(imageio.encode_png(
                rng.randint(0, 255, (gh, gw, 3)).astype(np.uint8)))
        flow = np.zeros((gh, gw, 3), np.float64)
        flow[:, :, :2] = np.round(rng.uniform(-4, 4, (gh, gw, 2)) * 64) / 64
        flow[:, :, 2] = rng.rand(gh, gw) > 0.2
        occ = imageio.encode_png(flow_png_samples(flow))
        (gt / "flow_occ" / f"{i:06d}_10.png").write_bytes(occ)
        flow[:, :, 2] *= rng.rand(gh, gw) > 0.3
        noc = imageio.encode_png(flow_png_samples(flow))
        (gt / "flow_noc" / f"{i:06d}_10.png").write_bytes(noc)
        (gt / "obj_map" / f"{i:06d}_10.png").write_bytes(
            imageio.encode_png((rng.rand(gh, gw) > 0.5).astype(np.uint8)))
    cfg = root / "cfg.yaml"
    cfg.write_text(
        "# a flat config as config/kitti.yaml, cut to size\n"
        f"prepared_base_dir: '{root / 'prepared'}'\n"
        f"gt_2012_dir: '{gt}'\ngt_2015_dir: '{gt}'\n"
        "dataset: 'kitti_depth'\nnum_scales: 3\nnum_iterations: 2\n"
        "w_ssim: 0.85\nw_flow_smooth: 10.0\nw_flow_consis: 0.01\nimg_hw: [64, 64]\n")
    return root


def _block(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    monkeypatch.setitem(sys.modules, "cv2", None)


def _reference(monkeypatch):
    """The port's readers and writer swapped for pyyaml's and cv2's."""
    monkeypatch.setattr(config, "parse_flat_yaml", lambda text, name: yaml.safe_load(text))
    monkeypatch.setattr(imageio, "imread", cv2.imread)
    monkeypatch.setattr(imageio, "imdecode",
                        lambda data, flags: cv2.imdecode(np.frombuffer(data, np.uint8), flags))
    monkeypatch.setattr(imageio, "resize", lambda img, wh: cv2.resize(img, tuple(wh)))
    monkeypatch.setattr(imageio, "imwrite", cv2.imwrite)


def _losses(out: str) -> list[str]:
    """The trainer's loss lines without the rate, which is a clock reading."""
    return [re.sub(r",? ?snippets_per_sec: [0-9.e+-]+", "", ln)
            for ln in out.splitlines() if "loss_pixel" in ln]


def _train(tree, model_dir, capsys, *extra):
    argv = ["-c", str(tree / "cfg.yaml"), "--no_test", "--device", "cpu", "--batch_size", "2",
            "--num_workers", "1", "--log_interval", "1", "--save_interval", "100",
            "--init_scheme", "pwc", "--model_dir", str(model_dir), *extra]
    assert train_mod.main(argv) == 0
    return _losses(capsys.readouterr().out)


def test_train_main_runs_without_yaml_and_cv2(tree, tmp_path, monkeypatch, capsys):
    with monkeypatch.context() as m:
        _reference(m)
        want = _train(tree, tmp_path / "with", capsys)
    with monkeypatch.context() as m:
        _block(m)
        got = _train(tree, tmp_path / "without", capsys, "-g", "0")
        assert "yaml" not in sys.modules or sys.modules["yaml"] is None
    assert len(want) == 2 and got == want
    a = torch.load(tmp_path / "with" / "flow" / "last.pth", weights_only=False)
    b = torch.load(tmp_path / "without" / "flow" / "last.pth", weights_only=False)
    sd_a, sd_b = a["model_state_dict"], b["model_state_dict"]
    assert sd_a.keys() == sd_b.keys() and all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)


def test_test_main_runs_without_yaml_and_cv2(tree, tmp_path, monkeypatch):
    from unopticalflow_tpu_torch.models import FlowModel
    from unopticalflow_tpu_torch.training import make_optimizer
    from unopticalflow_tpu_torch.utils.checkpoint import save_checkpoint

    model = FlowModel(device="cpu", scheme="pwc", generator=torch.Generator().manual_seed(0))
    pth = str(tmp_path / "m.pth")
    save_checkpoint([pth], 1, model, make_optimizer(model))
    argv = ["-c", str(tree / "cfg.yaml"), "--task", "kitti_flow", "--pretrained_model", pth,
            "--device", "cpu"]
    with monkeypatch.context() as m:
        _reference(m)
        want = port_test.main(argv)
    with monkeypatch.context() as m:
        _block(m)
        got = port_test.main(argv + ["-g", "0"])
    assert got == want
    values = [float(v) for v in got.split("\n")[1].split(",")]
    assert len(values) == 8 and np.isfinite(values).all()


def test_kitti_readers_without_cv2_equal_cv2(tree, monkeypatch):
    """The dataset's frames (decoded and resized) and the ground truth."""
    from unopticalflow_tpu_torch.data import KITTI_2015, KITTI_Prepared
    from unopticalflow_tpu_torch.evaluation import load_gt_flow_kitti, load_gt_mask

    def read():
        prep = KITTI_Prepared(str(tree / "prepared" / "data_s1"), img_hw=(64, 64),
                              num_iterations=4, emit_uint8=True)
        pairs = KITTI_2015(str(tree / "kitti2015"), img_hw=(64, 64))
        gts, nocs = load_gt_flow_kitti(str(tree / "kitti2015"), "kitti_2015")
        return ([prep[i] for i in range(4)], [pairs[i] for i in range(3)], gts[:5], nocs[:5],
                load_gt_mask(str(tree / "kitti2015"))[:5])

    with monkeypatch.context() as m:
        _reference(m)
        want = read()
    with monkeypatch.context() as m:
        _block(m)
        got = read()
    for a, b in zip(got, want):
        assert all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))


def test_write_flow_png_without_cv2_reads_back(tmp_path, monkeypatch):
    flow = np.zeros((7, 9, 3))
    flow[:, :, :2] = np.round(np.random.RandomState(1).uniform(-30, 30, (7, 9, 2)) * 64) / 64
    flow[:, :, 2] = 1
    with monkeypatch.context() as m:
        _reference(m)
        write_flow_png(flow, str(tmp_path / "a.png"))
    with monkeypatch.context() as m:
        _block(m)
        write_flow_png(flow, str(tmp_path / "b.png"))
    assert (imageio.decode_png((tmp_path / "a.png").read_bytes(), -1)
            == imageio.decode_png((tmp_path / "b.png").read_bytes(), -1)).all()


def test_sintel_raw_trains(tmp_path):
    """``dataset: sintel_raw`` reads SINTEL_Prepared (no intrinsics) and trains;
    without --no_test it is evaluated on KITTI, as the JAX trainer does."""
    _prepared(tmp_path / "prepared" / "data_s1", 3, calib=False)
    cfg = train_mod.recipe_config(
        dataset="sintel_raw", img_hw=(64, 64), num_iterations=2, batch_size=2, device="cpu",
        init_scheme="pwc", num_workers=1, log_interval=1, save_interval=100,
        prepared_base_dir=str(tmp_path / "prepared"), model_dir=str(tmp_path / "m"))
    os.makedirs(cfg.model_dir)
    losses = []
    res = train_mod.train(cfg, on_step=lambda it, m: losses.append(float(m["loss_pixel"])))
    assert res.step == 2 and len(losses) == 2 and np.isfinite(losses).all()
    assert os.path.exists(os.path.join(cfg.model_dir, "last.pth"))
    cfg.no_test, cfg.gt_2012_dir, cfg.gt_2015_dir = False, str(tmp_path / "no"), None
    with pytest.raises(FileNotFoundError, match="gt_2012_dir"):
        train_mod.train(cfg)
    # dataset nyuv2 now trains (2-frame snippets, undistorted, intrinsics per
    # scale); an unknown dataset is refused
    nyu = tmp_path / "nyu" / "data_s1"
    (nyu / "s").mkdir(parents=True)
    rng = np.random.RandomState(5)
    with open(nyu / "train.txt", "w") as f:
        for i in range(2):
            imageio.imwrite(str(nyu / "s" / f"{i}.png"),
                            rng.randint(0, 256, (2 * 96, 128, 3)).astype(np.uint8))
            f.write(f"s/{i}.png calib_cam_to_cam.txt\n")
    (nyu / "calib_cam_to_cam.txt").write_text(
        "P_rect: 5.1885790117450188e+02 0.0 3.2558244941119034e+02 0.0 "
        "0.0 5.1946961112127485e+02 2.5373616633400465e+02 0.0 0.0 0.0 1.0 0.0")
    cfg.no_test, cfg.dataset, cfg.mode = True, "nyuv2", "flowposenet"
    cfg.prepared_base_dir, cfg.model_dir = str(tmp_path / "nyu"), str(tmp_path / "m_nyu")
    os.makedirs(cfg.model_dir)
    losses = []
    res = train_mod.train(cfg, on_step=lambda it, m: losses.append(
        [float(m[k]) for k in ("loss_pixel", "loss_pose_epipolar")]))
    assert res.step == 2 and len(losses) == 2 and np.isfinite(losses).all()
    cfg.dataset = "kitti_2012"
    with pytest.raises(NotImplementedError, match="nyuv2, sintel_raw"):
        train_mod.train(cfg)


def test_gpu_flag_is_accepted():
    for parser in (train_mod.build_arg_parser(), port_test.build_arg_parser()):
        args = parser.parse_args(["-c", "x.yaml", "-g", "0"])
        assert (args.gpu, args.device) == ("0", "cuda")
        assert parser.parse_args(["--gpu", "1"]).gpu == "1"
    assert gpu_device("cuda", "0") == "cuda:0"
    assert gpu_device("cuda", None) == "cuda"
    assert gpu_device("cpu", "2") == "cpu"
    assert gpu_device("cuda:1", "0") == "cuda:1"


def test_set_float32_precision_turns_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    set_float32_precision(torch.device("cpu"), "float32")
    set_float32_precision(torch.device("cuda"), "bfloat16")
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    set_float32_precision(torch.device("cuda", 0), "float32")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_serve_decodes_png_without_cv2(monkeypatch):
    from unopticalflow_tpu_torch.serve import _decode_pair

    pair = np.random.RandomState(2).randint(0, 255, (2 * 40, 70, 3)).astype(np.uint8)
    body = imageio.encode_png(pair)
    with monkeypatch.context() as m:
        _reference(m)
        want = _decode_pair(body, (64, 64))
    with monkeypatch.context() as m:
        _block(m)
        got = _decode_pair(body, (64, 64))
        # a JPEG body goes to the port's own decoder, which names its fault
        with pytest.raises(ValueError, match="corrupt JPEG"):
            _decode_pair(b"\xff\xd8\xff\xe0" + bytes(16), (64, 64))
    assert got.dtype == np.float32 and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the JAX package's .ckpt in the trainer, --cache_decoded, preemption
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_state():
    """Random "pwc" weights and an Adam state (count 5, random moments) in the
    JAX package's layout, as numpy trees."""
    import jax
    import optax

    from unopticalflow_tpu.models import init_flow_model
    from unopticalflow_tpu.training import create_train_state

    params = jax.tree.map(np.asarray, jax.jit(init_flow_model, static_argnames="scheme")(
        jax.random.PRNGKey(0), scheme="pwc"))
    opt_state = jax.tree.map(np.asarray, create_train_state(params).opt_state)
    rng = np.random.RandomState(3)
    moment = lambda x: (rng.randn(*x.shape) * 1e-3).astype(np.float32)  # noqa: E731
    adam = optax.ScaleByAdamState(count=np.asarray(5, np.int32),
                                  mu=jax.tree.map(moment, params),
                                  nu=jax.tree.map(lambda x: moment(x) ** 2, params))
    return params, (adam,) + tuple(opt_state[1:])


def _yaml(tree, path, **over):
    text = (tree / "cfg.yaml").read_text()
    for k, v in over.items():
        text = re.sub(rf"^{k}: .*$", f"{k}: {v}", text, flags=re.M)
    path.write_text(text)
    return path


def test_train_warm_starts_and_resumes_from_a_jax_ckpt(tree, tmp_path, jax_state, capsys):
    from unopticalflow_tpu.utils.checkpoint import save_checkpoint as jax_save
    from unopticalflow_tpu.utils.torch_convert import export_torch_checkpoint
    from unopticalflow_tpu_torch.models import FlowModel
    from unopticalflow_tpu_torch.training import make_optimizer
    from unopticalflow_tpu_torch.utils import checkpoint as ckpt

    params, opt_state = jax_state
    src = str(tmp_path / "jax_last.ckpt")
    jax_save(src, 5, params, opt_state)
    pth = str(tmp_path / "jax_export.pth")
    export_torch_checkpoint(pth, params, iteration=5)
    runs = {}
    for name, model in (("ckpt", src), ("pth", pth)):
        runs[name] = _train(tree, tmp_path / name, capsys, "--flow_pretrained_model", model)
        assert len(runs[name]) == 2
    assert runs["ckpt"] == runs["pth"]
    a = torch.load(tmp_path / "ckpt" / "flow" / "last.pth", weights_only=True)
    b = torch.load(tmp_path / "pth" / "flow" / "last.pth", weights_only=True)
    assert all(torch.equal(v, b["model_state_dict"][k]) for k, v in a["model_state_dict"].items())

    # --resume where the model dir holds only the JAX trainer's last.ckpt, and
    # where it holds the port's last.pth of the same restored state
    model = FlowModel(device="cpu")
    opt = make_optimizer(model)
    assert ckpt.restore_checkpoint(src, model, opt) == 5
    cfg7 = _yaml(tree, tmp_path / "cfg7.yaml", num_iterations=7)
    for name in ("resume_ckpt", "resume_pth"):
        (tmp_path / name / "flow").mkdir(parents=True)
    shutil.copy(src, tmp_path / "resume_ckpt" / "flow" / "last.ckpt")
    ckpt.save_checkpoint([str(tmp_path / "resume_pth" / "flow" / "last.pth")], 5, model, opt)
    lines = {}
    for name, last in (("resume_ckpt", "last.ckpt"), ("resume_pth", "last.pth")):
        argv = ["-c", str(cfg7), "--no_test", "--device", "cpu", "--batch_size", "2",
                "--num_workers", "1", "--log_interval", "1", "--resume",
                "--model_dir", str(tmp_path / name)]
        assert train_mod.main(argv) == 0
        out = capsys.readouterr().out
        assert f"resumed from {tmp_path / name / 'flow' / last} at iteration 5." in out
        assert "starting iteration: 5." in out
        lines[name] = _losses(out)
    assert [ln.split(",")[0] for ln in lines["resume_ckpt"]] == ["iter: 5", "iter: 6"]
    assert lines["resume_ckpt"] == lines["resume_pth"]


def test_serve_loads_a_jax_ckpt(tmp_path, jax_state):
    """``serve.py --pretrained_model`` with the JAX ``save_checkpoint``'s
    ``.ckpt``: the server's weights are the JAX params moved across, bit for
    bit, and a request gets a finite flow."""
    import argparse

    from unopticalflow_tpu.utils.checkpoint import save_checkpoint as jax_save
    from unopticalflow_tpu_torch.serve import build_server
    from unopticalflow_tpu_torch.utils.config import Config
    from unopticalflow_tpu_torch.utils.convert import params_to_torch_state_dict

    src = str(tmp_path / "last.ckpt")
    jax_save(src, 3, jax_state[0], jax_state[1])
    args = argparse.Namespace(device="cpu", precision="float32", pretrained_model=src,
                              max_batch=2, max_wait_ms=1.0, spatial=1, spatial_devices=None)
    server = build_server(Config({"img_hw": (64, 64)}), args)
    try:
        want = params_to_torch_state_dict(jax_state[0])
        got = server.model.state_dict()
        assert set(got) == set(want)
        assert all(np.array_equal(got[k].numpy(), want[k]) for k in want)
        pair = np.random.RandomState(0).rand(128, 64, 3).astype(np.float32)
        flow = server.infer(pair)
        assert flow.shape == (64, 64, 2) and np.isfinite(flow).all()
    finally:
        server.close()


def _cache_dirs(prepared):
    return sorted(p.name for p in prepared.iterdir() if p.name.startswith("decoded_cache"))


def test_cache_decoded_gives_the_same_batches_in_the_jax_trainers_dir(tree, tmp_path, capsys):
    """Two runs from one prepared tree, without and with ``--cache_decoded``:
    the same losses and weights, and the cache holds every snippet's frames;
    the JAX trainer with ``cache_decoded`` on a copy of the tree makes the
    same directory."""
    import train as jax_train
    from unopticalflow_tpu.utils.config import Config

    copy = tmp_path / "tree"
    shutil.copytree(tree / "prepared", copy / "prepared")
    cfg = _yaml(tree, tmp_path / "cfg.yaml", prepared_base_dir=f"'{copy / 'prepared'}'")
    prepared = copy / "prepared" / "data_s1"
    argv = ["-c", str(cfg), "--no_test", "--device", "cpu", "--batch_size", "2",
            "--num_workers", "2", "--log_interval", "1", "--save_interval", "100",
            "--init_scheme", "pwc"]
    assert train_mod.main(argv + ["--model_dir", str(tmp_path / "plain")]) == 0
    plain = _losses(capsys.readouterr().out)
    assert _cache_dirs(prepared) == []
    assert train_mod.main(argv + ["--model_dir", str(tmp_path / "cached"), "--cache_decoded"]) == 0
    cached = _losses(capsys.readouterr().out)
    assert len(plain) == 2 and cached == plain
    a = torch.load(tmp_path / "plain" / "flow" / "last.pth", weights_only=True)
    b = torch.load(tmp_path / "cached" / "flow" / "last.pth", weights_only=True)
    assert all(torch.equal(v, b["model_state_dict"][k]) for k, v in a["model_state_dict"].items())
    port_dirs = _cache_dirs(prepared)
    assert port_dirs == ["decoded_cache_64x64"]
    assert train_mod.decoded_cache_dir(
        train_mod.recipe_config(cache_decoded=True, img_hw=(64, 64)), str(prepared)) \
        == str(prepared / "decoded_cache_64x64")
    # 4 iterations' samples drawn from the 4 snippets: each drawn one cached
    drawn = {np.random.RandomState(i).randint(4) for i in range(4)}
    assert len(list((prepared / "decoded_cache_64x64").glob("*.npy"))) == len(drawn)

    jax_copy = tmp_path / "jax_tree"
    shutil.copytree(tree / "prepared", jax_copy / "prepared")
    jax_cfg = dict(dataset="kitti_depth", num_scales=3, num_iterations=1, w_ssim=0.85,
                   w_flow_smooth=10.0, w_flow_consis=0.01, img_hw=(64, 64),
                   prepared_base_dir=str(jax_copy / "prepared"), prepared_save_dir="data_s1",
                   model_dir=str(tmp_path / "jax_models"), log_dump_dir=None, batch_size=2,
                   iter_start=0, lr=1e-4, num_workers=1, log_interval=1, test_interval=1000,
                   save_interval=1000, mode="flow", resume=False, multi_gpu=False,
                   no_test=True, flow_pretrained_model=None, precision="float32",
                   pallas_corr="off", seed=0, cache_decoded=True, steps_per_dispatch=1)
    os.makedirs(jax_cfg["model_dir"])
    jax_train.train(Config(jax_cfg))
    capsys.readouterr()
    assert _cache_dirs(jax_copy / "prepared" / "data_s1") == port_dirs


def _preempted_trainer(cfg, model_dir):
    """A ``--device cpu`` trainer process sent SIGTERM once it has logged
    iteration 2: (exit code, output, last logged iteration)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "unopticalflow_tpu_torch.train", "-c", str(cfg),
         "--no_test", "--device", "cpu", "--batch_size", "2", "--num_workers", "1",
         "--log_interval", "1", "--save_interval", "100000", "--init_scheme", "pwc",
         "--model_dir", str(model_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=str(REPO))
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    seen, sent = [], False
    deadline = time.time() + 120
    try:
        while time.time() < deadline and not sent:
            if not sel.select(timeout=1):
                continue
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                break
            seen.append(line)
            if line.startswith("iter: 2,"):
                proc.send_signal(signal.SIGTERM)
                sent = True
        if not sent:
            raise AssertionError("the trainer never logged iteration 2:\n" + "".join(seen[-20:]))
        out, _ = proc.communicate(timeout=120)
    finally:
        sel.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    out = "".join(seen) + out
    iters = [int(m) for m in re.findall(r"^iter: (\d+),", out, flags=re.M)]
    return proc.returncode, out, iters[-1]


def test_sigterm_checkpoints_the_last_step_and_exits_0(tree, tmp_path, capsys):
    cfg = _yaml(tree, tmp_path / "long.yaml", num_iterations=100000)
    rc, out, last = _preempted_trainer(cfg, tmp_path / "m")
    assert rc == 0, out
    assert f"preemption signal {int(signal.SIGTERM)}: checkpointing at iteration {last}" in out
    assert last >= 2
    files = set(os.listdir(tmp_path / "m" / "flow"))
    assert {"last.pth", f"iter_{last}.pth"} <= files, files
    data = torch.load(tmp_path / "m" / "flow" / "last.pth", weights_only=True)
    assert data["iteration"] == last
    assert data["optimizer_state_dict"]["state"][0]["step"] == last + 1

    # a --resume continues from it
    cfg2 = _yaml(tree, tmp_path / "more.yaml", num_iterations=last + 2)
    handler = signal.getsignal(signal.SIGTERM)
    assert train_mod.main(["-c", str(cfg2), "--no_test", "--device", "cpu", "--batch_size",
                           "2", "--num_workers", "1", "--log_interval", "1", "--resume",
                           "--model_dir", str(tmp_path / "m")]) == 0
    lines = _losses(capsys.readouterr().out)
    assert [ln.split(",")[0] for ln in lines] == [f"iter: {last}", f"iter: {last + 1}"]
    assert signal.getsignal(signal.SIGTERM) == handler  # put back


# ---------------------------------------------------------------------------
# test.py --task sintel_flow and demo against the JAX package's
# ---------------------------------------------------------------------------

SINTEL_GT_HW = (40, 70)


@pytest.fixture(scope="module")
def sintel_dir(tmp_path_factory):
    """An MPI-Sintel training/ tree: 2 scenes of 3 frames in both passes
    (written by cv2), random flows and occlusion masks (grey PNGs)."""
    from unopticalflow_tpu.evaluation.flowlib import write_flow

    root = tmp_path_factory.mktemp("sintel") / "training"
    rng = np.random.RandomState(4)
    h, w = SINTEL_GT_HW
    for scene in ("alley_1", "bandage_2"):
        for sub in ("clean", "final", "flow", "occlusions"):
            (root / sub / scene).mkdir(parents=True)
        for n in (1, 2, 3):
            for sub in ("clean", "final"):
                img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
                cv2.imwrite(str(root / sub / scene / f"frame_{n:04d}.png"), img)
        for n in (1, 2):
            write_flow(rng.uniform(-5, 5, (h, w, 2)).astype(np.float32),
                       str(root / "flow" / scene / f"frame_{n:04d}.flo"))
            occ = ((rng.rand(h, w) > 0.7) * 255).astype(np.uint8)
            cv2.imwrite(str(root / "occlusions" / scene / f"frame_{n:04d}.png"), occ)
    return root


def test_sintel_flow_and_demo_match_jax(sintel_dir, tmp_path, jax_state, monkeypatch):
    """The JAX ``.ckpt``'s weights through ``test.main`` (yaml and cv2
    blocked) and through the JAX ``test_sintel_flow``/``test_single_pair``;
    the demo PNG reads back as ``flow_to_image`` of the flow."""
    import jax
    import jax.numpy as jnp

    import test as jax_test
    from unopticalflow_tpu.evaluation import load_gt_flow_sintel as jax_load_sintel
    from unopticalflow_tpu.models import FlowModelConfig as JaxFlowModelConfig
    from unopticalflow_tpu.models import inference_flow as jax_inference_flow
    from unopticalflow_tpu.utils.checkpoint import save_checkpoint as jax_save
    from unopticalflow_tpu.utils.config import Config
    from unopticalflow_tpu_torch.evaluation import load_gt_flow_sintel
    from unopticalflow_tpu_torch.evaluation.flowlib import flow_to_image

    params = jax_state[0]
    src = str(tmp_path / "last.ckpt")
    jax_save(src, 3, params)
    cfg_path = tmp_path / "sintel.yaml"
    cfg_path.write_text(f"img_hw: [64, 128]\nnum_scales: 3\nsintel_training_dir: '{sintel_dir}'\n")
    pair = [str(sintel_dir / "final" / "alley_1" / f"frame_{n:04d}.png") for n in (1, 2)]
    with monkeypatch.context() as m:
        _block(m)
        got_gt = [load_gt_flow_sintel(str(sintel_dir), p) for p in ("clean", "final")]
        base = ["-c", str(cfg_path), "--pretrained_model", src, "--device", "cpu"]
        got = port_test.main(base + ["--task", "sintel_flow"])
        flow = port_test.main(base + ["--task", "demo", "--image_path", pair[0],
                                      "--image_path2", pair[1], "--result_dir",
                                      str(tmp_path / "demo")])
        png = imageio.imread(str(tmp_path / "demo" / "demo_flow.png"))

    for (g_flows, g_nocs, g_pairs), p in zip(got_gt, ("clean", "final")):
        w_flows, w_nocs, w_pairs = jax_load_sintel(str(sintel_dir), p)
        assert g_pairs == w_pairs and len(g_pairs) == 4
        assert all(np.array_equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(g_flows + g_nocs, w_flows + w_nocs))
        assert 0 < g_nocs[0].mean() < 1

    jcfg = JaxFlowModelConfig(num_scales=3)
    infer = jax.jit(lambda a, b: jax_inference_flow(
        jax.tree.map(jnp.asarray, params), jcfg, a, b))
    cfg = Config({"img_hw": (64, 128), "config_file": str(cfg_path), "mode": "flow"})
    want = jax_test.test_sintel_flow(cfg, infer, str(sintel_dir))
    assert sorted(got) == sorted(want) == ["clean", "final"]
    for k in want:
        (gh, gv), (wh, wv) = (_metric_values(got[k]), _metric_values(want[k]))
        assert gh == wh and len(gv) == 4 and np.isfinite(gv).all()
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-4 + 1e-9)

    want_flow = jax_test.test_single_pair(cfg, infer, *pair, save_dir=str(tmp_path / "jax"))
    assert flow.shape == want_flow.shape == (64, 128, 2) and flow.dtype == np.float32
    peak = np.abs(want_flow).max()
    assert peak > 1.0
    assert np.abs(flow - want_flow).max() <= 1e-4 * (1 + peak)
    assert np.array_equal(png, flow_to_image(flow))


def _metric_values(res):
    header, values = res.split("\n")[:2]
    return header, np.array([float(v) for v in values.split(",")])
