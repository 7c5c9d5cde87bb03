"""The port's entry points as a user runs them, held to pyyaml and cv2.

``train.main`` and ``test.main`` on the CPU, from a YAML file and PNG trees
written by the port's own writer with libpng's row filters, first with the
port's readers swapped for pyyaml and cv2 (the reference) and then through
the port's own, with yaml and cv2 blocked (``sys.modules[name] = None``, as
on a machine that lacks them): the same losses, the same checkpoint and the
same metric string.  Also: ``dataset: sintel_raw`` trains on a prepared
Sintel directory, ``-g 0`` is accepted, and ``set_float32_precision`` turns
TF32 off for cuDNN and matmul.
"""

import os
import re
import sys

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
    cfg.dataset = "nyuv2"
    with pytest.raises(NotImplementedError, match="sintel_raw"):
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
        with pytest.raises(ValueError, match="JPEG needs opencv"):
            _decode_pair(b"\xff\xd8\xff\xe0" + bytes(16), (64, 64))
    assert got.dtype == np.float32 and np.array_equal(got, want)
