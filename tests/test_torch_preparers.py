"""The port's raw-data preparers against the JAX package's (CPU).

``unopticalflow_tpu_torch/data/preparers.py``'s ``KITTI_RAW``,
``KITTI_Odo`` and ``SINTEL_RAW`` and the JAX package's, each with
``num_processes=2``, on synthetic raw trees (frames written by cv2): the
same files, byte-equal manifests and calibration copies, and PNGs that
decode to the same pixels (the port writes with its own encoder, the JAX
package with cv2).  The KITTI tree holds a static frame and a test scene
that both skip.  Then ``train.main`` prepares a raw KITTI tree on its first
run, as the JAX trainer does, and trains on it.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from unopticalflow_tpu.data import preparers as jax_prep
from unopticalflow_tpu_torch import train as train_mod
from unopticalflow_tpu_torch.data import preparers as port_prep


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FRAME_HW = (24, 40)


def _frames(d, names, rng):
    d.mkdir(parents=True)
    for n in names:
        img = rng.randint(0, 256, FRAME_HW + (3,)).astype(np.uint8)
        cv2.imwrite(str(d / n), img)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """Raw KITTI (two dates, three drives, one a test scene, one with a
    static frame), KITTI odometry (sequences 00, 01 and 09) and Sintel
    (two scenes) trees, with the Eigen lists."""
    root = tmp_path_factory.mktemp("raw")
    rng = np.random.RandomState(0)
    kitti = root / "kitti_raw"
    for date, drive in (("2011_09_26", "0001"), ("2011_09_26", "0002"), ("2011_09_28", "0003")):
        _frames(kitti / date / f"{date}_drive_{drive}_sync" / "image_02" / "data",
                [f"{i:010d}.png" for i in range(6)], rng)
        (kitti / date / "calib_cam_to_cam.txt").write_text(
            f"calib_time: {date}\nP_rect_02: 721.5 0.0 609.6 44.9 0.0 721.5 172.9 0.2 "
            "0.0 0.0 1.0 0.003\n")
    (root / "static_frames.txt").write_text("2011_09_26 2011_09_26_drive_0001_sync 3\n")
    (root / "test_scenes.txt").write_text("2011_09_26_drive_0002\n")
    odo = root / "odometry"
    for seq in ("00", "01", "09"):
        _frames(odo / seq / "image_2", [f"{i:06d}.png" for i in range(4)], rng)
        (odo / seq / "calib.txt").write_text(f"P2: {seq} 1.0 0.0 0.0\n")
    sintel = root / "sintel"
    for scene in ("alley_1", "bamboo_2"):
        _frames(sintel / scene, [f"frame_{i:04d}.png" for i in range(1, 8)], rng)
    return root


def _prepare(which, raw, out, module):
    if which == "kitti_raw":
        prep = module.KITTI_RAW(str(raw / "kitti_raw"), str(raw / "static_frames.txt"),
                                str(raw / "test_scenes.txt"))
        prep.prepare_data_mp(str(out), stride=1, num_processes=2)
    elif which == "kitti_odo":
        module.KITTI_Odo(str(raw / "odometry")).prepare_data_mp(str(out), stride=1,
                                                                 num_processes=2)
    else:
        module.SINTEL_RAW(str(raw / "sintel")).prepare_data_mp(str(out), stride=2,
                                                               num_processes=2)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("which,n_snippets", [("kitti_raw", 5), ("kitti_odo", 6),
                                              ("sintel", 6)])
def test_preparers_match_jax(which, n_snippets, raw, tmp_path, capsys):
    _prepare(which, raw, tmp_path / "jax", jax_prep)
    _prepare(which, raw, tmp_path / "port", port_prep)
    assert capsys.readouterr().out.count("Data Preparation Finished.") == 2
    files = _files(tmp_path / "jax")
    assert _files(tmp_path / "port") == files
    pngs = [f for f in files if f.endswith(".png")]
    assert len(pngs) == n_snippets
    for f in files:
        a, b = tmp_path / "jax" / f, tmp_path / "port" / f
        if f.endswith(".png"):
            want = cv2.imread(str(a), cv2.IMREAD_UNCHANGED)
            got = cv2.imread(str(b), cv2.IMREAD_UNCHANGED)
            assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want), f
        else:
            assert b.read_bytes() == a.read_bytes(), f
    manifest = (tmp_path / "port" / "train.txt").read_text().splitlines()
    assert len(manifest) == n_snippets
    if which == "kitti_raw":
        # frame 3 of drive 0001 is static: snippets 1, 2 and 3 skip; 0002 is a test scene
        assert [ln.split()[0] for ln in manifest] == [
            "2011_09_26/2011_09_26_drive_0001_sync/0000000000.png",
            "2011_09_28/2011_09_28_drive_0003_sync/0000000000.png",
            "2011_09_28/2011_09_28_drive_0003_sync/0000000001.png",
            "2011_09_28/2011_09_28_drive_0003_sync/0000000002.png",
            "2011_09_28/2011_09_28_drive_0003_sync/0000000003.png"]
        assert manifest[0].split()[1] == "2011_09_26/calib_cam_to_cam.txt"


def test_train_prepares_raw_kitti_on_first_run(raw, tmp_path, capsys):
    prepared = tmp_path / "prepared"
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        f"raw_base_dir: '{raw / 'kitti_raw'}'\nprepared_base_dir: '{prepared}'\n"
        f"static_frames_txt: '{raw / 'static_frames.txt'}'\n"
        f"test_scenes_txt: '{raw / 'test_scenes.txt'}'\n"
        "dataset: 'kitti_depth'\nnum_scales: 3\nnum_iterations: 2\nw_ssim: 0.85\n"
        "w_flow_smooth: 10.0\nw_flow_consis: 0.01\nimg_hw: [64, 64]\n")
    assert train_mod.main(["-c", str(cfg), "--no_test", "--device", "cpu", "--batch_size", "2",
                           "--num_workers", "1", "--log_interval", "1", "--init_scheme", "pwc",
                           "--model_dir", str(tmp_path / "m")]) == 0
    out = capsys.readouterr().out
    assert "Data Preparation Finished." in out and "A total of 5 image pairs found" in out
    assert out.count("loss_pixel") == 2
    assert (prepared / "data_s1" / "train.txt").read_text().count("\n") == 5
    # a second run finds train.txt and prepares nothing
    assert train_mod.main(["-c", str(cfg), "--no_test", "--device", "cpu", "--batch_size", "2",
                           "--num_workers", "1", "--model_dir", str(tmp_path / "m2")]) == 0
    assert "Data Preparation Finished." not in capsys.readouterr().out
