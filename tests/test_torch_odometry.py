"""The port's odometry evaluation and ``test.py --task kitti_odo`` against the
JAX package's (CPU).

* ``evaluation/eval_odom.py``: every function and ``KittiEvalOdom.eval``
  (``plot=False``) on synthetic trajectories from ``np.random.RandomState``
  (300 poses about 1 m apart, turning), equal to the JAX module's within
  1e-12 relative;
* ``test.main --mode flowposenet --task kitti_odo`` on a 6-frame PNG
  sequence with a JAX ``.ckpt``'s weights: every line of the pose file within
  1e-5 (relative L2 of its 12 numbers) of the root ``test.py``'s
  ``test_kitti_odo`` with the same weights; a translation-scaled copy of a
  trajectory aligns to errors under 1e-9.
"""

import importlib.util
import os
import types

import numpy as np
import pytest
import torch

import jax

from unopticalflow_tpu.evaluation import eval_odom as jeo
from unopticalflow_tpu.models import FlowModelConfig as JaxFlowModelConfig
from unopticalflow_tpu.models import inference_pose as jax_inference_pose
from unopticalflow_tpu.models import init_flowpose_model
from unopticalflow_tpu.utils.checkpoint import save_checkpoint
from unopticalflow_tpu_torch import test as port_test
from unopticalflow_tpu_torch.evaluation import eval_odom as teo
from unopticalflow_tpu_torch.utils import imageio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trajectory(seed, n=300):
    """Camera-to-world 3x4 poses about 1 m apart along a turning path."""
    rng = np.random.RandomState(seed)
    yaw = np.cumsum(rng.randn(n) * 0.02)
    pos = np.cumsum(np.stack([np.sin(yaw), 0.01 * rng.randn(n), np.cos(yaw)], 1), 0)
    poses = []
    for a, p in zip(yaw, pos):
        c, s = np.cos(a), np.sin(a)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses.append(np.concatenate([rot, p[:, None]], 1))
    return np.stack(poses)


def _write(path, poses, with_idx=False):
    with open(path, "w") as f:
        for i, p in enumerate(poses):
            vals = " ".join(f"{v:.9e}" for v in p.reshape(-1))
            f.write(f"{i} {vals}\n" if with_idx else vals + "\n")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-12, atol=0)


def test_eval_odom_functions_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    x, y = rng.randn(3, 40), rng.randn(3, 40)
    assert teo.scale_lse_solver(x, y) == jeo.scale_lse_solver(x, y)
    for with_scale in (False, True):
        for a, b in zip(teo.umeyama_alignment(x, y, with_scale),
                        jeo.umeyama_alignment(x, y, with_scale)):
            _close(a, b)
    with pytest.raises(ValueError, match="shape"):
        teo.umeyama_alignment(x, y[:, :5])
    gt = _trajectory(1)
    _write(tmp_path / "gt.txt", gt, with_idx=True)
    got, want = (m.load_poses(str(tmp_path / "gt.txt")) for m in (teo, jeo))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])
    _close(teo.trajectory_distances(got), jeo.trajectory_distances(want))
    pert = got[5] @ np.linalg.inv(got[9])
    assert teo.rotation_error(pert) == jeo.rotation_error(pert)
    assert teo.translation_error(pert) == jeo.translation_error(pert)
    pred = {k: v.copy() for k, v in got.items()}
    for k in pred:
        pred[k][:3, 3] *= 0.7 + 0.001 * k
    errs = teo.calc_sequence_errors(got, pred)
    _close(errs, jeo.calc_sequence_errors(want, pred))
    assert len(errs) > 10
    seg_t, seg_j = teo.compute_segment_error(errs), jeo.compute_segment_error(errs)
    assert list(seg_t) == list(seg_j)
    for k in seg_j:
        _close(seg_t[k], seg_j[k])
    _close(teo.compute_overall_err(errs), jeo.compute_overall_err(errs))
    assert teo.compute_overall_err([]) == jeo.compute_overall_err([]) == (0.0, 0.0)
    opt_t, opt_j = teo.scale_optimization(got, pred), jeo.scale_optimization(want, pred)
    for k in opt_j:
        _close(opt_t[k], opt_j[k])


@pytest.mark.parametrize("noise", [0.0, 0.01])
def test_kitti_eval_odom_matches_jax(tmp_path, noise):
    """A result that is the ground truth with translations scaled by 0.5 (and,
    with noise, jittered): the port's errors equal JAX's, and the exact copy
    aligns to zero error."""
    gt = _trajectory(2)
    pred = gt.copy()
    pred[:, :, 3] *= 0.5
    pred[:, :, 3] += noise * np.random.RandomState(3).randn(len(gt), 3).cumsum(0)
    _write(tmp_path / "gt.txt", gt)
    _write(tmp_path / "res.txt", pred)
    got = teo.KittiEvalOdom().eval(str(tmp_path / "gt.txt"), str(tmp_path / "res.txt"),
                                   plot=False)
    want = jeo.KittiEvalOdom().eval(str(tmp_path / "gt.txt"), str(tmp_path / "res.txt"),
                                    plot=False)
    _close(got, want)
    if noise:
        assert got[0] > 1e-4
    else:
        assert max(got) < 1e-9


@pytest.fixture(scope="module")
def root_test():
    """The JAX package's ``test.py`` (the repo root's), loaded by path."""
    spec = importlib.util.spec_from_file_location("jax_root_test", os.path.join(REPO, "test.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kitti_odo_matches_jax(tmp_path, root_test):
    params = jax.jit(init_flowpose_model, static_argnames="scheme")(
        jax.random.PRNGKey(3), scheme="pwc")
    ckpt = str(tmp_path / "fp.ckpt")
    save_checkpoint(ckpt, 0, params)
    seq = tmp_path / "seq" / "image_2"
    seq.mkdir(parents=True)
    rng = np.random.RandomState(4)
    base = rng.randint(0, 256, (90, 180, 3)).astype(np.uint8)
    for i in range(6):  # a scene sliding left and down a little each frame
        imageio.imwrite(str(seq / f"{i:06d}.png"),
                        np.ascontiguousarray(base[i:i + 72, 2 * i:2 * i + 160]))
    cfg_path = tmp_path / "odo.yaml"
    cfg_path.write_text("img_hw: [64, 128]\nnum_scales: 3\n")
    out = str(tmp_path / "port.txt")
    got_path = port_test.main(["-c", str(cfg_path), "--mode", "flowposenet", "--task",
                               "kitti_odo", "--seq_dir", str(tmp_path / "seq"),
                               "--result_txt", out, "--pretrained_model", ckpt,
                               "--device", "cpu"])
    assert got_path == out
    cfg = types.SimpleNamespace(img_hw=(64, 128))
    pose_fn = jax.jit(lambda a, b: jax_inference_pose(params, JaxFlowModelConfig(), a, b))
    want_path = root_test.test_kitti_odo(cfg, pose_fn, str(tmp_path / "seq"),
                                         str(tmp_path / "jax.txt"))
    got = np.loadtxt(out)
    want = np.loadtxt(want_path)
    assert got.shape == want.shape == (6, 12)
    np.testing.assert_array_equal(got[0], np.eye(4)[:3].reshape(-1))
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b), i
    assert np.abs(got[1:, [3, 7, 11]]).max() > 0  # the pose net moved the camera
