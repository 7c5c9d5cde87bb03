"""The port's camera geometry (``ops/geometry.py``) against the JAX package's.

Same numpy inputs from ``np.random.RandomState`` through both, float32:
within rtol 1e-5 / atol 1e-6 (the warps 1e-5 absolute: a sampling position
is recovered from a normalized one in float32 on both sides), images and
flows NCHW in the port and NHWC in JAX.  The Sampson distance is also held
to zero on an exactly rigid flow field.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unopticalflow_tpu.ops import geometry as jg
from unopticalflow_tpu_torch.ops import geometry as tg

B, H, W = 2, 16, 24
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _k(rng, b=B, h=H, w=W):
    k = np.zeros((b, 3, 3), np.float32)
    k[:, 0, 0] = w * (0.8 + 0.4 * rng.rand(b))
    k[:, 1, 1] = w * (0.8 + 0.4 * rng.rand(b))
    k[:, 0, 2] = w / 2 + rng.randn(b)
    k[:, 1, 2] = h / 2 + rng.randn(b)
    k[:, 2, 2] = 1.0
    return k, np.linalg.inv(k).astype(np.float32)


def _pose(rng, b=B):
    return np.concatenate([rng.randn(b, 3) * 0.5, rng.randn(b, 3) * 0.1], 1).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=atol)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def test_pixel_grid_and_projections():
    rng = np.random.RandomState(0)
    _close(tg.pixel_grid(H, W), jg.pixel_grid(H, W))
    depth = (2.0 + 5.0 * rng.rand(B, H, W)).astype(np.float32)
    _, k_inv = _k(rng)
    cam = tg.pixel2cam(torch.from_numpy(depth), torch.from_numpy(k_inv))
    _close(cam, jg.pixel2cam(jnp.asarray(depth), jnp.asarray(k_inv)))
    rot = rng.randn(B, 3, 3).astype(np.float32)
    tr = rng.randn(B, 3, 1).astype(np.float32)
    got = tg.cam2pixel(cam, torch.from_numpy(rot), torch.from_numpy(tr))
    want = jg.cam2pixel(jnp.asarray(cam.numpy()), jnp.asarray(rot), jnp.asarray(tr))
    assert got.shape == (B, H, W, 2)
    _close(got, want)


@pytest.mark.parametrize("mode", ["euler", "quat"])
def test_rotations_and_pose_vec2mat(mode):
    rng = np.random.RandomState(1)
    ang = (rng.randn(5, 3) * 0.7).astype(np.float32)
    _close(tg.euler2mat(torch.from_numpy(ang)), jg.euler2mat(jnp.asarray(ang)))
    _close(tg.quat2mat(torch.from_numpy(ang)), jg.quat2mat(jnp.asarray(ang)))
    vec = _pose(rng, 5)
    got = tg.pose_vec2mat(torch.from_numpy(vec), mode)
    assert got.shape == (5, 3, 4)
    _close(got, jg.pose_vec2mat(jnp.asarray(vec), mode))
    with pytest.raises(ValueError, match="rotation_mode"):
        tg.pose_vec2mat(torch.from_numpy(vec), "axis")


def test_inverse_warps():
    rng = np.random.RandomState(2)
    img = rng.rand(B, H, W, 3).astype(np.float32)
    depth = (4.0 + 4.0 * rng.rand(B, H, W)).astype(np.float32)
    ref_depth = (4.0 + 4.0 * rng.rand(B, H, W)).astype(np.float32)
    k, _ = _k(rng)
    pose = (_pose(rng) * 0.2).astype(np.float32)
    got, valid = tg.inverse_warp(_nchw(img), torch.from_numpy(depth), torch.from_numpy(pose),
                                 torch.from_numpy(k))
    want, want_valid = jg.inverse_warp(jnp.asarray(img), jnp.asarray(depth), jnp.asarray(pose),
                                       jnp.asarray(k))
    assert got.shape == (B, 3, H, W) and valid.shape == (B, 1, H, W)
    _close(got.permute(0, 2, 3, 1), want, atol=1e-5)
    _close(valid.permute(0, 2, 3, 1), want_valid)
    assert 0 < float(valid.mean()) < 1  # both sides of the border are exercised
    mat = tg.pose_vec2mat(torch.from_numpy(pose))
    got = tg.inverse_warp2(_nchw(img), torch.from_numpy(depth), torch.from_numpy(ref_depth),
                           mat, torch.from_numpy(k))
    want = jg.inverse_warp2(jnp.asarray(img), jnp.asarray(depth), jnp.asarray(ref_depth),
                            jnp.asarray(mat.numpy()), jnp.asarray(k))
    _close(got[0].permute(0, 2, 3, 1), want[0], atol=1e-5)
    _close(got[1].permute(0, 2, 3, 1), want[1])
    _close(got[2], want[2], atol=1e-5)


def test_skew_fundamental_and_sampson():
    rng = np.random.RandomState(3)
    t = rng.randn(B, 3).astype(np.float32)
    _close(tg.skew_matrix(torch.from_numpy(t)), jg.skew_matrix(jnp.asarray(t)))
    k, k_inv = _k(rng)
    pose = _pose(rng)
    f = tg.fundamental_from_pose(*map(torch.from_numpy, (pose, k, k_inv)))
    fj = jg.fundamental_from_pose(*map(jnp.asarray, (pose, k, k_inv)))
    _close(f, fj)
    flow = (rng.randn(B, H, W, 2) * 3).astype(np.float32)
    got = tg.sampson_epipolar_distance(_nchw(flow), f)
    assert got.shape == (B, H, W)
    _close(got, jg.sampson_epipolar_distance(jnp.asarray(flow), fj))


def _rigid_flow(pose, k, k_inv, depth):
    """The flow frame1 -> frame2 of a static scene at ``depth`` seen from a
    camera that moves by ``pose`` (frame 2's points into frame 1's), float64."""
    h, w = depth.shape
    mat = np.asarray(jg.pose_vec2mat(jnp.asarray(pose[None])), np.float64)[0]
    rot, t = mat[:, :3], mat[:, 3]
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    pix = np.stack([u, v, np.ones_like(u)], 0).reshape(3, -1).astype(np.float64)
    p1 = (k_inv.astype(np.float64) @ pix) * depth.reshape(1, -1)
    p2 = rot.T @ (p1 - t[:, None])  # p1 = R p2 + t
    q = k.astype(np.float64) @ p2
    q = q[:2] / q[2:]
    return (q - pix[:2]).reshape(2, h, w).astype(np.float32)


def test_sampson_vanishes_on_a_rigid_flow():
    """As tests/test_flowpose.py holds the JAX function: ~0 under the true
    pose, far from it under a wrong one."""
    rng = np.random.RandomState(4)
    k, k_inv = (x[:1] for x in _k(rng, 1, 32, 48))
    pose = np.array([0.3, -0.1, 0.8, 0.02, -0.03, 0.01], np.float32)
    depth = 8.0 + 4.0 * rng.rand(32, 48)
    flow = torch.from_numpy(_rigid_flow(pose, k[0], k_inv[0], depth)[None])
    f = tg.fundamental_from_pose(*map(torch.from_numpy, (pose[None], k, k_inv)))
    d = tg.sampson_epipolar_distance(flow, f)
    assert float(d.median()) < 1e-4
    bad = pose + np.array([0.5, 0.4, -0.3, 0.05, 0.04, -0.06], np.float32)
    fb = tg.fundamental_from_pose(*map(torch.from_numpy, (bad[None], k, k_inv)))
    assert float(tg.sampson_epipolar_distance(flow, fb).median()) > 100 * max(
        float(d.median()), 1e-8)
