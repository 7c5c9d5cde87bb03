"""The port's photometric pack against the JAX package's fused kernel (CPU).

The port's plain version ``photometric_pack_reference(img_l, img_r, flow_b,
flow_f, img)`` (NCHW, the contract of the CUDA kernels) is held against the
JAX ``photometric_pack(warp_corners(img_l, flow_b), warp_corners(img_r,
flow_f), flow_b, flow_f, img)`` with ``pallas_call`` forced into interpret
mode (the fixture of tests/test_pallas_photometric.py), so ``_fwd_body`` and
the hand-written ``_bwd_body`` run.  Forward sums and weights within 1e-5;
the flow gradients of the same normalised loss within rtol 2e-4 / atol 2e-5
(the JAX package's own tolerance for its kernel against autograd).
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from unopticalflow_tpu.ops import pallas_photometric as pp
from unopticalflow_tpu.ops.warp import warp_corners
from unopticalflow_tpu_torch.ops import photometric_cuda
from unopticalflow_tpu_torch.ops.photometric import photometric_pack, photometric_pack_reference


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the suite runs in several workers on one machine's cores, where torch's
    # spinning thread pools (one thread a core in every worker) made the model
    # runs here up to ~70 times slower than alone (a 7 s test took 504 s)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def interpret_pack():
    """photometric_pack with pallas_call forced into interpreter mode."""
    orig = pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    with mock.patch.object(pl, "pallas_call", interp):
        yield


def _case(b, h, w, seed):
    """NHWC numpy: img_l, img_r, flow_b, flow_f, img."""
    rng = np.random.RandomState(seed)
    imgs = [rng.rand(b, h, w, 3).astype(np.float32) for _ in range(3)]
    flows = [rng.uniform(-5, 5, (b, h, w, 2)).astype(np.float32) for _ in range(2)]
    return imgs[0], imgs[1], flows[0], flows[1], imgs[2]


def _nchw(x, grad=False):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).requires_grad_(grad)


def _loss(out, lib):
    # the downstream shape of the real losses: sums normalised by s_w
    return lib.sum(out["s_dw"] / (out["s_w"] + 1.0)) + lib.sum(out["s_cl"] / (out["s_w"] + 1.0))


def _jax(case):
    img_l, img_r, flow_b, flow_f, img = (jnp.asarray(x) for x in case)

    def run(fb, ff):
        return pp.photometric_pack(warp_corners(img_l, fb), warp_corners(img_r, ff), fb, ff, img)

    out = run(flow_b, flow_f)
    grads = jax.grad(lambda fb, ff: _loss(run(fb, ff), jnp), argnums=(0, 1))(flow_b, flow_f)
    return out, grads


def _port(case):
    img_l, img_r, flow_b, flow_f, img = case
    fb, ff = _nchw(flow_b, True), _nchw(flow_f, True)
    out = photometric_pack_reference(_nchw(img_l), _nchw(img_r), fb, ff, _nchw(img))
    _loss(out, torch).backward()
    return out, (fb.grad, ff.grad)


@pytest.mark.parametrize("shape", [(2, 16, 32), (1, 24, 40)])
def test_reference_matches_the_jax_kernel(interpret_pack, shape):
    case = _case(*shape, seed=sum(shape))
    want, want_g = _jax(case)
    got, got_g = _port(case)
    for k in ("s_dw", "s_w", "s_cl"):
        assert got[k].shape == (2 * shape[0],) and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["weights"].numpy().transpose(0, 2, 3, 1),
                               np.asarray(want["weights"]), rtol=1e-5, atol=1e-5)
    for g, r in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), np.asarray(r),
                                   rtol=2e-4, atol=2e-5)


def test_weights_and_sw_carry_no_gradient():
    img_l, img_r, flow_b, flow_f, img = _case(2, 16, 32, seed=3)
    fb = _nchw(flow_b, True)
    out = photometric_pack(_nchw(img_l), _nchw(img_r), fb, _nchw(flow_f), _nchw(img))
    assert not out["weights"].requires_grad and not out["s_w"].requires_grad
    (out["weights"].sum() + out["s_w"].sum() + 0.0 * out["s_dw"].sum()).backward()
    assert float(fb.grad.abs().sum()) == 0.0


def test_bf16_images_follow_f32():
    """bfloat16 images: within 2e-2 of the float32 result (the warped image is
    rounded to bfloat16 in the plain version)."""
    case = [_nchw(x) for x in _case(1, 16, 32, seed=4)]
    want = photometric_pack_reference(*case)
    img_l, img_r, fb, ff, img = case
    got = photometric_pack_reference(img_l.bfloat16(), img_r.bfloat16(), fb, ff, img.bfloat16())
    assert got["weights"].dtype == torch.bfloat16
    for k in ("s_dw", "s_w", "s_cl"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=2e-2, atol=2e-2)


def test_cpu_dispatch_never_launches_the_kernels():
    case = [_nchw(x) for x in _case(1, 8, 16, seed=5)]
    got = photometric_pack(*case)
    want = photometric_pack_reference(*case)
    for k in got:
        torch.testing.assert_close(got[k], want[k])
    with pytest.raises(ValueError, match="CUDA"):
        photometric_cuda.photo_fwd(*case)
    with pytest.raises(ValueError, match="CUDA"):
        photometric_cuda.photometric(*case)
    assert set(photometric_cuda.launches.values()) == {0}


@pytest.mark.parametrize("shape,ok", [
    ((8, 3, 256, 832), True),              # the finest loss scale of the KITTI recipe
    ((1, 3, 16 * 65535, 1), True),         # the largest grid y
    ((1, 3, 16 * 65535 + 1, 1), False),    # ceil(H / 16) above 65535
    ((65535, 3, 1, 1), True),              # the largest grid z
    ((65536, 3, 1, 1), False),             # B above 65535
    ((1, 3, 1, 715827882), True),          # B * 3 * H * W = 2**31 - 2: 32-bit indices hold
    ((1, 3, 2, 357913942), False),         # B * 3 * H * W = 2**31 + 4
    ((2, 3, 16384, 21846), False),         # the same bound with every dimension above 1
    ((1, 3, 0, 4), False),
])
def test_kernel_grid_bound(shape, ok):
    """Both photometric kernels launch the grid (ceil(W / 32), ceil(H / 16), B)
    and index with 32-bit integers: a shape is refused before any launch when
    the grid's y or z passes 65535 or B * 3 * H * W reaches 2**31."""
    if ok:
        photometric_cuda._check_grid(shape)
    else:
        with pytest.raises(ValueError, match="cannot launch"):
            photometric_cuda._check_grid(shape)
    assert set(photometric_cuda.launches.values()) == {0}
