"""The port's pyramid, SSIM and loss stack against the JAX package's (CPU).

Same numpy inputs on both sides (NHWC for JAX, NCHW for the port).  Values
within rtol 1e-5 / atol 1e-6 in float32 (only the order of float32 sums
differs); gradients with respect to the flows within rtol 1e-4 / atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unopticalflow_tpu.models import losses as jl
from unopticalflow_tpu.ops.pyramid import avg_pool_pyramid as jax_pyramid
from unopticalflow_tpu.ops.ssim import ssim as jax_ssim
from unopticalflow_tpu_torch.models import losses as tl
from unopticalflow_tpu_torch.ops.pyramid import avg_pool_pyramid
from unopticalflow_tpu_torch.ops.ssim import ssim


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the suite runs in several workers on one machine's cores, where torch's
    # spinning thread pools (one thread a core in every worker) made the model
    # runs here up to ~70 times slower than alone (a 7 s test took 504 s)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = dict(rtol=1e-5, atol=1e-6)
GTOL = dict(rtol=1e-4, atol=1e-6)
NS = 3


def _nchw(x, grad=False):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).requires_grad_(grad)


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _rand(rng, *shape, lo=0.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("hw,levels", [((64, 128), 4), ((50, 70), 3)])
def test_pyramid_matches_jax(hw, levels):
    img = _rand(np.random.RandomState(0), 2, *hw, 3)
    t = _nchw(img, True)
    got = avg_pool_pyramid(t, levels)
    want = jax_pyramid(jnp.asarray(img), levels)
    assert len(got) == len(want) == levels
    for g, w in zip(got, want):
        assert not g.requires_grad  # every level is detached
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssim_matches_jax(dtype):
    rng = np.random.RandomState(1)
    x, y = _rand(rng, 2, 12, 20, 3), _rand(rng, 2, 12, 20, 3)
    got = ssim(_nchw(x).to(dtype), _nchw(y).to(dtype))
    assert got.dtype == torch.float32  # computed in float32 whatever the input
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_ssim(jnp.asarray(x, jdt), jnp.asarray(y, jdt))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def stack():
    """Per-scale NHWC numpy: packed warped [bwd; fwd], center images, flows."""
    rng = np.random.RandomState(2)
    b, sizes = 2, [(16, 24), (8, 12), (4, 6)]
    warped = [_rand(rng, 2 * b, h, w, 3) for h, w in sizes]
    for wp in warped:  # some invalid (all-zero) warped pixels
        wp[:, :2, :3] = 0.0
    imgs = [_rand(rng, b, h, w, 3) for h, w in sizes]
    flows = [_rand(rng, 2 * b, h, w, 2, lo=-3.0, hi=3.0) for h, w in sizes]
    flows[0][0, 0, 0] = 0.0  # an exactly-zero flow vector (flow_normalization)
    return warped, imgs, flows


@pytest.mark.parametrize("use_weights", [True, False])
def test_diff_and_occlusion_weights_match_jax(stack, use_weights):
    warped, imgs, _ = stack
    d, w = tl.diff_and_occlusion_weights_packed(
        [_nchw(x) for x in warped], [_nchw(x) for x in imgs], NS, use_weights)
    jd, jw = jl.diff_and_occlusion_weights_packed(
        [jnp.asarray(x) for x in warped], [jnp.asarray(x) for x in imgs], NS, use_weights)
    for a, b in zip(d + w, jd + jw):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), **TOL)


def test_masked_losses_match_jax(stack):
    warped, imgs, _ = stack
    tw, ti = [_nchw(x) for x in warped], [_nchw(x) for x in imgs]
    jw, ji = [jnp.asarray(x) for x in warped], [jnp.asarray(x) for x in imgs]
    d, w = tl.diff_and_occlusion_weights_packed(tw, ti, NS)
    jd, jwt = jl.diff_and_occlusion_weights_packed(jw, ji, NS)
    np.testing.assert_allclose(tl.masked_diff_loss(d, w, NS).numpy(),
                               np.asarray(jl.masked_diff_loss(jd, jwt, NS)), **TOL)
    cc = [torch.cat([x, x], 0) for x in ti]
    jcc = [jnp.concatenate([x, x], 0) for x in ji]
    np.testing.assert_allclose(tl.masked_ssim_loss(cc, tw, w, NS).numpy(),
                               np.asarray(jl.masked_ssim_loss(jcc, jw, jwt, NS)), **TOL)


def test_smoothness_matches_jax_with_tiled_edge_weights(stack):
    _, imgs, flows = stack
    tf = [_nchw(x, True) for x in flows]
    got = tl.flow_smooth_loss(tf, [_nchw(x) for x in imgs], NS)  # B-sized images, 2B flows
    got.sum().backward()

    def jax_loss(fl):
        return jl.flow_smooth_loss(fl, [jnp.asarray(x) for x in imgs], NS)

    jf = [jnp.asarray(x) for x in flows]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jax_loss(jf)), **TOL)
    jg = jax.grad(lambda fl: jnp.sum(jax_loss(fl)))(jf)
    for t, g in zip(tf, jg):
        np.testing.assert_allclose(_nhwc(t.grad), np.asarray(g), **GTOL)
    # the tiled edge weights equal those of the duplicated center image
    dup = [torch.cat([_nchw(x)] * 2, 0) for x in imgs]
    torch.testing.assert_close(got, tl.flow_smooth_loss(tf, dup, NS))


def test_flow_normalization_matches_jax_and_is_finite_at_zero(stack):
    _, _, flows = stack
    t = _nchw(flows[0], True)
    got = tl.flow_normalization(t)
    got.sum().backward()
    np.testing.assert_allclose(_nhwc(got), np.asarray(jl.flow_normalization(jnp.asarray(flows[0]))),
                               **TOL)
    assert bool(torch.isfinite(t.grad).all())
    assert float(got[0, :, 0, 0].detach().abs().sum()) == 0.0


def test_consistency_matches_jax_and_detaches_bwd(stack):
    warped, imgs, flows = stack
    b = imgs[0].shape[0]
    _, w = tl.diff_and_occlusion_weights_packed(
        [_nchw(x) for x in warped], [_nchw(x) for x in imgs], NS)
    occ = [x[b:] for x in w]
    fwd = [_nchw(f[b:], True) for f in flows]
    bwd = [_nchw(f[:b], True) for f in flows]
    got = tl.flow_consistency_loss(fwd, bwd, occ, NS)
    got.sum().backward()
    assert all(x.grad is None for x in bwd)

    jocc = [jnp.asarray(_nhwc(x)) for x in occ]

    def jax_loss(jfwd, jbwd):
        return jl.flow_consistency_loss(jfwd, jbwd, jocc, NS)

    jfwd = [jnp.asarray(f[b:]) for f in flows]
    jbwd = [jnp.asarray(f[:b]) for f in flows]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jax_loss(jfwd, jbwd)), **TOL)
    jg = jax.grad(lambda f: jnp.sum(jax_loss(f, jbwd)))(jfwd)
    for t, g in zip(fwd, jg):
        np.testing.assert_allclose(_nhwc(t.grad), np.asarray(g), **GTOL)
