"""The port's correlation backward against the JAX package's (CPU).

``cost_volume_bwd_reference`` (the plain version of the df1/df2 CUDA
kernels) is held against autograd through ``cost_volume_reference``, the JAX
package's ``cost_volume_bwd_xla``, and ``jax.vjp`` of ``cost_volume_pallas``
with its Pallas kernels (``_corr_df1_kernel``/``_corr_df2_kernel``) run in
interpret mode, as tests/test_pallas_kernels.py runs them.  The Pallas path
takes H % 8 == 0 only; the ragged shapes (H % 8 != 0, W not a multiple of 32,
H = 1, C = 1, odd C) check df2's index reversal against the XLA formula.  Float32, rtol 1e-5 /
atol 1e-5 (sums of 81 products in another order); bfloat16 inputs within
2e-2 of the float32 result.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from unopticalflow_tpu.ops.pallas_kernels import cost_volume_pallas
from unopticalflow_tpu.ops.pallas_kernels_xla_bwd import cost_volume_bwd_xla
from unopticalflow_tpu_torch.ops.cost_volume import (
    cost_volume,
    cost_volume_bwd_reference,
    cost_volume_reference,
)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the suite runs in several workers on one machine's cores, where torch's
    # spinning thread pools (one thread a core in every worker) made the model
    # runs here up to ~70 times slower than alone (a 7 s test took 504 s)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = dict(rtol=1e-5, atol=1e-5)


def _case(shape, seed):
    """NHWC f1, f2 and the (B, H, W, 81) gradient, from numpy."""
    rng = np.random.RandomState(seed)
    b, h, w, c = shape
    return (rng.randn(b, h, w, c).astype(np.float32), rng.randn(b, h, w, c).astype(np.float32),
            rng.randn(b, h, w, 81).astype(np.float32))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _port(f1, f2, g):
    return [_nhwc(t) for t in cost_volume_bwd_reference(_nchw(g), _nchw(f1), _nchw(f2), 4)]


# (B, H, W, C): H % 8 == 0; ragged (H % 8 != 0, W % 32 != 0); the level-6 form
SHAPES = [(2, 16, 24, 8), (1, 13, 45, 5), (1, 4, 13, 7)]
# the ragged shapes at which the card holds the tiled df1/df2 kernels to these
# plain versions (chip_smoke.py phase 4): W = 33, H = 1 with C = 1, odd C,
# W % 4 == 0 off the 32-column tile, and C no multiple of the 16-channel chunk
RAGGED_BWD = [(2, 7, 33, 5), (2, 1, 45, 1), (1, 5, 100, 7), (2, 6, 36, 13), (3, 5, 19, 37)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_is_autograd_of_the_plain_forward(shape):
    f1, f2, g = _case(shape, sum(shape))
    a, b = _nchw(f1).requires_grad_(True), _nchw(f2).requires_grad_(True)
    cost_volume(a, b, 4).backward(_nchw(g))  # a CPU tensor: the plain version
    df1, df2 = _port(f1, f2, g)
    np.testing.assert_allclose(df1, _nhwc(a.grad), **TOL)
    np.testing.assert_allclose(df2, _nhwc(b.grad), **TOL)


@pytest.mark.parametrize("shape", SHAPES + RAGGED_BWD)
def test_plain_backward_matches_jax_xla(shape):
    f1, f2, g = _case(shape, sum(shape) + 1)
    want = cost_volume_bwd_xla(4, (jnp.asarray(f1), jnp.asarray(f2)), jnp.asarray(g))
    for got, ref in zip(_port(f1, f2, g), want):
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape", [(2, 16, 24, 8), (1, 8, 40, 6)])
def test_plain_backward_matches_the_pallas_kernels(shape):
    f1, f2, g = _case(shape, sum(shape) + 2)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda x, y: cost_volume_pallas(x, y, 4),
                         jnp.asarray(f1), jnp.asarray(f2))
        want = vjp(jnp.asarray(g))
    for got, ref in zip(_port(f1, f2, g), want):
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_plain_backward_bf16_against_f32():
    f1, f2, g = _case((1, 8, 12, 6), 5)
    want = cost_volume_bwd_reference(_nchw(g), _nchw(f1), _nchw(f2), 4)
    got = cost_volume_bwd_reference(_nchw(g).bfloat16(), _nchw(f1).bfloat16(),
                                    _nchw(f2).bfloat16(), 4)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), rtol=2e-2, atol=2e-2)


def test_plain_forward_still_matches_its_backward_reference():
    """Autograd of the plain forward and the plain backward agree in a loss
    that mixes both inputs (a non-linear function of the cost volume)."""
    f1, f2, _ = _case((1, 9, 11, 4), 6)
    a, b = _nchw(f1).requires_grad_(True), _nchw(f2).requires_grad_(True)
    out = cost_volume_reference(a, b, 4)
    torch.sin(out).sum().backward()
    g = torch.cos(cost_volume_reference(_nchw(f1), _nchw(f2), 4))
    df1, df2 = cost_volume_bwd_reference(g, _nchw(f1), _nchw(f2), 4)
    torch.testing.assert_close(df1, a.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(df2, b.grad, rtol=1e-5, atol=1e-6)
