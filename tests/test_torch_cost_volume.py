"""The port's cost volume against the JAX package's (CPU).

The port's plain version ``cost_volume_reference`` (NCHW) is held against the
JAX Pallas kernel run in interpret mode, as tests/test_pallas_kernels.py runs
it, and against the XLA composition.  Tolerances are the JAX package's own
(benchmarks/PALLAS_VALIDATE.json): rtol 1e-5 / atol 1e-6 in float32, 2e-2 for
bfloat16 inputs against the float32 result.  The CUDA kernel itself runs only
on the card (chip_smoke.py compares it with this plain version there).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from unopticalflow_tpu.ops.cost_volume import cost_volume_xla
from unopticalflow_tpu.ops.pallas_kernels import cost_volume_pallas
from unopticalflow_tpu_torch.ops import correlation_cuda
from unopticalflow_tpu_torch.ops.cost_volume import cost_volume, cost_volume_reference


def _pair(shape, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().numpy().transpose(0, 2, 3, 1)


# (B, H, W, C); (1, 4, 13, 7) is the level-6 form that JAX routes to XLA
@pytest.mark.parametrize("shape", [(2, 16, 24, 8), (1, 8, 13, 5), (1, 4, 13, 7)])
def test_reference_matches_jax(shape):
    f1, f2 = _pair(shape, sum(shape))
    got = _nhwc(cost_volume_reference(_nchw(f1), _nchw(f2), 4))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(cost_volume_pallas(jnp.asarray(f1), jnp.asarray(f2), 4))
    xla = np.asarray(cost_volume_xla(jnp.asarray(f1), jnp.asarray(f2), 4))
    assert got.shape == shape[:3] + (81,)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-6)


def test_reference_bf16_against_f32():
    f1, f2 = _pair((1, 16, 12, 8), 3)
    a, b = _nchw(f1), _nchw(f2)
    got = cost_volume_reference(a.bfloat16(), b.bfloat16(), 4)
    assert got.dtype == torch.bfloat16
    want = cost_volume_reference(a, b, 4)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("md", [1, 2, 4])
def test_reference_channel_order(md):
    """Channel k = dy*(2md+1)+dx reads f2 at (y+dy-md, x+dx-md), zero outside."""
    f1, f2 = _pair((1, 3, 5, 6), md)
    got = cost_volume_reference(torch.from_numpy(f1), torch.from_numpy(f2), md).numpy()
    side = 2 * md + 1
    _, c, h, w = f1.shape
    for k in range(side * side):
        dy, dx = divmod(k, side)
        for y in range(h):
            for x in range(w):
                yy, xx = y + dy - md, x + dx - md
                want = 0.0
                if 0 <= yy < h and 0 <= xx < w:
                    want = float((f1[0, :, y, x] * f2[0, :, yy, xx]).sum() / c)
                assert got[0, k, y, x] == pytest.approx(want, rel=1e-5, abs=1e-6)


def test_cpu_dispatch_never_launches_the_kernel():
    """The kernel module imports without nvcc; CPU calls take the plain path."""
    f1, f2 = _pair((2, 8, 8, 4), 7)
    a, b = _nchw(f1).requires_grad_(True), _nchw(f2).requires_grad_(True)
    got = cost_volume(a, b, 4)
    got.sum().backward()
    torch.testing.assert_close(got, cost_volume_reference(_nchw(f1), _nchw(f2), 4))
    assert set(correlation_cuda.launches.values()) == {0}


def test_kernel_wrapper_rejects_cpu_tensors():
    f1, f2 = _pair((1, 8, 8, 4), 8)
    with pytest.raises(ValueError, match="CUDA"):
        correlation_cuda.correlation(_nchw(f1), _nchw(f2), 4)
    g = torch.zeros((1, 81, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        correlation_cuda.corr_df1(g, _nchw(f2), 4)
    with pytest.raises(ValueError, match="CUDA"):
        correlation_cuda.corr_df2(g, _nchw(f1), 4)
    assert set(correlation_cuda.launches.values()) == {0}
