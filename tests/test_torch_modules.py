"""The port's encoder, decoder and ops against the JAX package's (CPU, f32).

Inputs come from ``np.random.RandomState`` and go to both packages; weights
are ``init_flow_model(scheme="pwc")`` (input-sensitive, so a wrong concat
order or weight layout shows) moved across with ``load_jax_params``.
Tolerances: max |port - jax| <= 1e-5 * max|jax| for the conv stacks (float32
convolutions summed in another order; JAX runs them at HIGHEST precision),
1e-5 absolute for the single-op warp and resize.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unopticalflow_tpu.models import init_flow_model
from unopticalflow_tpu.models.feature_pyramid import apply_feature_pyramid
from unopticalflow_tpu.models.pwc_decoder import apply_pwc_decoder
from unopticalflow_tpu.ops.resize import resize_bilinear as jax_resize
from unopticalflow_tpu.ops.warp import bilinear_warp as jax_warp
from unopticalflow_tpu.ops.warp import warp_validity_mask as jax_mask
from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig
from unopticalflow_tpu_torch.models.layers import Conv2d, conv_block
from unopticalflow_tpu_torch.ops import (
    bilinear_warp,
    resize_bilinear,
    upsample2x_double,
    warp_validity_mask,
)
from unopticalflow_tpu_torch.utils.convert import load_jax_params


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the suite runs in several workers on one machine's cores, where torch's
    # spinning thread pools (one thread a core in every worker) made the model
    # runs here up to ~70 times slower than alone (a 7 s test took 504 s)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B, H, W = 2, 64, 128


@pytest.fixture(scope="module")
def params():
    init = jax.jit(init_flow_model, static_argnames="scheme")
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(3), scheme="pwc"))


@pytest.fixture(scope="module")
def model(params):
    return load_jax_params(FlowModel(FlowModelConfig(), device="cpu"), params)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _close(got, want, rel=1e-5):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def test_encoder_matches_jax(params, model):
    img = np.random.RandomState(0).rand(B, H, W, 3).astype(np.float32)
    want = apply_feature_pyramid(params["fpyramid"], jnp.asarray(img), jnp.float32)
    with torch.inference_mode():
        got = model.fpyramid(_nchw(img))
    assert len(got) == len(want) == 6
    for g, w_ in zip(got, want):
        assert g.shape[0] == B and g.is_contiguous()
        _close(_nhwc(g), np.asarray(w_))


def test_decoder_matches_jax(params, model):
    rng = np.random.RandomState(1)
    chans = (16, 32, 64, 96, 128, 196)
    shapes = [(B, H >> (i + 1), W >> (i + 1), c) for i, c in enumerate(chans)]
    f1 = [rng.randn(*s).astype(np.float32) for s in shapes]
    f2 = [rng.randn(*s).astype(np.float32) for s in shapes]
    decode = jax.jit(lambda p, a, b: apply_pwc_decoder(
        p, a, b, (H, W), compute_dtype=jnp.float32, use_pallas_corr=False))
    want = decode(params["pwc"], [jnp.asarray(x) for x in f1], [jnp.asarray(x) for x in f2])
    with torch.inference_mode():
        got = model.pwc_model([_nchw(x) for x in f1], [_nchw(x) for x in f2], (H, W))
    assert [tuple(g.shape) for g in got] == [
        (B, 2, H, W), (B, 2, H // 2, W // 2), (B, 2, H // 4, W // 4), (B, 2, H // 8, W // 8)
    ]
    for g, w_ in zip(got, want):
        _close(_nhwc(g), np.asarray(w_))


@pytest.mark.parametrize("hw", [(8, 12), (1, 5)])
def test_warp_and_mask_match_jax(hw):
    h, w = hw
    rng = np.random.RandomState(h)
    img = rng.randn(2, h, w, 5).astype(np.float32)
    flow = (3 * rng.randn(2, h, w, 2)).astype(np.float32)
    for use_mask in (False, True):
        want = np.asarray(jax_warp(jnp.asarray(img), jnp.asarray(flow), use_mask=use_mask))
        got = _nhwc(bilinear_warp(_nchw(img), _nchw(flow), use_mask=use_mask))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want = np.asarray(jax_mask(jnp.asarray(flow), (h, w)))
    np.testing.assert_array_equal(_nhwc(warp_validity_mask(_nchw(flow), (h, w))), want)


def test_warp_keeps_f32_coordinates_in_bf16():
    """At W=208 bf16 cannot hold x + 0.25; the blend must still see it."""
    img = torch.arange(208, dtype=torch.float32).expand(1, 1, 2, 208).contiguous()
    flow = torch.zeros(1, 2, 2, 208)
    flow[:, 0] = 0.25
    got = bilinear_warp(img.bfloat16(), flow.bfloat16()).float()
    want = bilinear_warp(img, flow)
    torch.testing.assert_close(got, want.bfloat16().float())


def test_resize_matches_jax():
    x = np.random.RandomState(2).randn(2, 4, 13, 2).astype(np.float32)
    for out_hw in ((8, 26), (16, 52), (3, 7)):
        want = np.asarray(jax_resize(jnp.asarray(x), out_hw))
        got = _nhwc(resize_bilinear(_nchw(x), out_hw))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    up = _nhwc(upsample2x_double(_nchw(x)))
    np.testing.assert_allclose(up, 2 * np.asarray(jax_resize(jnp.asarray(x), (8, 26))),
                               rtol=1e-5, atol=1e-5)


def test_conv_block_keys_and_init_schemes():
    blk = conv_block(4, 8)
    assert set(blk.state_dict()) == {"0.weight", "0.bias"}
    conv = Conv2d(64, 32, dilation=4)
    assert conv.padding == (4, 4)
    g = torch.Generator().manual_seed(0)
    conv.reset_parameters("pwc", g)
    assert float(conv.bias.detach().abs().max()) == 0.0
    std = float(conv.weight.detach().std())
    assert abs(std - np.sqrt(2 / 1.01) / np.sqrt(64 * 9)) < 0.1 * std
    conv.reset_parameters("torch", g)
    bound = 1 / np.sqrt(64 * 9)
    assert float(conv.weight.detach().abs().max()) <= bound
    assert float(conv.bias.detach().abs().max()) > 0
    a = FlowModel(scheme="pwc", generator=torch.Generator().manual_seed(5))
    b = FlowModel(scheme="pwc", generator=torch.Generator().manual_seed(5))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    with pytest.raises(ValueError, match="scheme"):
        conv.reset_parameters("xavier")


def test_compute_dtype_policy():
    """bf16: the weight and the input are cast, the bias added in bf16."""
    conv = Conv2d(3, 4)
    conv.reset_parameters("torch", torch.Generator().manual_seed(1))
    conv.compute_dtype = torch.bfloat16
    x = torch.randn(1, 3, 5, 5, generator=torch.Generator().manual_seed(2))
    got = conv(x)
    assert got.dtype == torch.bfloat16
    want = torch.nn.functional.conv2d(
        x.bfloat16(), conv.weight.bfloat16(), None, 1, 1
    ) + conv.bias.bfloat16()[:, None, None]
    torch.testing.assert_close(got, want)
