"""The port's spatial (height-sharded) inference against the JAX package (CPU).

Every shard lies on the CPU, as the JAX tests' shards lie on 8 virtual CPU
devices; the card runs the same code with the shards on CUDA devices
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 11).  Shapes and
config are ``tests/test_spatial.py``'s (H, W, B = 128, 64, 2), with JAX's
``init_flow_model(scheme="pwc")`` weights moved across.

Tolerances: the halo exchange exactly; the plain hpad trio and the sharded
cost volume rtol 1e-5 / atol 1e-6 (float32 sums in another order;
``test_spatial.py::test_spmd_corr_xla_fallback_matches``); the sharded model
within 1e-4 * (1 + max|flow|) of JAX's (the port-against-JAX rule of
``test_torch_inference.py``) and within 2e-5 of the port's unsharded flow
(``test_spatial.py``'s sharded-against-unsharded tolerance), whole frame.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from unopticalflow_tpu.models import FlowModelConfig as JaxFlowModelConfig
from unopticalflow_tpu.models import init_flow_model
from unopticalflow_tpu.ops.pallas_spmd import (
    _df1_hpad,
    _df2_hpad,
    _fwd_hpad,
    _halo_exchange_h,
    cost_volume_spmd,
)
from unopticalflow_tpu.parallel import spatial as jax_spatial
from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, inference_flow
from unopticalflow_tpu_torch.models.layers import conv_block
from unopticalflow_tpu_torch.ops.cost_volume import (
    corr_df1_hpad_reference,
    corr_df2_hpad_reference,
    corr_fwd_hpad_reference,
)
from unopticalflow_tpu_torch.ops.cost_volume_spmd import (
    cost_volume_sharded,
    halo_exchange_h,
    zero_halo,
)
from unopticalflow_tpu_torch.ops.resize import resize_bilinear
from unopticalflow_tpu_torch.ops.warp import bilinear_warp
from unopticalflow_tpu_torch.parallel import (
    gather_rows,
    make_spatial_infer,
    shard_images,
    spatial_mesh,
)
from unopticalflow_tpu_torch.parallel.spatial import _ShardOps
from unopticalflow_tpu_torch.serve import FlowServer
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


H, W, B = 128, 64, 2
MD = 4
SPEC = P(None, "spatial", None, None)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def _split(x, n):
    """(B, C, H, W) tensor -> n equal row-shards (contiguous)."""
    return [s.contiguous() for s in torch.chunk(x, n, dim=2)]


@pytest.fixture(scope="module")
def setup():
    cfg = JaxFlowModelConfig(num_scales=3)
    init = jax.jit(init_flow_model, static_argnames="scheme")
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), scheme="pwc"))
    model = load_jax_params(FlowModel(FlowModelConfig(), device="cpu"), params)
    rng = np.random.RandomState(0)
    img1 = rng.rand(B, H, W, 3).astype(np.float32)
    img2 = rng.rand(B, H, W, 3).astype(np.float32)
    with torch.inference_mode():
        dense = inference_flow(model, torch.from_numpy(img1), torch.from_numpy(img2)).numpy()
    return cfg, params, model, img1, img2, dense


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("rows", [8, 24])  # 8 rows at n = 4: shards shorter than md
def test_halo_exchange_matches_jax(n, rows):
    x = np.random.RandomState(rows + n).randn(2, rows, 5, 3).astype(np.float32)
    mesh = jax_spatial.spatial_mesh(n_spatial=n)
    fn = jax.shard_map(lambda a: _halo_exchange_h(a, "spatial", n, MD), mesh=mesh,
                       in_specs=(SPEC,), out_specs=SPEC, check_vma=False)
    want = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    got = halo_exchange_h(_split(_nchw(x), n), MD)
    assert all(g.shape == (2, 3, rows // n + 2 * MD, 5) and g.is_contiguous() for g in got)
    np.testing.assert_array_equal(_nhwc(torch.cat(got, 2)), want)
    # one shard: zeros above and below, as a map that is not split
    np.testing.assert_array_equal(halo_exchange_h([_nchw(x)], MD)[0].numpy(),
                                  zero_halo(_nchw(x), MD).numpy())


@pytest.mark.parametrize("h", [3, 8])
@pytest.mark.parametrize("op", ["fwd", "df1", "df2"])
def test_plain_hpad_trio_matches_jax(op, h):
    rng = np.random.RandomState(h)
    c = 7
    f1 = rng.randn(2, h, 11, c).astype(np.float32)
    f2h = rng.randn(2, h + 2 * MD, 11, c).astype(np.float32)
    f1h = rng.randn(2, h + 2 * MD, 11, c).astype(np.float32)
    g = rng.randn(2, h, 11, 81).astype(np.float32)
    gh = rng.randn(2, h + 2 * MD, 11, 81).astype(np.float32)
    jax_fn, port_fn, args = {
        "fwd": (_fwd_hpad, corr_fwd_hpad_reference, (f1, f2h)),
        "df1": (_df1_hpad, corr_df1_hpad_reference, (g, f2h)),
        "df2": (_df2_hpad, corr_df2_hpad_reference, (gh, f1h)),
    }[op]
    want = np.asarray(jax_fn(*(jnp.asarray(a) for a in args), MD, False))
    got = port_fn(*(_nchw(a) for a in args), MD)
    assert got.shape[2] == h
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-6)


def test_sharded_cost_volume_and_grads_match_jax():
    """Values and both input gradients of the n = 4 sharded cost volume
    (6-row shards) against JAX's ``cost_volume_spmd`` on the 4-device mesh,
    at ``test_spmd_corr_xla_fallback_matches``'s shapes; the whole frame, so
    the rows within md of each seam are compared too.  The values are held
    element by element: a float32 sum of the 62,208 of them rounds by a few
    parts in 1e6 with the reduction's order, which PyTorch's CPU kernels do
    not fix from one process to the next."""
    rng = np.random.RandomState(1)
    f1 = rng.rand(2, 24, 16, 6).astype(np.float32)
    f2 = rng.rand(2, 24, 16, 6).astype(np.float32)

    def loss_sp(a, b):
        return jnp.sum(jnp.sin(cost_volume_spmd(a, b, MD, False)))

    mesh = jax_spatial.spatial_mesh(n_spatial=4)
    sh = NamedSharding(mesh, SPEC)
    f1s, f2s = jax.device_put(jnp.asarray(f1), sh), jax.device_put(jnp.asarray(f2), sh)
    want = jax.jit(lambda x, y: cost_volume_spmd(x, y, MD, False), in_shardings=(sh, sh))(f1s, f2s)
    g_want = jax.jit(jax.grad(loss_sp, argnums=(0, 1)), in_shardings=(sh, sh))(f1s, f2s)

    a = [s.requires_grad_(True) for s in _split(_nchw(f1), 4)]
    b = [s.requires_grad_(True) for s in _split(_nchw(f2), 4)]
    cv = cost_volume_sharded(a, b, MD)
    assert [tuple(c.shape) for c in cv] == [(2, 81, 6, 16)] * 4
    np.testing.assert_allclose(_nhwc(torch.cat(cv, 2)), np.asarray(want), rtol=1e-5, atol=1e-6)
    sum(torch.sin(c).sum() for c in cv).backward()
    for shards, gw in ((a, g_want[0]), (b, g_want[1])):
        got = _nhwc(torch.cat([s.grad for s in shards], 2))
        np.testing.assert_allclose(got, np.asarray(gw), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_data", [1, 2], ids=["spatial2", "data2xspatial2"])
def test_spatial_infer_matches_jax_and_unsharded(setup, n_data):
    cfg, params, model, img1, img2, dense = setup
    batch_axis = "data" if n_data > 1 else None
    jmesh = jax_spatial.spatial_mesh(n_spatial=2, n_data=n_data)
    jfn = jax_spatial.make_spatial_infer(cfg, jmesh, batch_axis=batch_axis)
    want = np.asarray(jfn(params, *jax_spatial.shard_images(jmesh, batch_axis, img1, img2)))

    mesh = spatial_mesh(2, n_data, devices=["cpu"] * (2 * n_data))
    with torch.inference_mode():
        grid = make_spatial_infer(model, mesh, batch_axis=batch_axis)(img1, img2)
    assert [[tuple(s.shape) for s in row] for row in grid] == \
        [[(B // n_data, H // 2, W, 2)] * 2] * n_data
    got = gather_rows(grid).numpy()
    peak = np.abs(want).max()
    assert peak > 1.0
    assert np.abs(got - want).max() <= 1e-4 * (1 + peak)
    np.testing.assert_allclose(got, dense, rtol=2e-5, atol=2e-5)


def test_spatial_rejects_bad_height(setup):
    _, _, model, img1, img2, _ = setup
    fn = make_spatial_infer(model, spatial_mesh(4, devices=["cpu"] * 4))  # needs H % 256
    with pytest.raises(ValueError, match="divisible"):
        fn(img1, img2)
    with pytest.raises(ValueError, match="divisible"):
        FlowServer(_Cfg((64, W)), model, max_batch=1, spatial=2, devices=["cpu"] * 2)


def test_spatial_mesh_needs_enough_devices():
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        spatial_mesh(2, devices=["cpu"])
    # the default is every CUDA device, never the CPU
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"need {n} devices"):
        spatial_mesh(n)
    mesh = spatial_mesh(2, 2, devices=["cpu"] * 5)
    assert (mesh.n_data, mesh.n_spatial) == (2, 2)
    with pytest.raises(ValueError, match="batch_axis"):
        shard_images(mesh, None, np.zeros((2, 128, 64, 3), np.float32))


class _Cfg:
    def __init__(self, img_hw):
        self.img_hw = img_hw


def test_spatial_server_matches_unsharded_server(setup):
    _, _, model, img1, img2, _ = setup
    pair = np.concatenate([img1[0], img2[0]], 0)
    flows = []
    for kw in ({}, {"spatial": 2, "devices": ["cpu", "cpu"]}):
        srv = FlowServer(_Cfg((H, W)), model, max_batch=2, max_wait_ms=5, **kw)
        try:
            flows.append(srv.infer(pair))
        finally:
            srv.close()
    assert flows[1].shape == (H, W, 2) and flows[1].dtype == np.float32
    np.testing.assert_allclose(flows[1], flows[0], rtol=1e-5, atol=1e-5)


def _shard_case(op):
    """(row-shards in, row-shards out by _ShardOps, the whole-map result)."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 4, 16, 9).astype(np.float32))
    sizes = [6, 4, 6]  # every shard starts on an even row; slabs of stride 2 on odd ones
    xs = [s.contiguous() for s in torch.split(x, sizes, 2)]
    ops = _ShardOps()
    if op.startswith("conv"):
        stride, dil = {"conv_s2": (2, 1), "conv_d1": (1, 1), "conv_d8": (1, 8)}[op]
        layer = conv_block(4, 5, stride, dil)
        return ops.conv(layer, xs), layer(x)
    if op.startswith("resize"):
        f = int(op[-1])
        return ops.resize(xs, f), resize_bilinear(x, (16 * f, 9 * f))
    flow = torch.from_numpy(rng.uniform(-6, 6, (2, 2, 16, 9)).astype(np.float32))
    return ops.warp(xs, [s.contiguous() for s in torch.split(flow, sizes, 2)]), \
        bilinear_warp(x, flow)


@pytest.mark.parametrize("op", ["conv_s2", "conv_d1", "conv_d8", "resize2", "resize4", "warp"])
def test_shard_op_matches_whole_map(op):
    """Each operation of the sharded model on uneven row-shards equals the
    operation on the whole map, edge rows included: the stride-2 convolution's
    slabs start one row above their shard (an odd row), its first output row
    is the shard's global row / 2; the dilation-8 convolution takes its halo
    from two shards away; the resizes clamp at the image's edges."""
    with torch.no_grad():
        got, want = _shard_case(op)
    torch.testing.assert_close(torch.cat(got, 2), want, rtol=1e-5, atol=1e-6)
