"""The port's regularizer pack against the JAX package's (CPU).

The port's plain version ``regularizer_pack_reference(flow_b, flow_f, img,
w_fwd)`` (NCHW, the contract of the CUDA kernels) is held against the JAX
``_reg_run_fwd`` with ``pallas_call`` forced into interpret mode (the fixture
of tests/test_pallas_regularizer.py, so ``_reg_fwd_kernel`` runs) and against
the JAX ``regularizer_pack_reference``: sums within rtol/atol 1e-5 (float32
sums in another order).  The flow gradients are held against ``jax.grad`` of
the JAX reference (``jax.grad`` of the interpret kernel is the slow tier
there) within rtol 1e-4 / atol 1e-5, the JAX package's tolerance for its
kernel.  The training forward with ``use_pallas_reg`` is held against the
JAX forward at 64x64 within rtol 1e-4 on all four losses, with the JAX
weights carried across by the port's own ``params_to_torch_state_dict``.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from unopticalflow_tpu.models import FlowModelConfig as JaxFlowModelConfig
from unopticalflow_tpu.models import forward as jax_forward
from unopticalflow_tpu.models import init_flow_model
from unopticalflow_tpu.ops import pallas_regularizer as pr
from unopticalflow_tpu.utils import torch_convert
from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, forward
from unopticalflow_tpu_torch.ops import regularizer_cuda
from unopticalflow_tpu_torch.ops.regularizer import regularizer_pack, regularizer_pack_reference
from unopticalflow_tpu_torch.utils.convert import load_jax_params, params_to_torch_state_dict


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the suite runs in several workers on one machine's cores, where torch's
    # spinning thread pools (one thread a core in every worker) made the model
    # runs here up to ~70 times slower than alone (a 7 s test took 504 s)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


KEYS = ("s_sx", "s_sy", "s_consis")


@pytest.fixture(scope="module")
def interpret_pack():
    """pallas_call forced into interpreter mode."""
    orig = pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    with mock.patch.object(pl, "pallas_call", interp):
        yield


def _case(b, h, w, seed=11):
    """NHWC numpy: flow_b, flow_f, img, w_fwd."""
    rng = np.random.RandomState(seed)
    flow_b = rng.uniform(-6, 6, (b, h, w, 2)).astype(np.float32)
    flow_f = rng.uniform(-6, 6, (b, h, w, 2)).astype(np.float32)
    img = rng.rand(b, h, w, 3).astype(np.float32)
    w_fwd = rng.rand(b, h, w, 1).astype(np.float32)
    return flow_b, flow_f, img, w_fwd


def _nchw(x, grad=False, dtype=torch.float32):
    t = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(dtype)
    return t.requires_grad_(grad)


def _port(case, grad=False, dtype=torch.float32):
    fb, ff = _nchw(case[0], grad), _nchw(case[1], grad)
    return regularizer_pack_reference(fb, ff, _nchw(case[2], dtype=dtype),
                                      _nchw(case[3], dtype=dtype)), fb, ff


def _total(out, h, w, lib):
    # the three sums weighted differently, so a cross-wired cotangent is caught
    return (lib.sum(out["s_sx"]) / (h * (w - 2) * 2) + lib.sum(out["s_sy"]) / ((h - 2) * w * 2)
            + 0.37 * lib.sum(out["s_consis"]))


@pytest.mark.parametrize("shape", [(2, 16, 32), (2, 13, 24), (1, 3, 5)])
def test_plain_matches_jax(interpret_pack, shape):
    """(2, 16, 32) also against the Pallas kernel; H % 8 != 0 against the JAX
    reference only (the kernel needs H % 8 == 0, ``pr.supported``)."""
    case = _case(*shape)
    got, _, _ = _port(case)
    jargs = [jnp.asarray(x) for x in case]
    wants = [pr.regularizer_pack_reference(*jargs)]
    if pr.supported(shape[1]):
        wants.append(pr._reg_run_fwd(*jargs))
    for want in wants:
        for k in KEYS:
            assert got[k].shape == want[k].shape and got[k].dtype == torch.float32
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_plain_matches_jax_with_bf16_images():
    """A bfloat16 image and weights (the bf16 loss stack) are widened to float32."""
    case = _case(2, 16, 32, seed=3)
    got, _, _ = _port(case, dtype=torch.bfloat16)
    jargs = [jnp.asarray(case[0]), jnp.asarray(case[1]),
             jnp.asarray(case[2], jnp.bfloat16), jnp.asarray(case[3], jnp.bfloat16)]
    want = pr.regularizer_pack_reference(*jargs)
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("shape", [(2, 16, 32), (1, 13, 24)])
def test_flow_gradients_match_jax(shape):
    case = _case(*shape, seed=5)
    _, h, w = shape
    out, fb, ff = _port(case, grad=True)
    _total(out, h, w, torch).backward()
    img, w_fwd = jnp.asarray(case[2]), jnp.asarray(case[3])
    want = jax.grad(lambda a, b: _total(pr.regularizer_pack_reference(a, b, img, w_fwd), h, w, jnp),
                    argnums=(0, 1))(jnp.asarray(case[0]), jnp.asarray(case[1]))
    for got, ref, name in ((fb.grad, want[0], "d_flow_b"), (ff.grad, want[1], "d_flow_f")):
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_consis_grad_only_reaches_fwd():
    out, fb, ff = _port(_case(2, 16, 32), grad=True)
    # flow_b stays in the graph through the smoothness sums, weighted 0
    (out["s_consis"].sum() + 0.0 * out["s_sx"].sum()).backward()
    assert float(fb.grad.abs().max()) == 0.0
    assert float(ff.grad.abs().max()) > 0.0


def test_dispatch_takes_the_plain_version_on_cpu():
    case = _case(1, 8, 16)
    args = [_nchw(x) for x in case]
    before = dict(regularizer_cuda.launches)
    got = regularizer_pack(*args)
    want = regularizer_pack_reference(*args)
    for k in KEYS:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert regularizer_cuda.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        regularizer_pack(*(a.to("meta") for a in args))
    # the kernel's wrapper takes CUDA tensors only, and checks before it builds
    with pytest.raises(ValueError, match="CUDA"):
        regularizer_cuda.reg_fwd(*args)
    assert regularizer_cuda.launches == before


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
    """Both regularizer kernels launch the grid (ceil(W / 32), ceil(H / 16), B)
    and index with 32-bit integers: a shape is refused before any launch when
    the grid's y or z passes 65535 or B * 3 * H * W reaches 2**31."""
    before = dict(regularizer_cuda.launches)
    if ok:
        regularizer_cuda._check_grid(shape)
    else:
        with pytest.raises(ValueError, match="cannot launch"):
            regularizer_cuda._check_grid(shape)
    assert regularizer_cuda.launches == before


@pytest.fixture(scope="module")
def params():
    init = jax.jit(init_flow_model, static_argnames="scheme")
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(3), scheme="pwc"))


def test_weights_carried_by_the_ports_own_mapping(params):
    """The port's numpy mapping gives the JAX package's keys and arrays."""
    got = params_to_torch_state_dict(params)
    want = torch_convert.params_to_torch_state_dict(params)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    model = load_jax_params(FlowModel(device="cpu"), params)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("jax_path", ["pallas", "xla"])
def test_forward_with_regularizer_matches_jax(interpret_pack, params, jax_path):
    """64x64, batch 2, float32: the port's forward with ``use_pallas_reg``
    (the plain regularizer on the CPU) against the JAX forward with its fused
    photometric and regularizer kernels (interpret mode) and against its XLA
    path."""
    rng = np.random.RandomState(4)
    base = rng.rand(2, 68, 68, 3).astype(np.float32)
    images = np.concatenate([base[:, 0:64, 0:64], base[:, 2:66, 1:65], base[:, 4:68, 2:66]], 1)
    fused = jax_path == "pallas"
    jcfg = JaxFlowModelConfig(num_scales=3, use_pallas_photo=fused, use_pallas_reg=fused)
    want = jax.jit(lambda p, x: jax_forward(p, jcfg, x))(params, jnp.asarray(images))
    cfg = FlowModelConfig(use_pallas_reg=True)
    model = load_jax_params(FlowModel(cfg, device="cpu"), params)
    with torch.no_grad():
        got = forward(model, cfg, torch.from_numpy(images))
    for k, v in want.items():
        assert got[k].shape == (2,) and bool(torch.isfinite(got[k]).all())
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
