"""The port's spatial (height-sharded) training forward against the JAX package (CPU).

``make_spatial_forward`` with every shard on the CPU (the card runs the same
code with CUDA shards, ``chip_smoke.py`` phase 21) against JAX ``forward``
and ``jax.grad`` of the sum of its pack, as ``tests/test_spatial.py::
test_spatial_training_gradients_match`` holds JAX's sharded gradients to its
unsharded ones: B 2, H 128, W 64, num_scales 3 for n = 1, 2 and a (data 2,
spatial 2) mesh, H 256 for n = 4 (H divides by n * 64), the JAX test's
``init_flow_model(PRNGKey(0))`` weights moved across, snippets made from a
numpy seed.

Tolerances: the pack and every parameter's gradient within rtol 5e-4 /
atol 5e-5 of JAX (the JAX test's own), and within rtol 2e-5 / atol 2e-6 of
the port's unsharded ``forward`` on the same weights (the shards' slab
convolutions and sums round in another order; the worst gradient here sits
near 0.6 of it).  The plain row-shard versions of the photometric and
regularizer packs, added over the shards, equal the whole-map plain versions
within rtol 1e-5 / atol 1e-6, values and flow gradients (the same per-pixel
arithmetic; only the sums' order differs), and so does the regularizer with
a bfloat16 image.  The photometric pack in bfloat16 rounds its products and
its gradients to bfloat16 along the way, where PyTorch's CPU kernels round
a slab's last float32 bits apart from the whole map's (they vectorise by the
tensor's size): its weights within one bfloat16 ulp, its sums within rtol
1e-3 and its flow gradients within 2e-2 of their largest value (the JAX
package's bfloat16 tolerance; the worst here 0.4-1.3% of it).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unopticalflow_tpu.models import FlowModelConfig as JaxFlowModelConfig
from unopticalflow_tpu.models import forward as jax_forward
from unopticalflow_tpu.models import init_flow_model
from unopticalflow_tpu.utils.torch_convert import params_to_torch_state_dict
from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, FlowPoseModel, forward
from unopticalflow_tpu_torch.ops import photometric_cuda, regularizer_cuda
from unopticalflow_tpu_torch.ops.cost_volume_spmd import take_rows
from unopticalflow_tpu_torch.ops.photometric import (
    photometric_pack_reference,
    photometric_pack_rows,
    photometric_pack_rows_reference,
)
from unopticalflow_tpu_torch.ops.regularizer import (
    regularizer_pack_reference,
    regularizer_pack_rows,
    regularizer_pack_rows_reference,
)
from unopticalflow_tpu_torch.parallel import make_spatial_forward, spatial_mesh
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


B, W = 2, 64
HEIGHTS = {1: 128, 2: 128, 4: 256}  # the frame's rows by spatial shards
JAX_TOL = {"rtol": 5e-4, "atol": 5e-5}  # tests/test_spatial.py's
DENSE_TOL = {"rtol": 2e-5, "atol": 2e-6}
ROWS_TOL = {"rtol": 1e-5, "atol": 1e-6}
BF16_ULP = 2.0**-7  # bfloat16's 8-bit significand: one ulp at most this relative


def _snippets(h, seed=0):
    """(B, 3H, W, 3): two random frames stacked (img1, img2, img1), as the JAX test."""
    rng = np.random.RandomState(seed)
    img1 = rng.rand(B, h, W, 3).astype(np.float32)
    img2 = rng.rand(B, h, W, 3).astype(np.float32)
    return np.concatenate([img1, img2, img1], 1)


@pytest.fixture(scope="module")
def ref():
    """The JAX weights, the snippets of each height, and JAX's pack and
    gradients (state-dict keys) of the sum of the pack on them, computed once."""
    init = jax.jit(init_flow_model)
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    cfg = JaxFlowModelConfig(num_scales=3)

    def total(p, x):
        pack = jax_forward(p, cfg, x)
        return sum(jnp.sum(v) for v in pack.values()), pack

    fn = jax.jit(jax.value_and_grad(total, has_aux=True))
    out = {"params": params}
    for h in sorted(set(HEIGHTS.values())):
        images = _snippets(h)
        (_, pack), g = fn(params, jnp.asarray(images))
        out[h] = (images, {k: np.asarray(v) for k, v in pack.items()},
                  params_to_torch_state_dict(jax.tree.map(np.asarray, g)))
    return out


def _run(params, reg, images, fn=None):
    """The port's pack and parameter gradients of the sum of the pack:
    ``fn(model, cfg)`` builds the forward (the unsharded one by default)."""
    cfg = FlowModelConfig(use_pallas_reg=reg)
    model = load_jax_params(FlowModel(cfg, device="cpu"), params)
    fwd = fn(model, cfg) if fn else (lambda x: forward(model, cfg, x))
    pack = fwd(torch.from_numpy(images))
    sum(v.sum() for v in pack.values()).backward()
    return ({k: v.detach().numpy() for k, v in pack.items()},
            {k: p.grad.numpy() for k, p in model.named_parameters()})


@pytest.fixture(scope="module")
def dense(ref):
    """The port's unsharded pack and gradients by (height, use_pallas_reg)."""
    return {(h, reg): _run(ref["params"], reg, ref[h][0])
            for h in sorted(set(HEIGHTS.values())) for reg in (False, True)}


@pytest.mark.parametrize("reg", [False, True], ids=["reg_off", "reg_on"])
@pytest.mark.parametrize("n_data,n", [(1, 1), (1, 2), (1, 4), (2, 2)],
                         ids=["spatial1", "spatial2", "spatial4", "data2xspatial2"])
def test_spatial_forward_and_gradients_match_jax_and_unsharded(ref, dense, n_data, n, reg):
    h = HEIGHTS[n]
    images, jax_pack, jax_grads = ref[h]
    batch_axis = "data" if n_data > 1 else None
    mesh = spatial_mesh(n, n_data, devices=["cpu"] * (n * n_data))
    pack, grads = _run(ref["params"], reg, images,
                       lambda model, cfg: make_spatial_forward(model, cfg, mesh, batch_axis))
    dense_pack, dense_grads = dense[h, reg]
    assert sorted(pack) == sorted(jax_pack)
    for k, v in jax_pack.items():
        assert pack[k].shape == (B,) and pack[k].dtype == np.float32
        np.testing.assert_allclose(pack[k], v, err_msg=k, **JAX_TOL)
        np.testing.assert_allclose(pack[k], dense_pack[k], err_msg=k, **DENSE_TOL)
    assert sorted(grads) == sorted(jax_grads)
    for k, g in jax_grads.items():
        assert np.abs(g).max() > 0, k
        np.testing.assert_allclose(grads[k], g, err_msg=k, **JAX_TOL)
        np.testing.assert_allclose(grads[k], dense_grads[k], err_msg=k, **DENSE_TOL)


def _whole_and_rows(n, dtype, seed):
    """Random (B, 3, H, W) images in ``dtype`` and float32 flows reaching past
    the frame's edges, the flows as leaves and as n row-shards with one halo
    row each side (zeros outside the image), through ``take_rows`` so the
    halo rows' gradients flow back to the leaves."""
    h, w = 32, 24
    rng = np.random.RandomState(seed)
    img_l, img_r, img = (torch.from_numpy(rng.rand(B, 3, h, w).astype(np.float32)).to(dtype)
                         for _ in range(3))
    flows = [torch.from_numpy(rng.uniform(-6, 6, (B, 2, h, w)).astype(np.float32))
             .requires_grad_(True) for _ in range(2)]
    hs = h // n
    starts = [i * hs for i in range(n)]

    def slabs(x):
        parts = list(torch.chunk(x, n, 2))
        return [take_rows(parts, r - 1, r + hs + 1, "cpu") for r in starts]

    return (img_l, img_r, img, flows), starts, slabs


def _grads(out, leaves, seed):
    """d(sum_k out[k] * a_k) / d(leaves) for fixed random cotangents a_k."""
    gen = torch.Generator().manual_seed(seed)
    loss = sum((v * torch.rand(v.shape, generator=gen)).sum() for v in out.values()
               if v.requires_grad)
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("pack", ["photometric", "regularizer"])
def test_rows_references_add_up_to_the_whole_map(pack, n, dtype):
    (img_l, img_r, img, (fb, ff)), starts, slabs = _whole_and_rows(n, dtype, seed=n)
    h = img.shape[2]
    if pack == "photometric":
        want = photometric_pack_reference(img_l, img_r, fb, ff, img)
        got = [photometric_pack_rows_reference(img_l, img_r, b_, f_, c_, r, h)
               for b_, f_, c_, r in zip(slabs(fb), slabs(ff), slabs(img), starts)]
        weights = torch.cat([g.pop("weights") for g in got], 2).float().numpy()
        np.testing.assert_allclose(weights, want.pop("weights").float().numpy(),
                                   **ROWS_TOL if dtype == torch.float32 else
                                   {"rtol": BF16_ULP, "atol": 0})
    else:
        w_fwd = photometric_pack_reference(img_l, img_r, fb, ff, img)["weights"][B:]
        want = regularizer_pack_reference(fb, ff, img, w_fwd)
        got = [regularizer_pack_rows_reference(b_, f_, c_, w_fwd[:, :, r:r + h // n], r, h)
               for b_, f_, c_, r in zip(slabs(fb), slabs(ff), slabs(img), starts)]
    rounded = pack == "photometric" and dtype == torch.bfloat16
    total = {k: sum(g[k] for g in got) for k in want}
    for k, v in want.items():
        np.testing.assert_allclose(total[k].detach().numpy(), v.detach().numpy(), err_msg=k,
                                   **({"rtol": 1e-3, "atol": 0} if rounded else ROWS_TOL))
    for a, b_ in zip(_grads(total, [fb, ff], n), _grads(want, [fb, ff], n)):
        peak = float(b_.abs().max())
        assert peak > 0
        np.testing.assert_allclose(a.numpy(), b_.numpy(),
                                   **({"rtol": 0, "atol": 2e-2 * peak} if rounded else ROWS_TOL))


def test_rows_dispatch_takes_the_plain_versions_on_cpu():
    (img_l, img_r, img, (fb, ff)), starts, slabs = _whole_and_rows(2, torch.float32, seed=7)
    args = (img_l, img_r, slabs(fb)[1], slabs(ff)[1], slabs(img)[1], starts[1], img.shape[2])
    got = photometric_pack_rows(*args)
    for k, v in photometric_pack_rows_reference(*args).items():
        torch.testing.assert_close(got[k], v)
    reg_args = (*args[2:4], args[4], got["weights"][B:].detach(), starts[1], img.shape[2])
    got_reg = regularizer_pack_rows(*reg_args)
    for k, v in regularizer_pack_rows_reference(*reg_args).items():
        torch.testing.assert_close(got_reg[k], v)
    # the kernels' wrappers take CUDA tensors only
    with pytest.raises(ValueError, match="CUDA"):
        photometric_cuda.photometric_rows(*args)
    with pytest.raises(ValueError, match="CUDA"):
        regularizer_cuda.regularizer_rows(*reg_args)
    assert set(photometric_cuda.launches.values()) == {0}
    assert set(regularizer_cuda.launches.values()) == {0}


def test_spatial_forward_refuses_what_it_cannot_shard():
    mesh = spatial_mesh(2, devices=["cpu"] * 2)
    model = FlowModel(FlowModelConfig(), device="cpu")
    fn = make_spatial_forward(model, FlowModelConfig(), mesh)
    with pytest.raises(ValueError, match="divisible"):
        fn(_snippets(64, seed=0))  # H = 64, not a multiple of 2 * 64
    with pytest.raises(ValueError, match=r"\(B, 3H, W, 3\)"):
        fn(np.zeros((B, 256, W, 3), np.float32))
    # once refused, the occlusion ablation and the flowposenet forward now
    # have sharded forms (tests/test_torch_spatial_ablation.py, _pose.py)
    assert callable(make_spatial_forward(model, FlowModelConfig(use_occlusion_weights=False),
                                         mesh))
    pose_model = FlowPoseModel(FlowModelConfig(), device="cpu")
    pose_fn = make_spatial_forward(pose_model, FlowModelConfig(), mesh)
    with pytest.raises(ValueError, match="intrinsics"):
        pose_fn(_snippets(128, seed=0))  # a flowposenet call without intrinsics
    k = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    with pytest.raises(ValueError, match="intrinsics"):
        fn(_snippets(128, seed=0), k, k)  # a flow model's call with them
    # a 2-frame stack of the wrong height
    pair_fn = make_spatial_forward(model, FlowModelConfig(), mesh, frames=2)
    with pytest.raises(ValueError, match="divisible"):
        pair_fn(np.zeros((B, 2 * 64, W, 3), np.float32))
    with pytest.raises(ValueError, match=r"\(B, 2H, W, 3\)"):
        pair_fn(np.zeros((B, 257, W, 3), np.float32))
    with pytest.raises(ValueError, match="frames must be 2 or 3"):
        make_spatial_forward(model, FlowModelConfig(), mesh, frames=4)
    with pytest.raises(ValueError, match="batch_axis='data'"):
        make_spatial_forward(model, FlowModelConfig(), spatial_mesh(2, 2, devices=["cpu"] * 4))(
            _snippets(128, seed=0))
