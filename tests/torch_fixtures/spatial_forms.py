"""The sharded training forms against JAX and the port's unsharded forms (CPU).

Shared by ``tests/test_torch_spatial_{pose,pose_pair,pair,ablation}.py``:
``make_spatial_forward`` with every shard on the CPU (the card runs the same
code with CUDA shards, ``chip_smoke.py`` phase 21) against the JAX package's
unsharded forward and ``jax.grad`` of the sum of its pack, as
``tests/test_torch_spatial_train.py`` holds the 3-frame flow forward: B 2,
W 64, num_scales 3, H 128 at n = 1, 2 and a (data 2, spatial 2) mesh, H 256
at n = 4 and, for the 2-frame forms, H 192 at n = 3 (H divides by n * 64).
The weights are JAX's ``init_flow_model`` / ``init_flowpose_model`` at
``PRNGKey(0)``, moved across with ``load_jax_params``; snippets and
intrinsics come from a numpy seed.  Each file computes its JAX references
once, in a module fixture, one jitted gradient a height, and imports
``few_threads``, which pytest then applies to each of its tests.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unopticalflow_tpu.models import FlowModelConfig as JaxFlowModelConfig
from unopticalflow_tpu.models import flowpose_model as jfp
from unopticalflow_tpu.models import init_flow_model, init_flowpose_model
from unopticalflow_tpu.models.flow_model import forward as jax_forward
from unopticalflow_tpu.models.flow_model import forward_pair as jax_forward_pair
from unopticalflow_tpu_torch.models import (
    FlowModel,
    FlowModelConfig,
    FlowPoseModel,
    forward,
    forward_flowpose,
    forward_flowpose_pair,
    forward_pair,
)
from unopticalflow_tpu_torch.parallel import make_spatial_forward, spatial_mesh
from unopticalflow_tpu_torch.utils.convert import load_jax_params, params_to_torch_state_dict

B, W = 2, 64
JAX_TOL = {"rtol": 5e-4, "atol": 5e-5}  # tests/test_spatial.py's
DENSE_TOL = {"rtol": 2e-5, "atol": 2e-6}
# mesh id -> (n_data, n_spatial, the frame's rows)
MESHES = {"spatial1": (1, 1, 128), "spatial2": (1, 2, 128), "spatial4": (1, 4, 256),
          "data2xspatial2": (2, 2, 128), "spatial3": (1, 3, 192)}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """One torch thread while a file runs: several workers share the
    machine's cores (tests/test_torch_spatial_train.py says how much their
    spinning thread pools cost)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Form:
    """One sharded form: its frames, whether it is the flow + pose model, the
    config's occlusion switch, and the JAX and port unsharded forwards."""

    def __init__(self, frames, pose, weighted, jax_fn, port_fn):
        self.frames, self.pose, self.weighted = frames, pose, weighted
        self.jax_fn, self.port_fn = jax_fn, port_fn

    def meshes(self):
        return [m for m in MESHES if self.frames == 2 or m != "spatial3"]

    def heights(self):
        return sorted({MESHES[m][2] for m in self.meshes()})


FORMS = {
    "ablation": Form(3, False, False, lambda p, c, x, k, ki: jax_forward(p, c, x),
                     lambda m, c, x, k, ki: forward(m, c, x)),
    "pair": Form(2, False, True, lambda p, c, x, k, ki: jax_forward_pair(p, c, x),
                 lambda m, c, x, k, ki: forward_pair(m, c, x)),
    "flowpose": Form(3, True, True, jfp.forward_flowpose, forward_flowpose),
    "flowpose_pair": Form(2, True, True, jfp.forward_flowpose_pair, forward_flowpose_pair),
}


def snippets(frames: int, h: int, seed: int = 0) -> np.ndarray:
    """(B, frames * H, W, 3): two random frames stacked (img1, img2[, img1])."""
    rng = np.random.RandomState(seed)
    img1 = rng.rand(B, h, W, 3).astype(np.float32)
    img2 = rng.rand(B, h, W, 3).astype(np.float32)
    return np.concatenate([img1, img2, img1][:frames], 1)


def intrinsics(h: int, seed: int = 1):
    """(B, 3, 3) intrinsics at the network's resolution and their inverses
    (tests/test_torch_flowpose.py's draw at H rows)."""
    rng = np.random.RandomState(seed)
    k = np.zeros((B, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = 0.9 * W + rng.rand(B)
    k[:, 0, 2], k[:, 1, 2], k[:, 2, 2] = W / 2 + rng.randn(B), h / 2 + rng.randn(B), 1.0
    return k, np.linalg.inv(k).astype(np.float32)


def jax_reference(form: Form) -> dict:
    """The JAX weights, and by height the snippets, the intrinsics, and
    JAX's pack and gradients (state-dict keys) of the sum of the pack."""
    init = jax.jit(init_flowpose_model if form.pose else init_flow_model)
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    cfg = JaxFlowModelConfig(num_scales=3, use_occlusion_weights=form.weighted)

    def total(p, x, k, k_inv):
        pack = form.jax_fn(p, cfg, x, k, k_inv)
        return sum(jnp.sum(v) for v in pack.values()), pack

    fn = jax.jit(jax.value_and_grad(total, has_aux=True))
    out = {"params": params}
    for h in form.heights():
        images, ks = snippets(form.frames, h), intrinsics(h)
        (_, pack), g = fn(params, jnp.asarray(images), *map(jnp.asarray, ks))
        out[h] = (images, ks, {k: np.asarray(v) for k, v in pack.items()},
                  params_to_torch_state_dict(jax.tree.map(np.asarray, g)))
    return out


def port_run(form: Form, params, images, ks, reg: bool = False, mesh_id: str | None = None):
    """The port's pack and parameter gradients of the sum of the pack: the
    sharded form on ``MESHES[mesh_id]``'s CPU mesh, else the unsharded one."""
    cfg = FlowModelConfig(use_occlusion_weights=form.weighted, use_pallas_reg=reg)
    model = load_jax_params((FlowPoseModel if form.pose else FlowModel)(cfg, device="cpu"),
                            params)
    args = (torch.from_numpy(images), *map(torch.from_numpy, ks))
    if mesh_id is None:
        pack = form.port_fn(model, cfg, *args)
    else:
        n_data, n, _ = MESHES[mesh_id]
        mesh = spatial_mesh(n, n_data, devices=["cpu"] * (n * n_data))
        fn = make_spatial_forward(model, cfg, mesh, "data" if n_data > 1 else None,
                                  frames=form.frames)
        pack = fn(*(args if form.pose else args[:1]))
    sum(v.sum() for v in pack.values()).backward()
    return ({k: v.detach().numpy() for k, v in pack.items()},
            {k: p.grad.numpy() for k, p in model.named_parameters()})


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()), 1e-30))


def check(got, jax_ref, dense, nudged=None):
    """The sharded pack and gradients within ``JAX_TOL`` of JAX's and within
    ``DENSE_TOL`` of the port's unsharded ones, every gradient nonzero.

    With ``nudged`` (the port's unsharded gradients on the snippets moved by
    one float32 ulp; the pose forms), every gradient is held per tensor
    instead, by chip_smoke.py phase 21's rule: relative L2 from the unsharded
    one within 3 times the unsharded one's own distance on the moved
    snippets, floor 1e-4, and from JAX's no farther than the unsharded one
    is plus that bound.  The epipolar loss's gradient, which reaches both
    branches, carries rounding element by element as the flow losses' does
    not: the port's unsharded pose gradients sit 1.6-6.3e-4 from JAX's here
    (relative L2 a tensor, beyond 5e-4 / 5e-5 element by element), a one-ulp
    move of the snippets shifts them 1-4e-5, and a slab's convolutions 1-3e-5
    (a flow bias element of the 256-row frame at n = 4 goes 4.2e-6 past
    2e-5 / 2e-6).  At this init the flows are near zero, so each pixel's
    epipolar residual x1^T F x2 is near zero, and the gradient of
    sqrt(Sampson + 1e-6) weighs its rounding.
    """
    (pack, grads), (jax_pack, jax_grads), (dense_pack, dense_grads) = got, jax_ref, dense
    assert sorted(pack) == sorted(jax_pack) == sorted(dense_pack)
    for k, v in jax_pack.items():
        assert pack[k].shape == (B,) and pack[k].dtype == np.float32
        np.testing.assert_allclose(pack[k], v, err_msg=k, **JAX_TOL)
        np.testing.assert_allclose(pack[k], dense_pack[k], err_msg=k, **DENSE_TOL)
    assert sorted(grads) == sorted(jax_grads)
    for k, g in jax_grads.items():
        assert np.abs(g).max() > 0, k
        if nudged is not None:
            bound = max(1e-4, 3 * rel_l2(nudged[k], dense_grads[k]))
            assert rel_l2(grads[k], dense_grads[k]) <= bound, k
            assert rel_l2(grads[k], g) <= rel_l2(dense_grads[k], g) + bound, k
            continue
        np.testing.assert_allclose(grads[k], g, err_msg=k, **JAX_TOL)
        np.testing.assert_allclose(grads[k], dense_grads[k], err_msg=k, **DENSE_TOL)
