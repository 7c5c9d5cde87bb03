"""The port's ``synthetic_epe --supervised`` step against the JAX harness's
``sup_step`` (CPU).

The JAX ``benchmarks/synthetic_epe.py`` defines ``sup_step`` inside its
``main``, so the test writes it out: the L1 distance of ``inference_flow`` to
the analytic ground truth, through ``optax.adam``.  The port runs its plain
versions of the kernels here (CPU tensors).  ``test_torch_learning.py`` runs
the ``--supervised`` harness end to end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unopticalflow_tpu.models import FlowModelConfig as JaxFlowModelConfig
from unopticalflow_tpu.models import inference_flow as jax_inference_flow
from unopticalflow_tpu.models import init_flow_model
from unopticalflow_tpu_torch.benchmarks import synthetic_epe
from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig
from unopticalflow_tpu_torch.training import make_optimizer
from unopticalflow_tpu_torch.utils.convert import load_jax_params, params_to_torch_state_dict


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # one torch thread, as in the other model-running test_torch_* files: the
    # suite runs several workers on one machine's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()), 1e-30))


def test_supervised_steps_match_the_jax_sup_step():
    """``_supervised_step`` (L1 of ``inference_flow`` against the ground
    truth) at the weights of three steps of the JAX harness's ``sup_step``
    (written out here: it is local to its ``main``), from random "pwc"
    weights on synthetic snippets (batch 2, 64x64, float32, Adam at lr
    1e-4).  At each step the port starts from JAX's weights, so its loss and
    gradient are held by relative L2 with the rule of the trajectory test in
    ``test_torch_learning.py`` (3 times JAX's own distance on snippets moved
    by one ulp, or 1e-4), and its Adam step moves the weights by lr.
    Free-running trajectories are not compared: Adam moves every gradient
    element that rounding leaves near zero by up to lr either way, so two
    runs whose gradients agree to ~5e-7 part by ~1e-3 within three steps."""
    init = jax.jit(init_flow_model, static_argnames="scheme")
    params = init(jax.random.PRNGKey(0), scheme="pwc")
    h, w, lr = 64, 64, 1e-4
    rng = np.random.RandomState(0)
    gen_kw = dict(max_bg=4, max_fg=8, tex_power=1.0)
    batches = [synthetic_epe.make_batch(rng, 2, h, w, **gen_kw)[:2] for _ in range(3)]
    jcfg = JaxFlowModelConfig(num_scales=3)
    tx = optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)

    @jax.jit
    def loss_and_grad(p, stacked, gt):
        def sup_loss(p):
            flow = jax_inference_flow(p, jcfg, stacked[:, h:2 * h], stacked[:, 2 * h:])
            return jnp.mean(jnp.abs(flow - gt))
        return jax.value_and_grad(sup_loss)(p)

    opt_state = tx.init(params)
    for stacked, gt in batches:
        loss, grads = loss_and_grad(params, jnp.asarray(stacked), jnp.asarray(gt))
        _, nudged = loss_and_grad(params, jnp.asarray(np.nextafter(stacked, np.float32(2.0))),
                                  jnp.asarray(gt))
        p_np = jax.tree.map(np.asarray, params)
        model = load_jax_params(FlowModel(FlowModelConfig(num_scales=3), device="cpu"), p_np)
        got = synthetic_epe._supervised_step(model, make_optimizer(model, lr),
                                             torch.from_numpy(stacked), torch.from_numpy(gt), h)
        assert abs(float(got["loss_total"]) - float(loss)) <= 1e-4 * float(loss)

        want_g, nudge_g = (params_to_torch_state_dict(jax.tree.map(np.asarray, g))
                           for g in (grads, nudged))
        named = dict(model.named_parameters())
        keys = sorted(want_g)
        flat = [np.concatenate([d[k].ravel() for k in keys]) for d in (want_g, nudge_g)]
        got_g = np.concatenate([named[k].grad.numpy().ravel() for k in keys])
        tol = max(1e-4, 3.0 * _rel_l2(flat[1], flat[0]))
        assert _rel_l2(got_g, flat[0]) <= tol, (_rel_l2(got_g, flat[0]), tol)

        p0 = params_to_torch_state_dict(p_np)  # Adam's first step: lr * g / (|g| + eps)
        moved = max(np.abs(named[k].detach().numpy() - p0[k]).max() for k in keys)
        assert abs(moved - lr) <= 1e-3 * lr

        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
