"""The port's flow + pose branch against the JAX package (CPU, batch 2, 64x64).

Same ``init_flowpose_model(scheme="pwc")`` parameters on both sides (moved
across with the port's ``load_jax_params``), same numpy snippets and
intrinsics from ``np.random.RandomState``.  The port runs its plain kernel
versions here (CPU tensors); JAX its default XLA path.  Tolerances:

* ``PoseNet`` and ``inference_pose`` within rtol 1e-5 / atol 1e-7 of
  ``apply_pose_net`` / ``inference_pose``;
* the five losses of ``forward_flowpose`` and ``forward_flowpose_pair``, and
  the four of ``forward_pair``, within rtol 1e-4 / atol 1e-6;
* the gradient of ``loss_pose_epipolar`` alone over the pose branch within
  1e-4 by relative L2 per tensor; the weighted total's over all parameters no
  farther from JAX than JAX is from itself on snippets moved by one float32
  ulp, or 1e-4 (the rule of tests/test_torch_train.py);
* 20 Adam steps (lr 1e-4), joint and ``freeze_flow``: the losses, the pose
  net's output change on a held-out pair, the pose branch's parameter
  change and (joint) all parameters' change within 3 times JAX's own
  one-ulp distance, or 1e-4 (tests/test_torch_learning.py's rule); the
  frozen run's flow branch bit-equal to its start, its pose parameters held
  without the elements whose first gradient is at rounding level (see the
  test for why).

One jitted JAX gradient a snippet shape (about 17 s of compile each).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unopticalflow_tpu.models import FlowModelConfig as JaxFlowModelConfig
from unopticalflow_tpu.models import init_flowpose_model
from unopticalflow_tpu.models import flowpose_model as jfp
from unopticalflow_tpu.models.flow_model import forward_pair as jax_forward_pair
from unopticalflow_tpu.models.pose_net import apply_pose_net
from unopticalflow_tpu.training.train_step import loss_weights_from_config as jax_weights
from unopticalflow_tpu.training.train_step import make_optimizer as jax_make_optimizer
from unopticalflow_tpu_torch.models import (
    FlowModelConfig,
    FlowPoseModel,
    forward_flowpose,
    forward_flowpose_pair,
    forward_pair,
    inference_pose,
)
from unopticalflow_tpu_torch.training import loss_fn, loss_weights_from_config, make_optimizer
from unopticalflow_tpu_torch.training import train_step
from unopticalflow_tpu_torch.utils.convert import load_jax_params, params_to_torch_state_dict

B, H, W = 2, 64, 64
STEPS = 20
KEYS = sorted(["loss_pixel", "loss_ssim", "loss_flow_smooth", "loss_flow_consis",
               "loss_pose_epipolar"])
WEIGHTS = {"loss_pixel": 0.15, "loss_ssim": 0.85, "loss_flow_smooth": 10.0,
           "loss_flow_consis": 0.01, "loss_pose_epipolar": 1.0}
EPIPOLAR = {k: float(k == "loss_pose_epipolar") for k in KEYS}
JCFG = JaxFlowModelConfig(num_scales=3)
# a gradient element below this share of its tensor's largest is at rounding level
ROUNDING = 1e-5
CFG = FlowModelConfig(num_scales=3)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    init = jax.jit(init_flowpose_model, static_argnames="scheme")
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), scheme="pwc"))


def _snippets(seed, frames):
    """(B, frames * H, W, 3): a textured frame seen at small shifts."""
    rng = np.random.RandomState(seed)
    base = rng.rand(B, H + 4, W + 4, 3).astype(np.float32)
    return np.concatenate([base[:, 2 * i:H + 2 * i, i:W + i] for i in range(frames)], 1)


def _intrinsics(seed):
    rng = np.random.RandomState(seed)
    k = np.zeros((B, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = 0.9 * W + rng.rand(B)
    k[:, 0, 2], k[:, 1, 2], k[:, 2, 2] = W / 2 + rng.randn(B), H / 2 + rng.randn(B), 1.0
    return k, np.linalg.inv(k).astype(np.float32)


def _nudge(x):
    return np.nextafter(x, np.float32(2.0))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()), 1e-30))


def _jax_total(fwd):
    def total(p, x, k, k_inv, wv):
        pack = fwd(p, JCFG, x, k, k_inv)
        return sum(wv[i] * jnp.mean(pack[n]) for i, n in enumerate(KEYS)), pack

    return jax.jit(jax.value_and_grad(total, has_aux=True))


@pytest.fixture(scope="module")
def jax_grad3():
    return _jax_total(jfp.forward_flowpose)


@pytest.fixture(scope="module")
def jax_grad2():
    return _jax_total(jfp.forward_flowpose_pair)


def _jax_run(fn, params, x, k, weights):
    (_, pack), g = fn(params, jnp.asarray(x), jnp.asarray(k[0]), jnp.asarray(k[1]),
                      jnp.asarray([weights[n] for n in KEYS]))
    return ({n: np.asarray(v) for n, v in pack.items()},
            params_to_torch_state_dict(jax.tree.map(np.asarray, g)))


def _port_run(params, fwd, x, k, weights):
    model = load_jax_params(FlowPoseModel(CFG, device="cpu"), params)
    batch = (torch.from_numpy(x), *map(torch.from_numpy, k))
    pack = fwd(model, CFG, *batch)
    total = sum(weights[n] * v.mean() for n, v in pack.items())
    total.backward()
    return ({n: v.detach().numpy() for n, v in pack.items()},
            {n: p.grad.numpy() for n, p in model.named_parameters()})


def _check_pack(pack, want, keys):
    for k in keys:
        assert pack[k].shape == (B,) and np.isfinite(pack[k]).all(), k
        np.testing.assert_allclose(pack[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_pose_net_and_inference_pose_match_jax(params):
    rng = np.random.RandomState(1)
    img1, img2 = (rng.rand(3, 2 * H, 2 * W, 3).astype(np.float32) for _ in range(2))
    want = jax.jit(apply_pose_net)(params["pose"], img1, img2)
    model = load_jax_params(FlowPoseModel(CFG, device="cpu"), params)
    with torch.no_grad():
        got = model.pose(*(torch.from_numpy(x).permute(0, 3, 1, 2) for x in (img1, img2)))
        pose = inference_pose(model, torch.from_numpy(img1), torch.from_numpy(img2))
    assert got.shape == (3, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pose.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    sd = model.state_dict()
    assert {"pose.conv1.0.weight", "pose.conv7.0.bias", "pose.pose_pred.weight",
            "flow.fpyramid.conv1.0.weight", "flow.pwc_model.predict_flow2.weight"} <= set(sd)
    assert sd["pose.pose_pred.weight"].shape == (6, 256, 1, 1)


@pytest.mark.parametrize("frames", [3, 2])
def test_flowpose_losses_and_gradients_match_jax(params, jax_grad3, jax_grad2, frames):
    """The five losses; the epipolar gradient over the pose branch per
    tensor; the weighted total's gradient over all parameters under the
    one-ulp rule."""
    fn, fwd = (jax_grad3, forward_flowpose) if frames == 3 else (jax_grad2, forward_flowpose_pair)
    x, k = _snippets(frames, frames), _intrinsics(frames)
    want, g_epi = _jax_run(fn, params, x, k, EPIPOLAR)
    pack, grads = _port_run(params, fwd, x, k, EPIPOLAR)
    _check_pack(pack, want, KEYS)
    pose_keys = [n for n in grads if n.startswith("pose.")]
    assert len(pose_keys) == 16
    for n in pose_keys:
        assert _rel_l2(grads[n], g_epi[n]) <= 1e-4, n
    assert max(np.abs(grads[n]).max() for n in grads if n.startswith("flow.")) > 0

    _, g_total = _jax_run(fn, params, x, k, WEIGHTS)
    _, g_nudged = _jax_run(fn, params, _nudge(x), k, WEIGHTS)
    _, grads = _port_run(params, fwd, x, k, WEIGHTS)
    names = sorted(g_total)
    assert set(grads) == set(names)

    def flat(g):
        return np.concatenate([np.ravel(g[n]) for n in names])

    noise = _rel_l2(flat(g_nudged), flat(g_total))
    assert _rel_l2(flat(grads), flat(g_total)) <= max(1e-4, noise)


def test_forward_pair_matches_jax(params):
    x = _snippets(7, 2)
    want = jax.jit(lambda p, i: jax_forward_pair(p, JCFG, i))(params["flow"], jnp.asarray(x))
    model = load_jax_params(FlowPoseModel(CFG, device="cpu"), params)
    with torch.no_grad():
        pack, aux = forward_pair(model.flow, CFG, torch.from_numpy(x), return_aux=True)
    assert sorted(pack) == sorted(k for k in KEYS if k != "loss_pose_epipolar")
    _check_pack({k: v.numpy() for k, v in pack.items()},
                {k: np.asarray(v) for k, v in want.items()}, pack)
    assert len(aux["flows"]) >= 3 and aux["flows"][0].shape == (2 * B, 2, H, W)
    assert [w.shape for w in aux["weights"]] == [(2 * B, 1, H >> s, W >> s) for s in range(3)]


def test_loss_weights_match_jax():
    import types

    for mode in ("flow", "flowposenet"):
        cfg = types.SimpleNamespace(w_ssim=0.7, w_flow_smooth=3.0, w_flow_consis=0.5,
                                    w_pose_epipolar=0.25, mode=mode)
        assert loss_weights_from_config(cfg) == jax_weights(cfg)
    cfg = types.SimpleNamespace(mode="flowposenet")
    assert loss_weights_from_config(cfg)["loss_pose_epipolar"] == 1.0 == jax_weights(cfg)[
        "loss_pose_epipolar"]


@pytest.mark.parametrize("freeze_flow", [False, True], ids=["joint", "freeze_flow"])
def test_twenty_adam_steps_match_jax(params, jax_grad3, freeze_flow):
    """20 steps of JAX's flowposenet step body (the jitted gradient, then
    ``make_optimizer(freeze_flow)``'s update, as ``make_train_step`` runs
    them) against the port's ``train_step`` on the same batches, the model
    set up as ``train()`` sets it up.

    Held: the 20 weighted losses, the change of the pose net's output on a
    held-out pair, and the pose branch's parameter change on its own; jointly,
    also the change of all parameters.  Under ``freeze_flow`` the pose
    parameters' change is held without the elements whose first JAX gradient
    is at rounding level (below ``ROUNDING`` of their tensor's largest; the
    structural zeros of the taps that see only padding are among them):
    Adam's first step moves every element by about lr whatever its
    gradient's size, so such an element moves by +-lr at random, and the
    port's gradient, summed in another order, flips the sign of 10 of them
    where JAX on snippets one ulp away flips 1 (all parameters: 1.3e-3 from
    JAX's change against the one-ulp probe's 2.2e-4).  The first step's
    change without them is held too, where nothing has yet diverged."""
    batches = [_snippets(100 + i, 3) for i in range(4)]
    k = _intrinsics(5)
    probe = _snippets(200, 2)
    pair = probe[:, :H], probe[:, H:]
    tx = jax_make_optimizer(1e-4, freeze_flow)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    pose_fn = jax.jit(apply_pose_net)
    wv = jnp.asarray([WEIGHTS[n] for n in KEYS])
    pose0 = np.asarray(pose_fn(params["pose"], *pair))

    def host(tree):
        return params_to_torch_state_dict(jax.tree.map(np.asarray, tree))

    def jax_traj(xs):
        p = jax.tree.map(jnp.asarray, params)
        state = tx.init(p)
        losses, first = [], None
        for i in range(STEPS):
            (loss, _), g = jax_grad3(p, jnp.asarray(xs[i % len(xs)]), jnp.asarray(k[0]),
                                     jnp.asarray(k[1]), wv)
            upd, state = update(g, state, p)
            p = jax.tree.map(lambda a, u: a + u, p, upd)
            losses.append(float(loss))
            first = first or (host(g), host(p))
        return (np.array(losses), host(p), np.asarray(pose_fn(p["pose"], *pair)) - pose0,
                *first)

    want_loss, want_p, want_pose, g1, want_p1 = jax_traj(batches)
    noise_loss, noise_p, noise_pose, noise_g1, noise_p1 = jax_traj([_nudge(x) for x in batches])

    model = load_jax_params(FlowPoseModel(CFG, device="cpu"), params)
    if freeze_flow:
        model.flow.requires_grad_(False)
    opt = make_optimizer(model, 1e-4, freeze_flow=freeze_flow)
    kt = tuple(map(torch.from_numpy, k))
    got_loss, got_p1, got_g1 = [], None, None
    for i in range(STEPS):
        got_loss.append(float(train_step(model, opt, (torch.from_numpy(batches[i % len(batches)]),
                                                      *kt), WEIGHTS, CFG,
                                         mode="flowposenet")["loss_total"]))
        got_p1 = got_p1 or {n: v.detach().numpy().copy() for n, v in model.state_dict().items()}
        got_g1 = got_g1 or {n: v.grad.numpy().copy() for n, v in model.named_parameters()
                            if n.startswith("pose.")}
    got_loss = np.array(got_loss)
    with torch.no_grad():
        got_pose = inference_pose(model, *map(torch.from_numpy, pair)).numpy() - pose0
    got_p = {n: v.detach().numpy() for n, v in model.state_dict().items()}
    p0 = params_to_torch_state_dict(params)
    keys = sorted(p0)
    pose_keys = [n for n in keys if n.startswith("pose.")]
    kept = {n: np.abs(g1[n]) >= ROUNDING * np.abs(g1[n]).max() for n in pose_keys}

    def delta(p, prefix="", mask=None):
        return np.concatenate([(p[n] - p0[n])[mask[n] if mask else ...].ravel()
                               for n in keys if n.startswith(prefix)])

    def held(got, want, noise):
        return _rel_l2(got, want) <= max(1e-4, 3.0 * _rel_l2(noise, want))

    def flips(g):
        return sum(int(((np.sign(g[n]) != np.sign(g1[n])) & (g1[n] != 0)).sum())
                   for n in pose_keys)

    # the readings, shown with pytest -s: distance from JAX's, then the one-ulp probe's
    print(f"\n20 Adam steps, {'freeze_flow' if freeze_flow else 'joint'}: pose parameters' "
          f"change {_rel_l2(delta(got_p, 'pose.'), delta(want_p, 'pose.')):.3e} "
          f"(probe {_rel_l2(delta(noise_p, 'pose.'), delta(want_p, 'pose.')):.3e}); without "
          f"the {sum(int((~kept[n] & (g1[n] != 0)).sum()) for n in pose_keys)} moving elements "
          f"at rounding level: first step "
          f"{_rel_l2(delta(got_p1, 'pose.', kept), delta(want_p1, 'pose.', kept)):.3e} "
          f"({_rel_l2(delta(noise_p1, 'pose.', kept), delta(want_p1, 'pose.', kept)):.3e}), "
          f"20 steps {_rel_l2(delta(got_p, 'pose.', kept), delta(want_p, 'pose.', kept)):.3e} "
          f"({_rel_l2(delta(noise_p, 'pose.', kept), delta(want_p, 'pose.', kept)):.3e}); "
          f"first-gradient signs flipped {flips(got_g1)} ({flips(noise_g1)}); pose output "
          f"{_rel_l2(got_pose, want_pose):.3e} ({_rel_l2(noise_pose, want_pose):.3e})")

    assert np.isfinite(got_loss).all()
    assert held(got_loss, want_loss, noise_loss), (got_loss, want_loss)
    assert held(got_pose, want_pose, noise_pose), (got_pose, want_pose)
    assert np.abs(want_pose).max() > 0
    assert all(np.abs(got_p[n] - p0[n]).max() > 0 for n in pose_keys)
    if freeze_flow:
        assert all(np.array_equal(got_p[n], p0[n]) for n in keys if n.startswith("flow."))
        assert all(np.array_equal(want_p[n], p0[n]) for n in keys if n.startswith("flow."))
        assert all(p.grad is None for p in model.flow.parameters())
        assert len(opt.param_groups[0]["params"]) == 16
        # a small share of the pose branch's moving elements is set aside
        moving = sum(int((g1[n] != 0).sum()) for n in pose_keys)
        assert sum(int((~kept[n] & (g1[n] != 0)).sum()) for n in pose_keys) < 0.01 * moving
        for got, want, noise in ((got_p1, want_p1, noise_p1), (got_p, want_p, noise_p)):
            assert held(*(delta(p, "pose.", kept) for p in (got, want, noise)))
    else:
        assert held(delta(got_p), delta(want_p), delta(noise_p))
        assert held(delta(got_p, "pose."), delta(want_p, "pose."), delta(noise_p, "pose."))
        assert np.abs(delta(got_p, "flow.")).max() > 0


def test_loss_fn_takes_uint8_tuples(params):
    x = (_snippets(9, 3) * 255).astype(np.uint8)
    k = _intrinsics(9)
    model = load_jax_params(FlowPoseModel(CFG, device="cpu"), params)
    with torch.no_grad():
        total, means = loss_fn(model, CFG, (torch.from_numpy(x), *map(torch.from_numpy, k)),
                               WEIGHTS, mode="flowposenet")
        pack = forward_flowpose(model, CFG, torch.from_numpy(x.astype(np.float32) / 255.0),
                                *map(torch.from_numpy, k))
    assert sorted(means) == KEYS
    for n in KEYS:
        torch.testing.assert_close(means[n], pack[n].mean(), rtol=0, atol=0)
    assert torch.isfinite(total)
