"""K training steps a dispatch (``--steps_per_dispatch``) in the port (CPU).

- ``training.make_multi_train_step`` against the JAX ``make_multi_train_step``
  from the same weights (moved across with ``params_to_torch_state_dict``)
  on the same stacked snippets, held by the rule of
  ``tests/test_torch_learning.py::test_twenty_steps_match_the_jax_train_step``;
- a K-step call against K of the port's own ``train_step`` calls, bit for
  bit, in flow, flowposenet, ``--freeze_flow`` and 2-frame mode;
- the trainer's ``--steps_per_dispatch``: the JAX auto rule on a table of
  interval grids (``train.py:291-302``), its interval errors, a K = 2 run
  that mirrors ``tests/test_train_loop.py::test_train_loop_steps_per_dispatch``,
  flowposenet, ``--freeze_flow`` and NYU's 2-frame snippets at K = 2, and a
  preemption that saves the last finished sub-step, then a resume;
- checkpoints of a capturable Adam (the graph's), ``.pth`` and ``.ckpt``;
- ``synthetic_epe --steps-per-dispatch``: what the JAX harness refuses, the
  iteration counts it overshoots, and the cosine learning rate of each
  sub-step.

On the CPU a K-step call runs K eager steps with the plain kernels; the CUDA
graph is held to the eager steps on the card (``chip_smoke.py`` phase 18).
"""

import json
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unopticalflow_tpu.models import FlowModelConfig as JaxFlowModelConfig
from unopticalflow_tpu.models import init_flow_model
from unopticalflow_tpu.training import create_train_state
from unopticalflow_tpu.training import make_multi_train_step as jax_make_multi_train_step
from unopticalflow_tpu_torch import train as train_mod
from unopticalflow_tpu_torch.benchmarks import synthetic_epe
from unopticalflow_tpu_torch.data import stack_batches
from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, FlowPoseModel
from unopticalflow_tpu_torch.training import (
    make_multi_train_step,
    make_optimizer,
    set_capturable,
    train_step,
)
from unopticalflow_tpu_torch.utils import checkpoint as ckpt
from unopticalflow_tpu_torch.utils import imageio
from unopticalflow_tpu_torch.utils.convert import load_jax_params, params_to_torch_state_dict

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))

import sanity_train as jax_sanity  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the suite runs in several workers on one machine's cores, where torch's
    # spinning thread pools (one thread a core in every worker) made the model
    # runs up to ~70 times slower than alone
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B, H, W = 2, 64, 128
WEIGHTS = {"loss_pixel": 0.15, "loss_ssim": 0.85, "loss_flow_smooth": 10.0,
           "loss_flow_consis": 0.01}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()), 1e-30))


def _stacks(k, n, seed=0):
    """``n`` dispatches of ``k`` stacked (B, 3H, W, 3) sanity snippets (a 3 px shift)."""
    rng = np.random.RandomState(seed)
    return [np.stack([jax_sanity.make_batch(rng, B, H, W, 3)[0] for _ in range(k)])
            for _ in range(n)]


# ---------------------------------------------------------------------------
# make_multi_train_step
# ---------------------------------------------------------------------------


def test_multi_step_matches_the_jax_multi_step():
    """2 dispatches of K = 2 from the same random "pwc" weights on the same
    stacked snippets.  Held as the 20-step test holds its trajectory: the 4
    weighted losses (each dispatch's (K,) metrics, in order) and the final
    parameters' change from the same init, within 3 times the JAX run's own
    distance on snippets moved by one float32 ulp, or 1e-4."""
    k = 2
    init = jax.jit(init_flow_model, static_argnames="scheme")
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), scheme="pwc"))
    stacks = _stacks(k, 2)
    step = jax_make_multi_train_step(JaxFlowModelConfig(num_scales=3), WEIGHTS, k, lr=1e-4)

    def jax_run(batches):
        state = create_train_state(jax.tree.map(jnp.array, params), lr=1e-4)
        losses = []
        for x in batches:
            state, m = step(state, jnp.asarray(x))
            assert m["loss_total"].shape == (k,)
            losses.extend(np.asarray(m["loss_total"]).tolist())
        return np.array(losses), params_to_torch_state_dict(
            jax.tree.map(np.asarray, state.params))

    want_loss, want_p = jax_run(stacks)
    noise_loss, noise_p = jax_run([np.nextafter(x, np.float32(2.0)) for x in stacks])

    cfg = FlowModelConfig(num_scales=3)
    model = load_jax_params(FlowModel(cfg, device="cpu"), params)
    opt = make_optimizer(model, 1e-4)
    multi = make_multi_train_step(model, opt, cfg, WEIGHTS, k)
    got_loss = []
    for x in stacks:
        m = multi(torch.from_numpy(x))
        assert set(m) == set(WEIGHTS) | {"loss_total"}
        assert all(v.shape == (k,) for v in m.values())
        got_loss.extend(m["loss_total"].tolist())
    got_loss = np.array(got_loss)
    got_p = {n: v.detach().numpy() for n, v in model.state_dict().items()}

    p0 = params_to_torch_state_dict(params)
    keys = sorted(p0)

    def delta(p):
        return np.concatenate([(p[n] - p0[n]).ravel() for n in keys])

    assert np.isfinite(got_loss).all()
    loss_tol = max(1e-4, 3.0 * _rel_l2(noise_loss, want_loss))
    assert _rel_l2(got_loss, want_loss) <= loss_tol, (got_loss, want_loss, loss_tol)
    d_want = delta(want_p)
    d_tol = max(1e-4, 3.0 * _rel_l2(delta(noise_p), d_want))
    assert _rel_l2(delta(got_p), d_want) <= d_tol
    assert np.abs(d_want).max() > 0


def _intrinsics(seed, h, w):
    rng = np.random.RandomState(seed)
    k = np.zeros((B, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = 0.9 * w + rng.rand(B)
    k[:, 0, 2], k[:, 1, 2], k[:, 2, 2] = w / 2 + rng.randn(B), h / 2 + rng.randn(B), 1.0
    return k, np.linalg.inv(k).astype(np.float32)


# mode -> (model mode, snippet frames, --freeze_flow, image size)
SELF_CASES = {"flow": ("flow", 3, False, (64, 128)),
              "flowposenet": ("flowposenet", 3, False, (64, 128)),
              "freeze_flow": ("flowposenet", 3, True, (64, 128)),
              "pair": ("flowposenet", 2, False, (64, 128))}


@pytest.mark.parametrize("case", sorted(SELF_CASES))
def test_multi_step_is_k_train_steps_bit_for_bit(case):
    """One K = 3 call against 3 ``train_step`` calls from the same weights
    and Adam state: every metric, parameter and Adam tensor bit-equal."""
    mode, frames, freeze, (h, w) = SELF_CASES[case]
    k = 3
    rng = np.random.RandomState(7)
    imgs = rng.randint(0, 256, (k, B, frames * h, w, 3)).astype(np.uint8)
    intr = [_intrinsics(10 + i, h, w) for i in range(k)]
    if mode == "flowposenet":
        stacked = (torch.from_numpy(imgs), torch.from_numpy(np.stack([a for a, _ in intr])),
                   torch.from_numpy(np.stack([b for _, b in intr])))
    else:
        stacked = torch.from_numpy(imgs)
    cfg = FlowModelConfig(num_scales=3)
    weights = {**WEIGHTS, "loss_pose_epipolar": 1.0} if mode == "flowposenet" else WEIGHTS
    runs = []
    for multi in (False, True):
        model = (FlowPoseModel if mode == "flowposenet" else FlowModel)(
            cfg, device="cpu", scheme="pwc", generator=torch.Generator().manual_seed(3))
        if freeze:
            model.flow.requires_grad_(False)
        opt = make_optimizer(model, 1e-4, freeze_flow=freeze)
        if multi:
            m = make_multi_train_step(model, opt, cfg, weights, k, mode, frames,
                                      freeze_flow=freeze)(stacked)
        else:
            ms = []
            for j in range(k):
                x = tuple(t[j] for t in stacked) if isinstance(stacked, tuple) else stacked[j]
                ms.append(train_step(model, opt, x, weights, cfg, mode, frames))
            m = {n: torch.stack([d[n] for d in ms]) for n in ms[0]}
        runs.append((m, model, opt))
    (m1, model1, opt1), (m2, model2, opt2) = runs
    assert m1.keys() == m2.keys() and all(torch.equal(m1[n], m2[n]) for n in m1)
    if mode == "flowposenet":
        assert "loss_pose_epipolar" in m1
    for (name, p), q in zip(model1.named_parameters(), model2.parameters()):
        assert torch.equal(p, q), name
        s1, s2 = opt1.state.get(p, {}), opt2.state.get(q, {})
        assert s1.keys() == s2.keys() and all(torch.equal(s1[n], s2[n]) for n in s1), name
    if freeze:
        fresh = FlowPoseModel(cfg, device="cpu", scheme="pwc",
                              generator=torch.Generator().manual_seed(3))
        assert all(torch.equal(a, b) for a, b in zip(fresh.flow.parameters(),
                                                     model2.flow.parameters()))


def test_multi_step_refuses_what_it_cannot_run():
    cfg = FlowModelConfig(num_scales=3)
    model = FlowModel(cfg, device="cpu")
    multi = make_multi_train_step(model, make_optimizer(model), cfg, WEIGHTS, 2)
    with pytest.raises(ValueError, match="takes 2 stacked batches"):
        multi(torch.zeros(3, B, 3 * H, W, 3))
    with pytest.raises(ValueError, match="steps_per_dispatch must be >= 1"):
        make_multi_train_step(model, make_optimizer(model), cfg, WEIGHTS, 0)
    fp = FlowPoseModel(cfg, device="cpu")
    with pytest.raises(ValueError, match="freeze_flow: the optimizer holds the flow branch"):
        make_multi_train_step(fp, make_optimizer(fp), cfg, WEIGHTS, 2, "flowposenet",
                              freeze_flow=True)


def test_stack_batches_groups_k_host_batches():
    batches = [np.full((2, 3), i) for i in range(5)]
    got = list(stack_batches(iter(batches), 2))
    assert [g.shape for g in got] == [(2, 2, 3)] * 2  # the fifth is dropped
    assert [int(g[1, 0, 0]) for g in got] == [1, 3]
    tuples = [(np.full(2, i), np.full((2, 4), -i)) for i in range(4)]
    got = list(stack_batches(tuples, 4))
    assert len(got) == 1 and got[0][0].shape == (4, 2) and got[0][1].shape == (4, 2, 4)
    assert got[0][1][3, 0, 0] == -3


# ---------------------------------------------------------------------------
# the trainer's --steps_per_dispatch
# ---------------------------------------------------------------------------


def _grid(log, save, test, num_iterations, iter_start=0, spd="auto"):
    return types.SimpleNamespace(log_interval=log, save_interval=save, test_interval=test,
                                 num_iterations=num_iterations, iter_start=iter_start,
                                 steps_per_dispatch=spd)


# (log, save, test, num_iterations, iter_start) -> the JAX rule's K: the
# largest of 8, 4, 2, 1 dividing the three intervals and the remaining count
AUTO_TABLE = [
    # config/kitti.yaml at the flags' defaults: 100 = 4 x 25, so 4, not 8
    ((100, 2000, 2000, 200000, 0), 4),
    ((200, 2000, 2000, 200000, 0), 8),
    ((200, 2000, 2000, 200004, 0), 4),
    ((100, 2000, 2000, 200000, 7), 1),  # resumed off the grid
    ((8, 2000, 2000, 16, 0), 8),
    ((2, 2, 1000, 4, 0), 2),  # tests/test_train_loop.py's K = 2 run
    ((1, 2, 2000, 4, 0), 1),
    ((4, 8, 2000, 12, 0), 4),
    ((10, 20, 40, 30, 0), 2),
    ((8, 8, 2000, 23, 7), 8),  # a resume at iteration 7 of 23
    ((5, 1000, 2000, 10, 0), 1),
]


@pytest.mark.parametrize("grid,want", AUTO_TABLE)
def test_auto_picks_what_the_jax_rule_picks(grid, want, capsys):
    assert train_mod.steps_per_dispatch(_grid(*grid)) == want
    assert f"steps_per_dispatch auto -> {want}" in capsys.readouterr().out
    # an explicit K is taken as given where the grid allows it
    assert train_mod.steps_per_dispatch(_grid(*grid, spd=str(want))) == want


@pytest.mark.parametrize("grid,spd,message", [
    ((3, 4, 2000, 4), 2, r"--log_interval=3 must be a multiple of --steps_per_dispatch=2"),
    ((4, 6, 2000, 8), 4, r"--save_interval=6 must be a multiple of --steps_per_dispatch=4"),
    ((2, 2, 5, 4), 2, r"--test_interval=5 must be a multiple of --steps_per_dispatch=2"),
    ((2, 2, 2000, 5), 2, r"num_iterations - iter_start = 5 must be a multiple of "
                         r"--steps_per_dispatch=2"),
    ((8, 8, 2000, 16), -2, r"--steps_per_dispatch must be >= 1"),
])
def test_interval_validation_raises_the_jax_messages(grid, spd, message):
    with pytest.raises(ValueError, match=message):
        train_mod.steps_per_dispatch(_grid(*grid, spd=spd))


@pytest.mark.parametrize("value", ["auto", "1", "2", "4", "8"])
def test_parser_takes_steps_per_dispatch(value):
    args = train_mod.build_arg_parser().parse_args(["-c", "x.yaml", "--steps_per_dispatch",
                                                    value])
    assert args.steps_per_dispatch == value
    assert train_mod.build_arg_parser().parse_args([]).steps_per_dispatch == "auto"


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A prepared KITTI dir (tests/test_train_loop.py's) and a 2-frame NYU one."""
    root = tmp_path_factory.mktemp("dispatch")
    prep = root / "prepared" / "data_s1"
    drive = prep / "d" / "r"
    drive.mkdir(parents=True)
    rng = np.random.RandomState(0)
    lines = []
    h, w = 32, 32
    for i in range(4):
        base = rng.randint(0, 255, (h + 4, w, 3), dtype=np.uint8)
        tri = np.concatenate([base[:h], base[2:h + 2], base[4:h + 4]], 0)
        imageio.imwrite(str(drive / f"{i:010d}.png"), tri)
        lines.append(f"d/r/{i:010d}.png d/calib.txt\n")
    with open(prep / "d" / "calib.txt", "w") as f:
        f.write("P_rect_02: 30.0 0.0 16.0 0.0 0.0 30.0 16.0 0.0 0.0 0.0 1.0 0.0\n")
    with open(prep / "train.txt", "w") as f:
        f.writelines(lines)
    nyu = root / "nyu" / "data_s1"
    (nyu / "s").mkdir(parents=True)
    with open(nyu / "train.txt", "w") as f:
        for i in range(2):
            imageio.imwrite(str(nyu / "s" / f"{i}.png"),
                            rng.randint(0, 256, (2 * 96, 128, 3)).astype(np.uint8))
            f.write(f"s/{i}.png calib_cam_to_cam.txt\n")
    (nyu / "calib_cam_to_cam.txt").write_text(
        "P_rect: 5.1885790117450188e+02 0.0 3.2558244941119034e+02 0.0 "
        "0.0 5.1946961112127485e+02 2.5373616633400465e+02 0.0 0.0 0.0 1.0 0.0")
    return root


def _cfg(root, model_dir, **over):
    d = dict(dataset="kitti_depth", num_scales=3, num_iterations=4, w_ssim=0.85,
             w_flow_smooth=10.0, w_flow_consis=0.01, img_hw=(64, 64),
             prepared_base_dir=str(root / "prepared"), prepared_save_dir="data_s1",
             model_dir=str(model_dir), log_dump_dir=None, batch_size=2, iter_start=0,
             lr=1e-4, num_workers=1, log_interval=2, save_interval=2, test_interval=1000,
             mode="flow", resume=False, no_test=True, precision="float32",
             loss_precision=None, init_scheme="pwc", seed=0, device="cpu",
             steps_per_dispatch=1)
    d.update(over)
    os.makedirs(d["model_dir"], exist_ok=True)
    return types.SimpleNamespace(**d)


def _run(cfg, **kw):
    seen = []
    res = train_mod.train(cfg, on_step=lambda it, m: seen.append(
        (it, {k: float(v) for k, v in m.items()})), **kw)
    return res, seen


def test_trainer_k2_mirrors_the_jax_loop(workspace, tmp_path, capsys):
    """tests/test_train_loop.py::test_train_loop_steps_per_dispatch in the
    port: 4 iterations, save and log every 2, K = 2 against K = 1: iterations
    0 and 2 logged, ``iter_1.pth``, ``iter_3.pth`` and ``last.pth`` written,
    the same parameters (that test's rtol 1e-3 / atol 5e-4; on the CPU they
    are the same bits) and every sub-step's metrics passed to ``on_step``."""
    res1, seen1 = _run(_cfg(workspace, tmp_path / "k1"))
    capsys.readouterr()
    res2, seen2 = _run(_cfg(workspace, tmp_path / "k2", steps_per_dispatch="2"))
    out = capsys.readouterr().out
    assert "iter: 0, loss_pixel:" in out and "iter: 2, loss_pixel:" in out
    assert "iter: 1," not in out and "snippets_per_sec" in out
    assert res2.step == 4 and [it for it, _ in seen2] == [0, 1, 2, 3]
    assert seen1 == seen2
    assert {"iter_1.pth", "iter_3.pth", "last.pth"} <= set(os.listdir(tmp_path / "k2"))
    for a, b in zip(res1.model.parameters(), res2.model.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=1e-3,
                                   atol=5e-4)
        assert torch.equal(a, b)
    fresh = FlowModel(device="cpu")
    opt = make_optimizer(fresh)
    assert ckpt.restore_checkpoint(str(tmp_path / "k2" / "iter_3.pth"), fresh, opt) == 3
    assert all(torch.equal(a, b) for a, b in zip(fresh.parameters(), res2.model.parameters()))


@pytest.mark.parametrize("case", ["flowposenet", "freeze_flow", "nyuv2"])
def test_trainer_k2_in_every_training_mode(workspace, tmp_path, case):
    """flowposenet (KITTI intrinsics), --freeze_flow (the flow branch stays
    as initialised) and NYU's 2-frame snippets with per-scale intrinsics (the
    scale axis one deeper in a stacked batch): K = 2 equals K = 1."""
    over = dict(mode="flowposenet", freeze_flow=case == "freeze_flow")
    if case == "nyuv2":
        over.update(dataset="nyuv2", prepared_base_dir=str(workspace / "nyu"),
                    img_hw=(64, 128), num_iterations=2, save_interval=2, log_interval=2)
    runs = [_run(_cfg(workspace, tmp_path / f"k{k}", steps_per_dispatch=str(k), **over))
            for k in (1, 2)]
    (res1, seen1), (res2, seen2) = runs
    assert seen1 == seen2 and all("loss_pose_epipolar" in m for _, m in seen2)
    assert all(np.isfinite(list(m.values())).all() for _, m in seen2)
    assert all(torch.equal(a, b) for a, b in zip(res1.model.parameters(),
                                                 res2.model.parameters()))
    if case == "freeze_flow":
        fresh = FlowPoseModel(FlowModelConfig(num_scales=3), device="cpu", scheme="pwc",
                              generator=torch.Generator().manual_seed(0))
        assert all(torch.equal(a, b) for a, b in zip(fresh.flow.parameters(),
                                                     res2.model.flow.parameters()))


def test_preemption_saves_the_last_finished_substep_and_resumes(workspace, tmp_path,
                                                                monkeypatch, capsys):
    """A stop requested during the second dispatch's first sub-step (as
    SIGTERM's handler requests it): the dispatch finishes, ``last.pth`` holds
    its last sub-step, 3, and a ``--resume`` at K = 2 runs 3 ... 6."""
    stops = []

    class Recorded(train_mod.StopOnSignal):
        def __init__(self):
            super().__init__()
            stops.append(self)

    monkeypatch.setattr(train_mod, "StopOnSignal", Recorded)
    model_dir = tmp_path / "m"
    cfg = _cfg(workspace, model_dir, num_iterations=8, save_interval=8, log_interval=2,
               steps_per_dispatch="2")

    def on_step(it, m):
        seen.append(it)
        if it == 2:
            stops[-1].signum = 15

    seen = []
    res = train_mod.train(cfg, on_step=on_step)
    out = capsys.readouterr().out
    assert "preemption signal 15: checkpointing at iteration 3 and exiting." in out
    assert seen == [0, 1, 2, 3] and res.step == 4
    data = torch.load(model_dir / "last.pth", weights_only=True)
    assert data["iteration"] == 3 and set(os.listdir(model_dir)) >= {"iter_3.pth"}
    seen = []
    res2 = train_mod.train(_cfg(workspace, model_dir, num_iterations=7, save_interval=2,
                                log_interval=2, resume=True, steps_per_dispatch="2"),
                           on_step=lambda it, m: seen.append(it))
    out = capsys.readouterr().out
    assert "resumed from" in out and "starting iteration: 3." in out
    assert seen == [3, 4, 5, 6] and res2.step == 7


# ---------------------------------------------------------------------------
# checkpoints of a capturable Adam
# ---------------------------------------------------------------------------


def _stepped(capturable=False):
    """A small FlowModel after one eager step (CPU Adam cannot step capturable)."""
    cfg = FlowModelConfig(num_scales=3)
    model = FlowModel(cfg, device="cpu", scheme="pwc",
                      generator=torch.Generator().manual_seed(1))
    opt = make_optimizer(model, 1e-4)
    train_step(model, opt, torch.from_numpy(_stacks(1, 1)[0][0]), WEIGHTS, cfg)
    if capturable:
        set_capturable(opt)
    return model, opt


def _adam(model, capturable):
    opt = make_optimizer(model)
    if capturable:
        set_capturable(opt)
    return opt


def test_capturable_adam_checkpoints_both_ways(tmp_path):
    """``set_capturable`` keeps the state; a capturable Adam's ``.pth`` loads
    into an eager Adam and back, each keeping its own form (``step`` a
    float32 tensor on the parameter's device when capturable, the host's
    otherwise), and its ``.ckpt`` carries optax's ``count``.  A learning
    rate held as a tensor (``synthetic_epe``'s schedule in a graph) is
    stored as its float."""
    model, opt = _stepped(capturable=True)
    assert all(g["capturable"] for g in opt.param_groups)
    p0 = next(model.parameters())
    assert opt.state[p0]["step"].dtype == torch.float32 and float(opt.state[p0]["step"]) == 1
    opt.param_groups[0]["lr"] = torch.tensor(2.5e-5)
    path = str(tmp_path / "c.pth")
    ckpt.save_checkpoint([path], 0, model, opt)
    data = torch.load(path, weights_only=True)
    assert data["optimizer_state_dict"]["param_groups"][0]["lr"] == float(torch.tensor(2.5e-5))
    assert data["optimizer_state_dict"]["param_groups"][0]["capturable"] is True
    for capturable in (False, True):
        fresh = FlowModel(device="cpu")
        opt2 = _adam(fresh, capturable)
        assert ckpt.restore_checkpoint(path, fresh, opt2) == 0
        assert all(g["capturable"] is capturable for g in opt2.param_groups)
        for (name, p), q in zip(model.named_parameters(), fresh.parameters()):
            s, t = opt.state[p], opt2.state[q]
            assert torch.equal(s["exp_avg"], t["exp_avg"]) and float(t["step"]) == 1, name
            assert t["step"].device == q.device
        # and back: an eager Adam's file into a capturable one
        path2 = str(tmp_path / f"e{int(capturable)}.pth")
        ckpt.save_checkpoint([path2], 5, fresh, opt2)
        again = FlowModel(device="cpu")
        back = _adam(again, not capturable)
        assert ckpt.restore_checkpoint(path2, again, back) == 5
        assert all(g["capturable"] is (not capturable) for g in back.param_groups)
    flax_path = str(tmp_path / "c.ckpt")
    ckpt.save_flax_checkpoint(flax_path, 7, model, opt)
    tree = ckpt.read_flax_checkpoint(flax_path)
    assert int(np.asarray(tree["opt_state"]["0"]["count"])) == 1
    into = FlowModel(device="cpu")
    cap = _adam(into, True)
    assert ckpt.restore_checkpoint(flax_path, into, cap) == 7
    st = cap.state[next(into.parameters())]
    assert float(st["step"]) == 1 and st["step"].dtype == torch.float32
    assert all(g["capturable"] for g in cap.param_groups)


# ---------------------------------------------------------------------------
# synthetic_epe --steps-per-dispatch
# ---------------------------------------------------------------------------

COMMON = ["--device", "cpu", "--batch", "2", "--hw", "64", "128", "--eval-snippets", "2"]


@pytest.mark.parametrize("argv,message", [
    (["--steps-per-dispatch", "0"], "--steps-per-dispatch must be >= 1"),
    (["--steps-per-dispatch", "2", "--supervised"],
     "--steps-per-dispatch>1 not supported with --supervised"),
    (["--steps-per-dispatch", "2", "--eval-every", "3"],
     "--eval-every must be divisible by --steps-per-dispatch"),
    # the JAX harness's last dispatch would overshoot these
    (["--steps-per-dispatch", "2", "--iters", "3"],
     "--iters 3 less the start iteration 0 must be divisible by --steps-per-dispatch 2"),
])
def test_synthetic_epe_refuses_what_it_cannot_run(argv, message):
    with pytest.raises(SystemExit, match=message):
        synthetic_epe.main(COMMON + (argv if "--iters" in argv else ["--iters", "4", *argv]))


def test_cosine_lr_on_the_device_equals_the_schedule():
    """The graph's schedule, tensor operations on a float64 step count, equals
    ``cosine_decay_lr`` to float32 rounding at every count, past the decay too."""
    lr, steps, alpha = 1e-4, 37, 0.05
    count = torch.tensor(0.0, dtype=torch.float64)
    for c in range(steps + 3):
        got = synthetic_epe.cosine_decay_lr_tensor(lr, steps, alpha, count)
        want = np.float32(synthetic_epe.cosine_decay_lr(lr, steps, alpha, c))
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= float(np.spacing(want)), c
        count.add_(1)


def test_synthetic_epe_k2_steps_with_the_cosine_lr_of_each_substep(tmp_path, capsys):
    """K = 2 on the CPU: each sub-step takes its own cosine lr, so the run is
    bit for bit the K = 1 run; evaluation points carry the iteration of the
    step whose model they score (the dispatch's last), and a --load resumes
    at the stored count."""
    paths = {k: str(tmp_path / f"k{k}.pth") for k in (1, 2)}
    for k in (1, 2):
        synthetic_epe.main(COMMON + ["--iters", "4", "--lr-schedule", "cosine", "--eval-every",
                                     "2", "--steps-per-dispatch", str(k), "--save", paths[k]])
    lines = capsys.readouterr().out.strip().splitlines()
    results = [json.loads(ln) for ln in lines if ln.startswith('{"benchmark"')]
    assert [r["steps_per_dispatch"] for r in results] == [1, 2]
    assert [r["lr_max_rel_err"] for r in results] == [0.0, 0.0]
    assert results[1]["lr_last"] == synthetic_epe.cosine_decay_lr(1e-4, 4, 0.05, 3)
    assert [p["iter"] for p in results[0]["eval_points"]] == [0, 2]
    assert [p["iter"] for p in results[1]["eval_points"]] == [1, 3]
    a, b = (torch.load(paths[k], weights_only=True) for k in (1, 2))
    assert a["iteration"] == b["iteration"] == 4
    assert all(torch.equal(a["model_state_dict"][n], b["model_state_dict"][n])
               for n in a["model_state_dict"])
    assert b["optimizer_state_dict"]["param_groups"][0]["lr"] == \
        synthetic_epe.cosine_decay_lr(1e-4, 4, 0.05, 3)
    synthetic_epe.main(COMMON + ["--iters", "6", "--lr-schedule", "cosine",
                                 "--steps-per-dispatch", "2", "--load", paths[2], "--save",
                                 paths[2]])
    out = capsys.readouterr().out
    assert "at iter 4" in out and "iter 5: total" in out
    data = torch.load(paths[2], weights_only=True)
    assert data["iteration"] == 6
    assert data["optimizer_state_dict"]["param_groups"][0]["lr"] == \
        synthetic_epe.cosine_decay_lr(1e-4, 6, 0.05, 5)
