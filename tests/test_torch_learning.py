"""The port's learning harnesses against the JAX package's (CPU).

``unopticalflow_tpu_torch/benchmarks/sanity_train.py`` and
``synthetic_epe.py`` against the root ``benchmarks/`` ones, imported as
``tests/test_synthetic_epe.py`` imports them, unchanged:

- the generators bit for bit (the JAX ``synthetic_epe`` on its numpy path,
  its ``cv2`` set to None), and within 1e-6 of its cv2 path with the same
  flows and masks;
- ``evaluate`` and ``prediction_probe`` give the same dicts for the same
  predictor;
- the cosine schedule equals ``optax.cosine_decay_schedule``, and Adam under
  it ``optax.adam`` of that schedule;
- 20 training steps of the port against the JAX ``make_train_step`` from the
  same weights on the same snippets (see the test for its tolerance rule;
  ``test_torch_supervised.py`` holds the ``--supervised`` step);
- a short learning run of the port's ``sanity_train`` on the CPU ends well
  under zero flow's EPE, near where the JAX harness ends after as many steps.

The port runs its plain versions of the kernels here (CPU tensors).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from unopticalflow_tpu.models import FlowModelConfig as JaxFlowModelConfig
from unopticalflow_tpu.models import init_flow_model
from unopticalflow_tpu.training import create_train_state, make_train_step
from unopticalflow_tpu_torch.benchmarks import sanity_train, synthetic_epe
from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig
from unopticalflow_tpu_torch.training import make_optimizer, train_step
from unopticalflow_tpu_torch.utils.convert import load_jax_params, params_to_torch_state_dict

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))

import sanity_train as jax_sanity  # noqa: E402
import synthetic_epe as jax_synth  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the suite runs in several workers on one machine's cores, where torch's
    # spinning thread pools (one thread a core in every worker) made the model
    # runs here up to ~70 times slower than alone (a 7 s test took 504 s)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parents[1]
# generator settings: the occlusion campaign's regime (SYNTH_EPE_r05), its
# fg8 leg, a brightness-offset foreground and the original texture
GEN_SETTINGS = {
    "r05": ((128, 256), dict(max_bg=8, max_fg=16, tex_power=1.0)),
    "fg8": ((64, 128), dict(max_bg=8, max_fg=8, tex_power=1.0)),
    "fg_bias": ((64, 128), dict(max_bg=4, max_fg=8, tex_power=1.0, fg_bias=0.3)),
    "tex_power_0.5": ((64, 128), dict(max_bg=4, max_fg=8, tex_power=0.5)),
}


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("batch,h,w,shift", [(4, 64, 128, 3), (2, 64, 64, 1), (3, 32, 96, 5)])
def test_sanity_make_batch_is_bit_equal(batch, h, w, shift):
    r_port, r_jax = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(3):
        got, s_got = sanity_train.make_batch(r_port, batch, h, w, shift)
        want, s_want = jax_sanity.make_batch(r_jax, batch, h, w, shift)
        assert _equal(got, want) and s_got == s_want
    assert r_port.rand() == r_jax.rand()  # the same number of draws


@pytest.mark.parametrize("setting", sorted(GEN_SETTINGS))
def test_synthetic_generator_matches_jax(setting, monkeypatch):
    """Bit-equal to the JAX module's numpy path; its cv2 path (nearest
    upsampling and a 2-D filter in another summation order) within 1e-6,
    with the same flows and masks."""
    assert jax_synth.cv2 is not None  # the cv2 path is the JAX default here
    (h, w), kw = GEN_SETTINGS[setting]
    with monkeypatch.context() as m:
        m.setattr(jax_synth, "cv2", None)
        want = jax_synth.make_batch(np.random.RandomState(3), 3, h, w, **kw)
        want_snip = jax_synth.make_snippet(np.random.RandomState(4), h, w, **kw)
    got = synthetic_epe.make_batch(np.random.RandomState(3), 3, h, w, **kw)
    got_snip = synthetic_epe.make_snippet(np.random.RandomState(4), h, w, **kw)
    for a, b in zip((*got, *got_snip), (*want, *want_snip)):
        assert _equal(a, b)
    with_cv2 = jax_synth.make_batch(np.random.RandomState(3), 3, h, w, **kw)
    assert got[0].dtype == with_cv2[0].dtype
    np.testing.assert_allclose(got[0], with_cv2[0], rtol=0, atol=1e-6)
    assert _equal(got[1], with_cv2[1]) and _equal(got[2], with_cv2[2])
    assert got[2].dtype == bool and not got[2].all()  # occlusion is there


class _Replay:
    """A numpy predictor: zero flow, or the ground truth of the snippets it
    will be asked about (made from the same seed, in the same batches) plus
    noise from a seeded generator."""

    def __init__(self, kind, seed, hw, batch, n, gen_kw):
        self.kind = kind
        rng = np.random.RandomState(seed)
        self.gts = []
        done = 0
        while done < n:
            k = min(batch, n - done)
            self.gts.append(synthetic_epe.make_batch(rng, k, *hw, **gen_kw)[1])
            done += k
        self.noise = np.random.RandomState(1)

    def __call__(self, img1, img2):
        gt = self.gts.pop(0)
        assert gt.shape[:3] == img1.shape[:3] == img2.shape[:3]
        if self.kind == "zero":
            return np.zeros_like(gt)
        return gt + self.noise.randn(*gt.shape).astype(np.float32) * 1.5


@pytest.mark.parametrize("kind", ["zero", "noisy_gt"])
def test_metrics_match_jax(kind):
    hw, gen_kw = GEN_SETTINGS["fg8"]
    batch, n = 3, 7  # a ragged last batch
    args = type("Args", (), {"hw": hw, "batch": batch, "eval_snippets": n})()
    for zero_flow in (False, True):
        got = synthetic_epe.evaluate(
            None if zero_flow else _Replay(kind, synthetic_epe.EVAL_SEED, hw, batch, n, gen_kw),
            hw, batch, n, gen_kw, zero_flow=zero_flow)
        replay = _Replay(kind, synthetic_epe.EVAL_SEED, hw, batch, n, gen_kw)
        want = jax_synth.evaluate(None, args, gen_kw, lambda p, a, b: replay(a, b),
                                  zero_flow=zero_flow)
        assert got == want and got["epe_occluded"] is not None
    n_probe = synthetic_epe.PROBE_SNIPPETS
    got = synthetic_epe.prediction_probe(
        _Replay(kind, synthetic_epe.PROBE_SEED, hw, batch, n_probe, gen_kw), hw, batch, gen_kw)
    replay = _Replay(kind, synthetic_epe.PROBE_SEED, hw, batch, n_probe, gen_kw)
    want = jax_synth.prediction_probe(args, gen_kw, lambda p, a, b: replay(a, b), None)
    assert got == want
    if kind == "noisy_gt":
        assert 0.9 < got["slope_u"] < 1.1 and 0.9 < got["slope_v"] < 1.1


@pytest.mark.parametrize("iters,alpha", [(6, 0.05), (20, 0.0), (1500, 0.05), (6000, 0.05)])
def test_cosine_schedule_matches_optax(iters, alpha):
    """At every update count t = 0 .. iters + 2 (clamped after ``iters``).
    optax evaluated in float64: its float32 value carries the rounding of
    XLA's float32 cos, which moves it by up to ~2e-7 of itself near the
    floor (a jitted scalar call and a vmapped one of the same schedule
    differ by as much); the float32 path is held by the Adam test below."""
    sched = optax.cosine_decay_schedule(init_value=1e-4, decay_steps=iters, alpha=alpha)
    with jax.enable_x64(True):
        want = np.array([float(sched(t)) for t in range(iters + 3)])
    got = np.array([synthetic_epe.cosine_decay_lr(1e-4, iters, alpha, t)
                    for t in range(iters + 3)])
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    assert got[-1] == got[iters] == pytest.approx(1e-4 * alpha, rel=1e-12)


def test_adam_under_the_cosine_schedule_matches_optax():
    """Six fixed gradients, the schedule decaying over four updates (so two
    updates at the floor), the lr written before each step as the harness
    writes it."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(5, 7).astype(np.float32)
    grads = [rng.randn(5, 7).astype(np.float32) * 10.0 ** rng.uniform(-6, 1) for _ in range(6)]
    model = torch.nn.Linear(7, 5, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(p0))
    opt = make_optimizer(model, lr=1e-3)
    tx = optax.adam(optax.cosine_decay_schedule(1e-3, 4, 0.05), b1=0.9, b2=0.999, eps=1e-8)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    for t, g in enumerate(grads):
        for group in opt.param_groups:
            group["lr"] = synthetic_epe.cosine_decay_lr(1e-3, 4, 0.05, t)
        model.weight.grad = torch.from_numpy(g)
        opt.step()
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        np.testing.assert_allclose(model.weight.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-6)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()), 1e-30))


TRAJ_STEPS = 20
WEIGHTS = sanity_train.WEIGHTS


# the 20-step trajectory's cases: (use_occlusion_weights, snippets, loss weights)
# -- the sanity snippets (a shift, nothing occluded) with the softmax occlusion
# weights, and the occlusion campaign's regime (SYNTH_EPE_r05: its generator
# settings and smoothness weight 1; foreground objects occlude) at 64x128
# without them, the plain branch of the JAX forward and of the port's
TRAJ_CASES = {
    "occlusion_weights": (True, "sanity", WEIGHTS),
    "no_occlusion_weights": (False, "r05", {**WEIGHTS, "loss_flow_smooth": 1.0}),
}


def _traj_batches(kind):
    rng = np.random.RandomState(0)
    if kind == "sanity":
        return [jax_sanity.make_batch(rng, 2, 64, 64, 3)[0] for _ in range(TRAJ_STEPS)]
    # one batch, taken 20 times: the losses of fresh batches of this generator
    # spread more than 20 steps at lr 1e-4 lower them
    snips, _, visible = synthetic_epe.make_batch(rng, 2, 64, 128, **GEN_SETTINGS["r05"][1])
    assert not visible.all()  # the foreground occludes
    return [snips] * TRAJ_STEPS


@pytest.mark.parametrize("case", sorted(TRAJ_CASES))
def test_twenty_steps_match_the_jax_train_step(case):
    """20 Adam steps (lr 1e-4) from the same random "pwc" weights (moved
    across with ``params_to_torch_state_dict``) on the same snippets (batch 2,
    float32; ``TRAJ_CASES``), with the occlusion weights on and off in both
    packages.  Held by relative L2: the 20 weighted losses,
    and the final parameters' change from the same init over all parameters
    (the stricter reading of the final parameters: the init cancels from the
    difference and is left out of the norm).  The tolerance is the rule of the
    one-step tests (tests/test_torch_train.py): 3 times the JAX trajectory's
    own distance from itself on snippets moved by one float32 ulp, or 1e-4
    where JAX is steadier."""
    init = jax.jit(init_flow_model, static_argnames="scheme")
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), scheme="pwc"))
    use_weights, kind, weights = TRAJ_CASES[case]
    batches = _traj_batches(kind)

    step = make_train_step(JaxFlowModelConfig(num_scales=3, use_occlusion_weights=use_weights),
                           weights, lr=1e-4)

    def jax_run(snippets):
        state = create_train_state(jax.tree.map(jnp.array, params), lr=1e-4)
        losses = []
        for x in snippets:
            state, m = step(state, jnp.asarray(x))
            losses.append(float(m["loss_total"]))
        return np.array(losses), params_to_torch_state_dict(
            jax.tree.map(np.asarray, state.params))

    want_loss, want_p = jax_run(batches)
    noise_loss, noise_p = jax_run([np.nextafter(x, np.float32(2.0)) for x in batches])

    cfg = FlowModelConfig(num_scales=3, use_occlusion_weights=use_weights)
    model = load_jax_params(FlowModel(cfg, device="cpu"), params)
    opt = make_optimizer(model, 1e-4)
    got_loss = np.array([float(train_step(model, opt, torch.from_numpy(x), weights, cfg)
                               ["loss_total"]) for x in batches])
    got_p = {k: v.detach().numpy() for k, v in model.state_dict().items()}

    p0 = params_to_torch_state_dict(params)
    keys = sorted(p0)

    def delta(p):
        return np.concatenate([(p[k] - p0[k]).ravel() for k in keys])

    assert np.isfinite(got_loss).all() and got_loss[-1] < got_loss[0]
    loss_tol = max(1e-4, 3.0 * _rel_l2(noise_loss, want_loss))
    assert _rel_l2(got_loss, want_loss) <= loss_tol, (got_loss, want_loss, loss_tol)
    d_want = delta(want_p)
    d_tol = max(1e-4, 3.0 * _rel_l2(delta(noise_p), d_want))
    assert _rel_l2(delta(got_p), d_want) <= d_tol
    assert np.abs(d_want).max() > 0


# the fewest iterations after which the JAX harness's loop, on the CPU at its
# defaults, ends well under zero flow's 3 px (EPE 0.369 after 10, 2.158 after
# 5; 0.105 after 40, 0.019 after 100)
CPU_LEARN_ITERS = 10
# the port must learn about as fast: well above the JAX loop's 0.369 after 10
# iterations, and under its 2.158 after 5
CPU_LEARN_EPE_BAR = 1.5


def test_sanity_train_learns_on_the_cpu(capsys):
    res = sanity_train.run(iters=CPU_LEARN_ITERS, device="cpu")
    out = capsys.readouterr().out
    assert "iter 0: total" in out and "EPE vs known (3.0, 0) flow" in out
    assert res["zero_flow_epe"] == 3.0 and res["device"] == "cpu"
    assert res["precision"] == "float32" and res["iters"] == CPU_LEARN_ITERS
    assert np.isfinite(res["epe"]) and res["epe"] < CPU_LEARN_EPE_BAR < res["zero_flow_epe"], res


def test_synthetic_epe_runs_saves_and_resumes(tmp_path, capsys):
    """The harness end to end on the CPU at a tiny size: the JAX harness's
    result keys, evaluation points after the steps they name, the cosine lr
    of the last update in the checkpoint, a resume at the stored iteration,
    a ``--supervised`` run (its step is held to JAX's above), and a JAX
    ``.ckpt`` without optimizer state: refused for a resume, loaded for a
    warm start."""
    ckpt = str(tmp_path / "s.pth")
    common = ["--device", "cpu", "--batch", "2", "--hw", "64", "128", "--eval-snippets", "2",
              "--lr-schedule", "cosine"]
    synthetic_epe.main(common + ["--iters", "3", "--eval-every", "2", "--quantize-fresh",
                                 "--save", ckpt])
    lines = capsys.readouterr().out.strip().splitlines()
    res = json.loads(lines[-1])
    r05 = json.loads((REPO / "benchmarks" / "synth_epe_r05" / "SYNTH_EPE_r05.json").read_text())
    assert set(r05["runs"]["main"]["final"]) <= set(res)
    assert res["platform"] == "cpu" and res["precision"] == "bfloat16"
    assert [p["iter"] for p in res["eval_points"]] == [0, 2]
    assert json.loads(lines[0])["zero_flow"] == res["zero_flow"]
    data = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert data["iteration"] == 3
    assert data["optimizer_state_dict"]["param_groups"][0]["lr"] == \
        synthetic_epe.cosine_decay_lr(1e-4, 3, 0.05, 2)

    synthetic_epe.main(common + ["--iters", "5", "--load", ckpt, "--save", ckpt, "--fp32",
                                 "--pool", "3", "--pool-file", str(tmp_path / "pool.npy")])
    out = capsys.readouterr().out
    assert "resumed from" in out and "at iter 3" in out and "iter 4: total" in out
    data = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert data["iteration"] == 5
    assert data["optimizer_state_dict"]["param_groups"][0]["lr"] == \
        synthetic_epe.cosine_decay_lr(1e-4, 5, 0.05, 4)
    assert np.load(tmp_path / "pool.npy").shape == (3, 192, 128, 3)

    synthetic_epe.main(common + ["--iters", "2", "--supervised", "--fp32", "--pool", "2",
                                 "--hw", "64", "64", "--batch", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    res = json.loads(lines[-1])
    assert res["supervised"] is True and res["precision"] == "float32"
    losses = [float(ln.split("total ")[1].split()[0]) for ln in lines if ln.startswith("iter ")]
    assert len(losses) == 2 and np.isfinite(losses).all() and min(losses) > 0
    assert np.isfinite(res["epe_all"])

    # the JAX package's .ckpt: one without optimizer state is refused for a
    # resume and warm-starts the weights
    from unopticalflow_tpu_torch.utils.checkpoint import save_flax_checkpoint

    flax_ckpt = str(tmp_path / "x.ckpt")
    save_flax_checkpoint(flax_ckpt, 3, FlowModel(device="cpu"))
    with pytest.raises(ValueError, match="no optimizer state"):
        synthetic_epe.main(common + ["--iters", "1", "--load", flax_ckpt])
    synthetic_epe.main(common + ["--iters", "1", "--load", flax_ckpt, "--load-params-only"])
    assert "warm-started params from" in capsys.readouterr().out
    if not torch.cuda.is_available():  # the card is the default and is not here
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            synthetic_epe.main(["--iters", "1"])
