"""The port's checkpoints against the JAX package's (CPU).

- ``utils/flax_msgpack.py`` reads the JAX ``save_checkpoint`` blobs as
  ``flax.serialization.msgpack_restore`` does, leaf for leaf and bit for bit
  (float32 and bfloat16 leaves, scalars, optax's empty ``"1"`` state), writes
  the bytes flax writes, and refuses what it does not read;
- ``save_flax_checkpoint``'s files are read back by the JAX
  ``restore_checkpoint`` into its templates;
- a resume across packages: 3 JAX Adam steps, a ``.ckpt``, the port's
  ``restore_checkpoint`` (weights and Adam state bit-equal), 3 port steps,
  held to 3 more JAX steps under ``test_torch_learning.py``'s trajectory
  rule;
- ``test.py --task export_pth`` from a ``.ckpt`` equals the JAX
  ``export_torch_checkpoint``;
- flowposenet trees: a JAX ``.ckpt`` of ``{"flow", "pose"}``, joint and
  ``--freeze_flow`` (optax's ``multi_transform`` state), read into a
  ``FlowPoseModel`` with weights and Adam state bit-equal; the port's
  ``save_flax_checkpoint`` of one restored by the JAX ``restore_checkpoint``
  under the same ``freeze_flow``; a resume under the other ``freeze_flow``
  refused with ``ValueError`` (``.ckpt`` and ``.pth``); a flow ``.pth``
  warm-starting ``model.flow`` only;
- ``AsyncCheckpointer``: ordered writes with ``last.pth`` the newest, a
  snapshot that an in-place update after ``save()`` does not reach, a queue
  that blocks at 2, and a failing write raised by the next call while
  ``close()`` still stops the worker.

The port runs its plain versions of the kernels here (CPU tensors).
"""

import threading
import time

import msgpack
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from unopticalflow_tpu.models import FlowModelConfig as JaxFlowModelConfig
from unopticalflow_tpu.models import init_flow_model, init_flowpose_model
from unopticalflow_tpu.training import create_train_state, make_train_step
from unopticalflow_tpu.training.train_step import make_optimizer as jax_make_optimizer
from unopticalflow_tpu.utils import checkpoint as jax_ckpt
from unopticalflow_tpu.utils.torch_convert import export_torch_checkpoint
from unopticalflow_tpu_torch import test as port_test
from unopticalflow_tpu_torch.benchmarks import sanity_train
from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, FlowPoseModel
from unopticalflow_tpu_torch.training import make_optimizer, train_step
from unopticalflow_tpu_torch.utils import checkpoint as ckpt
from unopticalflow_tpu_torch.utils import flax_msgpack
from unopticalflow_tpu_torch.utils.convert import params_to_torch_state_dict


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the suite runs in several workers on one machine's cores, where torch's
    # spinning thread pools (one thread a core in every worker) made the model
    # runs here up to ~70 times slower than alone (a 7 s test took 504 s)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


WEIGHTS = sanity_train.WEIGHTS
LR = 1e-4
STEPS = 3  # before the checkpoint, and again after it


@pytest.fixture(scope="module")
def jax_run():
    """Random "pwc" weights, 2 * STEPS sanity snippets (batch 2, 64x64), the
    JAX state after STEPS Adam steps (numpy leaves: the step donates its
    input) and the jitted step."""
    params = jax.jit(init_flow_model, static_argnames="scheme")(
        jax.random.PRNGKey(0), scheme="pwc")
    rng = np.random.RandomState(0)
    batches = [sanity_train.make_batch(rng, 2, 64, 64, 3)[0] for _ in range(2 * STEPS)]
    step = make_train_step(JaxFlowModelConfig(num_scales=3), WEIGHTS, lr=LR)
    state = create_train_state(params, lr=LR)
    for x in batches[:STEPS]:
        state, _ = step(state, jnp.asarray(x))
    return jax.tree.map(np.asarray, state), batches, step


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _same_leaves(got, want, path=""):
    """``flax_msgpack.loads``'s tree against ``msgpack_restore``'s, bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same_leaves(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray) and want.dtype == jnp.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == want.shape, path
        assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16)), path
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


def _blob_cases(state):
    rng = np.random.RandomState(1)
    return {
        "train_state": (STEPS, state.params, state.opt_state),
        "no_opt_state": (7, state.params, None),
        "bf16_and_scalars": (123456, {
            "bf": jnp.asarray(rng.randn(3, 5), jnp.bfloat16),
            "f16": rng.randn(4).astype(np.float16),
            "ints": {"i32": np.int32(-5) + np.zeros((2,), np.int32),
                     "i64": np.arange(-3, 3, dtype=np.int64),
                     "u32": np.arange(4, dtype=np.uint32)},
            "mask": rng.rand(6) > 0.5,
            "scalar": jnp.asarray(2.5, jnp.float32),
        }, ({"count": jnp.asarray(70000, jnp.int32)}, {})),
    }


@pytest.mark.parametrize("case", ["train_state", "no_opt_state", "bf16_and_scalars"])
def test_msgpack_reader_equals_flax_restore(case, jax_run, tmp_path):
    it, params, opt_state = _blob_cases(jax_run[0])[case]
    path = str(tmp_path / "x.ckpt")
    jax_ckpt.save_checkpoint(path, it, params, opt_state)
    blob = open(path, "rb").read()
    want = serialization.msgpack_restore(blob)
    got = flax_msgpack.loads(blob)
    _same_leaves(got, want)
    if case == "train_state":
        assert set(got) == {"iteration", "params", "opt_state"}
        assert set(got["params"]) == {"fpyramid", "pwc"}
        assert set(got["opt_state"]) == {"0", "1"} and got["opt_state"]["1"] == {}
        assert set(got["opt_state"]["0"]) == {"count", "mu", "nu"}
        assert got["opt_state"]["0"]["count"].dtype == np.int32
    # the writer gives flax's bytes back for the tree it read
    assert flax_msgpack.dumps(got) == blob


@pytest.mark.parametrize("bad,match", [
    ({"c": 1 + 2j}, "ext type 2"),
    ({"s": np.float32(1.5)}, "ext type 3"),
    ({"d": np.zeros(3, np.float64)}, "dtype 'float64'"),
])
def test_msgpack_reader_refuses_what_it_does_not_read(bad, match):
    with pytest.raises(ValueError, match=match):
        flax_msgpack.loads(serialization.msgpack_serialize(bad))


def test_msgpack_reader_refuses_chunked_and_truncated_blobs():
    chunked = msgpack.packb({"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2},
                                   "chunks": {}}})
    with pytest.raises(ValueError, match="chunked array"):
        flax_msgpack.loads(chunked)
    blob = serialization.msgpack_serialize({"a": np.zeros(8, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.loads(blob[:-3])
    with pytest.raises(ValueError, match="after the msgpack value"):
        flax_msgpack.loads(blob + b"\x00")


def _port(seed=0):
    model = FlowModel(FlowModelConfig(num_scales=3), device="cpu", scheme="pwc",
                      generator=torch.Generator().manual_seed(seed))
    return model, make_optimizer(model, LR)


def test_save_flax_checkpoint_is_read_by_jax(jax_run, tmp_path):
    """The port's ``.ckpt`` (weights and Adam state after 2 port steps) is
    read by the JAX ``restore_checkpoint`` into its templates, bit for bit."""
    state, batches, _ = jax_run
    model, opt = _port()
    for x in batches[:2]:
        train_step(model, opt, torch.from_numpy(x), WEIGHTS, FlowModelConfig(num_scales=3))
    path = str(tmp_path / "port.ckpt")
    ckpt.save_flax_checkpoint(path, 11, model, opt)
    it, params, opt_state = jax_ckpt.restore_checkpoint(path, state.params, state.opt_state)
    assert it == 11
    sd = model.state_dict()
    for tree, want in ((params, sd),
                       (opt_state[0].mu, {n: opt.state[p]["exp_avg"]
                                          for n, p in model.named_parameters()}),
                       (opt_state[0].nu, {n: opt.state[p]["exp_avg_sq"]
                                          for n, p in model.named_parameters()})):
        got = params_to_torch_state_dict(_host(tree))
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k].numpy()), k
    assert int(opt_state[0].count) == 2


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()), 1e-30))


def test_resume_across_packages(jax_run, tmp_path):
    """JAX: 3 steps, ``save_checkpoint``; the port: ``restore_checkpoint``
    (weights, exp_avg, exp_avg_sq and step equal to params, mu, nu and count
    bit for bit), then 3 steps, held to 3 more JAX steps by relative L2 of
    the losses and of the parameters' change from the checkpoint: within 3
    times the JAX run's own distance on snippets moved by one float32 ulp,
    or 1e-4 where JAX is steadier."""
    state, batches, step = jax_run
    path = str(tmp_path / "iter_2.ckpt")
    jax_ckpt.save_checkpoint(path, STEPS - 1, state.params, state.opt_state)

    model, opt = _port(seed=5)  # other weights: all are replaced
    assert ckpt.restore_checkpoint(path, model, opt) == STEPS - 1
    p0 = params_to_torch_state_dict(_host(state.params))
    mu = params_to_torch_state_dict(_host(state.opt_state[0].mu))
    nu = params_to_torch_state_dict(_host(state.opt_state[0].nu))
    for n, p in model.named_parameters():
        s = opt.state[p]
        assert np.array_equal(p.detach().numpy(), p0[n]), n
        assert np.array_equal(s["exp_avg"].numpy(), mu[n]), n
        assert np.array_equal(s["exp_avg_sq"].numpy(), nu[n]), n
        assert float(s["step"]) == int(state.opt_state[0].count) == STEPS

    def jax_more(snippets):
        st, losses = jax.tree.map(jnp.array, state), []
        for x in snippets:
            st, m = step(st, jnp.asarray(x))
            losses.append(float(m["loss_total"]))
        return np.array(losses), params_to_torch_state_dict(_host(st.params))

    want_loss, want_p = jax_more(batches[STEPS:])
    noise_loss, noise_p = jax_more([np.nextafter(x, np.float32(2.0)) for x in batches[STEPS:]])
    cfg = FlowModelConfig(num_scales=3)
    got_loss = np.array([float(train_step(model, opt, torch.from_numpy(x), WEIGHTS, cfg)
                               ["loss_total"]) for x in batches[STEPS:]])
    got_p = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    keys = sorted(p0)

    def delta(p):
        return np.concatenate([(p[k] - p0[k]).ravel() for k in keys])

    loss_tol = max(1e-4, 3.0 * _rel_l2(noise_loss, want_loss))
    assert _rel_l2(got_loss, want_loss) <= loss_tol, (got_loss, want_loss, loss_tol)
    d_want = delta(want_p)
    assert np.abs(d_want).max() > 0
    assert _rel_l2(delta(got_p), d_want) <= max(1e-4, 3.0 * _rel_l2(delta(noise_p), d_want))


def test_export_pth_equals_jax_export(jax_run, tmp_path):
    state = jax_run[0]
    src = str(tmp_path / "last.ckpt")
    jax_ckpt.save_checkpoint(src, 42, state.params, state.opt_state)
    want_path = str(tmp_path / "jax.pth")
    export_torch_checkpoint(want_path, _host(state.params), iteration=42)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("img_hw: [64, 64]\nnum_scales: 3\n")
    got_path = port_test.main(["-c", str(cfg), "--task", "export_pth", "--pretrained_model",
                               src, "--output_pth", str(tmp_path / "port.pth"),
                               "--device", "cpu"])
    got = torch.load(got_path, weights_only=True)
    want = torch.load(want_path, weights_only=False)
    assert set(got) == set(want) == {"iteration", "model_state_dict"}
    assert got["iteration"] == want["iteration"] == 42
    g, w = got["model_state_dict"], want["model_state_dict"]
    assert set(g) == set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype == torch.float32 and torch.equal(g[k], w[k]), k
    # and the .ckpt itself loads into a model with the same weights
    model = FlowModel(device="cpu")
    assert ckpt.load_pretrained(model, src) == 42
    assert all(torch.equal(v, w[k]) for k, v in model.state_dict().items())


# ---------------------------------------------------------------------------
# AsyncCheckpointer
# ---------------------------------------------------------------------------


def _tiny():
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    return model, opt


def test_async_writes_in_order_and_last_is_newest(tmp_path):
    model, opt = _tiny()
    saver = ckpt.AsyncCheckpointer()
    want = {}
    try:
        for i in range(5):
            with torch.no_grad():
                model.weight.fill_(float(i))
            want[i] = model.weight.detach().clone()
            saver.save([str(tmp_path / f"iter_{i}.pth"), str(tmp_path / "last.pth")], i,
                       model, opt)
        saver.wait()
    finally:
        saver.close()
    for i in range(5):
        data = torch.load(tmp_path / f"iter_{i}.pth", weights_only=True)
        assert data["iteration"] == i
        assert torch.equal(data["model_state_dict"]["weight"], want[i])
    last = torch.load(tmp_path / "last.pth", weights_only=True)
    assert last["iteration"] == 4 and torch.equal(last["model_state_dict"]["weight"], want[4])
    assert not saver._thread.is_alive()


def test_async_snapshot_is_not_reached_by_an_update_after_save(tmp_path, monkeypatch):
    model, opt = _tiny()
    gate = threading.Event()
    write = ckpt._atomic_write

    def slow_write(path, blob):
        assert gate.wait(10)
        write(path, blob)

    monkeypatch.setattr(ckpt, "_atomic_write", slow_write)
    w0 = model.weight.detach().clone()
    avg0 = opt.state[model.weight]["exp_avg"].clone()
    step0 = float(opt.state[model.weight]["step"])
    saver = ckpt.AsyncCheckpointer()
    try:
        saver.save([str(tmp_path / "a.pth")], 1, model, opt)
        model(torch.ones(1, 3)).sum().backward()
        opt.step()  # in place: weight, exp_avg, exp_avg_sq and step
        with torch.no_grad():
            model.weight.add_(100.0)
        gate.set()
        saver.wait()
    finally:
        gate.set()
        saver.close()
    data = torch.load(tmp_path / "a.pth", weights_only=True)
    assert torch.equal(data["model_state_dict"]["weight"], w0)
    s = data["optimizer_state_dict"]["state"][0]
    assert torch.equal(s["exp_avg"], avg0) and float(s["step"]) == step0
    assert float(opt.state[model.weight]["step"]) == step0 + 1


def test_async_queue_blocks_at_two(tmp_path, monkeypatch):
    model, opt = _tiny()
    entered, gate = threading.Event(), threading.Event()
    write = ckpt._atomic_write

    def held_write(path, blob):
        entered.set()
        assert gate.wait(10)
        write(path, blob)

    monkeypatch.setattr(ckpt, "_atomic_write", held_write)
    saver = ckpt.AsyncCheckpointer()
    try:
        saver.save([str(tmp_path / "0.pth")], 0, model, opt)
        assert entered.wait(10)  # the worker holds the first snapshot
        saver.save([str(tmp_path / "1.pth")], 1, model, opt)
        saver.save([str(tmp_path / "2.pth")], 2, model, opt)  # the queue holds 2
        fourth = threading.Thread(
            target=saver.save, args=([str(tmp_path / "3.pth")], 3, model, opt))
        fourth.start()
        time.sleep(0.3)
        assert fourth.is_alive()  # blocked until the writer takes one
        gate.set()
        fourth.join(10)
        assert not fourth.is_alive()
        saver.wait()
    finally:
        gate.set()
        saver.close()
    assert [torch.load(tmp_path / f"{i}.pth", weights_only=True)["iteration"]
            for i in range(4)] == [0, 1, 2, 3]


def test_async_write_error_surfaces_and_close_still_joins(tmp_path, monkeypatch):
    model, opt = _tiny()

    def failing_write(path, blob):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_atomic_write", failing_write)
    saver = ckpt.AsyncCheckpointer()
    saver.save([str(tmp_path / "a.pth")], 0, model, opt)
    with pytest.raises(RuntimeError, match="checkpoint write failed") as info:
        saver.wait()
    assert isinstance(info.value.__cause__, OSError)
    saver.save([str(tmp_path / "b.pth")], 1, model, opt)
    saver._q.join()  # the second write has failed too
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        saver.save([str(tmp_path / "c.pth")], 2, model, opt)
    saver.save([str(tmp_path / "d.pth")], 3, model, opt)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        saver.close()
    assert not saver._thread.is_alive()
    saver.close()  # closed: nothing left to raise
    with pytest.raises(RuntimeError, match="closed"):
        saver.save([str(tmp_path / "e.pth")], 4, model, opt)


# ---------------------------------------------------------------------------
# flowposenet trees
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flowpose_states():
    """JAX flowposenet train states after 2 Adam updates of random gradients
    (numpy leaves), joint and ``freeze_flow``."""
    params = jax.jit(init_flowpose_model, static_argnames="scheme")(
        jax.random.PRNGKey(1), scheme="pwc")
    rng = np.random.RandomState(2)
    states = {}
    for frozen in (False, True):
        state = create_train_state(params, lr=LR, freeze_flow=frozen)
        tx = jax_make_optimizer(LR, frozen)
        p, opt_state = state.params, state.opt_state
        for _ in range(2):
            g = jax.tree.map(lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32)), p)
            upd, opt_state = tx.update(g, opt_state, p)
            p = jax.tree.map(lambda a, u: a + u, p, upd)
        states[frozen] = (_host(p), _host(opt_state))
    return states


def _adam_of(opt_state, frozen):
    return opt_state.inner_states["train"].inner_state[0] if frozen else opt_state[0]


def _flowpose_port(frozen):
    """A port model and its optimizer, set up as the trainer sets them up."""
    model = FlowPoseModel(FlowModelConfig(num_scales=3), device="cpu")
    if frozen:
        model.flow.requires_grad_(False)
    return model, make_optimizer(model, LR, freeze_flow=frozen)


@pytest.mark.parametrize("frozen", [False, True], ids=["joint", "freeze_flow"])
def test_jax_flowpose_ckpt_restores_bit_equal(flowpose_states, frozen, tmp_path):
    params, opt_state = flowpose_states[frozen]
    path = str(tmp_path / "fp.ckpt")
    jax_ckpt.save_checkpoint(path, 5, params, opt_state)
    model, opt = _flowpose_port(frozen)
    assert ckpt.restore_checkpoint(path, model, opt) == 5
    want = params_to_torch_state_dict(params)
    sd = model.state_dict()
    assert set(sd) == set(want) and any(k.startswith("pose.") for k in sd)
    assert all(np.array_equal(sd[k].numpy(), want[k]) for k in want)
    adam = _adam_of(opt_state, frozen)
    mu, nu = (params_to_torch_state_dict(t) for t in (adam.mu, adam.nu))
    held = {n for n, p in model.named_parameters() if p in opt.state}
    assert held == set(mu) == set(nu)
    assert all(n.startswith("pose.") for n in held) if frozen else len(held) == len(sd)
    for n, p in model.named_parameters():
        if n in held:
            s_ = opt.state[p]
            assert np.array_equal(s_["exp_avg"].numpy(), mu[n]), n
            assert np.array_equal(s_["exp_avg_sq"].numpy(), nu[n]), n
            assert float(s_["step"]) == float(adam.count) == 2.0


@pytest.mark.parametrize("frozen", [False, True], ids=["joint", "freeze_flow"])
def test_port_flowpose_ckpt_is_read_by_jax(flowpose_states, frozen, tmp_path):
    """2 port steps of random gradients, ``save_flax_checkpoint``, then the
    JAX ``restore_checkpoint`` into the same ``freeze_flow``'s templates."""
    params, opt_state = flowpose_states[frozen]
    model, opt = _flowpose_port(frozen)
    gen = torch.Generator().manual_seed(3)
    for _ in range(2):
        for p in model.parameters():
            if p.requires_grad:
                p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
    path = str(tmp_path / "port_fp.ckpt")
    ckpt.save_flax_checkpoint(path, 4, model, opt)
    it, got_params, got_opt = jax_ckpt.restore_checkpoint(path, params, opt_state)
    assert it == 4
    sd = model.state_dict()
    got = params_to_torch_state_dict(_host(got_params))
    assert set(got) == set(sd) and all(np.array_equal(got[k], sd[k].numpy()) for k in sd)
    adam = _adam_of(got_opt, frozen)
    assert int(adam.count) == 2
    by_name = dict(model.named_parameters())
    for tree, key in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
        got = params_to_torch_state_dict(_host(tree))
        assert set(got) == {n for n, p in by_name.items() if p.requires_grad}
        for n, v in got.items():
            assert np.array_equal(v, opt.state[by_name[n]][key].numpy()), n


def test_a_resume_under_the_other_freeze_flow_is_refused(flowpose_states, tmp_path):
    for frozen in (False, True):
        params, opt_state = flowpose_states[frozen]
        path = str(tmp_path / f"fp_{frozen}.ckpt")
        jax_ckpt.save_checkpoint(path, 5, params, opt_state)
        with pytest.raises(ValueError, match="--freeze_flow"):
            ckpt.restore_checkpoint(path, *_flowpose_port(not frozen))
        model, opt = _flowpose_port(frozen)
        pth = str(tmp_path / f"fp_{frozen}.pth")
        ckpt.save_checkpoint([pth], 5, model, opt)
        with pytest.raises(ValueError, match="--freeze_flow"):
            ckpt.restore_checkpoint(pth, *_flowpose_port(not frozen))
        assert ckpt.restore_checkpoint(pth, *_flowpose_port(frozen)) == 5
    # a flowposenet .ckpt is no flow-mode state, and a flow one no flowposenet state
    with pytest.raises(ValueError, match="not a flow-mode train state"):
        ckpt.load_pretrained(FlowModel(device="cpu"), path)
    flow_ckpt = str(tmp_path / "flow.ckpt")
    jax_ckpt.save_checkpoint(flow_ckpt, 1, flowpose_states[False][0]["flow"])
    with pytest.raises(ValueError, match="not a flowposenet train state"):
        ckpt.load_pretrained(FlowPoseModel(device="cpu"), flow_ckpt)


def test_a_flow_pth_warm_starts_the_flow_branch_only(tmp_path):
    flow = FlowModel(FlowModelConfig(num_scales=3), device="cpu", scheme="pwc",
                     generator=torch.Generator().manual_seed(4))
    pth = port_test.export_pth(str(tmp_path / "flow.pth"), flow, 7)
    model = FlowPoseModel(FlowModelConfig(num_scales=3), device="cpu")
    pose0 = {k: v.clone() for k, v in model.pose.state_dict().items()}
    assert ckpt.load_pretrained(model.flow, pth) == 7
    assert all(torch.equal(a, b) for a, b in zip(model.flow.state_dict().values(),
                                                 flow.state_dict().values()))
    assert all(torch.equal(v, model.pose.state_dict()[k]) for k, v in pose0.items())
