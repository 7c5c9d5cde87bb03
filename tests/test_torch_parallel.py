"""Data parallelism in the port (CPU, gloo): ``parallel/mesh.py``,
``BatchLoader``'s per-process blocks and ``train_step(group=...)``.

- ``BatchLoader(process_index, process_count)`` against the JAX
  ``BatchLoader``, block for block, and its refusal of a global batch that
  does not divide;
- two gloo ranks (two processes, a ``file://`` rendezvous under
  ``tmp_path``) each step on their half of a global batch of 4 at 64x64 from
  the JAX package's weights (moved across with ``utils/convert.py``): one
  step against JAX ``make_train_step(mesh=...)`` over 2 of conftest's virtual
  CPU devices, and against the port's own one-process step on the global
  batch; K = 2 steps a dispatch against JAX ``make_multi_train_step(mesh=
  ...)``; ``--freeze_flow`` in flowposenet mode against one process.  The
  tolerances are JAX's ``test_data_parallel_matches_single_device``: loss
  rtol 1e-4, parameters rtol 5e-3 / atol 3e-4 (Adam turns a rounding-level
  gradient into a step of ~lr either way).  Since a step of ~lr passes
  those whatever the gradient, every case also holds the parameters'
  change to the reference's own distance on images one ulp away, a bound
  that must reject the planted fault of every rank applying rank 0's
  gradient (one process on rank 0's blocks);
- the collectives themselves on a one-rank group, and what
  ``initialize_multi_host`` reads from torchrun's environment.

On the card the same step runs over NCCL inside the K-step CUDA graph and as
two gloo ranks on one card (``chip_smoke.py`` phase 20).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from unopticalflow_tpu.data.loader import BatchLoader as JaxBatchLoader
from unopticalflow_tpu.models import FlowModelConfig as JaxFlowModelConfig
from unopticalflow_tpu.models import init_flow_model
from unopticalflow_tpu.training import create_train_state
from unopticalflow_tpu.training import make_multi_train_step as jax_make_multi_train_step
from unopticalflow_tpu.training import make_train_step as jax_make_train_step
from unopticalflow_tpu_torch.data import BatchLoader
from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, FlowPoseModel
from unopticalflow_tpu_torch.parallel import (
    all_reduce_mean,
    data_parallel_world,
    initialize_multi_host,
    replicate,
    shard_batch,
)
from unopticalflow_tpu_torch.training import make_optimizer, train_step
from unopticalflow_tpu_torch.utils.convert import params_to_torch_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W = 4, 64, 64  # the global batch
LR = 1e-4
WEIGHTS = {"loss_pixel": 0.15, "loss_ssim": 0.85, "loss_flow_smooth": 10.0,
           "loss_flow_consis": 0.01}
FP_WEIGHTS = {**WEIGHTS, "loss_pose_epipolar": 1.0}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the suite runs in several workers on one machine's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# BatchLoader's per-process blocks
# ---------------------------------------------------------------------------


class _Indexed:
    """Sample i is (i, -i): every loader position names its index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.array([i, -i], np.int64)


@pytest.mark.parametrize("count", [2, 4])
def test_batch_loader_blocks_equal_jax(count):
    ds = _Indexed(22)  # 2 full global batches of 8 and a ragged one, dropped
    for index in range(count):
        got = list(BatchLoader(ds, 8, num_workers=2, process_index=index, process_count=count))
        want = list(JaxBatchLoader(ds, 8, num_workers=2, process_index=index,
                                   process_count=count))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert [int(b[0, 0]) for b in got] == [index * 8 // count, 8 + index * 8 // count]
    assert len(BatchLoader(ds, 8, process_count=count)) == len(
        JaxBatchLoader(ds, 8, process_count=count)) == 2
    # one process keeps the ragged last batch, as the JAX loader does
    assert [len(b) for b in BatchLoader(ds, 8, num_workers=1)] == \
        [len(b) for b in JaxBatchLoader(ds, 8, num_workers=1)] == [8, 8, 6]
    for loader in (BatchLoader, JaxBatchLoader):
        if 6 % count:
            with pytest.raises(ValueError, match=f"global batch 6 must divide over {count} "
                                                 "processes"):
                loader(ds, 6, process_index=0, process_count=count)
        else:
            assert loader(ds, 6, process_index=1, process_count=count).drop_last


def test_shard_batch_gives_contiguous_blocks():
    x = np.arange(24).reshape(6, 4)
    assert shard_batch(x, 1, 3).tolist() == x[2:4].tolist()
    t = (torch.arange(8), torch.arange(16).reshape(8, 2))
    a, b = shard_batch(t, 3, 4)
    assert a.tolist() == [6, 7] and b.tolist() == [[12, 13], [14, 15]]
    assert shard_batch(list(range(8, 16)), 1, 2) == [12, 13, 14, 15]  # BatchLoader's indices
    with pytest.raises(ValueError, match="global batch 6 must divide over 4 processes"):
        shard_batch(x, 0, 4)


# ---------------------------------------------------------------------------
# the collectives, and the rendezvous arguments
# ---------------------------------------------------------------------------


def test_one_rank_collectives_and_world(tmp_path):
    """A one-rank gloo group: the pmean of one rank is the identity (one
    buffer across dtypes grouped), ``replicate`` leaves the state as it is,
    ``data_parallel_world`` reads the group."""
    assert data_parallel_world() == (0, 1)
    device = initialize_multi_host(f"file://{tmp_path / 'store'}", 1, 0, device="cpu")
    try:
        assert device == torch.device("cpu") and dist.get_backend() == "gloo"
        assert data_parallel_world() == (0, 1)
        a, b = torch.randn(3, 4), torch.randn(5).double()
        a0, b0 = a.clone(), b.clone()
        all_reduce_mean([a, b])
        assert torch.equal(a, a0) and torch.equal(b, b0)
        model = FlowModel(device="cpu")
        opt = make_optimizer(model)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        replicate(model)
        replicate(opt)  # no state before the first step
        assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    finally:
        dist.destroy_process_group()
    assert data_parallel_world() == (0, 1)


def test_initialize_reads_torchrun_and_names_what_is_missing(monkeypatch, tmp_path):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match=r"--multi_host needs --coordinator_address \(or "
                                         r"MASTER_ADDR and MASTER_PORT\), --num_processes "
                                         r"\(or WORLD_SIZE\), --process_id \(or RANK\)"):
        initialize_multi_host(device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match=r"needs --coordinator_address .*, --process_id"):
        initialize_multi_host(device="cpu")
    with pytest.raises(ValueError, match=r"--process_id 2 is not in \[0, 2\)"):
        initialize_multi_host("127.0.0.1:1", process_id=2, device="cpu")
    # torchrun's variables alone: a one-process job on a free port
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert initialize_multi_host(device="cpu") == torch.device("cpu")
    try:
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
    finally:
        dist.destroy_process_group()


def test_train_as_a_rank_needs_a_joined_group(tmp_path):
    """``train(cfg)`` with ``cfg.multi_host`` trains as one rank of the
    group its caller joined, and raises where there is none."""
    from unopticalflow_tpu_torch.train import recipe_config, train

    assert not dist.is_initialized()
    cfg = recipe_config(multi_host=True, img_hw=(H, W), num_iterations=1, batch_size=2,
                        model_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match=r"multi_host: no process group; join one first "
                                           r"\(parallel.initialize_multi_host\)"):
        train(cfg, dataset=np.zeros((2, 3 * H, W, 3), np.uint8), device="cpu")


# ---------------------------------------------------------------------------
# two gloo ranks against JAX's data mesh and one process
# ---------------------------------------------------------------------------

# each case: mode, freeze_flow, K steps a dispatch, the (global) batches
_WORKER = r"""
import sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, FlowPoseModel
from unopticalflow_tpu_torch.parallel import initialize_multi_host, shard_batch
from unopticalflow_tpu_torch.training import make_multi_train_step, make_optimizer, train_step

rank, world, init, spec_path, out = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:]
initialize_multi_host(init, world, rank, device="cpu")
results = {}
for name, case in torch.load(spec_path, weights_only=False).items():
    cfg = FlowModelConfig(num_scales=3)
    model = (FlowPoseModel if case["mode"] == "flowposenet" else FlowModel)(cfg, device="cpu")
    model.load_state_dict(case["state"])
    if case["freeze"]:
        model.flow.requires_grad_(False)
    opt = make_optimizer(model, case["lr"], freeze_flow=case["freeze"])
    metrics = []
    if case["k"] == 1:
        for batch in case["batches"]:
            m = train_step(model, opt, shard_batch(batch, rank, world), case["weights"], cfg,
                           case["mode"], 3, dist.group.WORLD)
            metrics.append({n: float(v) for n, v in m.items()})
    else:
        multi = make_multi_train_step(model, opt, cfg, case["weights"], case["k"],
                                      case["mode"], 3, case["freeze"], group=dist.group.WORLD)
        for batch in case["batches"]:  # (K, B, ...): each sub-step's block
            m = multi(torch.stack([shard_batch(x, rank, world) for x in batch]))
            metrics += [{n: float(v[j]) for n, v in m.items()} for j in range(case["k"])]
    results[name] = {"metrics": metrics, "state": model.state_dict()}
torch.save(results, out)
dist.destroy_process_group()
"""


def _images(n, seed):
    """``n`` global batches of smooth random snippets, the JAX DP test's kind."""
    rng = np.random.RandomState(seed)
    base = rng.rand(n, B, H + 4, W + 6, 3).astype(np.float32)
    base = (base + np.roll(base, 1, 3) + np.roll(base, 1, 2)) / 3.0
    frames = [base[:, :, 2 * i:2 * i + H, 3 * i:3 * i + W] for i in range(3)]
    return np.ascontiguousarray(np.concatenate(frames, 2))


def _intrinsics(seed):
    rng = np.random.RandomState(seed)
    k = np.zeros((B, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = 0.9 * W + rng.rand(B)
    k[:, 0, 2], k[:, 1, 2], k[:, 2, 2] = W / 2 + rng.randn(B), H / 2 + rng.randn(B), 1.0
    return torch.from_numpy(k), torch.from_numpy(np.linalg.inv(k).astype(np.float32))


@pytest.fixture(scope="module")
def jax_params():
    init = jax.jit(init_flow_model, static_argnames="scheme")
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), scheme="pwc"))


@pytest.fixture(scope="module")
def cases(jax_params):
    state = {k: torch.from_numpy(np.array(v))
             for k, v in params_to_torch_state_dict(jax_params).items()}
    fp = FlowPoseModel(FlowModelConfig(num_scales=3), device="cpu", scheme="pwc",
                       generator=torch.Generator().manual_seed(4))
    fp.flow.load_state_dict(state)
    k1, kinv1 = _intrinsics(1)
    return {
        "step": dict(mode="flow", freeze=False, k=1, lr=LR, weights=WEIGHTS, state=state,
                     batches=[torch.from_numpy(_images(1, 0)[0])]),
        "k2": dict(mode="flow", freeze=False, k=2, lr=LR, weights=WEIGHTS, state=state,
                   batches=[torch.from_numpy(_images(2, 1))]),
        "freeze": dict(mode="flowposenet", freeze=True, k=1, lr=LR, weights=FP_WEIGHTS,
                       state={k: v.clone() for k, v in fp.state_dict().items()},
                       batches=[(torch.from_numpy(_images(1, 2)[0]), k1, kinv1)] * 2),
    }


@pytest.fixture(scope="module")
def two_ranks(cases, tmp_path_factory):
    """Every case on two gloo ranks (two processes); each rank's results."""
    root = tmp_path_factory.mktemp("two_ranks")
    spec = root / "spec.pt"
    torch.save(cases, spec)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), "2",
                               f"file://{root / 'store'}", str(spec), str(root / f"r{r}.pt")],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=150)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    return [torch.load(root / f"r{r}.pt", weights_only=True) for r in range(2)]


def _one_process(case):
    """The port's one-process steps on the global batches."""
    cfg = FlowModelConfig(num_scales=3)
    model = (FlowPoseModel if case["mode"] == "flowposenet" else FlowModel)(cfg, device="cpu")
    model.load_state_dict(case["state"])
    if case["freeze"]:
        model.flow.requires_grad_(False)
    opt = make_optimizer(model, case["lr"], freeze_flow=case["freeze"])
    metrics = []
    for batch in case["batches"]:
        for x in (batch if case["k"] > 1 else [batch]):
            m = train_step(model, opt, x, case["weights"], cfg, case["mode"])
            metrics.append({n: float(v) for n, v in m.items()})
    return metrics, model.state_dict()


def _rank0_only(case):
    """The case on rank 0's block of each global batch alone: where every
    rank applied rank 0's gradient instead of the mean, the weights would
    follow this run (the planted fault that ``_change_held`` must reject)."""
    def block(b):
        if case["k"] > 1:
            return torch.stack([shard_batch(x, 0, 2) for x in b])
        return shard_batch(b, 0, 2)

    return {**case, "batches": [block(b) for b in case["batches"]]}


def _held(metrics, state, want_metrics, want_state):
    """JAX's DP tolerances: every metric rtol 1e-4, parameters rtol 5e-3 /
    atol 3e-4."""
    assert len(metrics) == len(want_metrics)
    for m, w in zip(metrics, want_metrics):
        assert m.keys() == w.keys()
        for n in m:
            np.testing.assert_allclose(m[n], w[n], rtol=1e-4, err_msg=n)
    assert state.keys() == want_state.keys()
    for n in state:
        np.testing.assert_allclose(np.asarray(state[n]), np.asarray(want_state[n]), rtol=5e-3,
                                   atol=3e-4, err_msg=n)


def _ranks_agree(two_ranks, name):
    (a, b) = (r[name] for r in two_ranks)
    assert a["metrics"] == b["metrics"]
    assert all(torch.equal(a["state"][n], b["state"][n]) for n in a["state"])
    return a


def _jax_mesh():
    return Mesh(np.asarray(jax.devices()[:2]), axis_names=("data",))


def _jax_run(step, jax_params, batches, spec):
    mesh = _jax_mesh()
    state = create_train_state(jax.tree.map(jnp.array, jax_params), lr=LR)
    state = jax.device_put(state, NamedSharding(mesh, P()))
    metrics = []
    for x in batches:
        state, m = step(state, jax.device_put(jnp.asarray(x.numpy()), NamedSharding(mesh, spec)))
        m = jax.tree.map(np.asarray, m)
        k = np.shape(m["loss_total"])
        metrics += [{n: float(v) for n, v in m.items()}] if not k else \
            [{n: float(v[j]) for n, v in m.items()} for j in range(k[0])]
    return metrics, params_to_torch_state_dict(jax.tree.map(np.asarray, state.params))


def test_two_rank_step_matches_the_jax_data_parallel_step(two_ranks, cases, jax_params):
    got = _ranks_agree(two_ranks, "step")
    step = jax_make_train_step(JaxFlowModelConfig(num_scales=3), WEIGHTS, lr=LR,
                               mesh=_jax_mesh())
    case = cases["step"]
    want_m, want_p = _jax_run(step, jax_params, case["batches"], P("data"))
    _held(got["metrics"], got["state"], want_m, want_p)
    _change_held(got["state"], want_p, _jax_run(step, jax_params, _nudged(case)["batches"],
                                                 P("data"))[1],
                 _one_process(_rank0_only(case))[1], case["state"])


def test_two_rank_step_matches_one_process_on_the_global_batch(two_ranks, cases):
    got = _ranks_agree(two_ranks, "step")
    case = cases["step"]
    want_m, want_p = _one_process(case)
    _held(got["metrics"], got["state"], want_m, want_p)
    moved = sum(int((got["state"][n] != case["state"][n]).sum()) for n in want_p)
    assert moved > 0.5 * sum(v.numel() for v in want_p.values())
    _change_held(got["state"], want_p, _one_process(_nudged(case))[1],
                 _one_process(_rank0_only(case))[1], case["state"])


def _nudged(case):
    """The case with its images moved by one float32 ulp."""
    def nudge(b):
        if isinstance(b, tuple):
            return (nudge(b[0]), *b[1:])
        return torch.from_numpy(np.nextafter(b.numpy(), np.float32(2.0)))

    return {**case, "batches": [nudge(b) for b in case["batches"]]}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()), 1e-30))


def _change_held(got_s, want_s, noise_s, fault_s, init):
    """The parameters' change from ``init`` within 3 times the reference
    run's own distance on images one ulp away, or 1e-4 (one Adam step moves
    a weight by ~lr in its gradient's sign, so a per-weight tolerance of a
    few lr cannot tell a wrong reduction); and that bound rejects the
    planted fault ``fault_s`` (``_rank0_only``)."""
    keys = sorted(init)

    def delta(state):
        return np.concatenate([(np.asarray(state[k], np.float64)
                                - np.asarray(init[k], np.float64)).ravel() for k in keys])

    d_want = delta(want_s)
    assert np.abs(d_want).max() > 0
    bound = max(1e-4, 3 * _rel_l2(delta(noise_s), d_want))
    err, fault = _rel_l2(delta(got_s), d_want), _rel_l2(delta(fault_s), d_want)
    assert err <= bound, (err, bound)
    assert fault > bound, (fault, bound)


def _trajectory_held(got, want, noise, fault, init):
    """Over several steps Adam turns rounding-level gradients into moves of
    ~lr either way, so a run is held as ``test_torch_dispatch.py`` holds a
    trajectory: the first step's metrics to rtol 1e-4 (it starts from the
    same state), then the weighted losses within 3 times the reference
    run's own distance on images one ulp away, or 1e-4, and the parameters'
    change by ``_change_held``."""
    (got_m, got_s), (want_m, want_s), (noise_m, noise_s) = got, want, noise
    assert len(got_m) == len(want_m) == len(noise_m) > 1
    for n in want_m[0]:
        np.testing.assert_allclose(got_m[0][n], want_m[0][n], rtol=1e-4, err_msg=n)

    def losses(ms):
        return [m["loss_total"] for m in ms]

    tol = max(1e-4, 3 * _rel_l2(losses(noise_m), losses(want_m)))
    assert _rel_l2(losses(got_m), losses(want_m)) <= tol, (losses(got_m), losses(want_m))
    _change_held(got_s, want_s, noise_s, fault[1], init)


def test_two_rank_k2_dispatch_matches_the_jax_multi_step(two_ranks, cases, jax_params):
    got = _ranks_agree(two_ranks, "k2")
    case = cases["k2"]
    step = jax_make_multi_train_step(JaxFlowModelConfig(num_scales=3), WEIGHTS, 2, lr=LR,
                                     mesh=_jax_mesh())
    want = _jax_run(step, jax_params, case["batches"], P(None, "data"))
    noise = _jax_run(step, jax_params, _nudged(case)["batches"], P(None, "data"))
    got = (got["metrics"], got["state"])
    fault = _one_process(_rank0_only(case))
    _trajectory_held(got, want, noise, fault, case["state"])
    # and the port's own two one-process steps
    _trajectory_held(got, _one_process(case), _one_process(_nudged(case)), fault,
                     case["state"])


def test_two_rank_freeze_flow_trains_the_pose_branch_only(two_ranks, cases):
    got = _ranks_agree(two_ranks, "freeze")
    case = cases["freeze"]
    assert all("loss_pose_epipolar" in m for m in got["metrics"])
    _trajectory_held((got["metrics"], got["state"]), _one_process(case),
                     _one_process(_nudged(case)), _one_process(_rank0_only(case)),
                     case["state"])
    init = case["state"]
    flow = [n for n in init if n.startswith("flow.")]
    assert flow and all(torch.equal(got["state"][n], init[n]) for n in flow)
    assert any(not torch.equal(got["state"][n], init[n]) for n in init if n.startswith("pose."))
