"""The port's training slice against the JAX package (CPU, batch 2, 64x64).

Same ``init_flow_model(scheme="pwc")`` parameters on both sides (moved
across with ``load_jax_params``), same numpy snippets.  The port runs its
plain versions of the kernels here (CPU tensors).  Tolerances: the four
per-sample losses within rtol 1e-4 / atol 1e-6 of JAX ``forward`` (default
XLA path) and of ``tests/torch_oracle.py::loss_pack``; the gradient of the
photometric losses with respect to every parameter within 1e-4 of
``jax.grad`` by relative L2 norm (float32 sums in another order through ~40
layers), and that of the weighted total no farther from JAX than JAX is from
itself when the snippets move by one ulp (see the test); the port's Adam
within 1e-6 of ``optax.adam``.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from unopticalflow_tpu.models import FlowModelConfig as JaxFlowModelConfig
from unopticalflow_tpu.models import forward as jax_forward
from unopticalflow_tpu.models import init_flow_model
from unopticalflow_tpu.training.train_step import loss_weights_from_config as jax_weights
from unopticalflow_tpu.utils.torch_convert import params_to_torch_state_dict
from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, forward
from unopticalflow_tpu_torch.train import build_arg_parser, main, train
from unopticalflow_tpu_torch.training import loss_fn, loss_weights_from_config, make_optimizer
from unopticalflow_tpu_torch.utils.checkpoint import load_pretrained, restore_checkpoint
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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W = 2, 64, 64
WEIGHTS = {"loss_pixel": 0.15, "loss_ssim": 0.85, "loss_flow_smooth": 10.0,
           "loss_flow_consis": 0.01}


@pytest.fixture(scope="module")
def params():
    init = jax.jit(init_flow_model, static_argnames="scheme")
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), scheme="pwc"))


@pytest.fixture(scope="module")
def images():
    """(B, 3H, W, 3) snippets: a textured frame seen at three small shifts."""
    rng = np.random.RandomState(0)
    base = rng.rand(B, H + 4, W + 4, 3).astype(np.float32)
    return np.concatenate([base[:, 0:H, 0:W], base[:, 2:H + 2, 1:W + 1],
                           base[:, 4:H + 4, 2:W + 2]], 1)


PHOTO = {"loss_pixel": 0.15, "loss_ssim": 0.85, "loss_flow_smooth": 0.0, "loss_flow_consis": 0.0}


def _nudge(x):
    """The snippets moved by one float32 ulp: the conditioning probe below."""
    return np.nextafter(x, np.float32(2.0))


@pytest.fixture(scope="module")
def jax_ref(params, images):
    """JAX losses and parameter gradients (state-dict keys).

    ``grads[name]`` for the photometric part (``PHOTO``), the weighted total
    (``WEIGHTS``) and the weighted total on the nudged snippets.  The
    ablation gets its losses only.
    """
    keys = sorted(WEIGHTS)
    cfg = JaxFlowModelConfig(num_scales=3)

    def total(p, x, wv):
        pack = jax_forward(p, cfg, x)
        return sum(wv[i] * jnp.mean(pack[k]) for i, k in enumerate(keys)), pack

    fn = jax.jit(jax.value_and_grad(total, has_aux=True))
    grads = {}
    for name, wts, imgs in (("photo", PHOTO, images), ("total", WEIGHTS, images),
                            ("nudged", WEIGHTS, _nudge(images))):
        (_, pack), g = fn(params, jnp.asarray(imgs), jnp.asarray([wts[k] for k in keys]))
        grads[name] = params_to_torch_state_dict(jax.tree.map(np.asarray, g))
        if name == "total":
            losses = {k: np.asarray(v) for k, v in pack.items()}
    cfg_abl = JaxFlowModelConfig(num_scales=3, use_occlusion_weights=False)
    ablation = jax.jit(lambda p, x: jax_forward(p, cfg_abl, x))(params, jnp.asarray(images))
    return {"losses": losses, "grads": grads,
            "ablation": {k: np.asarray(v) for k, v in ablation.items()}}


def _port(params, images, weights, occ=True):
    cfg = FlowModelConfig(use_occlusion_weights=occ)
    model = load_jax_params(FlowModel(cfg, device="cpu"), params)
    total, _ = loss_fn(model, cfg, torch.from_numpy(images), weights)
    total.backward()
    with torch.no_grad():
        pack = forward(model, cfg, torch.from_numpy(images))
    return ({k: v.numpy() for k, v in pack.items()},
            {k: p.grad.numpy() for k, p in model.named_parameters()})


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()), 1e-30))


def _check_losses(pack, want):
    for k, v in want.items():
        assert pack[k].shape == (B,) and np.isfinite(pack[k]).all()
        np.testing.assert_allclose(pack[k], v, rtol=1e-4, atol=1e-6, err_msg=k)


def test_losses_and_gradients_match_jax(params, images, jax_ref):
    """The photometric part's gradient (the fused pack's path) within 1e-4 per
    tensor.  The weighted total's gradient is held to what it can show: the
    smoothness term is an L1 of second differences of bilinearly upsampled
    flows, exactly zero between the sample points, so its gradient there is
    sign(rounding noise).  JAX's own gradient moves by about 1% when the
    snippets move by one ulp; over all parameters the port must be no farther
    from JAX than that, and per tensor within 3 times it (two draws of the same
    noise), or within 1e-4 where JAX is steadier."""
    grads_ref = jax_ref["grads"]
    pack, grads = _port(params, images, PHOTO)
    _check_losses(pack, jax_ref["losses"])
    assert set(grads) == set(grads_ref["photo"])
    for k, g in grads.items():
        assert _rel_l2(g, grads_ref["photo"][k]) <= 1e-4, k
    _, grads = _port(params, images, WEIGHTS)
    total, nudged = grads_ref["total"], grads_ref["nudged"]
    flat = {name: np.concatenate([np.ravel(g[k]) for k in sorted(total)])
            for name, g in (("port", grads), ("total", total), ("nudged", nudged))}
    noise = _rel_l2(flat["nudged"], flat["total"])
    assert _rel_l2(flat["port"], flat["total"]) <= max(1e-4, noise)
    for k, g in grads.items():  # per tensor: two draws of one noise, 3x apart at most
        assert _rel_l2(g, total[k]) <= max(1e-4, 3.0 * _rel_l2(nudged[k], total[k])), k
    assert max(np.abs(g).max() for g in grads.values()) > 0


def test_ablation_losses_match_jax(params, images, jax_ref):
    pack, grads = _port(params, images, WEIGHTS, occ=False)
    _check_losses(pack, jax_ref["ablation"])
    assert all(np.isfinite(g).all() for g in grads.values())


def test_losses_match_the_torch_oracle(params, images):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_oracle import loss_pack, state_dict_from_params

    pack, _ = _port(params, images, WEIGHTS)
    with torch.no_grad():
        want = loss_pack(state_dict_from_params(params),
                         torch.from_numpy(images).permute(0, 3, 1, 2).contiguous())
    for k, v in want.items():
        np.testing.assert_allclose(pack[k], v.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def test_loss_weights_match_jax():
    cfg = types.SimpleNamespace(w_ssim=0.7, w_flow_smooth=3.0, w_flow_consis=0.5, mode="flow")
    assert loss_weights_from_config(cfg) == jax_weights(cfg)
    assert loss_weights_from_config(object()) == jax_weights(types.SimpleNamespace())


def test_adam_matches_optax():
    """A fixed gradient sequence through both: another eps, beta or bias
    correction would fail."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(5, 7).astype(np.float32)
    grads = [rng.randn(5, 7).astype(np.float32) * 10.0 ** rng.uniform(-6, 1) for _ in range(6)]
    model = torch.nn.Linear(7, 5, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(p0))
    opt = make_optimizer(model, lr=1e-3)
    tx = optax.adam(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    for g in grads:
        model.weight.grad = torch.from_numpy(g)
        opt.step()
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        np.testing.assert_allclose(model.weight.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A synthetic prepared KITTI dir, built as tests/test_train_loop.py builds it."""
    import cv2

    root = tmp_path_factory.mktemp("torch_loop")
    prep = root / "prepared" / "data_s1"
    drive = prep / "d" / "r"
    drive.mkdir(parents=True)
    rng = np.random.RandomState(0)
    lines = []
    h, w = 32, 32
    for i in range(4):
        base = rng.randint(0, 255, (h + 4, w, 3), dtype=np.uint8)
        tri = np.concatenate([base[:h], base[2:h + 2], base[4:h + 4]], 0)
        cv2.imwrite(str(drive / f"{i:010d}.png"), tri)
        lines.append(f"d/r/{i:010d}.png d/calib.txt\n")
    with open(prep / "d" / "calib.txt", "w") as f:
        f.write("P_rect_02: 30.0 0.0 16.0 0.0 0.0 30.0 16.0 0.0 0.0 0.0 1.0 0.0\n")
    with open(prep / "train.txt", "w") as f:
        f.writelines(lines)
    (root / "models").mkdir()
    return root


def _cfg(root, **over):
    d = dict(dataset="kitti_depth", num_scales=3, num_iterations=3, w_ssim=0.85,
             w_flow_smooth=10.0, w_flow_consis=0.01, img_hw=(64, 64),
             prepared_base_dir=str(root / "prepared"), prepared_save_dir="data_s1",
             model_dir=str(root / "models"), log_dump_dir=None, batch_size=2, iter_start=0,
             lr=1e-4, num_workers=1, log_interval=1, save_interval=2, mode="flow",
             resume=False, no_test=True, precision="float32",
             loss_precision=None, init_scheme="pwc", seed=0, device="cpu")
    d.update(over)
    return types.SimpleNamespace(**d)


def test_train_loop_saves_and_resumes(workspace, capsys):
    res = train(_cfg(workspace))
    out = capsys.readouterr().out
    assert "iter: 0, loss_pixel:" in out and "snippets_per_sec" in out
    assert res.step == 3
    files = set(os.listdir(workspace / "models"))
    # the grid save at iteration 1 and the final save (3 is off the grid of 2)
    assert {"iter_1.pth", "iter_2.pth", "last.pth"} <= files
    path = str(workspace / "models" / "last.pth")
    fresh = FlowModel(device="cpu")
    opt = make_optimizer(fresh)
    assert restore_checkpoint(path, fresh, opt) == 2
    for a, b in zip(fresh.parameters(), res.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert len(opt.state) == len(list(fresh.parameters()))
    assert load_pretrained(FlowModel(device="cpu"), path) == 2  # the serving slice reads it

    res2 = train(_cfg(workspace, resume=True, num_iterations=4))
    out2 = capsys.readouterr().out
    assert "starting iteration: 2." in out2 and "iter: 3, loss_pixel:" in out2
    assert res2.step == 4


def test_trainer_refuses_what_this_slice_does_not_run(workspace):
    # without --no_test the interleaved evaluation needs the ground truth
    with pytest.raises(FileNotFoundError, match="gt_2012_dir.*--no_test"):
        train(_cfg(workspace, no_test=False, gt_2012_dir=str(workspace / "missing"),
                   gt_2015_dir=str(workspace / "missing")))
    with pytest.raises(ValueError, match="flow only"):
        train(_cfg(workspace, mode="flowposenet"))
    with pytest.raises(ValueError, match="config file needed"):
        main([])
    args = build_arg_parser().parse_args(["-c", "x.yaml", "--no_test"])
    assert (args.device, args.batch_size, args.lr, args.precision) == ("cuda", 8, 1e-4, "float32")


def test_training_modules_leave_jax_out():
    code = (
        "import sys, unopticalflow_tpu_torch.train, unopticalflow_tpu_torch.data\n"
        "import unopticalflow_tpu_torch.training, unopticalflow_tpu_torch.utils.checkpoint\n"
        "from unopticalflow_tpu_torch.data import KITTI_Prepared\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert 'unopticalflow_tpu.data' not in sys.modules\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
