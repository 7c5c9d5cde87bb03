"""The port's bench (``unopticalflow_tpu_torch/bench.py``) against the root
``bench.py`` (CPU, batch 2, 64x64).

- the training setup: two eager steps from the JAX weights of
  ``init_flow_model(PRNGKey(0))`` (moved across with ``load_jax_params``)
  on the bench's images against two steps of ``make_train_step`` as
  ``bench.py:36-62`` builds it (on the CPU its Pallas switches are off):
  the first ``loss_total`` within rtol 1e-4 / atol 1e-6, as
  ``test_torch_train.py``, the second within rtol 1e-3 / atol 5e-4, as
  ``test_torch_dispatch.py`` (Adam's first update is lr x sign(g), so one
  step amplifies the float32 differences);
- ``--scan-steps 2``: one dispatch bit for bit two eager steps;
- the inference setup's flow against JAX ``inference_flow`` within 1e-4 x
  (1 + max |flow|), as ``test_torch_inference.py``;
- ``main``'s single stdout line (keys, ``metric`` strings and
  ``vs_baseline`` by ``bench.py:451-480``'s formula) for the recipe and other
  shapes, K = 0 and 2 and ``--infer``, and two real CPU runs;
- ``--validate`` raising without CUDA, and the JAX bench's TPU-only flags
  refused.

The kernels' own check, ``--validate``, runs on the card (``chip_smoke.py``
phase 23).
"""

import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unopticalflow_tpu.models import FlowModelConfig as JaxFlowModelConfig
from unopticalflow_tpu.models import inference_flow as jax_inference_flow
from unopticalflow_tpu.models import init_flow_model
from unopticalflow_tpu.training import create_train_state, make_train_step
from unopticalflow_tpu_torch import bench
from unopticalflow_tpu_torch.utils.convert import load_jax_params


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the suite runs in several workers on one machine's cores, where torch's
    # spinning thread pools (one thread a core in every worker) made the model
    # runs up to ~70 times slower than alone
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B, H, W = 2, 64, 64
CPU = torch.device("cpu")
# bench.py:49-54
JAX_WEIGHTS = {"loss_pixel": 0.15, "loss_ssim": 0.85, "loss_flow_smooth": 10.0,
               "loss_flow_consis": 0.01}


@pytest.fixture(scope="module")
def params():
    """bench.py:55's weights: the default ("torch") init of PRNGKey(0)."""
    return jax.tree.map(np.asarray, jax.jit(init_flow_model)(jax.random.PRNGKey(0)))


def _jax_cfg():
    # bench.py:44-48 off the TPU: use_pallas is False, quantize_loss_warps False
    return JaxFlowModelConfig(num_scales=3, compute_dtype="float32", loss_dtype="float32",
                              use_pallas_corr=False, use_pallas_photo=False)


def test_eager_steps_match_the_jax_bench_step(params):
    images = np.random.RandomState(0).rand(B, 3 * H, W, 3).astype(np.float32)  # bench.py:60-61
    state = create_train_state(jax.tree.map(jnp.array, params), lr=1e-4)
    step = make_train_step(_jax_cfg(), JAX_WEIGHTS, lr=1e-4)
    want = []
    for _ in range(2):
        state, m = step(state, jnp.asarray(images))
        want.append(float(m["loss_total"]))

    model, port_step, x = bench.train_setup(B, (H, W), "float32", 0, CPU)
    assert np.array_equal(x.numpy(), images)
    assert bench.RECIPE_WEIGHTS == JAX_WEIGHTS
    load_jax_params(model, params)
    got = [float(port_step(x)["loss_total"]) for _ in range(2)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3, atol=5e-4)


def test_two_steps_a_dispatch_are_two_eager_steps_bit_for_bit():
    model_1, step_1, x_1 = bench.train_setup(B, (H, W), "float32", 0, CPU)
    model_k, step_k, x_k = bench.train_setup(B, (H, W), "float32", 2, CPU)
    assert tuple(x_k.shape) == (2, *x_1.shape) and torch.equal(x_k[1], x_1)
    eager = [step_1(x_1) for _ in range(2)]
    multi = step_k(x_k)
    for name in eager[0]:
        assert torch.equal(multi[name], torch.stack([m[name] for m in eager])), name
    for (name, p), q in zip(model_1.named_parameters(), model_k.parameters()):
        assert torch.equal(p, q), name


def test_inference_setup_matches_jax_inference_flow(params):
    rng = np.random.RandomState(0)  # bench.py:163-165: img1, then img2
    img1, img2 = (rng.rand(B, H, W, 3).astype(np.float32) for _ in range(2))
    model, flow, pair = bench.infer_setup(B, (H, W), "float32", CPU)
    assert np.array_equal(pair[0].numpy(), img1) and np.array_equal(pair[1].numpy(), img2)
    load_jax_params(model, params)
    got = flow(*pair)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, W, 2)
    want = np.asarray(jax.jit(lambda a, b: jax_inference_flow(params, _jax_cfg(), a, b))(
        jnp.asarray(img1), jnp.asarray(img2)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * (1 + float(np.abs(want).max())))


def _jax_line(batch, hw, value, infer, scan_steps):
    """The line of bench.py:451-480, written out as there."""
    if infer:
        return {"metric": "infer frame-pairs/sec/chip (256x832)", "value": round(value, 2),
                "unit": "pairs/s", "vs_baseline": round(value / 35.0, 2)}
    default_recipe = tuple(hw) == (256, 832) and batch == 8
    metric = ("train snippets/sec/chip (KITTI recipe 256x832, batch 8)" if default_recipe
              else f"train snippets/sec/chip ({hw[0]}x{hw[1]}, batch {batch})")
    if scan_steps:
        metric += f", {scan_steps} steps/dispatch"
    base = 20.0 * ((256 * 832) / float(hw[0] * hw[1]))
    return {"metric": metric, "value": round(value, 2), "unit": "snippets/s",
            "vs_baseline": round(value / base, 2)}


def _one_line(capsys) -> dict:
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert len(lines) == 1, out
    return json.loads(lines[0])


@pytest.mark.parametrize("argv, want", [
    ([], dict(batch=8, hw=(256, 832), precision="bfloat16", scan_steps=8, infer=False)),
    (["--scan-steps", "0", "--fp32"],
     dict(batch=8, hw=(256, 832), precision="float32", scan_steps=0, infer=False)),
    (["--batch", "4", "--scan-steps", "2"],
     dict(batch=4, hw=(256, 832), precision="bfloat16", scan_steps=2, infer=False)),
    (["--hw", "384", "832", "--scan-steps", "0"],
     dict(batch=8, hw=(384, 832), precision="bfloat16", scan_steps=0, infer=False)),
    (["--infer", "--hw", "128", "256"],
     dict(batch=8, hw=(128, 256), precision="bfloat16", scan_steps=8, infer=True)),
], ids=["recipe-K8", "recipe-K0-fp32", "batch4-K2", "384x832-K0", "infer"])
def test_main_prints_the_jax_bench_line(monkeypatch, capsys, argv, want):
    """main's arguments reach the bench functions, and its one stdout line is
    bench.py's for the rate they return (the recipe's rate is not run here)."""
    seen = {}
    value = 123.456789

    def fake_train(batch, hw, iters, precision, scan_steps, device):
        seen.update(batch=batch, hw=hw, precision=precision, scan_steps=scan_steps,
                    infer=False, device=device)
        return {"value": value}

    def fake_infer(batch, hw, iters, precision, device):
        seen.update(batch=batch, hw=hw, precision=precision, scan_steps=8, infer=True,
                    device=device)
        return {"value": value}

    monkeypatch.setattr(bench, "bench_train", fake_train)
    monkeypatch.setattr(bench, "bench_infer", fake_infer)
    assert bench.main([*argv, "--device", "cpu"]) == 0
    line = _one_line(capsys)
    assert seen.pop("device") == CPU and seen == want
    assert line == _jax_line(want["batch"], want["hw"], value, want["infer"], want["scan_steps"])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]


@pytest.mark.parametrize("argv", [["--scan-steps", "2"], ["--infer"]], ids=["K2", "infer"])
def test_main_runs_on_the_cpu(capsys, argv):
    """A real run at batch 1, 64x64, --iters 1: 3 windows of 4 dispatches
    after the warm-up, one line, the diagnostics on stderr."""
    assert bench.main(["--device", "cpu", "--batch", "1", "--hw", "64", "64", "--iters", "1",
                       "--fp32", *argv]) == 0
    captured = capsys.readouterr()
    lines = captured.out.splitlines()
    assert len(lines) == 1, captured.out
    line = json.loads(lines[0])
    infer = argv == ["--infer"]
    want = _jax_line(1, (64, 64), line["value"], infer, 0 if infer else 2)
    assert list(line) == list(want) and line["metric"] == want["metric"]
    assert line["unit"] == want["unit"]
    # want's from the rounded rate: the last digit may differ
    assert line["vs_baseline"] == pytest.approx(want["vs_baseline"], abs=0.011)
    assert math.isfinite(line["value"]) and line["value"] > 0
    diag = json.loads(captured.err.strip().splitlines()[-1])
    assert diag["device"] == "cpu" and diag["steps_per_window"] == 4
    assert len(diag["windows"]) == 3 and diag["timed_dispatches"] == 12
    assert 2 <= diag["warmup_dispatches"] == len(diag["warmup_ms"]) <= 30
    assert diag["setup_s"] > 0 and min(diag["warmup_ms"]) > 0
    assert diag["dispatches"] == diag["warmup_dispatches"] + 12
    assert diag["median_step_ms"] == pytest.approx(float(np.median(diag["windows"])))
    if infer:
        assert diag["flow_ok"]
    else:
        assert math.isfinite(diag["loss"])


@pytest.mark.parametrize("argv", [[], ["--device", "cpu"]], ids=["cuda", "cpu"])
def test_validate_needs_the_card(monkeypatch, capsys, tmp_path, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "validate.json"
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--validate", "--validate-out", str(out), *argv])
    assert not out.exists() and capsys.readouterr().out == ""


def test_validate_writes_under_build_by_default():
    parts = bench.VALIDATE_OUT.split("/")
    assert parts[-3:] == ["build", "bench", "validate.json"]
    assert bench.build_arg_parser().parse_args([]).validate_out == bench.VALIDATE_OUT


@pytest.mark.parametrize("argv", [["--no-pallas"], ["--quant-warps"], ["--hw", "100", "832"],
                                  ["--scan-steps", "-1"]],
                         ids=["no-pallas", "quant-warps", "hw", "scan-steps"])
def test_what_the_port_does_not_take_is_refused(capsys, argv):
    with pytest.raises(SystemExit) as e:
        bench.main([*argv, "--device", "cpu"])
    assert e.value.code == 2 and capsys.readouterr().out == ""


def test_the_card_is_asked_for_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--scan-steps", "0"])
