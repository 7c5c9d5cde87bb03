"""The port's probes and evaluation tools against the JAX package's
(``unopticalflow_tpu_torch/benchmarks/`` against the root ``benchmarks/``),
on the CPU at small sizes, the port's kernels in their plain versions
(``tests/test_torch_tools.py`` holds the measuring tools):

- ``loss_landscape_probe``: both sweeps at 32x64, batch 2, against the same
  sweeps through the JAX ``losses``, ``avg_pool_pyramid`` and
  ``bilinear_warp``, op by op as the JAX script runs (rtol 1e-5, float32);
- ``fg_probe``: a JAX ``.ckpt`` of random weights, 4 snippets at 64x128:
  the JAX tool's printout within one unit of its last printed decimal;
- ``synth_epe_summarize``: the JAX summariser's JSON from the same logs;
- ``real_kitti_eval``: the JAX runbook smoke's trees (tests/test_eval.py),
  the JAX ``run_eval``'s metrics within test_torch_eval.py's 1e-4.
"""

import contextlib
import io
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from unopticalflow_tpu_torch.benchmarks import (
    fg_probe,
    loss_landscape_probe,
    real_kitti_eval,
    synth_epe_summarize,
    synthetic_epe,
)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the suite runs in several workers on one machine's cores, where torch's
    # spinning thread pools (one thread a core in every worker) made the model
    # runs here up to ~70 times slower than alone (a 7 s test took 504 s)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- loss_landscape_probe -----------------------------------------------------------

def _jax_sweep(stacked, gt, h, b):
    """The JAX script's ``loss_at`` sweeps (it computes at import, so the
    test computes them itself through the same JAX functions)."""
    import jax.numpy as jnp

    from unopticalflow_tpu.models import losses
    from unopticalflow_tpu.ops.pyramid import avg_pool_pyramid
    from unopticalflow_tpu.ops.warp import bilinear_warp

    stacked, gt = jnp.asarray(stacked), jnp.asarray(gt)
    imgl, img, imgr = stacked[:, :h], stacked[:, h:2 * h], stacked[:, 2 * h:]
    ns = 3

    def terms(flow_fwd):
        pyr_c = avg_pool_pyramid(img, ns)
        pyr_lr = avg_pool_pyramid(jnp.concatenate([imgl, imgr], 0), ns)
        flows = []
        for s in range(ns):
            f_s = flow_fwd[:, ::2**s, ::2**s] / (2**s)
            flows.append(jnp.concatenate([-f_s, f_s], 0))
        warped = [bilinear_warp(i, f, use_mask=True) for i, f in zip(pyr_lr, flows)]
        diffs, weights = losses.diff_and_occlusion_weights_packed(warped, pyr_c, ns,
                                                                  use_weights=True)
        pyr_cc = [jnp.concatenate([p, p], 0) for p in pyr_c]
        lp = losses.masked_diff_loss(diffs, weights, ns)
        lss = losses.masked_ssim_loss(pyr_cc, warped, weights, ns)
        lsm = losses.flow_smooth_loss(flows, pyr_c, ns)
        return jnp.mean(lp[:b] + lp[b:]), jnp.mean(lss[:b] + lss[b:]), jnp.mean(lsm[:b] + lsm[b:])

    def loss_at(flow_fwd):
        # op by op, as the script runs (a jit's fused sums round otherwise)
        out = dict(zip(("pixel", "ssim", "smooth"), map(float, terms(flow_fwd))))
        out["total"] = 0.15 * out["pixel"] + 0.85 * out["ssim"] + 10.0 * out["smooth"]
        return out

    return ([loss_at(a * gt) for a in loss_landscape_probe.ALPHAS],
            [loss_at(jnp.ones_like(gt) * jnp.asarray([c, 0.0]))
             for c in loss_landscape_probe.CONSTANTS])


def test_loss_landscape_matches_the_jax_sweeps():
    h, w, b, seed = 32, 64, 2, 5
    with contextlib.redirect_stdout(io.StringIO()):
        got = loss_landscape_probe.run((h, w), b, seed, "cpu")
    stacked, gt, _ = synthetic_epe.make_batch(np.random.RandomState(seed), b, h, w,
                                              **loss_landscape_probe.GEN_KW)
    want_alpha, want_const = _jax_sweep(stacked, gt, h, b)
    assert [r["a"] for r in got["alpha"]] == list(loss_landscape_probe.ALPHAS)
    assert [r["c"] for r in got["constant"]] == list(loss_landscape_probe.CONSTANTS)
    for g, wnt in zip(got["alpha"] + got["constant"], want_alpha + want_const):
        for key in ("pixel", "ssim", "smooth", "total"):
            np.testing.assert_allclose(g[key], wnt[key], rtol=1e-5, atol=1e-7, err_msg=key)
    # the objective is least at the true flow on this texture
    totals = [r["total"] for r in got["alpha"]]
    assert int(np.argmin(totals)) == loss_landscape_probe.ALPHAS.index(1.0)


# ---- fg_probe ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX ``.ckpt`` of random "pwc" weights."""
    import jax

    from unopticalflow_tpu.models import init_flow_model
    from unopticalflow_tpu.utils.checkpoint import save_checkpoint

    path = str(tmp_path_factory.mktemp("ckpt") / "random.ckpt")
    save_checkpoint(path, 0, init_flow_model(jax.random.PRNGKey(0), scheme="pwc"))
    return path


def _within_last_decimal(got, want, key=""):
    """Equal to one unit of the last decimal the JAX tool prints (2 or 3)."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), key
        for k in want:
            _within_last_decimal(got[k], want[k], f"{key}.{k}")
    elif isinstance(want, float):
        places = len(repr(want).split(".")[1]) if "." in repr(want) else 0
        assert abs(got - want) <= 10.0 ** -min(places, 3) + 1e-9, (key, got, want)
    else:
        assert got == want, key


def test_fg_probe_matches_the_jax_probe(jax_ckpt, monkeypatch):
    import benchmarks.fg_probe as jax_fg_probe

    argv = ["--ckpt", jax_ckpt, "--hw", "64", "128", "--snippets", "4", "--batch", "4"]
    monkeypatch.setattr(sys, "argv", ["fg_probe", *argv])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        jax_fg_probe.main()  # its generator on cv2's path, within 2.4e-7 of the numpy one
    want = json.loads(out.getvalue())
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert fg_probe.main([*argv, "--device", "cpu"]) == 0
    got = json.loads(out.getvalue())
    assert got["snippets"] == want["snippets"] > 0
    _within_last_decimal(got, want)


# ---- synth_epe_summarize -------------------------------------------------------------

def _log(path, zero_flow, points, final):
    lines = [json.dumps({"zero_flow": zero_flow})]
    for i, p in enumerate(points):
        lines.append(f"iter {p['iter']}: total {1.0 - 0.1 * i:.4f} pixel 0.3000 ssim 0.5000 (1s)")
        lines.append(json.dumps(p))
    lines.append(json.dumps(final))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_synth_epe_summarize_writes_the_jax_json(tmp_path, monkeypatch):
    import benchmarks.synth_epe_summarize as jax_summarize

    def point(it, e):
        return {"iter": it, "epe_all": e, "epe_nonoccluded": e - 0.1, "epe_occluded": e + 1.0,
                "epe_fg": e + 2.0, "epe_bg": e - 0.2, "outlier_rate_kitti": e / 100}

    def final(iters, e, max_bg):
        return {"benchmark": "synthetic piecewise-motion EPE (occlusion-aware)",
                "iters": iters, "max_bg": max_bg, "max_fg": 2 * max_bg,
                **{k: v for k, v in point(iters, e).items() if k != "iter"},
                "zero_flow": {"epe_all": 3.0 + max_bg}}

    runs = {
        "main": _log(tmp_path / "main.log", {"epe_all": 7.21},
                     [point(0, 5.0), point(500, 3.0), point(1000, 2.0)], final(1000, 1.9, 8)),
        "nomask": _log(tmp_path / "nomask.log", {"epe_all": 7.21},
                       [point(0, 5.1), point(500, 3.5)], final(500, 3.4, 8)),
        "fp32": _log(tmp_path / "fp32.log", {"epe_all": 3.56}, [point(0, 4.0)],
                     final(1000, 2.1, 4)),
    }
    specs = [f"{k}={v}" for k, v in runs.items()]
    monkeypatch.chdir(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()):
        assert synth_epe_summarize.main([*sum((["--run", s] for s in specs), []),
                                         "--out-dir", "port", "--name", "S"]) == 0
    got = json.loads((tmp_path / "port" / "S.json").read_text())
    pytest.importorskip("matplotlib")  # the JAX summariser draws its curve after the JSON
    monkeypatch.setattr(sys, "argv", ["s", *sum((["--run", s] for s in specs), []),
                                      "--out-dir", "jax", "--name", "S"])
    with contextlib.redirect_stdout(io.StringIO()):
        jax_summarize.main()
    assert got == json.loads((tmp_path / "jax" / "S.json").read_text())
    # every run carries its own zero-flow bar
    assert {k: r["zero_flow_measured"]["epe_all"] for k, r in got["runs"].items()} == {
        "main": 7.21, "nomask": 7.21, "fp32": 3.56}
    assert got["bf16_vs_f32"]["compared_at_iter"] == 1000
    assert got["ablation_occlusion_masks"]["compared_at_iter"] == 500


# ---- real_kitti_eval ----------------------------------------------------------------

def _kitti_tree(root, with_obj_map, rng, n=2, gh=40, gw=72):
    """tests/test_eval.py's runbook-smoke tree."""
    import cv2

    from unopticalflow_tpu.evaluation.flowlib import write_flow_png

    for sub in ("image_2", "flow_occ", "flow_noc") + (("obj_map",) if with_obj_map else ()):
        os.makedirs(os.path.join(root, sub))
    for i in range(n):
        for suffix in ("_10", "_11"):
            cv2.imwrite(os.path.join(root, "image_2", f"{i:06d}{suffix}.png"),
                        rng.randint(0, 255, (gh, gw, 3), dtype=np.uint8))
        gt = np.zeros((gh, gw, 3), np.float64)
        gt[:, :, :2] = np.round(rng.uniform(-4, 4, (gh, gw, 2)) * 64) / 64
        gt[:, :, 2] = (rng.rand(gh, gw) > 0.2).astype(np.float64)
        write_flow_png(gt, os.path.join(root, "flow_occ", f"{i:06d}_10.png"))
        noc = gt.copy()
        noc[:, :, 2] *= (rng.rand(gh, gw) > 0.3).astype(np.float64)
        write_flow_png(noc, os.path.join(root, "flow_noc", f"{i:06d}_10.png"))
        if with_obj_map:
            cv2.imwrite(os.path.join(root, "obj_map", f"{i:06d}_10.png"),
                        (rng.rand(gh, gw) > 0.5).astype(np.uint16))


def test_real_kitti_eval_matches_the_jax_runbook(tmp_path, jax_ckpt, capsys):
    sys.path.insert(0, str(REPO / "benchmarks"))
    try:
        import real_kitti_eval as jax_real_kitti_eval
    finally:
        sys.path.pop(0)
    rng = np.random.RandomState(5)
    d2012, d2015 = str(tmp_path / "2012" / "training"), str(tmp_path / "2015" / "training")
    _kitti_tree(d2012, False, rng)
    _kitti_tree(d2015, True, rng)
    want = jax_real_kitti_eval.run_eval(jax_ckpt, d2012, d2015, img_hw=(64, 128), limit=2)
    capsys.readouterr()
    got = real_kitti_eval.main(["--pretrained_model", jax_ckpt, "--gt_2012_dir", d2012,
                                "--gt_2015_dir", d2015, "--img_hw", "64", "128", "--limit", "2",
                                "--out_json", str(tmp_path / "m.json"), "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"kitti_2012": got["kitti_2012"]["epe"], "kitti_2015": got["kitti_2015"]["epe"],
                    "reference_targets": {"kitti_2012": 2.67, "kitti_2015": 7.1}}
    assert json.loads((tmp_path / "m.json").read_text()) == got
    assert "epe_move" in got["kitti_2015"]  # 2015 with its moving masks: 8 columns
    for key in ("kitti_2012", "kitti_2015"):
        assert got[key].keys() == want[key].keys()
        for k, v in want[key].items():
            assert np.isfinite(got[key][k])
            np.testing.assert_allclose(got[key][k], v, rtol=0, atol=1e-4 + 1e-9, err_msg=k)


def test_real_kitti_eval_refuses_pallas_corr(capsys):
    with pytest.raises(SystemExit):
        real_kitti_eval.main(["--gt_2015_dir", "x", "--pallas_corr", "on", "--device", "cpu"])
    assert "--pallas_corr is the JAX tool's TPU A/B switch" in capsys.readouterr().err
