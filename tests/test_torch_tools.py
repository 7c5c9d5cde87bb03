"""The port's measuring and learning tools against the JAX package's
(``unopticalflow_tpu_torch/benchmarks/`` against the root ``benchmarks/``),
on the CPU at small sizes, the port's kernels in their plain versions:

- ``synthetic_epe --device-gen`` and ``--pool-device``: 2-iteration runs
  whose final JSON has the JAX harness's keys, and at K = 2 a dispatch
  takes 2 fresh batches (the generator's next two draws; two pool samples);
- ``make_pool``: array-equal to the port's ``synthetic_epe`` pool and to the
  JAX ``make_pool.py``'s file in float32 and uint8 (the JAX generator on its
  numpy path: its cv2 path rounds within 2.4e-7 of it); ``--fg-bias``
  against the port's own pool;
- ``make_prepared_synth``: the tree of the JAX tool (a subprocess, cv2
  blocked for its numpy path) decoded pixel for pixel, the same
  ``train.txt`` and calibration, then the port's trainer 2 steps on it;
- ``loader_bench``: its prepared dir decodes equal to the JAX
  ``build_prepared_dir``'s, and its JSON has the JAX keys and the device
  rate's source;
- ``profile_step`` and ``ablate``: one-trial CPU runs; the ``full``
  variant's loss is ``train_step``'s, each stub has the shape of what it
  replaces, every variant's loss is finite, and the patches are gone after;
- ``probe.py``'s ``trace`` kinds on a recorded table.

``tests/test_torch_tools_eval.py`` holds the probes and the evaluation
tools.
"""

import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from unopticalflow_tpu_torch.benchmarks import (
    ablate,
    loader_bench,
    make_pool,
    make_prepared_synth,
    profile_step,
    synthetic_epe,
)
from unopticalflow_tpu_torch.benchmarks.synth_device_gen import make_device_batch
from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig
from unopticalflow_tpu_torch.utils import imageio

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import benchmarks.synthetic_epe as jax_synth  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the suite runs in several workers on one machine's cores, where torch's
    # spinning thread pools (one thread a core in every worker) made the model
    # runs here up to ~70 times slower than alone (a 7 s test took 504 s)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_main(module, argv, monkeypatch):
    """Run a JAX tool's ``main()`` with ``argv``, its generator on the numpy
    path; returns its stdout."""
    monkeypatch.setattr(jax_synth, "cv2", None)
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        module.main()
    return out.getvalue()


# ---- synthetic_epe --device-gen / --pool-device -------------------------------

# the final JSON's keys of the JAX harness (benchmarks/synthetic_epe.py)
JAX_EPE_KEYS = {"benchmark", "iters", "hw", "precision", "loss_precision", "lr", "lr_schedule",
                "init", "smooth_weight", "w_pixel", "w_ssim", "supervised", "batch",
                "eval_snippets", "max_bg", "max_fg", "tex_power", "occlusion_weights",
                "platform", "epe_all", "epe_nonoccluded", "epe_occluded", "epe_fg", "epe_bg",
                "outlier_rate_kitti", "zero_flow", "pred_probe", "train_seconds"}


@pytest.mark.parametrize("source,k", [("--device-gen", 1), ("--device-gen", 2),
                                      ("--pool-device", 1), ("--pool-device", 2)])
def test_synthetic_epe_device_batches(source, k, monkeypatch, capsys):
    h, w, b = 64, 128, 2
    monkeypatch.setattr(synthetic_epe, "PROBE_SNIPPETS", 4)  # the probe's 64: time only
    seen = []
    multi = synthetic_epe.make_multi_train_step

    def recording(*a, **kw):
        step = multi(*a, **kw)

        def run(batch):
            seen.append(batch.clone())
            return step(batch)
        return run

    monkeypatch.setattr(synthetic_epe, "make_multi_train_step", recording)
    extra = [source] if source == "--device-gen" else ["--pool", "3", source]
    argv = ["--device", "cpu", "--iters", "2", "--batch", str(b), "--hw", str(h), str(w),
            "--eval-snippets", "2", "--steps-per-dispatch", str(k), *extra]
    res = synthetic_epe.run(synthetic_epe.build_arg_parser().parse_args(argv))
    assert JAX_EPE_KEYS <= set(res) and res["platform"] == "cpu"
    assert np.isfinite(res["epe_all"]) and res["steps_per_dispatch"] == k
    assert res["device_gen"] == (source == "--device-gen")
    assert res["pool_device"] == (source == "--pool-device")
    if k == 1:
        return
    assert len(seen) == 1 and seen[0].shape == (2, b, 3 * h, w, 3)
    if source == "--device-gen":  # the generator's next two draws, in order
        gen = torch.Generator().manual_seed(synthetic_epe.DEVICE_GEN_SEED)
        kw = dict(max_bg=4, max_fg=8, tex_power=0.5)
        want = torch.stack([make_device_batch(gen, b, h, w, **kw)[0] for _ in range(2)])
        assert torch.equal(seen[0], want)
    else:  # every snippet a pool member or its mirror, the two batches fresh draws
        pool = synthetic_epe.make_pool_array(np.random.RandomState(0), 3, h, w, "uint8",
                                             dict(max_bg=4, max_fg=8, tex_power=0.5))
        members = [torch.from_numpy(p).float() / 255.0 for p in pool]
        members += [m.flip(1) for m in members]
        for snip in seen[0].reshape(2 * b, 3 * h, w, 3):
            assert any(torch.equal(snip, m) for m in members)
        assert not torch.equal(seen[0][0], seen[0][1]) or len(pool) == 1


def test_synthetic_epe_refuses_pool_device_without_pool_and_device_gen_with_fg_bias():
    parse = synthetic_epe.build_arg_parser().parse_args
    with pytest.raises(SystemExit, match="--pool-device needs --pool"):
        synthetic_epe.run(parse(["--device", "cpu", "--pool-device"]))
    with pytest.raises(SystemExit, match="no --fg-bias"):
        synthetic_epe.run(parse(["--device", "cpu", "--device-gen", "--fg-bias", "0.3"]))


# ---- make_pool ------------------------------------------------------------------

GEN_ARGS = ["--max-bg", "2", "--max-fg", "4", "--tex-power", "1.0"]


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_make_pool_equals_synthetic_epe_pool_and_jax_make_pool(dtype, tmp_path, monkeypatch):
    import benchmarks.make_pool as jax_make_pool

    h, w, n = 64, 128, 3
    port = tmp_path / "port.npy"
    with contextlib.redirect_stdout(io.StringIO()):
        make_pool.main(["--out", str(port), "--n", str(n), "--hw", str(h), str(w),
                        "--dtype", dtype, *GEN_ARGS])
    got = np.load(port)
    args = synthetic_epe.build_arg_parser().parse_args(
        ["--pool", str(n), "--pool-dtype", dtype, "--pool-file", str(tmp_path / "harness.npy"),
         *GEN_ARGS])
    gen_kw = dict(max_bg=2, max_fg=4, tex_power=1.0)
    with contextlib.redirect_stdout(io.StringIO()):
        harness = synthetic_epe._pool(args, np.random.RandomState(0), h, w, gen_kw)
    assert got.dtype == np.dtype(dtype) and got.shape == (n, 3 * h, w, 3)
    np.testing.assert_array_equal(got, harness)
    np.testing.assert_array_equal(got, np.load(tmp_path / "harness.npy"))
    jax_out = tmp_path / "jax.npy"
    _jax_main(jax_make_pool, ["--out", str(jax_out), "--n", str(n), "--hw", str(h), str(w),
                              "--dtype", dtype, *GEN_ARGS], monkeypatch)
    np.testing.assert_array_equal(got, np.load(jax_out))


def test_make_pool_passes_fg_bias_through(tmp_path):
    h, w, n = 64, 128, 2
    with contextlib.redirect_stdout(io.StringIO()):
        make_pool.main(["--out", str(tmp_path / "p.npy"), "--n", str(n), "--hw", str(h), str(w),
                        "--dtype", "uint8", "--fg-bias", "0.4", *GEN_ARGS])
        args = synthetic_epe.build_arg_parser().parse_args(
            ["--pool", str(n), "--pool-dtype", "uint8", "--fg-bias", "0.4", *GEN_ARGS])
        want = synthetic_epe._pool(args, np.random.RandomState(0), h, w,
                                   dict(max_bg=2, max_fg=4, tex_power=1.0, fg_bias=0.4))
        plain = synthetic_epe._pool(args, np.random.RandomState(0), h, w,
                                    dict(max_bg=2, max_fg=4, tex_power=1.0))
    got = np.load(tmp_path / "p.npy")
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, plain)


# ---- make_prepared_synth --------------------------------------------------------

def test_make_prepared_synth_writes_the_jax_tree_and_trains(tmp_path, capsys):
    from unopticalflow_tpu_torch import train as train_mod

    h, w, n = 64, 128, 3
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "prep"
    # the JAX tool as a user runs it, its generator on the numpy path
    code = ("import sys, runpy; sys.modules['cv2'] = None; "
            f"sys.argv = ['make_prepared_synth', '--out', {str(jax_dir)!r}, '--n', '{n}', "
            f"'--hw', '{h}', '{w}']; "
            "runpy.run_path('benchmarks/make_prepared_synth.py', run_name='__main__')")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert make_prepared_synth.main(["--out", str(port_dir), "--n", str(n), "--hw", str(h),
                                     str(w)]) == 0

    def files(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())

    assert files(port_dir) == files(jax_dir) and len(files(port_dir)) == n + 2
    for name in ("train.txt", "2011_09_26/calib_cam_to_cam.txt"):
        assert (port_dir / name).read_text() == (jax_dir / name).read_text()
    for i in range(n):
        rel = f"2011_09_26/drive_0001/{i:010d}.png"
        a, b = imageio.imread(str(port_dir / rel)), imageio.imread(str(jax_dir / rel))
        assert a.shape == (3 * h, w, 3)
        np.testing.assert_array_equal(a, b)

    # the port's trainer, 2 steps from the tree at its own shape
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"prepared_base_dir: '{tmp_path}'\ndataset: 'kitti_depth'\nnum_scales: 3\n"
                   f"num_iterations: 2\nimg_hw: [{h}, {w}]\n")
    capsys.readouterr()
    assert train_mod.main(["-c", str(cfg), "--prepared_save_dir", "prep", "--no_test",
                           "--device", "cpu", "--batch_size", "2", "--num_workers", "1",
                           "--log_interval", "1", "--model_dir", str(tmp_path / "m")]) == 0
    out = capsys.readouterr().out
    assert "A total of 3 image pairs found" in out
    assert out.count("loss_pixel") == 2
    assert (tmp_path / "m" / "flow" / "last.pth").exists()


# ---- loader_bench ---------------------------------------------------------------

JAX_LOADER_KEYS = {"benchmark", "host_cpus", "raw_frame_hw", "batch", "decode_w1_snippets_per_s",
                   "decode_w4_snippets_per_s", "cache_fill_s", "cached_w4_snippets_per_s",
                   "cached_w4_uint8_snippets_per_s", "device_rate_snippets_per_s",
                   "sustains_device_rate", "recipe_note"}


def test_loader_bench_prepared_dir_and_json(tmp_path, monkeypatch):
    sys.path.insert(0, str(REPO / "benchmarks"))
    try:
        import loader_bench as jax_loader_bench
        import synthetic_epe as jax_synth_by_path
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(jax_synth_by_path, "cv2", None)  # its texture on the numpy path
    n = 2
    jax_loader_bench.build_prepared_dir(str(tmp_path / "jax"), n)
    loader_bench.build_prepared_dir(str(tmp_path / "port"), n)
    for name in ("train.txt", "2011_09_26/calib_cam_to_cam.txt"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    for i in range(n):
        rel = f"2011_09_26/drive_0001/{i:010d}.png"
        a = imageio.imread(str(tmp_path / "port" / rel))
        assert a.shape == (3 * loader_bench.RAW_H, loader_bench.RAW_W, 3)
        np.testing.assert_array_equal(a, imageio.imread(str(tmp_path / "jax" / rel)))

    args = loader_bench.build_arg_parser().parse_args(
        ["--device", "cpu", "--device-rate", "100", "--snippets", str(n), "--batch", "2",
         "--batches", "2", "--dir", str(tmp_path / "port")])
    with contextlib.redirect_stdout(io.StringIO()):
        res = loader_bench.run(args)
    assert JAX_LOADER_KEYS <= set(res)
    assert res["device_rate_source"] == "--device-rate"
    assert res["device_rate_snippets_per_s"] == 100.0
    assert all(res[k] > 0 for k in ("decode_w1_snippets_per_s", "decode_w4_snippets_per_s",
                                    "cached_w4_snippets_per_s", "cached_w4_uint8_snippets_per_s"))
    # on the CPU the rate is the caller's: nothing here is the card's
    args.device_rate = None
    with pytest.raises(SystemExit, match="give --device-rate"):
        loader_bench.run(args)


# ---- profile_step and ablate ------------------------------------------------------

def test_profile_step_runs_interleaved_trials():
    args = profile_step.build_arg_parser().parse_args(
        ["--device", "cpu", "--batch", "1", "--hw", "64", "64", "--iters", "1", "--trials", "2",
         "--steps-per-dispatch", "1", "2"])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = profile_step.run(args)
    names = [s["setup"] for s in res["setups"]]
    assert names == ["bfloat16 K=1 reg-off", "bfloat16 K=1 reg-on", "bfloat16 K=2 reg-off",
                     "bfloat16 K=2 reg-on"]
    # per K, reg off and on in turns: A B A B, then the next pair
    trials = [ln.split(":")[0] for ln in out.getvalue().splitlines() if ln.startswith("trial")]
    assert trials == [f"trial {t} {n}" for pair in (names[:2], names[2:]) for t in range(2)
                      for n in pair]
    for s in res["setups"]:
        assert len(s["ms_step"]) == 2 and s["ms_step_median"] > 0 and s["spread"] >= 0
        assert not any(s["launches_per_step"].values())  # the CPU runs the plain versions


def test_ablate_full_variant_is_the_train_step():
    from unopticalflow_tpu_torch.benchmarks import RECIPE_WEIGHTS
    from unopticalflow_tpu_torch.training import make_optimizer, train_step

    cfg = FlowModelConfig(compute_dtype="bfloat16", loss_dtype="bfloat16")
    imgs = torch.from_numpy(np.random.RandomState(0).rand(1, 192, 64, 3).astype(np.float32))
    rec = ablate.run_variant("full", cfg, imgs, k=2, replays=1, eager_steps=1)
    model = FlowModel(cfg, device="cpu", scheme="torch",
                      generator=torch.Generator().manual_seed(0))
    m = train_step(model, make_optimizer(model), imgs, RECIPE_WEIGHTS, cfg)
    assert rec["first_loss"] == float(m["loss_total"])


def test_ablate_stubs_have_the_shapes_of_what_they_replace():
    from unopticalflow_tpu_torch.models import pwc_decoder as pwc
    from unopticalflow_tpu_torch.models.flow_model import forward
    from unopticalflow_tpu_torch.ops.cost_volume import cost_volume
    from unopticalflow_tpu_torch.ops.ssim import ssim
    from unopticalflow_tpu_torch.ops.warp import bilinear_warp

    g = torch.Generator().manual_seed(0)
    feat = torch.randn(2, 32, 8, 16, generator=g).to(torch.bfloat16)
    flow = torch.randn(2, 2, 8, 16, generator=g)
    for a, b in ((ablate.fake_warp(feat, flow), bilinear_warp(feat, flow)),
                 (ablate.fake_corr(None, feat, feat), cost_volume(feat, feat, 4)),
                 (ablate.fake_ssim(feat, feat), ssim(feat, feat))):
        assert a.shape == b.shape and a.dtype == b.dtype
    model = FlowModel(FlowModelConfig(), device="cpu")
    x = torch.randn(1, 34, 16, 16, generator=g)
    for i in range(1, 7):  # the context net: its dilated layers become slices
        layer = getattr(model.pwc_model, f"dc_conv{i}")
        got, want = ablate.skip_dilated(layer, x), pwc.DenseOps.conv(layer, x)
        assert got.shape == want.shape
        assert torch.equal(got, want) == (layer[0].dilation[0] == 1)
        x = want
    imgs = torch.rand(2, 192, 64, 3, generator=g)
    got, want = ablate.flows_only(model, FlowModelConfig(), imgs), forward(model,
                                                                           FlowModelConfig(), imgs)
    assert got.keys() == want.keys()
    assert all(got[k].shape == want[k].shape == (2,) for k in got)


def test_ablate_every_variant_is_finite_and_the_patches_go():
    from unopticalflow_tpu_torch.models import flow_model as fm
    from unopticalflow_tpu_torch.models import losses as ls
    from unopticalflow_tpu_torch.models import pwc_decoder as pwc
    from unopticalflow_tpu_torch.ops import photometric

    def originals():
        return (pwc.bilinear_warp, fm.bilinear_warp, pwc.DenseOps.__dict__["corr"],
                pwc.DenseOps.__dict__["conv"], ls.ssim, photometric.ssim,
                ablate.ts.FORWARDS[("flow", 3)])

    before = originals()
    args = ablate.build_arg_parser().parse_args(
        ["--device", "cpu", "--batch", "1", "--hw", "64", "64", "--steps-per-dispatch", "2",
         "--replays", "1", "--eager-steps", "1"])
    with contextlib.redirect_stdout(io.StringIO()):
        res = ablate.run(args)
    assert [r["variant"] for r in res] == list(ablate.VARIANTS)
    assert all(np.isfinite(r["first_loss"]) and r["ms_step_graph"] > 0 for r in res)
    losses = {r["variant"]: r["first_loss"] for r in res}
    # the stubs change what they replace: the loss moves off full's
    for v in ("no-warp", "no-corr", "no-ssim", "convs-only", "no-context"):
        assert losses[v] != losses["full"], v
    after = originals()
    assert all(a is b for a, b in zip(before, after))
    with pytest.raises(ValueError, match="unknown variant"):
        ablate.patches("no-encoder")


# ---- probe.py trace -----------------------------------------------------------------

def test_trace_kinds_sum_a_recorded_table_per_step():
    import types

    from unopticalflow_tpu_torch.probe import TRACE_KINDS, device_time_by_kind

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def row(key, us, dev=cuda):
        return types.SimpleNamespace(key=key, self_device_time_total=us, device_type=dev)

    rows = [row("void (anonymous namespace)::photo_bwd_kernel<__nv_bfloat16>", 2000),
            row("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>", 1000),
            row("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nchw", 8000),
            row("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast"
                "<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)>>", 600),
            row("Memcpy DtoD (Device -> Device)", 200), row("Memset (Device)", 100),
            row("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>", 300),
            row("void at::native::vectorized_elementwise_kernel<4, at::native::"
                "leaky_relu_kernel>", 1200),
            row("void at::native::reduce_kernel<512, 1>", 400),
            row("void at::native::_scatter_gather_elementwise_kernel<128, 4>", 500),
            row("void at::native::multi_tensor_apply_kernel<FusedAdam>", 700),
            row("aten::convolution", 9000, cpu), row("Command Buffer Full", 50000),
            row("mystery", 100)]
    got = device_time_by_kind(rows, steps=2, kinds=TRACE_KINDS)
    assert got == {"port kernels": 1.0, "transposes/layout": 0.5,
                   "convolution (cuDNN/cuBLAS)": 4.0, "gather/scatter (warps)": 0.25,
                   "optimizer": 0.35, "copies and sets": 0.6,
                   "elementwise/reduction": 0.8, "other": 0.05}
