"""The port's evaluation path against the JAX package's (CPU).

``eval_flow_avg`` on the same seeded ground truth and predictions gives the
JAX package's header and format, each metric within 1e-4 (the JAX side
resizes with ``cv2.resize``, the port with ``torch.nn.functional.interpolate``:
the same bilinear sampling, float32 sums in another order; the strings round
to 4 decimals, so two values within 1e-7 can print 1e-4 apart).  Then
``_batched_flows``' padding, ``python -m unopticalflow_tpu_torch.test --task
kitti_flow`` on a fake KITTI 2015 tree written with ``write_flow_png``, and
the trainer's interleaved evaluation.
"""

import os
import pickle
import types

import cv2
import numpy as np
import pytest
import torch

from unopticalflow_tpu.evaluation import eval_flow_avg as jax_eval_flow_avg
from unopticalflow_tpu_torch import test as port_test
from unopticalflow_tpu_torch import train as train_mod
from unopticalflow_tpu_torch.data.synthetic import SyntheticSnippets
from unopticalflow_tpu_torch.evaluation import eval_flow_avg, load_gt_flow_kitti, load_gt_mask
from unopticalflow_tpu_torch.evaluation.evaluate_flow import resize_flow
from unopticalflow_tpu_torch.evaluation.flowlib import read_flow_png, write_flow_png
from unopticalflow_tpu_torch.models import FlowModel
from unopticalflow_tpu_torch.test import EvalSet
from unopticalflow_tpu_torch.train import recipe_config, train
from unopticalflow_tpu_torch.training import make_optimizer
from unopticalflow_tpu_torch.utils.checkpoint import save_checkpoint


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the suite runs in several workers on one machine's cores, where torch's
    # spinning thread pools (one thread a core in every worker) made the model
    # runs here up to ~70 times slower than alone (a 7 s test took 504 s)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


IMG_HW = (32, 64)


_Cfg = types.SimpleNamespace(img_hw=IMG_HW)


def _gt_set(n, h, w, seed):
    """Seeded KITTI-like ground truth: [u, v, valid] (1/64 px steps), noc and
    moving masks."""
    rng = np.random.RandomState(seed)
    gts, nocs, movs = [], [], []
    for _ in range(n):
        gt = np.zeros((h, w, 3), np.float64)
        gt[:, :, :2] = np.round(rng.uniform(-8, 8, (h, w, 2)) * 64) / 64
        gt[:, :, 2] = rng.rand(h, w) > 0.2
        gts.append(gt)
        nocs.append(gt[:, :, 2] * (rng.rand(h, w) > 0.3))
        movs.append((rng.rand(h, w) > 0.6).astype(np.uint16))
    return gts, nocs, movs


def _values(res):
    header, values = res.split("\n")[:2]
    return header, np.array([float(v) for v in values.split(",")])


@pytest.mark.parametrize("gt_hw", [(45, 100), (20, 40)])
@pytest.mark.parametrize("moving", [True, False])
def test_eval_flow_avg_matches_jax(gt_hw, moving):
    gts, nocs, movs = _gt_set(3, *gt_hw, seed=1)
    rng = np.random.RandomState(2)
    preds = [rng.uniform(-6, 6, IMG_HW + (2,)).astype(np.float32) for _ in range(3)]
    masks = movs if moving else None
    want = jax_eval_flow_avg(gts, nocs, preds, _Cfg, moving_masks=masks)
    for given in (preds, [torch.from_numpy(p) for p in preds]):  # numpy or tensors
        got = eval_flow_avg(gts, nocs, given, _Cfg, moving_masks=masks)
        (gh, gv), (wh, wv) = _values(got), _values(want)
        assert gh == wh and len(gv) == (8 if moving else 4)
        assert got.count("\n") == want.count("\n") and np.isfinite(gv).all()
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-4 + 1e-9)


@pytest.mark.parametrize("gt_hw", [(45, 100), (20, 40), (32, 64)])
def test_resize_matches_cv2(gt_hw):
    """Within 1e-4 px on flows of up to 19 px: both sample at
    (dst + 0.5) * scale - 0.5, but cv2 and torch compute the float32
    coordinates (and so the bilinear weights) in another order, which moves
    the values by up to ~2e-5."""
    h, w = gt_hw
    pred = np.random.RandomState(3).uniform(-6, 6, IMG_HW + (2,)).astype(np.float32)
    scaled = pred.copy()
    scaled[:, :, 0] = scaled[:, :, 0] / IMG_HW[1] * w
    scaled[:, :, 1] = scaled[:, :, 1] / IMG_HW[0] * h
    want = cv2.resize(scaled, (w, h), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(resize_flow(pred, IMG_HW, h, w), want, rtol=0, atol=1e-4)


def test_batched_flows_pads_the_last_chunk():
    calls = []

    def infer(img1, img2):
        calls.append((tuple(img1.shape), img1[:, 0, 0, 0].tolist(), img2[:, 0, 0, 0].tolist()))
        return torch.cat([img1[..., :1], img2[..., :1]], -1)

    stacks = [np.concatenate([np.full((4, 5, 3), k), np.full((4, 5, 3), 100 + k)], 0)
              for k in range(11)]
    flows = port_test._batched_flows(infer, iter(stacks), 11, torch.device("cpu"), batch=8)
    assert [c[0] for c in calls] == [(8, 4, 5, 3)] * 2
    assert calls[1][1] == [8, 9, 10, 10, 10, 10, 10, 10]
    assert calls[1][2] == [108, 109, 110, 110, 110, 110, 110, 110]
    assert len(flows) == 11
    assert [f.shape for f in flows] == [(4, 5, 2)] * 11
    assert [(float(f[0, 0, 0]), float(f[0, 0, 1])) for f in flows] == [
        (k, 100 + k) for k in range(11)]


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    """Fake KITTI 2012 (194 pairs) and 2015 (200, with obj_map) trees."""
    root = tmp_path_factory.mktemp("kitti")
    rng = np.random.RandomState(5)
    gh, gw = 20, 36
    dirs = {}
    for name, n, with_obj in (("2012", 194, False), ("2015", 200, True)):
        d = root / f"kitti_{name}" / "training"
        for sub in ("image_2", "flow_occ", "flow_noc") + (("obj_map",) if with_obj else ()):
            (d / sub).mkdir(parents=True)
        for i in range(n):
            for suffix in ("_10", "_11"):
                cv2.imwrite(str(d / "image_2" / f"{i:06d}{suffix}.png"),
                            rng.randint(0, 255, (gh, gw, 3), dtype=np.uint8))
            gt = np.zeros((gh, gw, 3), np.float64)
            gt[:, :, :2] = np.round(rng.uniform(-4, 4, (gh, gw, 2)) * 64) / 64
            gt[:, :, 2] = rng.rand(gh, gw) > 0.2
            write_flow_png(gt, str(d / "flow_occ" / f"{i:06d}_10.png"))
            gt[:, :, 2] *= rng.rand(gh, gw) > 0.3
            write_flow_png(gt, str(d / "flow_noc" / f"{i:06d}_10.png"))
            if with_obj:
                cv2.imwrite(str(d / "obj_map" / f"{i:06d}_10.png"),
                            (rng.rand(gh, gw) > 0.5).astype(np.uint16))
        dirs[name] = str(d)
    return dirs


def test_kitti_2015_end_to_end(kitti_tree, tmp_path, monkeypatch):
    """``python -m unopticalflow_tpu_torch.test --task kitti_flow`` on the
    fake tree: the 8-column table, finite, and the JAX package's metrics on
    the flows it computed, whose first batch is the saved model's."""
    model = FlowModel(device="cpu", scheme="pwc", generator=torch.Generator().manual_seed(0))
    pth = str(tmp_path / "m.pth")
    save_checkpoint([pth], 7, model, make_optimizer(model))
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(f"img_hw: [64, 64]\nnum_scales: 3\ngt_2015_dir: {kitti_tree['2015']}\n"
                        f"gt_2012_dir: {kitti_tree['2012']}\n")
    argv = ["-c", str(cfg_path), "--mode", "flow", "--task", "kitti_flow",
            "--pretrained_model", pth, "--device", "cpu"]
    computed = []  # the flows test.main evaluates, kept rather than computed twice
    batched_flows = port_test._batched_flows

    def keep(*args, **kwargs):
        computed.append(batched_flows(*args, **kwargs))
        return computed[-1]

    monkeypatch.setattr(port_test, "_batched_flows", keep)
    res = port_test.main(argv)
    monkeypatch.undo()
    header, values = _values(res)
    assert header.split(",")[3].strip() == "epe_move" and len(values) == 8
    assert np.isfinite(values).all() and values[0] > 0

    gts, nocs = load_gt_flow_kitti(kitti_tree["2015"], "kitti_2015")
    masks = load_gt_mask(kitti_tree["2015"])
    assert len(gts) == len(nocs) == len(masks) == 200
    np.testing.assert_array_equal(
        gts[3], read_flow_png(os.path.join(kitti_tree["2015"], "flow_occ", "000003_10.png")))
    cfg = types.SimpleNamespace(img_hw=(64, 64), gt_2015_dir=kitti_tree["2015"])
    data = port_test.load_kitti_2015(cfg)
    assert len(computed) == 1 and len(computed[0]) == 200
    flows = computed[0]
    first = port_test._batched_flows(port_test.make_infer(model),
                                     (data.pairs[i] for i in range(8)), 8, torch.device("cpu"))
    for f, g in zip(first, flows[:8]):
        torch.testing.assert_close(f, g, rtol=0, atol=0)
    want = jax_eval_flow_avg(gts, nocs, [f.numpy() for f in flows], cfg, moving_masks=masks)
    np.testing.assert_allclose(values, _values(want)[1], rtol=0, atol=1e-4 + 1e-9)

    # kitti_odo runs the pose net: it needs --mode flowposenet (and --seq_dir)
    with pytest.raises(ValueError, match="kitti_odo needs --mode flowposenet"):
        port_test.main(argv[:5] + ["kitti_odo"] + argv[6:])
    with pytest.raises(ValueError, match="kitti_odo needs --seq_dir"):
        port_test.main(argv[:3] + ["flowposenet", "--task", "kitti_odo"] + argv[6:])


def test_train_evaluates_between_steps(tmp_path, monkeypatch, capsys):
    """train() with --test_interval 2 on in-memory evaluation sets: the
    evaluation runs at the top of steps 1 and 3 (after 1 and 3 optimizer
    steps) and logs eval_2012_res / eval_2015_res to log.pkl; the regularizer
    override takes the fused path's plain version on the CPU."""
    hw = (64, 64)
    snippets = SyntheticSnippets(hw, 8, seed=0).snippets
    pairs = [s[:2 * hw[0]].astype(np.float32) / 255.0 for s in snippets[:5]]
    gts, nocs, movs = _gt_set(5, 40, 72, seed=4)
    sets = {"2012": EvalSet(pairs, gts, nocs), "2015": EvalSet(pairs, gts, nocs, movs)}
    steps, evals = [], []
    orig = train_mod.test_kitti_2015

    def spy(*a, **k):
        evals.append(len(steps))
        return orig(*a, **k)

    monkeypatch.setattr(train_mod, "test_kitti_2015", spy)
    cfg = recipe_config(img_hw=hw, batch_size=2, num_iterations=4, test_interval=2,
                        no_test=False, device="cpu", init_scheme="pwc", model_dir=str(tmp_path),
                        num_workers=1, log_interval=1, save_interval=100)
    res = train(cfg, dataset=SyntheticSnippets(hw, 8, seed=1), eval_sets=sets,
                model_overrides={"use_pallas_reg": True},
                on_step=lambda it, m: steps.append({k: float(v) for k, v in m.items()}))
    assert res.step == 4 and evals == [1, 3]
    assert all(np.isfinite(list(m.values())).all() for m in steps)
    with open(tmp_path / "log.pkl", "rb") as f:
        log = pickle.load(f)
    assert len(log) == 2
    for pack in log:
        assert _values(pack["eval_2015_res"])[0].split(",")[3].strip() == "epe_move"
        assert len(_values(pack["eval_2012_res"])[1]) == 4
    out = capsys.readouterr().out
    assert out.count("[EVAL] [KITTI 2012]") == 2 and out.count("[EVAL] [KITTI 2015]") == 2
