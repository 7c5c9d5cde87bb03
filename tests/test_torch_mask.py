"""The port's mask evaluation against the JAX package's (CPU): the four
segmentation metrics on seeded label maps, and ``eval_mask`` on seeded
float32 and uint8 predictions, its returned numbers equal and its two PNGs
per mask equal pixel for pixel to the ones the JAX package writes with
cv2."""

import os
import types

import cv2
import numpy as np
import pytest

from unopticalflow_tpu.evaluation import evaluate_mask as jem
from unopticalflow_tpu_torch.evaluation import evaluate_mask, load_gt_mask
from unopticalflow_tpu_torch.evaluation import evaluate_flow

METRICS = ("pixel_accuracy", "mean_accuracy", "mean_IU", "frequency_weighted_IU")


@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize("classes", [2, 5])
def test_metrics_equal_jax(name, classes):
    rng = np.random.RandomState(classes)
    for _ in range(4):
        gt = rng.randint(0, classes, (30, 41)).astype(np.float64)
        pred = np.where(rng.rand(30, 41) < 0.7, gt, rng.randint(0, classes + 1, (30, 41)))
        got = getattr(evaluate_mask, name)(pred, gt)
        want = getattr(jem, name)(pred, gt)
        if name == "mean_IU":
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
        else:
            assert got == want
    with pytest.raises(evaluate_mask.EvalSegErr):
        getattr(evaluate_mask, name)(np.zeros((3, 4)), np.zeros((4, 3)))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_eval_mask_equals_jax(tmp_path, dtype):
    rng = np.random.RandomState(7)
    gts = [(rng.rand(48, 80) > 0.6).astype(np.uint8) for _ in range(3)]
    if dtype == np.uint8:
        preds = [(rng.rand(24, 40) > 0.5).astype(np.uint8) for _ in range(3)]
    else:
        preds = [rng.rand(24, 40).astype(np.float32) for _ in range(3)]
    got = evaluate_mask.eval_mask(preds, gts, types.SimpleNamespace(trace=str(tmp_path / "p")))
    want = jem.eval_mask(preds, gts, types.SimpleNamespace(trace=str(tmp_path / "j")))
    for a, b in zip(got[:4], want[:4]):
        assert a == b
    np.testing.assert_array_equal(got[4], want[4])
    names = sorted(os.listdir(tmp_path / "j" / "pred_mask"))
    assert names == sorted(os.listdir(tmp_path / "p" / "pred_mask")) and len(names) == 6
    for name in names:
        a = cv2.imread(str(tmp_path / "p" / "pred_mask" / name), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(tmp_path / "j" / "pred_mask" / name), cv2.IMREAD_UNCHANGED)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name


def test_load_gt_mask_is_one_copy():
    assert evaluate_mask.load_gt_mask is evaluate_flow.load_gt_mask is load_gt_mask
