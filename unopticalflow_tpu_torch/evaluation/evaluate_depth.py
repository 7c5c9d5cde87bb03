"""Depth evaluation metrics (the Eigen protocol and its NYU variant).

The port's copy of ``unopticalflow_tpu/evaluation/evaluate_depth.py``:
per-image median scaling, the Eigen crop (KITTI) or the full frame (NYU),
depths clamped to [min, max], and the monodepth error set (abs_rel, sq_rel,
rms, log_rms or log10, a1..a3), in float64 numpy, averaged in float32 as
the JAX package averages them.
"""

from __future__ import annotations

import numpy as np


def compute_errors(gt: np.ndarray, pred: np.ndarray, nyu: bool = False):
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25**2).mean()
    a3 = (thresh < 1.25**3).mean()

    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    log10 = np.mean(np.abs(np.log10(gt) - np.log10(pred)))
    abs_rel = np.mean(np.abs(gt - pred) / gt)
    sq_rel = np.mean(((gt - pred) ** 2) / gt)

    if nyu:
        return abs_rel, sq_rel, rmse, log10, a1, a2, a3
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


def process_depth(gt_depth, pred_depth, min_depth, max_depth):
    mask = gt_depth > 0
    pred_depth = np.clip(pred_depth, min_depth, max_depth)
    gt_depth = np.clip(gt_depth, min_depth, max_depth)
    return gt_depth, pred_depth, mask


def eval_depth(gt_depths, pred_depths, min_depth=1e-3, max_depth=80, nyu=False):
    """Per-image median-scaled errors averaged over the dataset."""
    n = len(pred_depths)
    acc = np.zeros((n, 7), np.float32)
    for i in range(n):
        gt = np.asarray(gt_depths[i], np.float64)
        pred = np.asarray(pred_depths[i], np.float64)
        mask = np.logical_and(gt > min_depth, gt < max_depth)

        if not nyu:  # Eigen crop (evaluate_depth.py:32-38)
            h, w = gt.shape
            crop = np.array(
                [0.40810811 * h, 0.99189189 * h, 0.03594771 * w, 0.96405229 * w]
            ).astype(np.int32)
            crop_mask = np.zeros_like(mask)
            crop_mask[crop[0] : crop[1], crop[2] : crop[3]] = 1
            mask = np.logical_and(mask, crop_mask)

        gt_m = gt[mask]
        pred_m = pred[mask]
        pred_m = pred_m * (np.median(gt_m) / np.median(pred_m))
        gt_m, pred_m, _ = process_depth(gt_m, pred_m, min_depth, max_depth)
        acc[i] = compute_errors(gt_m, pred_m, nyu=nyu)
    return list(acc.mean(axis=0))
