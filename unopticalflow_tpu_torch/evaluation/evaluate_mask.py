"""Moving-object mask metrics and their evaluation.

The port's copy of ``unopticalflow_tpu/evaluation/evaluate_mask.py``: the
py_img_seg_eval metrics (pixel accuracy, mean accuracy, mean IU,
frequency-weighted IU) over per-class counts, and ``eval_mask``, which
resizes each predicted mask to its ground truth (``utils/imageio.py``'s
``resize``, as ``cv2.resize``), binarises it at 0.5, writes its two PNGs as
the JAX package's ``cv2.imwrite`` writes them, and averages the metrics.
``load_gt_mask`` (KITTI 2015's ``obj_map``) is ``evaluate_flow``'s.
"""

from __future__ import annotations

import os

import numpy as np

from unopticalflow_tpu_torch.evaluation.evaluate_flow import load_gt_mask  # noqa: F401
from unopticalflow_tpu_torch.utils import imageio

# matplotlib's "Greys" at 0 and at 1 (RGBA): a binarised mask takes no other value
_GREYS_ENDS = np.array([[1.0, 1.0, 1.0, 1.0], [0.0, 0.0, 0.0, 1.0]])


class EvalSegErr(Exception):
    pass


def _check_size(a, b):
    if a.shape[:2] != b.shape[:2]:
        raise EvalSegErr("DiffDim: Different dimensions of matrices!")


def _class_stats(eval_segm, gt_segm, classes):
    """Per-class (n_ii, t_i, n_ij): intersection, gt count, pred count."""
    stats = []
    for c in classes:
        e = eval_segm == c
        g = gt_segm == c
        stats.append((np.logical_and(e, g).sum(), g.sum(), e.sum()))
    return stats


def pixel_accuracy(eval_segm, gt_segm) -> float:
    _check_size(eval_segm, gt_segm)
    stats = _class_stats(eval_segm, gt_segm, np.unique(gt_segm))
    sum_nii = sum(s[0] for s in stats)
    sum_ti = sum(s[1] for s in stats)
    return 0 if sum_ti == 0 else sum_nii / sum_ti


def mean_accuracy(eval_segm, gt_segm) -> float:
    _check_size(eval_segm, gt_segm)
    stats = _class_stats(eval_segm, gt_segm, np.unique(gt_segm))
    return float(np.mean([nii / ti if ti != 0 else 0 for nii, ti, _ in stats]))


def mean_IU(eval_segm, gt_segm):
    _check_size(eval_segm, gt_segm)
    classes = np.union1d(np.unique(eval_segm), np.unique(gt_segm))
    n_cl_gt = len(np.unique(gt_segm))
    iu = [0.0 if (nij == 0 or ti == 0) else nii / (ti + nij - nii)
          for nii, ti, nij in _class_stats(eval_segm, gt_segm, classes)]
    return float(np.sum(iu) / n_cl_gt), np.array(iu)


def frequency_weighted_IU(eval_segm, gt_segm) -> float:
    _check_size(eval_segm, gt_segm)
    classes = np.union1d(np.unique(eval_segm), np.unique(gt_segm))
    total = 0.0
    for nii, ti, nij in _class_stats(eval_segm, gt_segm, classes):
        if nij == 0 or ti == 0:
            continue
        total += (ti * nii) / (ti + nij - nii)
    return total / (eval_segm.shape[0] * eval_segm.shape[1])


def eval_mask(pred_masks, gt_masks, opt):
    """Average the four metrics over the dataset.

    ``pred_masks``: uint8 or float32 masks at any size; ``opt.trace``: the
    directory under which ``pred_mask/<i>_10.png`` (the binarised mask, 0
    or 1) and ``<i>_10_plot.png`` (its "Greys" RGBA, each value rounded to
    0 or 1 and read as BGRA, as cv2 writes a float image) are written.
    Returns (pixel acc., mean acc., mean IU, frequency-weighted IU, per-class IU).
    """
    out_dir = os.path.join(opt.trace, "pred_mask")
    os.makedirs(out_dir, exist_ok=True)

    pa = ma = miu = fwiu = 0.0
    iu = np.array([0.0, 0.0])
    num_total = len(gt_masks)
    for i in range(num_total):
        gt = gt_masks[i]
        h, w = gt.shape[:2]
        pred = imageio.resize(np.asarray(pred_masks[i]), (w, h))
        pred = (pred >= 0.5).astype(np.float64)

        plot = _GREYS_ENDS[pred.astype(np.int64)]
        imageio.imwrite(os.path.join(out_dir, f"{i:06d}_10_plot.png"), imageio.saturate_u8(plot))
        imageio.imwrite(os.path.join(out_dir, f"{i:06d}_10.png"), imageio.saturate_u8(pred))

        pa += pixel_accuracy(pred, gt)
        ma += mean_accuracy(pred, gt)
        m, u = mean_IU(pred, gt)
        miu += m
        iu = iu + u
        fwiu += frequency_weighted_IU(pred, gt)

    n = float(num_total)
    return pa / n, ma / n, miu / n, fwiu / n, iu / n
