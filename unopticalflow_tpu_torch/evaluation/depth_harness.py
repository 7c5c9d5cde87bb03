"""Depth-evaluation harnesses: the Eigen split, NYUv2, and a single image.

The port's copy of ``unopticalflow_tpu/evaluation/depth_harness.py``: the
same protocols (the Eigen file walk and ``gt_depths.npz``, NYU's labeled-set
crop, disparity to depth by resizing and inverting, median-scaled metrics
through ``evaluate_depth.py``) for any depth-predicting callable

    infer_disp(images: (B, H, W, 3) float32 in [0, 1]) -> (B, H, W[, 1]) disparity

which may return a numpy array or a torch tensor on any device (it is
brought to the host).  Frames are read and resized by ``utils/imageio.py``
(PNG or JPEG; uint8 frames as cv2 resizes them, float32 crops and
disparities within 2 float32 ulps of cv2), and the labeled set
``nyu_depth_v2_labeled.mat`` by ``utils/hdf5.py``, reading the test frames
only: no cv2 and no h5py.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from unopticalflow_tpu_torch.evaluation.evaluate_depth import eval_depth
from unopticalflow_tpu_torch.utils import hdf5, imageio

_METRIC_HEADER = "{:>10}, {:>10}, {:>10}, {:>10}, {:>10}, {:>10}, {:>10} \n"
_METRIC_ROW = "{:10.4f}, {:10.4f}, {:10.3f}, {:10.3f}, {:10.3f}, {:10.3f}, {:10.3f} \n"


def _host(x) -> np.ndarray:
    """A prediction (numpy, or a torch tensor on any device) as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x)


def _as_disp_hw(disp) -> np.ndarray:
    """(H, W[, 1]) prediction -> (H, W) float32."""
    d = np.asarray(_host(disp), np.float32)
    if d.ndim == 3:
        d = d[..., 0]
    return d


def resize_depths(gt_depth_list, pred_disp_list):
    """Each predicted disparity resized to its ground truth's frame and
    inverted: depth = 1 / (disp + 1e-4)."""
    pred_depth_list, pred_disp_resized = [], []
    for gt, disp in zip(gt_depth_list, pred_disp_list):
        h, w = gt.shape[:2]
        d = imageio.resize(_as_disp_hw(disp), (w, h))
        pred_depth_list.append(1.0 / (d + 1e-4))
        pred_disp_resized.append(d)
    return pred_depth_list, pred_disp_resized


def resize_disp(pred_disp_list, gt_depths):
    """NYU's variant: every disparity to the first frame's size, depth =
    1 / (disp + 1e-6)."""
    h, w = gt_depths[0].shape[:2]
    return [1.0 / (imageio.resize(_as_disp_hw(d), (w, h)) + 1e-6) for d in pred_disp_list]


def _print_metrics(res, nyu: bool = False, file=None) -> None:
    f = file or sys.stderr
    abs_rel, sq_rel, rms, log_rms, a1, a2, a3 = res
    f.write(_METRIC_HEADER.format("abs_rel", "sq_rel", "rms", "log10" if nyu else "log_rms",
                                  "a1", "a2", "a3"))
    f.write(_METRIC_ROW.format(abs_rel, sq_rel, rms, log_rms, a1, a2, a3))


def _read(path: str) -> np.ndarray:
    img = imageio.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img


def test_eigen_depth(cfg, infer_disp, eigen_dir: str = "data/eigen", file=None):
    """Eigen-split KITTI depth evaluation.

    ``cfg`` has ``raw_base_dir`` (the KITTI raw root) and ``img_hw``;
    ``eigen_dir`` holds ``test_files.txt`` and ``gt_depths.npz``.  Returns
    (abs_rel, sq_rel, rms, log_rms, a1, a2, a3).
    """
    with open(os.path.join(eigen_dir, "test_files.txt")) as f:
        filenames = f.readlines()
    h, w = int(cfg.img_hw[0]), int(cfg.img_hw[1])
    pred_disp_list = []
    for line in filenames:
        path1, idx = line.strip().split(" ")[:2]
        img = _read(os.path.join(cfg.raw_base_dir, path1, "image_02", "data", f"{idx}.png"))
        inp = imageio.resize(img, (w, h)).astype(np.float32)[None] / 255.0
        pred_disp_list.append(_as_disp_hw(_host(infer_disp(inp))[0]))

    gt_depths = np.load(os.path.join(eigen_dir, "gt_depths.npz"), allow_pickle=True)["data"]
    pred_depths, _ = resize_depths(gt_depths, pred_disp_list)
    res = eval_depth(gt_depths, pred_depths)
    _print_metrics(res, nyu=False, file=file)
    return res


def load_nyu_test_data(data_dir: str):
    """NYUv2's official test split from the labeled set.

    Reads only the test frames of ``nyu_depth_v2_labeled.mat``; returns
    (images (N, 3, H, W) uint8, depths (N, H, W) float32).
    """
    import scipy.io as sio

    splits = sio.loadmat(os.path.join(data_dir, "splits.mat"))
    test = np.array(splits["testNdxs"]).squeeze(1)
    with hdf5.File(os.path.join(data_dir, "nyu_depth_v2_labeled.mat")) as data:
        images = np.transpose(data["images"][test - 1], [0, 1, 3, 2])
        depths = np.transpose(data["depths"][test - 1], [0, 2, 1])
    return images, depths


def test_nyu(cfg, infer_disp, test_images, test_gt_depths, file=None):
    """NYUv2 depth evaluation with the reference crop.

    ``test_images``: (N, 3, H, W) uint8, as ``load_nyu_test_data`` returns
    them; ``test_gt_depths``: (N, H, W) metric depths.
    """
    h, w = int(cfg.img_hw[0]), int(cfg.img_hw[1])
    pred_disp_list, crop_gt_depths = [], []
    for img, gt in zip(test_images, test_gt_depths):
        img_crop = np.transpose(img[:, 45:472, 41:602], [1, 2, 0])
        crop_gt_depths.append(np.asarray(gt)[45:472, 41:602])
        inp = imageio.resize(img_crop.astype(np.float32), (w, h))[None] / 255.0
        pred_disp_list.append(_as_disp_hw(_host(infer_disp(inp))[0]))

    pred_depths = resize_disp(pred_disp_list, crop_gt_depths)
    res = eval_depth(crop_gt_depths, pred_depths, nyu=True)
    _print_metrics(res, nyu=True, file=file)
    return res


def test_single_image(img_path, infer_disp, training_hw, save_dir="./"):
    """The single-image depth demo: predict, resize back, and save the
    magma-coloured disparity as ``<save_dir>/demo_depth.jpg``.  Returns
    (disparity, depth) at the image's size."""
    from unopticalflow_tpu_torch.utils.visualizer import VisualizerDebug

    img = _read(img_path)
    h, w = img.shape[:2]
    inp = imageio.resize(img, (int(training_hw[1]), int(training_hw[0])))
    disp = _as_disp_hw(_host(infer_disp(inp.astype(np.float32)[None] / 255.0))[0])
    disp_resized = imageio.resize(disp, (w, h))
    depth = 1.0 / (1e-6 + disp_resized)
    VisualizerDebug(dump_dir=save_dir).save_disp_color_img(disp_resized, name="demo")
    print("Depth prediction saved in " + save_dir)
    return disp_resized, depth
