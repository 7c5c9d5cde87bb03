"""Flow evaluation: KITTI and Sintel ground truth and the EPE/outlier metrics.

Port of ``unopticalflow_tpu/evaluation/evaluate_flow.py`` (and of
``load_gt_mask`` from ``evaluate_mask.py``): the KITTI calibration readers,
the MPI-Sintel ``.flo`` ground truth with its occlusion PNGs, the KITTI
flow_occ/flow_noc PNGs and the object maps read in a pool of threads (the
PNG reader's zlib and row unfiltering release the interpreter lock), each
prediction vector-rescaled from network to ground-truth resolution and
resized bilinearly, average EPE over valid /
non-occluded / occluded pixels, the KITTI outlier rate (> 3 px and > 5% of
the ground-truth magnitude), the moving/static splits, and the same
formatted result string.

The resize is ``torch.nn.functional.interpolate`` (bilinear,
``align_corners=False``, no antialias: the sampling of ``cv2.resize`` with
``INTER_LINEAR``) on the prediction's device, so the metric path needs no
cv2; the metrics themselves are numpy, in float64 against the float64
ground truth, as in the JAX package.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from unopticalflow_tpu_torch.evaluation.flowlib import read_flow, read_flow_png
from unopticalflow_tpu_torch.utils import imageio

KITTI_NUM_GT = {"kitti_2012": 194, "kitti_2015": 200}


def read_raw_calib_file(filepath: str) -> dict:
    """KITTI calib file -> dict of float arrays (lines that are not numbers skipped)."""
    data = {}
    with open(filepath, "r") as f:
        for line in f.readlines():
            key, value = line.split(":", 1)
            try:
                data[key] = np.array([float(x) for x in value.split()])
            except ValueError:
                pass
    return data


def load_intrinsics_raw(calib_file: str) -> np.ndarray:
    """The 3x3 intrinsics of ``P_rect_02`` (or ``P2``) in a KITTI calib file."""
    filedata = read_raw_calib_file(calib_file)
    p_rect = filedata["P_rect_02"] if "P_rect_02" in filedata else filedata["P2"]
    return np.reshape(p_rect, (3, 4))[:3, :3]


def scale_intrinsics(mat: np.ndarray, sx: float, sy: float) -> np.ndarray:
    out = np.copy(mat)
    out[0, 0] *= sx
    out[0, 2] *= sx
    out[1, 1] *= sy
    out[1, 2] *= sy
    return out


def get_scaled_intrinsic_matrix(calib_file, zoom_x, zoom_y) -> np.ndarray:
    """The intrinsics scaled by (zoom_x, zoom_y), skew and last row's zeros exact."""
    intr = scale_intrinsics(load_intrinsics_raw(calib_file), zoom_x, zoom_y)
    intr[0, 1] = intr[1, 0] = intr[2, 0] = intr[2, 1] = 0.0
    return intr


def _read_flow_gt(dir_gt: str, i: int):
    occ = read_flow_png(os.path.join(dir_gt, "flow_occ", f"{i:06d}_10.png"))
    noc = read_flow_png(os.path.join(dir_gt, "flow_noc", f"{i:06d}_10.png"))
    return occ, noc[:, :, 2]


def load_gt_flow_kitti(gt_dataset_dir: str, mode: str, num_workers: int = 5):
    """KITTI 2012 (194) / 2015 (200) ground-truth flows and noc masks."""
    if mode not in KITTI_NUM_GT:
        raise ValueError(f"Mode {mode} not found.")
    with ThreadPoolExecutor(num_workers) as pool:
        results = list(pool.map(lambda i: _read_flow_gt(gt_dataset_dir, i),
                                range(KITTI_NUM_GT[mode])))
    return [r[0] for r in results], [r[1] for r in results]


def load_gt_mask(gt_dataset_dir: str, num_workers: int = 5):
    """KITTI 2015 moving-object masks (``obj_map``), binarised at > 0."""

    def read(i):
        path = os.path.join(gt_dataset_dir, "obj_map", f"{i:06d}_10.png")
        m = imageio.imread(path, imageio.IMREAD_UNCHANGED)
        if m is None:
            raise FileNotFoundError(path)
        return (m > 0.0).astype(m.dtype)

    with ThreadPoolExecutor(num_workers) as pool:
        return list(pool.map(read, range(KITTI_NUM_GT["kitti_2015"])))


def load_gt_flow_sintel(training_dir: str, pass_name: str = "clean"):
    """Ground truth and image pairs of an MPI-Sintel ``training/`` tree.

    ``flow/<scene>/frame_####.flo`` (frame N -> N+1) pairs with
    ``<pass>/<scene>/frame_####.png`` and the next frame; the occlusion PNG
    ``occlusions/<scene>/frame_####.png``, where there is one, gives the
    non-occluded mask (grey > 127 is occluded), else every pixel counts.

    Returns (gt_flows, noc_masks, image_pairs): (H, W, 3) float32 flows with
    an all-ones validity channel (Sintel's ground truth is dense), (H, W)
    float32 masks and pairs of paths, as ``eval_flow_avg`` takes them.
    """
    flow_root = os.path.join(training_dir, "flow")
    img_root = os.path.join(training_dir, pass_name)
    occ_root = os.path.join(training_dir, "occlusions")
    gt_flows, noc_masks, pairs = [], [], []
    if not os.path.isdir(flow_root) or not os.path.isdir(img_root):
        return gt_flows, noc_masks, pairs
    for scene in sorted(os.listdir(flow_root)):
        scene_dir = os.path.join(flow_root, scene)
        for fname in sorted(os.listdir(scene_dir)):
            if not fname.endswith(".flo"):
                continue
            num = int(fname[:-4].split("_")[-1])
            img1 = os.path.join(img_root, scene, f"frame_{num:04d}.png")
            img2 = os.path.join(img_root, scene, f"frame_{num + 1:04d}.png")
            if not (os.path.exists(img1) and os.path.exists(img2)):
                continue
            gt = read_flow(os.path.join(scene_dir, fname)).astype(np.float32)
            h, w = gt.shape[:2]
            gt_flows.append(np.concatenate([gt[:, :, :2], np.ones((h, w, 1), np.float32)], 2))
            occ = imageio.imread(os.path.join(occ_root, scene, f"frame_{num:04d}.png"),
                                 imageio.IMREAD_GRAYSCALE)
            if occ is None:
                noc_masks.append(np.ones((h, w), np.float32))
            else:
                noc_masks.append(1.0 - (occ > 127).astype(np.float32))
            pairs.append((img1, img2))
    return gt_flows, noc_masks, pairs


def calculate_error_rate(epe_map, gt_flow, mask) -> float:
    """KITTI Fl outlier rate: EPE > 3 px and > 5% of the ground-truth magnitude."""
    bad = np.logical_and(
        epe_map * mask > 3,
        epe_map * mask / np.maximum(np.sqrt(np.sum(np.square(gt_flow), axis=2)), 1e-10) > 0.05,
    )
    return bad.sum() / mask.sum()


def resize_flow(pred, img_hw, h: int, w: int) -> np.ndarray:
    """(H_net, W_net, 2) flow at network resolution -> (h, w, 2) float32 numpy.

    The vectors are rescaled to the new size, then the field is resized
    bilinearly on ``pred``'s device (a numpy array resizes on the CPU).
    """
    pred = torch.as_tensor(pred, dtype=torch.float32)
    u = pred[:, :, 0] / img_hw[1] * w
    v = pred[:, :, 1] / img_hw[0] * h
    x = torch.stack([u, v], 0)[None]
    out = torch.nn.functional.interpolate(x, size=(h, w), mode="bilinear",
                                          align_corners=False, antialias=False)
    return out[0].permute(1, 2, 0).cpu().numpy()


def eval_flow_avg(gt_flows, noc_masks, pred_flows, cfg, moving_masks=None) -> str:
    """Average the per-image KITTI flow metrics; returns the formatted string.

    ``pred_flows``: (H_net, W_net, 2) flows at ``cfg.img_hw``, torch tensors
    (on any device) or numpy arrays.
    """
    error = error_noc = error_occ = error_rate = 0.0
    error_move = error_static = error_move_rate = error_static_rate = 0.0

    num = len(gt_flows)
    for i, (gt_flow, noc_mask, pred_flow) in enumerate(zip(gt_flows, noc_masks, pred_flows)):
        h, w = gt_flow.shape[0:2]
        flo_pred = resize_flow(pred_flow, cfg.img_hw, h, w)
        epe_map = np.sqrt(np.sum(np.square(flo_pred[:, :, 0:2] - gt_flow[:, :, 0:2]), axis=2))
        valid = gt_flow[:, :, 2]
        error += np.sum(epe_map * valid) / np.sum(valid)
        error_noc += np.sum(epe_map * noc_mask) / np.sum(noc_mask)
        error_occ += np.sum(epe_map * (valid - noc_mask)) / max(np.sum(valid - noc_mask), 1.0)
        error_rate += calculate_error_rate(epe_map, gt_flow[:, :, 0:2], valid)

        if moving_masks:
            move_mask = moving_masks[i]
            error_move_rate += calculate_error_rate(epe_map, gt_flow[:, :, 0:2],
                                                    valid * move_mask)
            error_static_rate += calculate_error_rate(epe_map, gt_flow[:, :, 0:2],
                                                      valid * (1.0 - move_mask))
            error_move += np.sum(epe_map * valid * move_mask) / np.sum(valid * move_mask)
            error_static += (np.sum(epe_map * valid * (1.0 - move_mask))
                             / np.sum(valid * (1.0 - move_mask)))

    if moving_masks:
        header = ("{:>10}, " * 7 + "{:>10} \n").format(
            "epe", "epe_noc", "epe_occ", "epe_move", "epe_static",
            "move_err_rate", "static_err_rate", "err_rate",
        )
        return header + ("{:10.4f}, " * 7 + "{:10.4f} \n").format(
            error / num, error_noc / num, error_occ / num, error_move / num,
            error_static / num, error_move_rate / num, error_static_rate / num,
            error_rate / num,
        )
    header = ("{:>10}, " * 3 + "{:>10} \n").format("epe", "epe_noc", "epe_occ", "err_rate")
    return header + ("{:10.4f}, " * 3 + "{:10.4f} \n").format(
        error / num, error_noc / num, error_occ / num, error_rate / num
    )
