"""KITTI odometry evaluation (host-side numpy, and a CLI).

The port's copy of ``unopticalflow_tpu/evaluation/eval_odom.py``: pose files
of 12 (or index + 12) numbers a line, the alignment of both trajectories to
the first predicted frame, the Umeyama Sim(3) alignment with scale of the
predicted positions onto the ground truth, the per-segment (100 .. 800 m,
every 10th frame) translational and rotational errors, their averages, and
the x-z trajectory plot (``plot_path`` imports matplotlib at its call; pass
``plot=False`` where it is not installed; the CLI plots).

    python -m unopticalflow_tpu_torch.evaluation.eval_odom \
        --gt_txt GT.txt --result_txt PRED.txt [--seq 09]
"""

from __future__ import annotations

import copy
import os

import numpy as np

SEGMENT_LENGTHS = (100, 200, 300, 400, 500, 600, 700, 800)
STEP_SIZE = 10


def scale_lse_solver(x: np.ndarray, y: np.ndarray) -> float:
    """argmin_s ||s*x - y||^2."""
    return float(np.sum(x * y) / np.sum(x**2))


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = False):
    """Least-squares Sim(m) aligning column-point sets x -> y (Umeyama 1991).

    Returns (R, t, c).
    """
    if x.shape != y.shape:
        raise ValueError("x.shape not equal to y.shape")
    m, n = x.shape
    mean_x = x.mean(axis=1)
    mean_y = y.mean(axis=1)
    sigma_x = np.sum((x - mean_x[:, None]) ** 2) / n
    cov_xy = (y - mean_y[:, None]) @ (x - mean_x[:, None]).T / n
    u, d, v = np.linalg.svd(cov_xy)
    s = np.eye(m)
    if np.linalg.det(u) * np.linalg.det(v) < 0.0:
        s[m - 1, m - 1] = -1
    r = u @ s @ v
    c = np.trace(np.diag(d) @ s) / sigma_x if with_scale else 1.0
    t = mean_y - c * (r @ mean_x)
    return r, t, c


def load_poses(file_name: str) -> dict:
    """Pose txt -> {frame_idx: 4x4 pose}; lines are 12 or idx+12 floats."""
    poses = {}
    with open(file_name, "r") as f:
        for cnt, line in enumerate(f.readlines()):
            vals = [float(v) for v in line.split()]
            with_idx = len(vals) == 13
            pose = np.eye(4)
            pose[:3, :4] = np.array(vals[1:] if with_idx else vals).reshape(3, 4)
            poses[vals[0] if with_idx else cnt] = pose
    return poses


def trajectory_distances(poses: dict) -> list:
    dist = [0.0]
    keys = sorted(poses.keys())
    for a, b in zip(keys[:-1], keys[1:]):
        delta = poses[a][:3, 3] - poses[b][:3, 3]
        dist.append(dist[-1] + float(np.linalg.norm(delta)))
    return dist


def rotation_error(pose_error: np.ndarray) -> float:
    d = 0.5 * (np.trace(pose_error[:3, :3]) - 1.0)
    return float(np.arccos(np.clip(d, -1.0, 1.0)))


def translation_error(pose_error: np.ndarray) -> float:
    return float(np.linalg.norm(pose_error[:3, 3]))


def _last_frame_from_segment_length(dist, first_frame, length):
    for i in range(first_frame, len(dist)):
        if dist[i] > dist[first_frame] + length:
            return i
    return -1


def calc_sequence_errors(poses_gt: dict, poses_result: dict) -> list:
    """[(first_frame, r_err/len, t_err/len, len, speed), ...]."""
    err = []
    dist = trajectory_distances(poses_gt)
    for first in range(0, len(poses_gt), STEP_SIZE):
        for length in SEGMENT_LENGTHS:
            last = _last_frame_from_segment_length(dist, first, length)
            if last == -1 or last not in poses_result or first not in poses_result:
                continue
            delta_gt = np.linalg.inv(poses_gt[first]) @ poses_gt[last]
            delta_pred = np.linalg.inv(poses_result[first]) @ poses_result[last]
            pose_error = np.linalg.inv(delta_pred) @ delta_gt
            num_frames = last - first + 1.0
            err.append(
                [
                    first,
                    rotation_error(pose_error) / length,
                    translation_error(pose_error) / length,
                    length,
                    length / (0.1 * num_frames),
                ]
            )
    return err


def compute_segment_error(seq_errs: list) -> dict:
    segment = {length: [] for length in SEGMENT_LENGTHS}
    for _, r_err, t_err, length, _ in seq_errs:
        segment[length].append([t_err, r_err])
    return {
        length: (list(np.mean(np.asarray(v), axis=0)) if v else [])
        for length, v in segment.items()
    }


def compute_overall_err(seq_err: list):
    if not seq_err:
        return 0.0, 0.0
    arr = np.asarray(seq_err)
    return float(arr[:, 2].mean()), float(arr[:, 1].mean())


def scale_optimization(gt: dict, pred: dict) -> dict:
    """Globally rescale predicted translations to LSE-fit the GT."""
    pred_updated = copy.deepcopy(pred)
    xyz_pred = np.asarray([pred[i][:3, 3] for i in pred])
    xyz_ref = np.asarray([gt[i][:3, 3] for i in pred])
    scale = scale_lse_solver(xyz_pred, xyz_ref)
    for i in pred_updated:
        pred_updated[i][:3, 3] *= scale
    return pred_updated


class KittiEvalOdom:
    """KITTI odometry protocol evaluator."""

    def __init__(self):
        self.lengths = list(SEGMENT_LENGTHS)

    def plot_path(self, seq, poses_gt, poses_result, out_dir):
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        fig = plt.figure()
        ax = plt.gca()
        ax.set_aspect("equal")
        for label, poses in (("Ground Truth", poses_gt), ("Ours", poses_result)):
            xz = np.asarray(
                [[poses[k][0, 3], poses[k][2, 3]] for k in sorted(poses.keys())]
            )
            plt.plot(xz[:, 0], xz[:, 1], label=label)
        plt.legend(loc="upper right", prop={"size": 20})
        plt.xlabel("x (m)", fontsize=20)
        plt.ylabel("z (m)", fontsize=20)
        fig.set_size_inches(10, 10)
        plt.savefig(
            os.path.join(out_dir, f"sequence_{seq}.pdf"),
            bbox_inches="tight",
            pad_inches=0,
        )
        plt.close(fig)

    def eval(self, gt_txt: str, result_txt: str, seq: str = "09", plot: bool = True):
        """Returns (avg translational error, avg rotational error [rad/m])."""
        poses_result = load_poses(result_txt)
        poses_gt = load_poses(gt_txt)

        # align both trajectories to the first predicted frame
        idx_0 = sorted(poses_result.keys())[0]
        pred_0_inv = np.linalg.inv(poses_result[idx_0])
        gt_0_inv = np.linalg.inv(poses_gt[idx_0])
        for cnt in poses_result:
            poses_result[cnt] = pred_0_inv @ poses_result[cnt]
            poses_gt[cnt] = gt_0_inv @ poses_gt[cnt]

        # Sim(3) alignment of predicted XYZ onto GT
        keys = list(poses_result.keys())
        xyz_result = np.asarray([poses_result[k][:3, 3] for k in keys]).T
        xyz_gt = np.asarray([poses_gt[k][:3, 3] for k in keys]).T
        r, t, scale = umeyama_alignment(xyz_result, xyz_gt, True)
        align = np.eye(4)
        align[:3, :3] = r
        align[:3, 3] = t
        for cnt in poses_result:
            poses_result[cnt][:3, 3] *= scale
            poses_result[cnt] = align @ poses_result[cnt]

        seq_err = calc_sequence_errors(poses_gt, poses_result)
        avg_segment_errs = compute_segment_error(seq_err)
        ave_t_err, ave_r_err = compute_overall_err(seq_err)

        print(f"Sequence: {seq}")
        print("Translational error (%): ", ave_t_err * 100)
        print("Rotational error (deg/100m): ", ave_r_err / np.pi * 180 * 100)
        for length, errs in avg_segment_errs.items():
            if errs:
                print(f"  segment {length} m: t {errs[0] * 100:.2f}%  "
                      f"r {errs[1] / np.pi * 180 * 100:.4f} deg/100m")

        if plot:
            plot_dir = os.path.join(os.path.dirname(result_txt) or ".", "plot_path")
            os.makedirs(plot_dir, exist_ok=True)
            self.plot_path(seq, poses_gt, poses_result, plot_dir)
        return ave_t_err, ave_r_err


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description="KITTI odometry evaluation")
    parser.add_argument("--gt_txt", type=str, required=True)
    parser.add_argument("--result_txt", type=str, required=True)
    parser.add_argument("--seq", type=str, default="09")
    args = parser.parse_args()
    KittiEvalOdom().eval(args.gt_txt, args.result_txt, seq=args.seq)
