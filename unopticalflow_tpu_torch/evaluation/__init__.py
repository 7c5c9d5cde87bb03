"""Flow evaluation: KITTI and Sintel ground truth, metrics and flow file I/O."""

from unopticalflow_tpu_torch.evaluation.evaluate_flow import (
    calculate_error_rate,
    eval_flow_avg,
    load_gt_flow_kitti,
    load_gt_flow_sintel,
    load_gt_mask,
)

__all__ = ["calculate_error_rate", "eval_flow_avg", "load_gt_flow_kitti", "load_gt_flow_sintel",
           "load_gt_mask"]
