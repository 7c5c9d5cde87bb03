"""Evaluation: flow, depth, mask and odometry metrics, and flow file I/O."""

from unopticalflow_tpu_torch.evaluation.depth_harness import (
    load_nyu_test_data,
    test_eigen_depth,
    test_nyu,
)
from unopticalflow_tpu_torch.evaluation.evaluate_depth import eval_depth
from unopticalflow_tpu_torch.evaluation.evaluate_flow import (
    calculate_error_rate,
    eval_flow_avg,
    get_scaled_intrinsic_matrix,
    load_gt_flow_kitti,
    load_gt_flow_sintel,
)
from unopticalflow_tpu_torch.evaluation.evaluate_mask import eval_mask, load_gt_mask

__all__ = [
    "load_nyu_test_data",
    "test_eigen_depth",
    "test_nyu",
    "eval_flow_avg",
    "load_gt_flow_kitti",
    "load_gt_flow_sintel",
    "get_scaled_intrinsic_matrix",
    "eval_mask",
    "load_gt_mask",
    "eval_depth",
    "calculate_error_rate",
]
