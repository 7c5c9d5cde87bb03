"""Conv blocks, feature encoder, PWC decoder, the flow model and the
flow + pose model."""

from unopticalflow_tpu_torch.models.flow_model import (
    FlowModel,
    FlowModelConfig,
    forward,
    forward_pair,
    inference_flow,
)
from unopticalflow_tpu_torch.models.flowpose_model import (
    FlowPoseModel,
    forward_flowpose,
    forward_flowpose_pair,
    inference_pose,
)
from unopticalflow_tpu_torch.models.pose_net import PoseNet

__all__ = ["FlowModel", "FlowModelConfig", "FlowPoseModel", "PoseNet", "forward",
           "forward_flowpose", "forward_flowpose_pair", "forward_pair", "inference_flow",
           "inference_pose"]
