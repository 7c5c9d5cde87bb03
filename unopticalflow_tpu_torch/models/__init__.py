"""Conv blocks, feature encoder, PWC decoder and the flow model."""

from unopticalflow_tpu_torch.models.flow_model import (
    FlowModel,
    FlowModelConfig,
    inference_flow,
)

__all__ = ["FlowModel", "FlowModelConfig", "inference_flow"]
