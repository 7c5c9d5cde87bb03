"""Compute primitives of the flow-serving path (NCHW)."""

from unopticalflow_tpu_torch.ops.cost_volume import cost_volume, cost_volume_reference
from unopticalflow_tpu_torch.ops.resize import resize_bilinear, upsample2x_double
from unopticalflow_tpu_torch.ops.warp import bilinear_warp, warp_validity_mask

__all__ = [
    "bilinear_warp",
    "cost_volume",
    "cost_volume_reference",
    "resize_bilinear",
    "upsample2x_double",
    "warp_validity_mask",
]
