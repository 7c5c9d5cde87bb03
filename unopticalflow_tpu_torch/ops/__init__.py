"""Compute primitives of the serving, training and evaluation paths (NCHW), and
the gathers of the gather probes."""

from unopticalflow_tpu_torch.ops.cost_volume import (
    cost_volume,
    cost_volume_bwd_reference,
    cost_volume_reference,
)
from unopticalflow_tpu_torch.ops.gather import (
    lane_gather,
    lane_gather_reference,
    row_gather,
    row_gather_reference,
    sublane_gather,
    sublane_gather_reference,
)
from unopticalflow_tpu_torch.ops.photometric import photometric_pack, photometric_pack_reference
from unopticalflow_tpu_torch.ops.pyramid import avg_pool_pyramid
from unopticalflow_tpu_torch.ops.regularizer import regularizer_pack, regularizer_pack_reference
from unopticalflow_tpu_torch.ops.resize import resize_bilinear, upsample2x_double
from unopticalflow_tpu_torch.ops.ssim import ssim
from unopticalflow_tpu_torch.ops.warp import bilinear_warp, warp_validity_mask

__all__ = [
    "avg_pool_pyramid",
    "bilinear_warp",
    "cost_volume",
    "cost_volume_bwd_reference",
    "cost_volume_reference",
    "lane_gather",
    "lane_gather_reference",
    "photometric_pack",
    "photometric_pack_reference",
    "regularizer_pack",
    "regularizer_pack_reference",
    "resize_bilinear",
    "row_gather",
    "row_gather_reference",
    "ssim",
    "sublane_gather",
    "sublane_gather_reference",
    "upsample2x_double",
    "warp_validity_mask",
]
