"""Training and evaluation datasets and the loader.

Samples come back channels-last, (frames * H, W, 3), as the port's training
forward and ``test.py`` take them.
"""

from __future__ import annotations

from unopticalflow_tpu_torch.data.datasets import (
    KITTI_2012,
    KITTI_2015,
    KITTI_Prepared,
    NYU_v2,
    SINTEL_Prepared,
)
from unopticalflow_tpu_torch.data.loader import BatchLoader, device_prefetch, stack_batches

__all__ = ["BatchLoader", "KITTI_2012", "KITTI_2015", "KITTI_Prepared", "NYU_v2",
           "SINTEL_Prepared", "device_prefetch", "stack_batches"]
