"""Parallelism of the port: spatial (height-sharded) inference."""

from unopticalflow_tpu_torch.parallel.spatial import (
    Mesh,
    gather_rows,
    make_spatial_infer,
    shard_images,
    spatial_mesh,
)

__all__ = ["Mesh", "gather_rows", "make_spatial_infer", "shard_images", "spatial_mesh"]
