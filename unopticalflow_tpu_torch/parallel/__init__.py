"""Parallelism of the port: data parallelism over processes (``mesh``) and
spatial (height-sharded) inference and training forwards (``spatial``:
the flow model's 3- and 2-frame forwards, the occlusion ablation and the
flow + pose model's forwards, each frame's rows split over a mesh)."""

from unopticalflow_tpu_torch.parallel.mesh import (
    all_reduce_mean,
    data_parallel_world,
    initialize_multi_host,
    process_device,
    replicate,
    shard_batch,
)
from unopticalflow_tpu_torch.parallel.spatial import (
    Mesh,
    gather_rows,
    make_spatial_forward,
    make_spatial_infer,
    shard_images,
    spatial_mesh,
)

__all__ = ["Mesh", "all_reduce_mean", "data_parallel_world", "gather_rows",
           "initialize_multi_host", "make_spatial_forward", "make_spatial_infer", "process_device", "replicate",
           "shard_batch", "shard_images", "spatial_mesh"]
