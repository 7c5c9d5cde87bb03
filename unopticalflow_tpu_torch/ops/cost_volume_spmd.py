"""The cost volume of a map split into row-shards, forward and backward.

Port of ``unopticalflow_tpu/ops/pallas_spmd.py``.  A height-sharded model
(``parallel/spatial.py``) holds each feature map as a list of row-shards in
order, NCHW, each on its own entry of the mesh (a device; two entries may
name the same one).  The correlation window reaches md = 4 rows up and down,
so each shard's kernel reads an operand that carries md real neighbour rows
on each side (``halo_exchange_h``), and the same hand-written kernels run
per shard in their halo-prepadded form (``correlation_cuda.corr_*_hpad``).

* ``take_rows`` is the one halo primitive: global rows ``[start, stop)`` of a
  sharded map on one device, copied from every shard they overlap (several
  shards where a halo is taller than a shard: the 1- and 2-row shards of the
  coarse levels), with zeros above the image's top and below its bottom,
  which is the unsharded correlation's zero padding.  A copy between two
  entries on different cards is a peer copy; on one card a device-local copy.
* ``halo_exchange_h`` gives each shard its md rows above and below, as JAX's
  ``_halo_exchange_h`` (``ppermute`` ring shifts, or an all-gather for shards
  shorter than md) does.
* ``cost_volume_sharded`` is a ``torch.autograd.Function`` over the list of
  shards.  Its forward exchanges f2's halos and runs the hpad forward per
  shard; its backward, as ``_cv_bwd``, runs df1 per shard on the saved
  halo-extended f2, then exchanges the halos of g and f1 and runs df2 in its
  gather form per shard, so a shard's d(f2) near a seam also sums the windows
  of the shard next to it.

CUDA shards go to the kernels, CPU shards to the plain versions
(``ops/cost_volume.py``'s ``*_hpad_reference``), each shard by its own
device, so one mesh may hold both.
"""

from __future__ import annotations

import torch

from unopticalflow_tpu_torch.ops import correlation_cuda
from unopticalflow_tpu_torch.ops.cost_volume import (
    corr_df1_hpad_reference,
    corr_df2_hpad_reference,
    corr_fwd_hpad_reference,
    zero_halo,
)

__all__ = ["cost_volume_sharded", "halo_exchange_h", "row_starts", "take_rows", "zero_halo"]


def row_starts(shards) -> list[int]:
    """Global row of each shard's first row, and the map's height last."""
    starts = [0]
    for s in shards:
        starts.append(starts[-1] + s.shape[2])
    return starts


def take_rows(shards, start: int, stop: int, device) -> torch.Tensor:
    """Rows ``[start, stop)`` of the map split into ``shards``, contiguous on
    ``device``; rows outside the map are zeros."""
    ref = shards[0]
    b, c, _, w = ref.shape
    height = row_starts(shards)[-1]
    parts = []
    if start < 0:
        parts.append(ref.new_zeros((b, c, min(stop, 0) - start, w), device=device))
    top = 0
    for s in shards:
        lo, hi = max(start, top), min(stop, top + s.shape[2])
        if lo < hi:
            parts.append(s[:, :, lo - top:hi - top].to(device))
        top += s.shape[2]
    if stop > height:
        parts.append(ref.new_zeros((b, c, stop - max(start, height), w), device=device))
    return torch.cat(parts, 2) if len(parts) > 1 else parts[0].contiguous()


def halo_exchange_h(shards, md: int) -> list[torch.Tensor]:
    """Each shard with md real neighbour rows above and below (zeros at the
    image's top and bottom), on the shard's own device: (B, C, h + 2md, W)."""
    starts = row_starts(shards)
    return [take_rows(shards, starts[i] - md, starts[i + 1] + md, s.device)
            for i, s in enumerate(shards)]


def _ops(t):
    """(fwd, df1, df2) for a shard on ``t``'s device: the kernels or the plain versions."""
    if t.device.type == "cuda":
        return (correlation_cuda.corr_fwd_hpad, correlation_cuda.corr_df1_hpad,
                correlation_cuda.corr_df2_hpad)
    if t.device.type == "cpu":
        return corr_fwd_hpad_reference, corr_df1_hpad_reference, corr_df2_hpad_reference
    raise ValueError(f"cost_volume_sharded: a shard on {t.device}; shards live on CUDA "
                     "devices or the CPU")


class _ShardedCorrelation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, md, n, *shards):
        f1s, f2s = shards[:n], shards[n:]
        f2h = halo_exchange_h(f2s, md)
        ctx.md, ctx.n = md, n
        ctx.save_for_backward(*f1s, *f2h)
        return tuple(_ops(a)[0](a, b, md) for a, b in zip(f1s, f2h))

    @staticmethod
    def backward(ctx, *grads):
        md, n = ctx.md, ctx.n
        saved = ctx.saved_tensors
        f1s, f2h = saved[:n], saved[n:]
        gs = [g.to(a.dtype).contiguous() for g, a in zip(grads, f1s)]
        d1 = d2 = [None] * n
        if any(ctx.needs_input_grad[2:2 + n]):
            d1 = [_ops(g)[1](g, b, md) for g, b in zip(gs, f2h)]
        if any(ctx.needs_input_grad[2 + n:]):
            d2 = [_ops(g)[2](g, a, md)
                  for g, a in zip(halo_exchange_h(gs, md), halo_exchange_h(f1s, md))]
        return (None, None, *d1, *d2)


def cost_volume_sharded(f1_shards, f2_shards, md: int = 4) -> list[torch.Tensor]:
    """The cost volume of two maps split into the same row-shards (NCHW, in
    order): one (B, (2md+1)^2, h_i, W) shard each, input dtype.  Differentiable."""
    n = len(f1_shards)
    if n == 0 or len(f2_shards) != n or any(
            a.shape != b.shape or a.device != b.device for a, b in zip(f1_shards, f2_shards)):
        raise ValueError("cost_volume_sharded needs f1 and f2 split into the same "
                         "shards on the same devices")
    return list(_ShardedCorrelation.apply(md, n, *f1_shards, *f2_shards))
