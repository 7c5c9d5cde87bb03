"""Spatial (height-sharded) inference and training forward: one frame's rows
split over a mesh.

Port of ``unopticalflow_tpu/parallel/spatial.py``.  For frames too large for
one card (panoramas, film scans), or to spread one frame's latency over
several, every image and feature map is held as a list of row-shards, one
per entry of the mesh's spatial axis.  One process drives every shard, as
JAX's single controller drives its mesh: a mesh is a grid of devices, and a
halo is a tensor copy between entries (``ops/cost_volume_spmd.py::take_rows``:
a peer copy between two cards, a device-local copy when two entries name the
same card).

JAX's GSPMD partitions every convolution, resize and gather by itself;
PyTorch has no partitioner, so ``_ShardOps`` spells out the rows each
operation of the model reads beyond its shard:

* 3x3 convolution of dilation d: d rows above and below (stride 1), d above
  and d - 1 below (stride 2; every shard starts on an even row at every
  level because H % (n_spatial * 64) == 0); zeros beyond the image's edges,
  the convolution's own zero padding;
* the cost volume: md = 4 rows of f2 (forward, df1), of g and f1 (df2), in
  ``cost_volume_sharded`` with the halo-prepadded kernels;
* the 2x and final 4x bilinear resizes: 1 row each side, and none beyond the
  image's edges, so ``F.interpolate`` clamps there as it does on the whole
  map (a zero row would pull the edge rows' flow toward 0);
* the decoder's warp: the whole target map, gathered onto each shard's
  device, sampled at the shard's global rows (flow displacements are
  unbounded);
* LeakyReLU, bias, channel concatenation, sums: none.

A halo taller than a neighbour's shard takes its rows from further shards
(the 1- and 2-row shards of levels 6 and 5, the context network's 16 rows).
The encoder and decoder are the model's own (``FeaturePyramid.forward``'s
``conv`` and ``PWCDecoder.decode``'s ``ops``), so both forms of the model
walk the same code.

A 2-D ``(data, spatial)`` mesh splits the batch over ``data`` as well
(``make_spatial_infer(batch_axis="data")``): each data row of the mesh runs
its part of the batch.

``make_spatial_forward`` is the training forward (``models/flow_model.py::
forward``) on row-shards: the same encoder and decoder, the four x4 flow
resizes through ``_ShardOps.resize``, each shard's image pyramid pooled on its
own rows (exact: every shard's height stays even at every loss scale), and
per scale and shard the photometric pack of the rows it owns
(``ops/photometric.py::photometric_pack_rows``: the whole source maps
gathered onto the shard's device, the center rows and flows with one halo
row each side) and the regularizer's sums of the terms it owns
(``regularizer_pack_rows`` with ``use_pallas_reg``, else
``losses.smoothness_rows``/``consistency_rows``).  The shards' sums are added
on the first shard's device before the ratios of the whole map's means.
The backward is autograd's: each halo row's gradient flows back through
``take_rows`` to the shard that owns it, and each weight's gradient adds up
the shards' uses of it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from unopticalflow_tpu_torch.models import losses
from unopticalflow_tpu_torch.models.flow_model import FlowModel, scale_losses
from unopticalflow_tpu_torch.models.pwc_decoder import MAX_DISPLACEMENT
from unopticalflow_tpu_torch.ops.cost_volume_spmd import cost_volume_sharded, row_starts, take_rows
from unopticalflow_tpu_torch.ops.photometric import photometric_pack_rows
from unopticalflow_tpu_torch.ops.pyramid import avg_pool_pyramid
from unopticalflow_tpu_torch.ops.regularizer import regularizer_pack_rows
from unopticalflow_tpu_torch.ops.resize import resize_bilinear
from unopticalflow_tpu_torch.ops.warp import bilinear_warp

# the encoder halves the rows six times: every level's shards stay equal and even
ROW_MULTIPLE = 64


class Mesh(NamedTuple):
    """A (data, spatial) grid of devices: ``devices[d][s]`` holds row-shard s
    of batch part d."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def n_data(self) -> int:
        return len(self.devices)

    @property
    def n_spatial(self) -> int:
        return len(self.devices[0])


def spatial_mesh(n_spatial: int, n_data: int = 1, devices=None) -> Mesh:
    """(data, spatial) mesh over the first ``n_data * n_spatial`` devices.

    ``devices`` defaults to every CUDA device; a caller that wants several
    shards on one card (or CPU shards) lists them, e.g. ``["cuda:0"] * 2``.
    """
    devs = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if devices is None else [torch.device(d) for d in devices])
    need = n_data * n_spatial
    if n_data < 1 or n_spatial < 1:
        raise ValueError(f"mesh needs n_data, n_spatial >= 1, got {n_data}, {n_spatial}")
    if need > len(devs):
        raise ValueError(f"need {need} devices, have {len(devs)}")
    return Mesh(tuple(tuple(devs[d * n_spatial:(d + 1) * n_spatial]) for d in range(n_data)))


def check_height(h: int, n_spatial: int) -> None:
    if h % (n_spatial * ROW_MULTIPLE) != 0:
        raise ValueError(f"H={h} must be divisible by n_spatial*{ROW_MULTIPLE}="
                         f"{n_spatial * ROW_MULTIPLE}")


def shard_images(mesh: Mesh, batch_axis: str | None, *imgs):
    """Split (B, H, W, C) arrays or tensors into the mesh's layout: for each,
    ``grid[d][s]`` is batch part d, row-shard s, on ``mesh.devices[d][s]``."""
    if batch_axis not in (None, "data"):
        raise ValueError(f"batch_axis must be None or 'data', got {batch_axis!r}")
    if batch_axis is None and mesh.n_data > 1:
        raise ValueError("a mesh with a data axis needs batch_axis='data'")
    out = []
    for img in imgs:
        x = torch.from_numpy(np.asarray(img)) if not isinstance(img, torch.Tensor) else img
        b, h = x.shape[:2]
        if b % mesh.n_data or h % mesh.n_spatial:
            raise ValueError(f"cannot split {tuple(x.shape)} over a {mesh.n_data}x"
                             f"{mesh.n_spatial} mesh")
        bs, hs = b // mesh.n_data, h // mesh.n_spatial
        out.append([[x[d * bs:(d + 1) * bs, s * hs:(s + 1) * hs].to(dev)
                     for s, dev in enumerate(row)] for d, row in enumerate(mesh.devices)])
    return tuple(out) if len(out) > 1 else out[0]


def gather_rows(grid, device=None) -> torch.Tensor:
    """The (B, H, ...) tensor of a ``shard_images``-style grid, on ``device``
    (the first shard's by default)."""
    device = grid[0][0].device if device is None else torch.device(device)
    return torch.cat([torch.cat([s.to(device) for s in row], 1) for row in grid], 0)


class _ShardOps:
    """The model's operations on maps split into row-shards (lists of NCHW
    tensors, in order); see the module docstring for each one's halo."""

    @staticmethod
    def conv(layer: nn.Module, xs):
        block = layer[0] if isinstance(layer, nn.Sequential) else layer
        d, stride = block.dilation[0], block.stride[0]
        above, below = d, max(0, d + 1 - stride)
        starts = row_starts(xs)
        out = []
        for i, x in enumerate(xs):
            if starts[i] % stride:
                raise ValueError(f"a stride-{stride} shard starts on row {starts[i]}")
            y = block.forward_rows(take_rows(xs, starts[i] - above, starts[i + 1] + below,
                                             x.device))
            out.append(layer[1](y) if block is not layer else y)
        return out

    @staticmethod
    def cat(parts):
        return [torch.cat(p, 1) for p in zip(*parts)]

    @staticmethod
    def add(a, b):
        return [x + y for x, y in zip(a, b)]

    @staticmethod
    def corr(f1s, f2s):
        return cost_volume_sharded(f1s, f2s, MAX_DISPLACEMENT)

    @staticmethod
    def resize(xs, factor: int):
        """Each shard resized ``factor``x (bilinear, align_corners=False) from a
        slab with one row of halo each side inside the image."""
        starts = row_starts(xs)
        out = []
        for i, x in enumerate(xs):
            lo, hi = max(starts[i] - 1, 0), min(starts[i + 1] + 1, starts[-1])
            slab = take_rows(xs, lo, hi, x.device)
            big = resize_bilinear(slab, (factor * (hi - lo), factor * x.shape[3]))
            out.append(big[:, :, factor * (starts[i] - lo):factor * (starts[i + 1] - lo)])
        return out

    def up(self, flows):
        return [f * 2.0 for f in self.resize(flows, 2)]

    @staticmethod
    def warp(f2s, flows):
        starts = row_starts(flows)
        return [bilinear_warp(take_rows(f2s, 0, starts[-1], fl.device), fl, row0=starts[i])
                for i, fl in enumerate(flows)]


def _infer_rows(model, s1, s2):
    """The finest flow of one batch part: lists of (b, h, W, 3) row-shards ->
    (b, h, W, 2) float32 row-shards (``inference_flow`` on the whole frame)."""
    b = s1[0].shape[0]
    ops = _ShardOps()
    imgs = [torch.cat([a, c], 0).permute(0, 3, 1, 2).contiguous() for a, c in zip(s1, s2)]
    feats = model.fpyramid(imgs, conv=ops.conv)
    f1 = [[x[:b] for x in f] for f in feats]
    f2 = [[x[b:] for x in f] for f in feats]
    flow2 = model.pwc_model.decode(f1, f2, ops)[2]
    return [f.permute(0, 2, 3, 1).float() for f in ops.resize([f * 4.0 for f in flow2], 4)]


def make_spatial_infer(model, mesh: Mesh, batch_axis: str | None = None):
    """``inference_flow`` with images and flow split over the mesh's rows.

    Returns ``fn(img1, img2)``: (B, H, W, 3) arrays or tensors in [0, 1] ->
    the flow as a grid of (B / n_data, H / n_spatial, W, 2) float32 shards
    (``gather_rows`` joins them).  H must be divisible by n_spatial * 64.
    The model's weights are read at each call (moved to a shard's device
    when they live elsewhere).  Differentiable: the cost volumes' backward
    runs the halo-prepadded df1/df2 kernels.
    """

    def infer(img1, img2):
        check_height(img1.shape[1], mesh.n_spatial)
        g1, g2 = shard_images(mesh, batch_axis, img1, img2)
        return [_infer_rows(model, r1, r2) for r1, r2 in zip(g1, g2)]

    return infer


def _forward_rows(model, cfg, frames):
    """The four (b,) losses of one batch part (``forward``'s pack), on the first
    shard's device: ``frames``, (prev, center, next) lists of (b, h, W, 3)
    row-shards."""
    imgl, img, imgr = frames
    b = img[0].shape[0]
    dev0 = img[0].device
    ops = _ShardOps()
    ns = cfg.num_scales
    ld = getattr(torch, cfg.loss_dtype)
    # one encoder pass at 3B [img; imgl; imgr] and one decoder pass at 2B [bwd; fwd]
    x = [torch.cat(fr, 0).permute(0, 3, 1, 2).contiguous() for fr in zip(img, imgl, imgr)]
    feats = model.fpyramid(x, conv=ops.conv)
    feats_cc = [[torch.cat([f[:b], f[:b]], 0) for f in level] for level in feats]
    feats_lr = [[f[b:] for f in level] for level in feats]
    dec = model.pwc_model.decode(feats_cc, feats_lr, ops)
    flows = [[f.float() for f in ops.resize([f * 4.0 for f in dec[2 + s]], 4)]
             for s in range(ns)]
    # per scale, the shards' pyramid levels: centre (b) and [prev; next] (2b)
    pyr_c = list(zip(*(avg_pool_pyramid(t[:b].to(ld), ns) for t in x)))
    pyr_lr = list(zip(*(avg_pool_pyramid(t[b:].to(ld), ns) for t in x)))

    def added(parts):
        return {k: sum(p[k].to(dev0) for p in parts) for k in parts[0] if k != "weights"}

    loss_pixel = loss_ssim = smooth = consis = 0.0
    for s in range(ns):
        starts = row_starts(pyr_c[s])
        h_s, w_s = starts[-1], pyr_c[s][0].shape[3]
        photo, reg = [], []
        for i, c in enumerate(pyr_c[s]):
            dev, lo, hi = c.device, starts[i] - 1, starts[i + 1] + 1
            src = take_rows(pyr_lr[s], 0, h_s, dev)
            img_h = take_rows(pyr_c[s], lo, hi, dev)
            fl = take_rows(flows[s], lo, hi, dev)
            out = photometric_pack_rows(src[:b], src[b:], fl[:b], fl[b:], img_h, starts[i], h_s)
            photo.append(out)
            w_fwd = out["weights"][b:]
            if cfg.use_pallas_reg:
                reg.append(regularizer_pack_rows(fl[:b], fl[b:], img_h, w_fwd, starts[i], h_s))
            else:
                s_sx, s_sy = losses.smoothness_rows(fl / 20.0, img_h, starts[i], h_s)
                s_c, s_occ = losses.consistency_rows(fl[b:, :, 1:-1], fl[:b, :, 1:-1], w_fwd)
                reg.append({"s_sx": s_sx, "s_sy": s_sy, "s_consis": s_c, "s_occ": s_occ})
        # the whole map's ratios of the shards' added sums (mean_w is the map's)
        terms = scale_losses(added(photo), added(reg), h_s, w_s, b)
        loss_pixel = loss_pixel + terms[0]
        loss_ssim = loss_ssim + terms[1]
        smooth = smooth + terms[2]
        consis = consis + terms[3]
    return {
        "loss_pixel": loss_pixel[:b] + loss_pixel[b:],
        "loss_ssim": loss_ssim[:b] + loss_ssim[b:],
        "loss_flow_smooth": smooth[:b] + smooth[b:],
        "loss_flow_consis": consis,
    }


def make_spatial_forward(model, cfg, mesh: Mesh, batch_axis: str | None = None):
    """The training forward (``models/flow_model.py::forward``) with each frame's
    rows split over the mesh.

    Returns ``fn(images)``: (B, 3H, W, 3) stacked (prev, center, next) snippets
    in [0, 1], the JAX layout (an array or a tensor on any device) -> the pack
    of the four (B,) float32 losses on the first shard's device,
    differentiable to the model's parameters.  Each frame's H rows split as
    ``make_spatial_infer`` splits them (H divisible by n_spatial * 64; JAX's
    GSPMD splits the stacked 3H axis instead, the same function).  The
    photometric and regularizer sums take their halo-prepadded kernels on
    CUDA shards and their plain versions on CPU shards; the cost volumes take
    ``cost_volume_sharded``.  Only the 3-frame flow forward with the softmax
    occlusion weights has a sharded form: the 2-frame forward
    (``forward_pair``) and the flowposenet one (``forward_flowpose``, refused
    here by its model type) have none, nor has ``use_occlusion_weights=False``.
    """
    if not isinstance(model, FlowModel):
        raise ValueError("make_spatial_forward: the flowposenet forward (forward_flowpose) "
                         "has no spatial form; it takes a FlowModel")
    if not cfg.use_occlusion_weights:
        raise ValueError("make_spatial_forward: use_occlusion_weights=False (the occlusion "
                         "ablation's plain loss path) has no spatial form")

    def fn(images):
        h3 = images.shape[1]
        if h3 % 3:
            raise ValueError(f"make_spatial_forward needs (B, 3H, W, 3) snippets, got "
                             f"{tuple(images.shape)}")
        h = h3 // 3
        check_height(h, mesh.n_spatial)
        grids = shard_images(mesh, batch_axis, *(images[:, i * h:(i + 1) * h] for i in range(3)))
        packs = [_forward_rows(model, cfg, parts) for parts in zip(*grids)]
        dev0 = mesh.devices[0][0]
        return {k: torch.cat([p[k].to(dev0) for p in packs], 0) for k in packs[0]}

    return fn
