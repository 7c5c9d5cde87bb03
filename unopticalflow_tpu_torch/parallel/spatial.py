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
  and d - 1 below (stride 2; every shard of the encoder starts on an even
  row at every level because H % (n_spatial * 64) == 0, and the pose net's
  seventh stride-2 conv, which meets the 1-row shards of level 6, first
  joins neighbouring shards until each starts on an even row); zeros beyond
  the image's edges, the convolution's own zero padding (one zero row more
  below a map of odd height); a 1x1 convolution: none;
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

``make_spatial_forward`` is the training forward on row-shards, in each of
the unsharded forms of ``training/train_step.py``'s ``FORWARDS``: the same
encoder and decoder, the x4 flow resizes through ``_ShardOps.resize``, each
shard's image pyramid pooled on its own rows (exact: every shard's height
stays even at every loss scale), and per scale and shard the loss sums of
the rows it owns, added on the first shard's device before the ratios of
the whole map's means (``flow_model.scale_losses``):

* ``forward`` (3 frames): the photometric pack
  (``ops/photometric.py::photometric_pack_rows``: the whole source maps
  gathered onto the shard's device, the center rows and flows with one halo
  row each side) and the regularizer's sums (``regularizer_pack_rows`` with
  ``use_pallas_reg``, else ``losses.smoothness_rows``/``consistency_rows``);
  its occlusion ablation (``use_occlusion_weights=False``) takes the plain
  pack with the warps' validity as weights
  (``photometric_pack_rows_reference(use_weights=False)``) and the plain
  sums, as the unsharded ablation takes no kernel;
* ``forward_pair`` (2 frames): per slab with one halo row each side (SSIM's
  window reads it), the other frame's whole map warped by the shard's flow,
  ``back`` (the swapped whole-map flow warped by it) and the soft
  forward-backward weights, then the plain sums (``_forward_pair_rows``);
* ``forward_flowpose`` and ``forward_flowpose_pair`` (a ``FlowPoseModel``):
  the flow form's pack, the pose net on the row-shards (``pose_rows``: its
  mean is the shards' added sums) and ``loss_pose_epipolar`` as the ratio of
  the shards' added epipolar sums, each shard's at its rows in the frame
  (``models/flowpose_model.py::epipolar_sums``), F copied to every shard.

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
from unopticalflow_tpu_torch.models.flow_model import FlowModel, pair_weights, scale_losses
from unopticalflow_tpu_torch.models.flowpose_model import (FlowPoseModel, epipolar_ratio,
                                                           epipolar_sums)
from unopticalflow_tpu_torch.models.pose_net import POSE_SCALE
from unopticalflow_tpu_torch.models.pwc_decoder import MAX_DISPLACEMENT
from unopticalflow_tpu_torch.ops.cost_volume_spmd import cost_volume_sharded, row_starts, take_rows
from unopticalflow_tpu_torch.ops.geometry import fundamental_from_pose
from unopticalflow_tpu_torch.ops.photometric import (owned_rows_pack, photometric_pack_rows,
                                                     photometric_pack_rows_reference)
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
        pad, stride = block.padding[0], block.stride[0]
        if any(r % stride for r in row_starts(xs)[:-1]):
            xs = _join_to_even_starts(xs, stride)
        starts = row_starts(xs)
        out = []
        for i, x in enumerate(xs):
            # past its last row a shard's outputs read pad + 1 - stride rows,
            # and one more where a stride-2 map ends on an odd row (a zero row)
            below = max(0, pad + 1 - stride) + starts[i + 1] % stride
            y = block.forward_rows(take_rows(xs, starts[i] - pad, starts[i + 1] + below,
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


def _join_to_even_starts(xs, stride: int):
    """Neighbouring shards joined (on the first one's device) until every
    shard starts on a multiple of ``stride``: the pose net's seventh stride-2
    conv meets the 1-row shards of level 6 (H = n * 64)."""
    groups, top = [[]], 0
    for x in xs:
        groups[-1].append(x)
        top += x.shape[2]
        if top % stride == 0:
            groups.append([])
    return [torch.cat([x.to(g[0].device) for x in g], 2) for g in groups if g]


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


def _forward_rows(model, cfg, frames, return_aux: bool = False):
    """The four (b,) losses of one batch part (``forward``'s pack), on the first
    shard's device: ``frames``, (prev, center, next) lists of (b, h, W, 3)
    row-shards.  With ``return_aux`` also the finest scale's packed [bwd; fwd]
    flows and occlusion weights as row-shards ({"flows", "weights"}: (2b, 2,
    h, W) float32 and detached (2b, 1, h, W), each shard's own rows), for the
    pose loss."""
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
    # the occlusion ablation takes the plain pack (weights: the warps' validity)
    # and the plain regularizer sums, as the unsharded forward does
    fused_reg = cfg.use_pallas_reg and cfg.use_occlusion_weights

    scales = []
    for s in range(ns):
        starts = row_starts(pyr_c[s])
        h_s, w_s = starts[-1], pyr_c[s][0].shape[3]
        photo, reg = [], []
        for i, c in enumerate(pyr_c[s]):
            dev, lo, hi = c.device, starts[i] - 1, starts[i + 1] + 1
            src = take_rows(pyr_lr[s], 0, h_s, dev)
            img_h = take_rows(pyr_c[s], lo, hi, dev)
            fl = take_rows(flows[s], lo, hi, dev)
            args = (src[:b], src[b:], fl[:b], fl[b:], img_h, starts[i], h_s)
            out = (photometric_pack_rows(*args) if cfg.use_occlusion_weights
                   else photometric_pack_rows_reference(*args, use_weights=False))
            photo.append(out)
            w_fwd = out["weights"][b:]
            if fused_reg:
                reg.append(regularizer_pack_rows(fl[:b], fl[b:], img_h, w_fwd, starts[i], h_s))
            else:
                reg.append(_plain_reg_rows(fl, img_h, fl[b:], fl[:b], w_fwd, starts[i], h_s))
        scales.append((photo, reg, h_s, w_s))
    return _pack(scales, flows[0], b, dev0, return_aux)


def _plain_reg_rows(fl_h, img_h, fwd_h, bwd_h, w_own, row0: int, height: int) -> dict:
    """One shard's plain regularizer sums: smoothness of the flows' slab
    ``fl_h`` (one halo row each side) on ``img_h``, and consistency of the
    slab ``fwd_h`` against ``bwd_h`` under ``w_own``, the weights of the
    owned rows."""
    s_sx, s_sy = losses.smoothness_rows(fl_h / 20.0, img_h, row0, height)
    s_c, s_occ = losses.consistency_rows(fwd_h[:, :, 1:-1], bwd_h[:, :, 1:-1], w_own)
    return {"s_sx": s_sx, "s_sy": s_sy, "s_consis": s_c, "s_occ": s_occ}


def _pack(scales, flows0, b: int, dev0, return_aux: bool):
    """The four (b,) losses from each loss scale's (photometric sums, regularizer
    sums, h, w) by shard: the whole map's ratios of the shards' added sums
    (mean_w is the map's), on ``dev0``; with ``return_aux`` also the finest
    scale's flows and weights by shard."""
    loss_pixel = loss_ssim = smooth = consis = 0.0
    for photo, reg, h_s, w_s in scales:
        terms = scale_losses(_added(photo, dev0), _added(reg, dev0), h_s, w_s, b)
        loss_pixel = loss_pixel + terms[0]
        loss_ssim = loss_ssim + terms[1]
        smooth = smooth + terms[2]
        consis = consis + terms[3]
    pack = {
        "loss_pixel": loss_pixel[:b] + loss_pixel[b:],
        "loss_ssim": loss_ssim[:b] + loss_ssim[b:],
        "loss_flow_smooth": smooth[:b] + smooth[b:],
        "loss_flow_consis": consis,
    }
    if not return_aux:
        return pack
    return pack, {"flows": flows0, "weights": [p["weights"] for p in scales[0][0]]}


def _added(parts, dev0):
    """The shards' sums added on ``dev0``, key by key (their weights left out)."""
    return {k: sum(p[k].to(dev0) for p in parts) for k in parts[0] if k != "weights"}


def _forward_pair_rows(model, cfg, frames, return_aux: bool = False):
    """The four (b,) losses of one batch part of the 2-frame forward
    (``forward_pair``'s pack), on the first shard's device: ``frames``, (frame1,
    frame2) lists of (b, h, W, 3) row-shards.  ``return_aux`` as in
    ``_forward_rows``, the flows packed [1->2; 2->1].

    Per loss scale and shard, on a slab of the shard's rows with one halo row
    each side (SSIM's 3x3 window reads it, of the warped images and of the
    weights): the whole target map (the other frame) warped by the slab's
    flow f_ab, ``back`` (the swapped whole-map flow warped by f_ab, unmasked),
    the soft forward-backward weight times the warp's validity (detached), and
    the sums of the rows the shard owns; smoothness on the source pyramid,
    consistency of f_ab against ``back`` under the first half's weights.
    """
    img1, img2 = frames
    b = img1[0].shape[0]
    dev0 = img1[0].device
    ops = _ShardOps()
    ns = cfg.num_scales
    ld = getattr(torch, cfg.loss_dtype)

    def swap(t):
        return torch.cat([t[b:], t[:b]], 0)

    # one encoder pass at 2B [img1; img2] and one decoder pass at 2B [1->2; 2->1]
    x = [torch.cat(fr, 0).permute(0, 3, 1, 2).contiguous() for fr in zip(img1, img2)]
    feats = model.fpyramid(x, conv=ops.conv)
    dec = model.pwc_model.decode(list(feats), [[swap(f) for f in level] for level in feats], ops)
    flows = [[f.float() for f in ops.resize([f * 4.0 for f in dec[2 + s]], 4)]
             for s in range(ns)]
    pyr_src = list(zip(*(avg_pool_pyramid(t.to(ld), ns) for t in x)))  # [p1; p2] a shard

    scales = []
    for s in range(ns):
        starts = row_starts(pyr_src[s])
        h_s, w_s = starts[-1], pyr_src[s][0].shape[3]
        photo, reg = [], []
        for i, p in enumerate(pyr_src[s]):
            dev, lo, hi = p.device, starts[i] - 1, starts[i + 1] + 1
            f_ab = take_rows(flows[s], lo, hi, dev)
            src_h = take_rows(pyr_src[s], lo, hi, dev)
            warped = bilinear_warp(swap(take_rows(pyr_src[s], 0, h_s, dev)), f_ab,
                                   use_mask=True, row0=lo)
            back = bilinear_warp(swap(take_rows(flows[s], 0, h_s, dev)), f_ab, row0=lo)
            wt = pair_weights(f_ab, back, warped, ld)
            out = owned_rows_pack(src_h, warped, (src_h - warped).abs().mean(1, keepdim=True),
                                  wt)
            photo.append(out)
            reg.append(_plain_reg_rows(f_ab, src_h, f_ab[:b], back[:b], out["weights"][:b],
                                       starts[i], h_s))
        scales.append((photo, reg, h_s, w_s))
    return _pack(scales, flows[0], b, dev0, return_aux)


def pose_rows(pose_net, first, second) -> torch.Tensor:
    """``PoseNet`` over row-shards: ``first`` and ``second`` lists of (N, 3,
    h, W) shards of the pairs' frames -> the (N, 6) float32 pose on the
    first shard's device, as ``pose_net(whole first, whole second)`` gives
    it.  Each conv runs on its shards with their halos (``_ShardOps.conv``,
    which joins shards that a stride-2 conv would start on an odd row); the
    mean is the shards' float32 sums added over H * W."""
    ops = _ShardOps()
    ys = pose_net.encode([torch.cat([a, c], 1) for a, c in zip(first, second)], conv=ops.conv)
    dev0 = first[0].device
    total = sum(y.float().sum((2, 3)).to(dev0) for y in ys)
    return POSE_SCALE * total / (row_starts(ys)[-1] * ys[0].shape[3])


def _pose_loss_rows(model, frames, aux, intrinsics, intrinsics_inv):
    """``loss_pose_epipolar`` (b,) of one batch part on its first shard's
    device: the pose net over the pairs of the packed flows' layout (3
    frames: [(center, prev); (center, next)]; 2 frames: [(1, 2); (2, 1)]),
    F from the pose and the intrinsics there, copied to each shard's device
    for its ``epipolar_sums`` of the rows it owns."""
    nchw = [[t.permute(0, 3, 1, 2) for t in fr] for fr in frames]
    if len(frames) == 3:
        imgl, img, imgr = nchw
        first = [torch.cat([c, c], 0) for c in img]
        second = [torch.cat([lt, r], 0) for lt, r in zip(imgl, imgr)]
    else:
        img1, img2 = nchw
        first = [torch.cat([a, c], 0) for a, c in zip(img1, img2)]
        second = [torch.cat([c, a], 0) for a, c in zip(img1, img2)]
    pose = pose_rows(model.pose, first, second)
    dev0 = pose.device
    k2 = torch.cat([intrinsics, intrinsics], 0).to(dev0)
    k2_inv = torch.cat([intrinsics_inv, intrinsics_inv], 0).to(dev0)
    fund = fundamental_from_pose(pose.float(), k2.float(), k2_inv.float())
    starts = row_starts(aux["flows"])
    sums = [epipolar_sums(fl, wt, fund.to(fl.device), starts[i])
            for i, (fl, wt) in enumerate(zip(aux["flows"], aux["weights"]))]
    loss2 = epipolar_ratio(sum(a.to(dev0) for a, _ in sums), sum(w.to(dev0) for _, w in sums))
    b = intrinsics.shape[0]
    return loss2[:b] + loss2[b:]


def make_spatial_forward(model, cfg, mesh: Mesh, batch_axis: str | None = None,
                         frames: int = 3):
    """The training forward with each frame's rows split over the mesh.

    ``model`` and ``frames`` choose the form, the port's unsharded forward
    it equals (``training/train_step.py``'s ``FORWARDS``):

    * ``FlowModel``, 3 frames: ``forward`` (with ``cfg.use_occlusion_weights``
      False, its occlusion ablation);
    * ``FlowModel``, 2 frames: ``forward_pair``;
    * ``FlowPoseModel``, 3 frames: ``forward_flowpose``;
    * ``FlowPoseModel``, 2 frames: ``forward_flowpose_pair``.

    Returns ``fn(images)``, or ``fn(images, intrinsics, intrinsics_inv)``
    for a ``FlowPoseModel``: (B, frames * H, W, 3) stacked frames in [0, 1],
    the JAX layout, and (B, 3, 3) intrinsics (arrays or tensors on any
    device) -> the pack of (B,) float32 losses on the first shard's device,
    differentiable to the model's parameters.  Each frame's H rows split as
    ``make_spatial_infer`` splits them (H divisible by n_spatial * 64; JAX's
    GSPMD splits the stacked axis instead, the same function).  The cost
    volumes take ``cost_volume_sharded``; the 3-frame occlusion-weighted
    forms take the photometric (and with ``use_pallas_reg`` the regularizer)
    sums' halo-prepadded kernels on CUDA shards, their plain versions on CPU
    shards; the ablation and the 2-frame forms take the plain loss sums, as
    their unsharded forms do.  The pose loss is ``_pose_loss_rows``'s.
    """
    if frames not in (2, 3):
        raise ValueError(f"make_spatial_forward: frames must be 2 or 3, got {frames}")
    with_pose = isinstance(model, FlowPoseModel)
    if not with_pose and not isinstance(model, FlowModel):
        raise ValueError("make_spatial_forward takes a FlowModel or a FlowPoseModel, got "
                         f"{type(model).__name__}")
    flow_model = model.flow if with_pose else model
    rows = _forward_rows if frames == 3 else _forward_pair_rows

    def fn(images, intrinsics=None, intrinsics_inv=None):
        if with_pose != (intrinsics is not None and intrinsics_inv is not None):
            raise ValueError("make_spatial_forward: a FlowPoseModel's forward takes (images, "
                             "intrinsics, intrinsics_inv), a FlowModel's (images)")
        if len(images.shape) != 4 or images.shape[1] % frames or images.shape[3] != 3:
            raise ValueError(f"make_spatial_forward needs (B, {frames}H, W, 3) stacks, got "
                             f"{tuple(images.shape)}")
        h = images.shape[1] // frames
        check_height(h, mesh.n_spatial)
        grids = shard_images(mesh, batch_axis, *(images[:, i * h:(i + 1) * h]
                                                 for i in range(frames)))
        packs = []
        for d, parts in enumerate(zip(*grids)):
            if not with_pose:
                packs.append(rows(flow_model, cfg, parts))
                continue
            pack, aux = rows(flow_model, cfg, parts, return_aux=True)
            bs = parts[0][0].shape[0]
            ks = [torch.as_tensor(k)[d * bs:(d + 1) * bs].to(parts[0][0].device)
                  for k in (intrinsics, intrinsics_inv)]
            packs.append({**pack, "loss_pose_epipolar": _pose_loss_rows(model, parts, aux, *ks)})
        dev0 = mesh.devices[0][0]
        return {k: torch.cat([p[k].to(dev0) for p in packs], 0) for k in packs[0]}

    return fn
