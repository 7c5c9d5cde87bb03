#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the run exits non-zero):

1. Setup: require CUDA, print the card (nvidia-smi name and power limit),
   torch and CUDA versions, build every kernel source of
   ``unopticalflow_tpu_torch/csrc/`` (one nvcc each, all at once) and print
   the build time and ptxas's registers and spills for the correlation
   forward, df1 and df2, the row gather, the block gathers
   (``lane_gather_kernel``, ``lane_gather_rows_kernel``,
   ``sublane_gather_kernel``) and both photometric and both regularizer
   kernels (each instantiation; the regularizer's with its static shared
   memory and the blocks of 256 an SM holds).  TF32 is switched off for cuDNN
   and matmul, so float32 comparisons are float32 (phase 13 starts from
   PyTorch's default and checks that the entry points turn it off).
2. Correlation forward vs plain: ``cost_volume_reference`` at the five
   decoder-level shapes of the KITTI serving recipe (batch 8, 256x832) and
   ragged shapes (W no multiple of the 32-column tile, with and without
   W % 4 == 0, H = 1, C = 1, odd C), float32 (rtol 1e-5 / atol 1e-6) and
   bfloat16 (2e-2), the JAX package's tolerances
   (benchmarks/PALLAS_VALIDATE.json); then the five training-level shapes
   (batch 2B = 16), timed, with one line of the per-level times.  Times by
   CUDA events.
3. The serving slice: a full-width FlowModel (random "pwc" weights from a
   seed, bfloat16 as serve's default) behind the port's FlowServer at
   256x832, max_batch 8; 24 requests from 8 client threads.  Every flow must
   be finite (256, 832, 2) float32, the kernel must launch 5 times per served
   batch, and one batch must agree with the plain correlation.
4. Correlation backward (df1, df2) vs ``corr_df1_reference`` /
   ``corr_df2_reference`` at the five training-level shapes (2B = 16; level 6
   splits its channel chunks over the grid) and ragged ones (phase 2's and one
   with a channel split and C no multiple of the 16-channel chunk), float32
   (1e-5 / 1e-6) and bfloat16 (2e-2); each call made twice and the two
   outputs bit-equal (no atomics).  A float32 sum of 81 products that
   cancels can sit below what float32 accumulation resolves (a C = 1 output
   of 0.088 was 3.0e-6 from the plain version's): where 1e-5 / 1e-6 fails at
   C <= 16, the output is held instead to the elementwise bound 1e-6 +
   1e-5 * |want| + 81 * 2**-24 * (1/C) * sum_k |g_k * f_k| (the last term the
   plain version on absolute values), and the line says which held.  Timed,
   with one line of the per-level df1/df2 times in both dtypes and one of
   the profiler's device time per launch (the kernel without the host's
   call, which sets the coarse levels' call times).
5. Photometric forward and backward vs ``photometric_pack_reference`` at
   the three loss scales of batch 8 at 256x832 and at ragged shapes (H and W
   no multiple of the 16 x 32 tile, odd W where the pixel pairs are loaded
   one at a time, H = 1, W = 1, H = 2): float32
   sums rtol 1e-4, weights 1e-5, d(flow) within 1e-4 of its largest value;
   bfloat16 sums and weights within 2e-2 of the plain version on the same
   inputs, and everything at the float32 tolerances against the plain
   version on the widened images (the kernel computes in float32 and never
   rounds).  Each pack launches each kernel once; two calls of each kernel
   give the same bits; each line prints a digest of the weights' bits.
   Timed (the plain backward alone, by autograd on a kept graph), with one
   line of the per-scale kernel ms, one of the profiler's device ms per
   launch (both dtypes), the per-step sums against the bound, and the device
   ms at s0 once more on smooth flows (upsampled from a field 32 times
   coarser): the per-pixel uniform flows above are the gathers' worst case.
6. The training slice: ``train()`` at the KITTI recipe (batch 8, 256x832,
   3 scales, float32), 10 steps, on in-memory snippets made from a seed,
   through the port's BatchLoader and device_prefetch.  Every loss must be
   finite, the parameters must change, and each step must launch exactly
   5 correlation forwards, 5 df1, 5 df2, 3 photometric forwards and 3
   photometric backwards.  ms/step: median interval between CUDA events
   recorded after each step.
7. Step parity at the same size, float32: the losses with the kernels vs the
   plain versions (rtol 1e-4); the gradients of the photometric losses and of
   the weighted total, over all parameters by relative L2 norm, no farther
   from the plain step's than the plain step is from itself on snippets
   moved by one ulp, or within 1e-4.  The gradient is that ill-conditioned
   by nature: an L1 term's gradient is the sign of rounding noise where its
   argument vanishes (the smoothness term between the upsampled flow's
   samples), and a bilinear warp's jumps where a sampling position crosses
   a pixel (at 256x832 a rounding-sized change of the flow moves some of the
   3.4 million positions across one).  Then 8 steps of
   ``train()`` at --precision bfloat16 --loss_precision bfloat16: finite
   losses, every bf16 kernel launched, ms/step (median CUDA-event interval
   after the first two, phase 13's bf16 step rate).
8. Regularizer forward and backward vs ``regularizer_pack_reference`` at the
   three loss scales of batch 8 at 256x832 and at ragged shapes (H and W no
   multiple of the 16 x 32 tile, odd W where the position pairs are loaded one
   at a time, W = 1, 2, 3, H = 1, 2, 3, one exact tile), on flows upsampled
   from a coarse field (their second differences vanish over large areas, as
   the decoder's upsampled flows' do): float32 sums rtol 1e-4, d(flow) within
   1e-4 of its largest value and zero where the plain gradient is zero;
   bfloat16 images within 2e-2 of the bf16 plain version and at the float32
   tolerances against the plain version on the widened images.  Each pack
   launches each kernel once; two calls of each kernel launch once each and
   give the same bits; each line prints a CRC32 of d(flow)'s bits (equal
   CRCs: equal bits, so two trees' kernels can be held to each other in one
   call).  Timed per scale in both dtypes, with one line each of the CUDA-event
   ms per call, the profiler's device ms per launch and the device ms per call
   (every kernel and memset of a call, the calls queued behind
   ``torch.cuda._sleep`` so the host is ahead), and the per-step sums against
   the bound in both dtypes.
9. Training with ``use_pallas_reg``: ``train()`` at the KITTI recipe, float32,
   5 steps, with ``test_interval`` 5 so that one interleaved evaluation runs
   on in-memory KITTI 2012/2015-shaped sets (8 pairs each, ground truth at
   375x1242 from a seed): exactly 5+5+5+3+3 launches of the other kernels and
   3+3 regularizer launches per step, plus 5 correlation launches per
   evaluation batch; the evaluation logged.  Step parity with the regularizer
   kernels against ``reg_fn=regularizer_pack_reference`` (the other kernels
   on): losses rtol 1e-4, the weighted total's gradient under phase 7's
   one-ulp rule.  Then 2 bfloat16 steps: finite, every kernel launched.
10. Evaluation: ``test._batched_flows`` over 37 synthetic pairs at 256x832
   (5 batches of 8, the last padded, exactly 5 correlation launches each),
   then ``eval_flow_avg`` against seeded ground truth at KITTI 2015's
   375x1242 with valid, noc and moving masks: the 8-column string, all
   finite, and the same metrics (within 1e-4) from the same flows on the CPU.
11. Spatial (height-sharded) inference and serving, every shard on its own
   card when there are enough, else all on ``cuda:0`` named explicitly (a
   line says which).  (a) The halo-prepadded correlation kernels
   (``corr_fwd_hpad``, ``corr_df1_hpad``, ``corr_df2_hpad``) against their
   plain versions at the per-shard shapes of the serving recipe (batch 8,
   256x832) at n = 2 and 4 and ragged shapes (3-, 1- and 5-row shards at
   phase 2's ragged widths), float32 (1e-5 / 1e-6, the backward under phase
   4's cancellation rule) and bfloat16 (2e-2), timed, with one line of the
   per-level times of all three and one of the backward's device time per
   launch.  (b) ``make_spatial_infer`` at 256x832,
   batch 8, full width, random "pwc" weights, n = 1, 2, 4, float32 and
   bfloat16: within 1e-4 * (1 + max|flow|) (float32) of the unsharded
   ``inference_flow`` on the same card and weights, or (bfloat16) no farther
   from the float32 flow than 1.2 times the unsharded bfloat16 flow is
   (each slab's convolutions sum in another order than the whole map's and
   round differently to bfloat16: ``probe.py --phases spatial_gap``), exactly
   5 * n ``corr_fwd_hpad`` launches and no other per batch; ms/batch against
   the unsharded path.  (c) The n = 4 sharded cost volume's values and both
   input gradients at the five training-level shapes (2B = 16) against the
   unsharded kernels, float32 1e-5 / 1e-6, the rows within 4 of a seam
   reported on their own; the parameter gradient of sum(flow * a fixed
   cotangent) through the n = 2 spatial path against the unsharded path, with
   exactly 10 launches of each hpad kernel: the last layer's (downstream of
   every warp and activation) within 1e-4 in relative L2, all parameters'
   under phase 7's one-ulp rule (the warps' flow derivatives and LeakyReLU's
   kink make it as ill-conditioned as the training step's).
   (d) ``FlowServer(spatial=2)`` (bfloat16) serves 8 requests from 4 client
   threads: finite (256, 832, 2) flows, 10 ``corr_fwd_hpad`` launches per
   batch and no other, and one flow held to (b)'s bfloat16 rule: no farther
   from the float32 flow of the same pair than 1.2 times the unsharded
   server's.

12. The gather probes (TPU kernel rows 11-12).  (a) ``row_gather`` against
   its plain version (``torch.gather``) at the row-gather probe's default
   shape (batch 16 at 256x832, 12 channels: 3,407,872 rows of 214,081) and
   ragged ones (3 at 45x61 with 5 channels, 2 at 17x19 with 3, 2 at 9x31 with
   128: 2-, 4-, 8- and 16-byte copies, rows wider than 4 units), two indices
   out of range (the kernel clamps them; the plain version gets them
   clamped), bfloat16 and float32;
   ``lane_gather`` and ``sublane_gather`` at the block-gather probe's shapes
   ((4096, 128) float32 and bfloat16, (8, 8192) float32) and 11 more
   (BLOCK_GATHER_CASES: W = 1, 127, 129 and 4096, one row, S = 1 and 64, S =
   8 in bfloat16, ragged ones), each on five index sets (in range, the column
   or row number, negative, past the span, within 63 of INT32_MAX and
   INT32_MIN, where the JAX kernels' int32 idx + k wraps), each call one
   launch and two calls bit-equal; every one bit for bit (``torch.equal``: a
   copy, and sums in x's dtype in the plain version's order), timed, with
   ``torch.gather`` timed beside the row gather; each block-gather line names
   the kernel csrc/gather.cu chose and its launch (threads, dynamic shared
   memory, grid, blocks an SM, registers, local bytes; ``block_gather_plan``),
   and prints the shared-memory floor (the taps at one 32-bit read each, 32 a
   clock on every SM at ``nvidia-smi``'s clocks.max.sm) beside ``bound_ms``,
   and the profiler's device ms per launch on in-range and on column-number
   indices; then one JSON line of them all.  (b) The probes' entry points
   on the card:
   ``gather_probe.main`` in every mode (default, --widths, --layout,
   --diffwarp) and ``block_gather_probe.main``: no FAIL line, and each of
   the three kernels launched (no other).
13. The entry points as a user runs them, with ``yaml`` and ``cv2`` blocked
   (``sys.modules[name] = None``; the card's machine has neither) and TF32 at
   PyTorch's default: the smoke writes a prepared directory of 8 stacked
   3-frame PNGs at KITTI's 375x1242 (the loader resizes them to 256x832),
   every PNG of the phase filtered row by row as libpng filters it (so, as
   in files cv2.imwrite or KITTI wrote, most rows are Average or Paeth), and
   a YAML file as config/kitti.yaml, then runs ``train.main(["-c", yaml,
   "--no_test", "-g", "0", ...])``: 4 float32 steps at batch 8, each through
   the training kernels (5 + 5 + 5 + 3 + 3 launches), TF32 off afterwards, a
   checkpoint written.  Then ``test.main`` with that checkpoint on a KITTI
   2015-shaped tree of 200 pairs at 375x1242, its ground truth at half size
   (188x621: the evaluation reads 600 ground-truth PNGs, and phase 10 covers
   375x1242): 5 correlation launches per batch of 8 and a finite 8-column
   table.  It prints each part's seconds, the port's PNG decode rate on those
   frames, and the training loader's
   snippets/s (decode and resize in 4 threads) beside the float32 (phase 6)
   and bfloat16 (phase 7) step rates.
14. Learning: the port's ``benchmarks/sanity_train.run`` on the card, 800
   iterations from the "torch" init at batch 4, 64x128, a 3 px shift, lr
   1e-4, seed 0, in float32 and then in bfloat16.  Each must end with an EPE
   under 0.1 px against the known flow (the JAX package's own bar; zero
   flow's is 3 px) and launch exactly 5 + 5 + 5 + 3 + 3 training kernels a
   step (and 5 correlation forwards for the scoring inference).  It prints
   each leg's EPE, mean u and v, ms/step (CUDA events) and seconds.
15. The entry points complete (``entry_points_complete``): (a) a raw KITTI
   tree (2 drives x 6 frames at 375x1242) that ``train.main`` prepares on
   its first run (``data/preparers.py``, spawned processes), then trains 4
   float32 steps at batch 8, 256x832, with ``--cache_decoded`` and
   ``--flow_pretrained_model`` a full-width ``.ckpt`` that
   ``save_flax_checkpoint`` wrote (5 + 5 + 5 + 3 + 3 launches a step); the
   loader's snippets/s from PNGs, filling the cache and from the cache,
   beside phase 13's rate and the step rates.  (b) The weights of that
   ``.ckpt`` equal bit for bit those of the ``.pth`` that ``test.main
   --task export_pth`` writes from it; a ``.ckpt`` with the trained Adam
   state restores ``exp_avg``, ``exp_avg_sq`` and ``step`` bit for bit, and
   ``train.main --resume`` from it (a model dir holding only ``last.ckpt``)
   takes one step whose change agrees with the same step in memory under
   phase 7's one-ulp rule.  (c) A trainer process (``python -m
   unopticalflow_tpu_torch.train``) sent SIGTERM after logging iteration 2
   exits 0 with ``last.pth`` at the last logged iteration, and a
   ``--resume`` continues there.  (d) ``test.main --task sintel_flow`` on a
   Sintel tree (2 pairs a pass at 436x1024, img_hw 384x832: 5 correlation
   launches a pass) and ``--task demo`` on one pair (5 launches), whose PNG
   reads back as ``flow_to_image`` of its flow and whose flow is within
   1e-4 (1 + max |flow|) of the batched flow of the same pair.  (e) The
   loop's time blocked in ``AsyncCheckpointer.save()`` against a
   synchronous ``save_checkpoint`` of the same full-width state (model and
   Adam), and the ``.ckpt`` read time (medians of 3).
16. Flow + pose (``flowpose``): (a) ``train()`` with ``--mode flowposenet``
   at config/odo.yaml's recipe (batch 8, 256x832, 3 scales) on in-memory
   snippets with KITTI's intrinsics (scaled, moved 1% from a seed), 10
   float32 and 8 bfloat16 steps: finite losses, exactly 5+5+5+3+3 launches
   a step (the pose net and the geometry launch no kernel of the port's),
   ms/step (median CUDA-event interval) beside phases 6 and 7's flow steps;
   the five losses with the kernels against ``corr_fn``/``photo_fn`` plain,
   rtol 1e-4 (float32) and 2e-2 (bfloat16), and the float32 weighted
   total's gradient over both branches under phase 7's one-ulp rule.  (b)
   ``--freeze_flow``, 3 steps: every flow tensor bit-identical, every pose
   tensor moved, 5 + 0 + 0 + 3 + 0 launches a step (the flow branch has
   ``requires_grad=False``: no backward kernel).  (c) ``train.main --mode
   flowposenet`` on a raw KITTI odometry sequence (6 frames at 375x1242) that
   ``KITTI_Odo`` prepares, 4 float32 steps (5+5+5+3+3 launches each), then a
   ``--resume``: a check of the plumbing, not of a correct odometry sample
   (``KITTI_Odo`` writes 2-frame stacks and ``dataset: kitti_odo`` reads
   them as 3-frame snippets, in the JAX package too); ``dataset: nyuv2`` at
   config/nyu_posenet_192.yaml's 192x256 on a prepared 2-frame tree (8
   snippets of 640x480 frames, NYU's calibration line), ``--mode
   flowposenet`` and ``--mode flow``, 4 steps each at 5 + 5 + 5 + 0 + 0
   launches (the plain 2-frame losses); the NYU loader's snippets/s (numpy
   undistortion, 4 threads) beside the logged step rates; on one batch of
   2-frame pairs at 192x256, each decoder level's correlation forward
   (1e-5 / 1e-6) and backward (phase 4's rule) at the shapes the step gives
   it, the losses of both modes against ``corr_fn`` plain (rtol 1e-4) and
   the float32 flowposenet gradient under phase 7's one-ulp rule.  (d)
   ``test.main --mode flowposenet --task kitti_odo`` with (c)'s
   ``last.pth`` on 16 frames at 375x1242: 16 finite pose lines, no
   kernel launch, ms a pose pair, the pose net's ms alone; then
   ``KittiEvalOdom().eval(plot=False)`` on 240 poses 1 m apart against the
   same trajectory with translations times 0.5: both errors under 1e-9
   after the Umeyama alignment.
17. The host modules without opencv, h5py or matplotlib
   (``host_modules``; fixtures of ``tests/torch_fixtures/``, written by its
   ``make_fixtures.py`` with cv2 and h5py).  (a) Every committed JPEG
   (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, grey, qualities 10 to 100, a restart
   interval, optimised tables, an odd size, an Exif orientation, a 512x832
   stacked pair) decodes to cv2's decode beside it, bit for bit; the
   progressive one raises; the host ms of decoding the pair (median of 20,
   this machine's CPU).  (b) ``FlowServer`` and its HTTP handler on the
   card at 256x832, bfloat16, ``max_batch`` 8: the JPEG pair and a PNG of
   its decoded pixels get equal ``.flo`` replies (5 + 5 launches), a
   progressive body a 400 naming the mode; the median ms of 8 requests with
   each body.  (c) ``test.main --task demo`` on two JPEG frames equals the
   demo on PNGs of their decoded pixels (5 launches each).  (d) NYUv2
   without h5py: ``NYU_Prepare`` on raw ``.ppm`` scenes this phase writes
   and the MATLAB-layout labeled set (``train.txt`` names the train scenes
   only), ``load_nyu_test_data`` equal to the JAX package's arrays (by
   SHA-256; the ``.mat`` read's ms), ``test_nyu`` with an oracle whose
   disparities are resized on the card (near-zero error, as the JAX test's
   oracle), ``eval_depth`` (both protocols) and ``eval_mask`` on seeded
   inputs equal to the JAX package's numbers (rtol 1e-6) and PNG pixels.

The second-to-last line is the kernels' JSON record (``launches`` from the
training run of phase 6, of phase 9 for the regularizer, of phase 11 (d) for
``corr_fwd_hpad`` and 11 (c)'s gradient for the hpad backward, of phase 12
(b)'s probe runs for the gathers; ``ms``/``plain_ms`` per float32 training
step: the sum over the five decoder levels or the three loss scales, for the
hpad kernels per float32 spatial batch at n = 2: 5 levels x 2 shards, for the
gathers per call at the probes' default shapes: ``row_gather`` bfloat16,
``lane_gather`` and ``sublane_gather`` float32; ``bound_ms``: the larger of
the bytes the function must move over 3.35 TB/s and its operations over 67
TFLOP/s (float32), from this run's shapes, for ``row_gather`` the source
rows that this run's indices touch, each once; ``library_ms``: the time of
``torch.gather`` on the expanded int64 index for ``row_gather``, null for
the others: no single PyTorch call computes any of them); the last line is
``{"ok": true, "device": {...}}``.  Only the CUDA path is driven: with no
GPU the script exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import pickle
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import types
import zlib

SEED = 0
# config/kitti.yaml: img_hw [256, 832], num_scales 3; serve.py: --max_batch 8,
# --precision bfloat16; train.py: --batch_size 8 (defaults)
IMG_HW = (256, 832)
BATCH = 8
N_REQUESTS = 24
N_CLIENTS = 8
TRAIN_STEPS = 10
BF16_STEPS = 8
REG_STEPS = 5  # phase 9, with one interleaved evaluation at the top of the last step
REG_BF16_STEPS = 2
SPATIAL_N = (2, 4)  # phase 11: row-shards of the 256-row frame
# phase 11: a bfloat16 sharded flow's distance to the float32 flow within this
# many times the unsharded bf16 flow's own (both round the same float32 flow;
# probe.py spatial_gap read 0.90-1.00 of it at n = 2, 4 and 8)
BF16_SPATIAL_FACTOR = 1.2
SPATIAL_REQUESTS = 8
SPATIAL_CLIENTS = 4
MD = 4  # the decoder's correlation window, +-4 px; the hpad operands carry 2 * MD more rows
EVAL_PAIRS = 37  # phase 10: 4 full batches and one padded
EVAL_SET_PAIRS = 8  # phase 9's in-memory KITTI 2012/2015 sets
KITTI_GT_HW = (375, 1242)  # KITTI 2015's ground-truth resolution
# phase 12: (B, H, W, C) of the row gather (benchmarks/gather_probe.py's
# defaults, and a ragged one); the block gathers' (kind, (S, W), dtype), the
# first of each kind the record's; REPS gathers summed per element
ROW_GATHER_CASES = {"probe": (16, 256, 832, 12), "ragged": (3, 45, 61, 5),
                    "c3": (2, 17, 19, 3), "c128": (2, 9, 31, 128)}
BLOCK_GATHER_CASES = (("lane", (4096, 128), "float32"), ("lane", (4096, 128), "bfloat16"),
                      ("sublane", (8, 8192), "float32"), ("lane", (13, 96), "bfloat16"),
                      ("sublane", (5, 333), "float32"), ("lane", (4224, 1), "bfloat16"),
                      ("lane", (2100, 127), "bfloat16"), ("lane", (2200, 129), "bfloat16"),
                      ("lane", (16, 4096), "float32"), ("lane", (3, 4096), "bfloat16"),
                      ("lane", (1, 333), "float32"), ("sublane", (1, 4096), "float32"),
                      ("sublane", (64, 1000), "float32"), ("sublane", (8, 8192), "bfloat16"))
# the block gathers' index sets (_block_indices): in range (timed), the column or
# row number (timed: neighbouring lanes start in neighbouring banks), negative,
# past the span, and within 63 of INT32_MAX and INT32_MIN, where idx + k wraps in
# the JAX kernels' int32
BLOCK_GATHER_INDICES = ("uniform", "column", "negative", "beyond", "extreme")
GATHER_PROBE_MODES = ([], ["--widths"], ["--layout"], ["--diffwarp"])
# phase 13: the entry points on PNG trees; KITTI's frames, its 2015 frame
# count, the ground truth at half size
KITTI_HW = (375, 1242)
ENTRY_STEPS = 4
ENTRY_SNIPPETS = 8
ENTRY_GT_HW = (188, 621)
ENTRY_PAIRS = 200
LOADER_SNIPPETS = 64  # 8 batches through the training loader in phase 13
# phase 14: benchmarks/sanity_train.py's learning check (the JAX harness's
# defaults but its iterations) and the JAX package's own bar for it
LEARN_ITERS = 800
LEARN_BATCH = 4
LEARN_HW = (64, 128)
LEARN_SHIFT = 3
LEARN_EPE = 0.1
# phase 15: a raw KITTI tree (2 drives of 6 frames at KITTI's size) and a
# Sintel tree (MPI-Sintel's 436x1024 frames, config/sintel.yaml's img_hw)
RAW_DRIVES = ("2011_09_26_drive_0901_sync", "2011_09_26_drive_0902_sync")
RAW_FRAMES = 6
SINTEL_HW = (436, 1024)
SINTEL_IMG_HW = (384, 832)
SAVE_REPS = 3  # phase 15 (e): saves timed, each way
# phase 16: flowposenet steps timed at config/odo.yaml's recipe (IMG_HW, BATCH),
# --freeze_flow steps, NYUv2's 640x480 frames and config/nyu_posenet_192.yaml's
# img_hw, prepared NYU snippets, and a 16-frame odometry sequence at KITTI's size
FP_STEPS = 10
FP_BF16_STEPS = 8
FREEZE_STEPS = 3
NYU_FRAME_HW = (480, 640)
NYU_HW = (192, 256)
NYU_SNIPPETS = 8
ODO_FRAMES = 16
# the H100 SXM's published peaks: HBM and float32 outside
# the tensor cores; every kernel here computes in float32
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# operations per pixel position of the loss kernels' algorithms (rounded up;
# both kernels are far below the card's float32 rate per byte moved): warps,
# weights and the 3x3 SSIM pools of both directions; the regularizer's
# second differences, edge weights and normalised flows
OPS_PER_POSITION = {"photometric_fwd": 600, "photometric_bwd": 1000,
                    "regularizer_fwd": 120, "regularizer_bwd": 200}
# (B, C, H, W) of the decoder's five cost volumes at 256x832, batch 8
SERVE_LEVELS = {
    "L6": (8, 196, 4, 13), "L5": (8, 128, 8, 26), "L4": (8, 96, 16, 52),
    "L3": (8, 64, 32, 104), "L2": (8, 32, 64, 208),
}
# training: the decoder runs at 2B = 16 ([bwd; fwd])
TRAIN_LEVELS = {k: (2 * BATCH,) + v[1:] for k, v in SERVE_LEVELS.items()}
# ragged shapes of the tiled kernels (4 x 32 output tiles, channels staged 8
# at a time forward, 16 backward): W no multiple of 32 with and without
# W % 4 == 0, H = 1, C = 1, odd C; the backward adds one whose few tiles split
# its channel chunks over the grid, with C no multiple of the chunk
RAGGED_CORR = ((2, 5, 7, 33), (2, 1, 1, 45), (1, 7, 5, 100), (2, 13, 6, 36))
RAGGED_BWD = (*RAGGED_CORR, (3, 37, 5, 19))
RAGGED_HPAD = ((2, 5, 3, 33), (2, 1, 1, 45), (1, 7, 5, 100))  # 3-, 1- and 5-row shards
# a float32 backward sum of 81 products with C at most this may cancel below
# what float32 accumulation resolves; it is then held to _hold_bwd's bound
CANCEL_MAX_C = 16
# (B, H, W) of the three loss scales
PHOTO_SCALES = {"s0": (8, 256, 832), "s1": (8, 128, 416), "s2": (8, 64, 208)}
# ragged shapes of the photometric kernels (16 x 32 tiles, two adjacent pixels
# a thread, loaded as one vector where W is even): H and W no multiple of the
# tile, odd W (scalar loads), H = 1, W = 1, H = 2 (the backward's 2-pixel halo
# wider than the image), one row of tiles with a ragged last column pair
PHOTO_RAGGED = ((1, 13, 45), (2, 37, 45), (2, 1, 40), (1, 7, 1), (2, 2, 50), (3, 17, 66),
                (1, 16, 33))
# ragged shapes of the regularizer kernels (16 x 32 tiles, two adjacent
# positions a thread, loaded as one vector where W is even): H and W no
# multiple of the tile, odd W (scalar loads), even ragged W, W = 1, 2, 3 (no
# x anchor, or one), H = 1, 2, 3 (no y anchor, or one), one exact tile, 3 x 5
# tiles
REG_RAGGED = ((1, 13, 45), (2, 37, 100), (2, 21, 70), (1, 5, 1), (1, 7, 2), (2, 9, 3),
              (2, 1, 50), (1, 2, 33), (2, 3, 130), (2, 16, 32), (1, 33, 129))
PER_STEP = {"corr_fwd": 5, "corr_bwd_df1": 5, "corr_bwd_df2": 5,
            "photometric_fwd": 3, "photometric_bwd": 3,
            "regularizer_fwd": 0, "regularizer_bwd": 0,
            "corr_fwd_hpad": 0, "corr_bwd_df1_hpad": 0, "corr_bwd_df2_hpad": 0,
            "row_gather": 0, "lane_gather": 0, "sublane_gather": 0}
PER_STEP_REG = {**PER_STEP, "regularizer_fwd": 3, "regularizer_bwd": 3}
# a --freeze_flow step (no backward through the flow branch) and a 2-frame
# step (the plain photometric losses, as the JAX forward_pair)
PER_STEP_FROZEN = {**PER_STEP, "corr_bwd_df1": 0, "corr_bwd_df2": 0, "photometric_bwd": 0}
PER_STEP_PAIR = {**PER_STEP, "photometric_fwd": 0, "photometric_bwd": 0}
KERNELS = {
    "corr_fwd": ("unopticalflow_tpu_torch/csrc/correlation.cu",
                 "unopticalflow_tpu/ops/pallas_kernels.py:59"),
    "corr_bwd_df1": ("unopticalflow_tpu_torch/csrc/correlation.cu",
                     "unopticalflow_tpu/ops/pallas_kernels.py:72"),
    "corr_bwd_df2": ("unopticalflow_tpu_torch/csrc/correlation.cu",
                     "unopticalflow_tpu/ops/pallas_kernels.py:85"),
    "photometric_fwd": ("unopticalflow_tpu_torch/csrc/photometric.cu",
                        "unopticalflow_tpu/ops/pallas_photometric.py:198"),
    "photometric_bwd": ("unopticalflow_tpu_torch/csrc/photometric.cu",
                        "unopticalflow_tpu/ops/pallas_photometric.py:261"),
    "regularizer_fwd": ("unopticalflow_tpu_torch/csrc/regularizer.cu",
                        "unopticalflow_tpu/ops/pallas_regularizer.py:151"),
    "regularizer_bwd": ("unopticalflow_tpu_torch/csrc/regularizer.cu",
                        "unopticalflow_tpu/ops/pallas_regularizer.py:179"),
    "corr_fwd_hpad": ("unopticalflow_tpu_torch/csrc/correlation.cu",
                      "unopticalflow_tpu/ops/pallas_spmd.py:58"),
    "corr_bwd_df1_hpad": ("unopticalflow_tpu_torch/csrc/correlation.cu",
                          "unopticalflow_tpu/ops/pallas_spmd.py:80"),
    "corr_bwd_df2_hpad": ("unopticalflow_tpu_torch/csrc/correlation.cu",
                          "unopticalflow_tpu/ops/pallas_spmd.py:104"),
    "row_gather": ("unopticalflow_tpu_torch/csrc/gather.cu", "benchmarks/gather_probe.py:352"),
    "lane_gather": ("unopticalflow_tpu_torch/csrc/gather.cu",
                    "benchmarks/pallas_gather_probe.py:42"),
    "sublane_gather": ("unopticalflow_tpu_torch/csrc/gather.cu",
                       "benchmarks/pallas_gather_probe.py:50"),
}
PHOTO_W = {"loss_pixel": 0.15, "loss_ssim": 0.85, "loss_flow_smooth": 0.0,
           "loss_flow_consis": 0.0}


def _time_ms(torch, fn, reps: int = 15, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _device_ms(torch, fn, pattern: str, calls: int = 10, tries: int = 3) -> str:
    """Device ms per launch of the kernels whose name holds ``pattern``
    (``torch.profiler``): the kernel alone, without the host's launch.  The
    profiler now and then reports no device event for a window; after
    ``tries`` such windows this says "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA and pattern in e.key]
        n = sum(e.count for e in found)
        if n:
            return f"{sum(e.self_device_time_total for e in found) / 1e3 / n:.5f}"
    return "not measured"


def _queued_ms(torch, fn, calls: int = 20, reps: int = 5) -> float:
    """Device ms of one call of ``fn``: every kernel and memset it launches
    and the gaps between them, without the host's time.  The calls are queued
    behind ``torch.cuda._sleep`` (20M cycles, ~11 ms, far longer than the host
    takes to enqueue them) and timed by CUDA events recorded after the sleep;
    median of ``reps``.  (The profiler's per-event times can miss part of a
    window, so a sum of them under-reads a call.)"""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _block_indices(rng, shape, span: int, kind: str, name: str):
    """int32 indices of one of BLOCK_GATHER_INDICES for a block gather of
    ``shape`` whose taps wrap modulo ``span``."""
    import numpy as np

    if name == "uniform":
        i = rng.randint(0, span, shape)
    elif name == "column":
        i = np.broadcast_to(np.arange(shape[1]) if kind == "lane"
                            else np.arange(shape[0])[:, None], shape)
    elif name == "negative":
        i = rng.randint(-10 * span - 7, 0, shape)
    elif name == "beyond":
        i = rng.randint(span, 10 * span + 7, shape)
    else:
        i = np.where(rng.rand(*shape) < 0.5, 2**31 - 1 - rng.randint(0, 64, shape),
                     -2**31 + rng.randint(0, 64, shape))
    return np.ascontiguousarray(i).astype(np.int32)


def _ptxas_registers(log: str, kernel: str) -> list[str]:
    """"<mangled name>: N registers, S bytes smem" (and the spill stores, if
    any) for each instantiation of ``kernel`` in an ``nvcc -Xptxas -v``
    report."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name and kernel in name:
            out.append(f"{name}: {m.group(1)} registers, {m.group(2) or 0} bytes smem")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name and kernel in name and m.group(1) != "0":
            out.append(f"{name}: {m.group(1)} bytes spill stores")
    return out or [f"no report for {kernel}"]


def _blocks_per_sm(registers: int, smem: int, threads: int = 256) -> int:
    """Blocks of ``threads`` an H100 SM holds at that many registers a thread
    and bytes of static shared memory a block: registers go to warps in units
    of 256 of the SM's 65,536; the SM's 233,472 bytes of shared memory hold
    1 KB reserved a block; at most 2,048 threads and 32 blocks."""
    warps = threads // 32
    by_regs = 65536 // (-(-registers * 32 // 256) * 256) // warps
    return min(by_regs, 233472 // (smem + 1024), 2048 // threads, 32)


def _hold_bwd(torch, got, want, rtol, atol, abs_ref) -> str:
    """Hold a correlation backward to its plain version: assert_close at
    (rtol, atol); where that fails in float32 at C <= CANCEL_MAX_C, the
    elementwise bound atol + rtol * |want| + 81 * 2**-24 * abs_ref, with
    abs_ref() the plain version on |g| and |f| ((1/C) sum_k |g_k * f_k|: what
    rounding 81 float32 terms can move a sum that cancels).  Says which held."""
    try:
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
        return "tolerance"
    except AssertionError:
        if got.dtype != torch.float32 or got.shape[1] > CANCEL_MAX_C:
            raise
    bound = atol + rtol * want.abs() + 81 * 2.0 ** -24 * abs_ref()
    excess = float(((got - want).abs() - bound).max())
    if excess > 0:
        raise AssertionError(f"float32 backward beyond the cancellation bound by {excess:.3e}")
    return "cancellation bound"


def _values(res: str) -> list[float]:
    return [float(v) for v in res.split("\n")[1].split(",")]


def _launched(counts: dict) -> dict:
    """The kernels of ``counts`` that launched."""
    return {k: v for k, v in counts.items() if v}


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def depth_mask_inputs(seed: int):
    """Seeded inputs of phase 17 (d)'s ``eval_depth`` and ``eval_mask`` (and
    of ``tests/torch_fixtures/make_fixtures.py``, which stores the JAX
    package's results on them): two ground-truth depth maps and predictions,
    and two float32 mask predictions with their binary ground truths."""
    import numpy as np

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:96, 0:160].astype(np.float64)
    gts = [12.0 + 4.0 * np.sin(xx / 17.0 + k) + 3.0 * np.cos(yy / 13.0 - k) for k in range(2)]
    for g in gts:
        g[rng.rand(*g.shape) < 0.1] = 0.0  # pixels without ground truth
    preds = [(g + 2.0 * rng.rand(*g.shape) + 0.5) * (1.0 + k) for k, g in enumerate(gts)]
    masks = [rng.rand(24, 40).astype(np.float32) for _ in range(2)]
    gt_masks = [(rng.rand(48, 80) > 0.6).astype(np.uint8) for _ in range(2)]
    return gts, preds, masks, gt_masks


def host_modules(c) -> None:
    """Phase 17 (see the module): ``c`` holds the device, the precision and
    size the server runs at, the launch counters (``want`` maps an expected
    count to what this device launches), ``sync``, the entry points' device
    flags ``cli``, ``smi`` and a work directory ``root``."""
    import glob
    import hashlib
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from unopticalflow_tpu_torch import test as evaluation
    from unopticalflow_tpu_torch.data import preparers
    from unopticalflow_tpu_torch.evaluation import depth_harness, eval_depth, eval_mask
    from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig
    from unopticalflow_tpu_torch.serve import FlowServer, make_handler
    from unopticalflow_tpu_torch.utils import imageio

    t17 = time.perf_counter()
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                            "torch_fixtures")
    jpeg_dir, nyu_dir = os.path.join(fixtures, "jpeg"), os.path.join(fixtures, "nyu")
    zero_counts = dict.fromkeys(KERNELS, 0)
    counts, reset_counts = c.counts, c.reset_counts
    os.makedirs(c.root, exist_ok=True)

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    # (a) the committed JPEGs against cv2's decodes
    checked = []
    for path in sorted(glob.glob(os.path.join(jpeg_dir, "*.jpg"))):
        name = os.path.basename(path)[:-4]
        if name == "progressive":
            try:
                imageio.decode_jpeg(read(path))
            except ValueError as e:
                if "progressive" not in str(e):
                    raise
            else:
                raise AssertionError("a progressive JPEG decoded")
            continue
        got = imageio.decode_jpeg(read(path))
        want = imageio.decode_png(read(path[:-4] + ".png"))
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"JPEG {name}: differs from cv2's decode")
        checked.append(name)
    pair_jpg = read(os.path.join(jpeg_dir, "pair_512x832.jpg"))
    t_dec = []
    for _ in range(20):
        t0 = time.perf_counter()
        pair_px = imageio.decode_jpeg(pair_jpg)
        t_dec.append((time.perf_counter() - t0) * 1e3)
    print(f"host modules (a): {len(checked)} JPEGs decode bit-equal to cv2's decodes "
          f"({', '.join(checked)}), the progressive one raises; decoding the {pair_px.shape[0]}x"
          f"{pair_px.shape[1]} stacked pair: {statistics.median(t_dec):.3f} ms on the host "
          f"(median of 20, one thread; {c.smi})")

    # (b) serving JPEG bodies on the card
    h, w = c.img_hw
    cfg = types.SimpleNamespace(img_hw=c.img_hw)
    model = FlowModel(FlowModelConfig(compute_dtype=c.precision), device=c.device, scheme="pwc",
                      generator=torch.Generator().manual_seed(SEED + 17))
    server = FlowServer(cfg, model, max_batch=c.batch, max_wait_ms=5.0)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server, cfg))
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()
    pair_png = imageio.encode_png(pair_px)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/flow"

    def post(body):
        req = urllib.request.Request(url, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.read()

    try:
        reset_counts()
        replies = [post(pair_jpg), post(pair_png)]
        served = counts()
        try:
            post(read(os.path.join(jpeg_dir, "progressive.jpg")))
        except urllib.error.HTTPError as e:
            refusal = (e.code, json.loads(e.read())["error"])
        else:
            refusal = (200, "")
        lat = {}
        for kind, body in (("jpeg", pair_jpg), ("png", pair_png)):
            lat[kind] = []
            for _ in range(8):
                t0 = time.perf_counter()
                post(body)
                lat[kind].append((time.perf_counter() - t0) * 1e3)
    finally:
        httpd.shutdown()
        httpd.server_close()
        serving.join(timeout=10)
        server.close()
    flow = np.frombuffer(replies[0][12:], np.float32).reshape(-1)
    if replies[0] != replies[1] or flow.size != h * w * 2 or not np.isfinite(flow).all() \
            or served != c.want({**zero_counts, "corr_fwd": 10}) or refusal[0] != 400 \
            or "progressive JPEG" not in refusal[1]:
        raise AssertionError(f"serving JPEG: replies equal {replies[0] == replies[1]}, "
                             f"{flow.size} values, launches {served}, refusal {refusal}")
    print(f"host modules (b): FlowServer + HTTP on {c.device} at {h}x{w}, {c.precision}, "
          f"max_batch {c.batch}: the JPEG pair and a PNG of its decoded pixels get equal .flo "
          f"replies ({len(replies[0])} bytes), {served['corr_fwd']} corr_fwd launches; a "
          f"progressive body: {refusal[0]} {refusal[1]!r}; median ms a request (8 in turn, "
          f"decode + resize + inference + reply): JPEG {statistics.median(lat['jpeg']):.2f}, "
          f"PNG {statistics.median(lat['png']):.2f} ({c.smi})")

    # (c) the demo on JPEG frames against the demo on PNGs of their pixels
    pth = evaluation.export_pth(os.path.join(c.root, "demo.pth"), model)
    del model
    yaml = os.path.join(c.root, "demo.yaml")
    with open(yaml, "w") as f:
        f.write(f"img_hw: [{h}, {w}]\nnum_scales: 3\n")
    frames = {}
    for k in ("a", "b"):
        jpg = os.path.join(jpeg_dir, f"frame_{k}.jpg")
        png = os.path.join(c.root, f"frame_{k}.png")
        imageio.imwrite(png, imageio.decode_jpeg(read(jpg)))
        frames[k] = (jpg, png)
    demo, demo_counts = {}, {}
    for kind, idx in (("jpeg", 0), ("png", 1)):
        reset_counts()
        demo[kind] = evaluation.main([
            "-c", yaml, "--task", "demo", "--pretrained_model", pth, "--image_path",
            frames["a"][idx], "--image_path2", frames["b"][idx], "--result_dir",
            os.path.join(c.root, f"demo_{kind}"), *c.cli])
        demo_counts[kind] = counts()
    if not np.array_equal(demo["jpeg"], demo["png"]) or demo["jpeg"].shape != (h, w, 2) \
            or any(v != c.want({**zero_counts, "corr_fwd": 5}) for v in demo_counts.values()):
        raise AssertionError(f"demo on JPEG frames: equal to PNG "
                             f"{np.array_equal(demo['jpeg'], demo['png'])}, launches {demo_counts}")
    print(f"host modules (c): test.main --task demo on two JPEG frames equals the demo on PNGs "
          f"of their decoded pixels ({h}x{w} flow, mean |flow| "
          f"{float(np.abs(demo['jpeg']).mean()):.4f} px), "
          f"{demo_counts['jpeg']['corr_fwd']} corr_fwd launches each")

    # (d) NYUv2 without h5py: the preparer, the test split, the metrics
    with open(os.path.join(nyu_dir, "expected.json")) as f:
        expected = json.load(f)

    def digest(*arrays):
        hd = hashlib.sha256()
        for a in arrays:
            a = np.ascontiguousarray(a)
            hd.update(str(a.dtype.str).encode() + str(a.shape).encode() + a.tobytes())
        return hd.hexdigest()

    blocked = {m: sys.modules.get(m) for m in ("h5py", "cv2", "matplotlib", "PIL")}
    try:
        for m in blocked:
            sys.modules[m] = None  # as on a machine without them
        raw = os.path.join(c.root, "nyu_raw")
        rng = np.random.RandomState(SEED + 17)
        for k, scene in enumerate(expected["train_scenes"] + expected["test_scenes"]):
            folder = os.path.join(raw, f"d{k % 2}", scene)
            os.makedirs(folder, exist_ok=True)
            for i in range(12):
                img = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
                with open(os.path.join(folder, f"r-{1000 + i:06d}.ppm"), "wb") as f:
                    f.write(b"P6\n64 48\n255\n" + img.tobytes())
        prepared = os.path.join(c.root, "nyu_prepared")
        prep = preparers.NYU_Prepare(raw, nyu_dir)
        scenes = (prep.get_train_scenes(), prep.get_test_scenes())
        prep.prepare_data_mp(prepared, stride=5, num_processes=2)
        with open(os.path.join(prepared, "train.txt")) as f:
            lines = f.read().splitlines()
        named = sorted({ln.split()[0].split("/")[1] for ln in lines})
        t0 = time.perf_counter()
        test_images, test_depths = depth_harness.load_nyu_test_data(nyu_dir)
        t_mat = (time.perf_counter() - t0) * 1e3
        gt_crop = test_depths[0][45:472, 41:602]

        def oracle(images):  # the ground truth's disparity, resized on the card
            disp = torch.from_numpy(1.0 / gt_crop).to(c.device, torch.float32)[None, None]
            return torch.nn.functional.interpolate(disp, size=images.shape[1:3],
                                                   mode="bilinear", align_corners=False)[0]

        nyu_res = depth_harness.test_nyu(types.SimpleNamespace(img_hw=(192, 256)), oracle,
                                         test_images, test_depths, file=io.StringIO())
        gts, preds, masks, gt_masks = depth_mask_inputs(17)
        depth_res = eval_depth(gts, preds)
        depth_res_nyu = eval_depth(gts, preds, nyu=True)
        trace = os.path.join(c.root, "mask_trace")
        mask_res = eval_mask(masks, gt_masks, types.SimpleNamespace(trace=trace))
        pngs = {n: digest(imageio.imread(os.path.join(trace, "pred_mask", n),
                                         imageio.IMREAD_UNCHANGED))
                for n in sorted(os.listdir(os.path.join(trace, "pred_mask")))}
    finally:
        for m, mod in blocked.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod

    def close(got, want):
        return np.allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                           rtol=1e-6, atol=0)

    faults = []
    if [list(x) for x in scenes] != [expected["train_scenes"], expected["test_scenes"]] \
            or named != sorted(expected["train_scenes"]) or not lines:
        faults.append(f"NYU_Prepare: scenes {scenes}, train.txt names {named}")
    if digest(test_images) != expected["test_images_sha256"] \
            or digest(test_depths) != expected["test_depths_sha256"]:
        faults.append(f"load_nyu_test_data: {test_images.shape}, {test_depths.shape} differ")
    if not (nyu_res[0] < 0.05 and nyu_res[4] > 0.95):
        faults.append(f"test_nyu oracle: {nyu_res}")
    if not close(depth_res, expected["eval_depth"]) \
            or not close(depth_res_nyu, expected["eval_depth_nyu"]):
        faults.append(f"eval_depth: {depth_res}, {depth_res_nyu}")
    if not close(mask_res[:4], expected["eval_mask"][:4]) \
            or not close(mask_res[4], expected["eval_mask"][4]) \
            or pngs != expected["eval_mask_png_pixels_sha256"]:
        faults.append(f"eval_mask: {mask_res}, PNGs equal "
                      f"{pngs == expected['eval_mask_png_pixels_sha256']}")
    if faults:
        raise AssertionError("; ".join(faults))
    print(f"host modules (d), h5py, cv2, matplotlib and PIL blocked: NYU_Prepare's train.txt "
          f"({len(lines)} snippets) names {named}; load_nyu_test_data equals the JAX "
          f"package's arrays {list(test_images.shape)} uint8 and {list(test_depths.shape)} "
          f"float32, the .mat read (3 frames of 640x480, test split 1) in {t_mat:.1f} ms on "
          f"the host; test_nyu with an oracle on {c.device}: abs_rel {nyu_res[0]:.5f}, a1 "
          f"{nyu_res[4]:.5f}; eval_depth and eval_mask equal the JAX package's numbers "
          f"(rtol 1e-6) and PNG pixels")
    print(f"host modules: phase 17 took {time.perf_counter() - t17:.1f} s")


def entry_points_complete(c) -> None:
    """Phase 15 (see the module): ``c`` holds the run's device, shapes,
    launch counters (``want`` maps an expected count to what this device
    launches), ``sync``, the entry points' device flags ``cli`` and the
    earlier phases' rates."""
    import numpy as np
    import torch

    from unopticalflow_tpu_torch import test as evaluation
    from unopticalflow_tpu_torch import train as train_cli
    from unopticalflow_tpu_torch.data.loader import BatchLoader
    from unopticalflow_tpu_torch.data.synthetic import SyntheticSnippets
    from unopticalflow_tpu_torch.evaluation.flowlib import encode_flow, flow_to_image
    from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig
    from unopticalflow_tpu_torch.training import loss_weights_from_config, make_optimizer, train_step
    from unopticalflow_tpu_torch.utils import checkpoint as ckpt
    from unopticalflow_tpu_torch.utils import imageio

    device, (h, w), batch_n = c.device, c.img_hw, c.batch
    per_step = c.want(PER_STEP)
    zero_counts = dict.fromkeys(KERNELS, 0)
    counts, reset_counts = c.counts, c.reset_counts

    t15 = time.perf_counter()
    root15 = c.root
    raw = os.path.join(root15, "kitti_raw", "2011_09_26")
    frames15 = SyntheticSnippets(c.kitti_hw, 4, seed=SEED + 15).snippets[:4].reshape(
        4 * 3, c.kitti_hw[0], c.kitti_hw[1], 3)
    for d, drive in enumerate(RAW_DRIVES):
        img_dir = os.path.join(raw, drive, "image_02", "data")
        os.makedirs(img_dir, exist_ok=True)
        for i in range(RAW_FRAMES):
            imageio.imwrite(os.path.join(img_dir, f"{i:010d}.png"), frames15[d * RAW_FRAMES + i])
    with open(os.path.join(raw, "calib_cam_to_cam.txt"), "w") as f:
        f.write("P_rect_02: 721.5 0.0 609.6 44.9 0.0 721.5 172.9 0.2 0.0 0.0 1.0 0.003\n")
    lists = {"static_frames_txt": "2011_09_26 2011_09_26_drive_0009_sync 0000000001\n",
             "test_scenes_txt": "2011_09_26_drive_0117\n"}
    for key, text in lists.items():
        with open(os.path.join(root15, key + ".txt"), "w") as f:
            f.write(text)
    prepared15 = os.path.join(root15, "prepared")

    def yaml15(name, **over):
        keys = {"raw_base_dir": f"'{os.path.dirname(raw)}'",
                "prepared_base_dir": f"'{prepared15}'",
                **{k: f"'{os.path.join(root15, k + '.txt')}'" for k in lists},
                "dataset": "'kitti_depth'", "num_scales": 3, "num_iterations": c.steps,
                "w_ssim": 0.85, "w_flow_smooth": 10.0, "w_flow_consis": 0.01,
                "img_hw": f"[{h}, {w}]", **over}
        path = os.path.join(root15, name)
        with open(path, "w") as f:
            f.write("".join(f"{k}: {v}\n" for k, v in keys.items()))
        return path

    # (a) a full-width .ckpt, then the trainer: preparation, cache, warm start
    warm = FlowModel(FlowModelConfig(), device=c.device, scheme="pwc",
                     generator=torch.Generator().manual_seed(SEED + 15))
    warm_ckpt = os.path.join(root15, "warm.ckpt")
    ckpt.save_flax_checkpoint(warm_ckpt, 0, warm)
    yaml_a = yaml15("kitti_raw.yaml")
    dir_a = os.path.join(root15, "models_a")
    reset_counts()
    t0 = time.perf_counter()
    out_a = io.StringIO()
    with contextlib.redirect_stdout(out_a):
        rc = train_cli.main(["-c", yaml_a, "--no_test", "--batch_size", str(batch_n),
                             "--num_workers", "4", "--log_interval", "1", "--save_interval",
                             "1000", "--cache_decoded", "--flow_pretrained_model", warm_ckpt,
                             "--model_dir", dir_a, *c.cli])
    c.sync()
    t_a = time.perf_counter() - t0
    counts_a = counts()
    prep15 = os.path.join(prepared15, "data_s1")
    cache15 = os.path.join(prep15, f"decoded_cache_{h}x{w}")
    n_manifest = sum(1 for _ in open(os.path.join(prep15, "train.txt")))
    last_a = os.path.join(dir_a, "flow", "last.pth")
    log_a = out_a.getvalue()
    if rc != 0 or counts_a != {k: c.steps * v for k, v in per_step.items()} \
            or "Data Preparation Finished." not in log_a \
            or f"Load Flow Pretrained Model from {warm_ckpt}" not in log_a \
            or n_manifest != len(RAW_DRIVES) * (RAW_FRAMES - 2) or not os.path.isdir(cache15) \
            or not os.path.exists(last_a) or log_a.count("loss_pixel") != c.steps:
        raise AssertionError(f"train.main (prepare, --cache_decoded, warm start): rc {rc}, "
                             f"launches {counts_a}, {n_manifest} snippets, log:\n{log_a}")
    loader_rates = {}
    for name, cache in (("PNG", None), ("cache (cold)", cache15), ("cache (warm)", cache15)):
        if name == "cache (cold)":
            shutil.rmtree(cache15)
        ds = train_cli.PREPARED["kitti_depth"](prep15, num_scales=3, img_hw=c.img_hw,
                                               num_iterations=c.loader_snippets, cache_dir=cache,
                                               emit_uint8=True)
        t0 = time.perf_counter()
        n_loaded = sum(len(b) for b in BatchLoader(ds, batch_size=batch_n, num_workers=4))
        loader_rates[name] = n_loaded / (time.perf_counter() - t0)
    print(f"entry points complete (a): raw KITTI tree of {len(RAW_DRIVES)} drives x "
          f"{RAW_FRAMES} frames at {c.kitti_hw} prepared by train.main into {n_manifest} "
          f"snippets, then {c.steps} float32 steps at batch {batch_n} {h}x{w} warm-started "
          f"from a full-width .ckpt with --cache_decoded in {t_a:.2f} s, launches {counts_a}; "
          f"loader snippets/s (4 threads, {c.loader_snippets} snippets of {len(RAW_DRIVES) * 4}): "
          + ", ".join(f"{k} {v:.1f}" for k, v in loader_rates.items())
          + f"; phase 13's from PNGs {c.loader_rate:.1f}; steps "
          + ", ".join(f"{k} {v:.1f}" for k, v in c.need.items()) + f" ({c.smi})")

    # (b) the .ckpt against the .pth that export_pth writes from it, and a resume
    reset_counts()
    export = evaluation.main(["-c", yaml_a, "--task", "export_pth", "--pretrained_model",
                              warm_ckpt, "--output_pth", os.path.join(root15, "warm.pth"),
                              *c.cli])
    from_ckpt, from_pth = (FlowModel(FlowModelConfig(), device=c.device) for _ in range(2))
    it_ckpt = ckpt.load_pretrained(from_ckpt, warm_ckpt)
    it_pth = ckpt.load_pretrained(from_pth, export)
    same = [torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(
        from_ckpt.state_dict().values(), from_pth.state_dict().values(),
        warm.state_dict().values())]
    if not all(same) or (it_ckpt, it_pth) != (0, 0) or counts() != zero_counts:
        raise AssertionError(f".ckpt and export_pth: {sum(same)} of {len(same)} tensors "
                             f"bit-equal, iterations {it_ckpt} {it_pth}")
    del from_ckpt, from_pth, warm

    src_model = FlowModel(FlowModelConfig(), device=c.device)
    src_opt = make_optimizer(src_model)
    it_src = ckpt.restore_checkpoint(last_a, src_model, src_opt)
    dir_b = os.path.join(root15, "models_b", "flow")
    os.makedirs(dir_b, exist_ok=True)
    ckpt.save_flax_checkpoint(os.path.join(dir_b, "last.ckpt"), it_src, src_model, src_opt)
    back = FlowModel(FlowModelConfig(), device=c.device)
    back_opt = make_optimizer(back)
    it_back = ckpt.restore_checkpoint(os.path.join(dir_b, "last.ckpt"), back, back_opt)
    bad = []
    for (name, p), q in zip(src_model.named_parameters(), back.parameters()):
        s_, t_ = src_opt.state[p], back_opt.state[q]
        if not (torch.equal(p, q) and torch.equal(s_["exp_avg"], t_["exp_avg"])
                and torch.equal(s_["exp_avg_sq"], t_["exp_avg_sq"])
                and float(s_["step"]) == float(t_["step"]) == it_src + 1):
            bad.append(name)
    if bad or it_back != it_src:
        raise AssertionError(f".ckpt resume state: iteration {it_back} != {it_src} or not "
                             f"bit-equal: {bad[:5]}")
    del back, back_opt
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()) as out_b:
        rc = train_cli.main(["-c", yaml15("resume.yaml", num_iterations=it_src + 1),
                             "--no_test", "--batch_size", str(batch_n), "--num_workers", "4",
                             "--log_interval", "1", "--resume", "--model_dir",
                             os.path.dirname(dir_b), *c.cli])
    counts_b = counts()
    if rc != 0 or counts_b != per_step \
            or f"resumed from {os.path.join(dir_b, 'last.ckpt')} at iteration {it_src}." \
            not in out_b.getvalue():
        raise AssertionError(f"--resume from .ckpt: rc {rc}, launches {counts_b}, log:\n"
                             f"{out_b.getvalue()}")
    resumed = torch.load(os.path.join(dir_b, "last.pth"), map_location=device,
                         weights_only=True)["model_state_dict"]
    ds = train_cli.PREPARED["kitti_depth"](prep15, num_scales=3, img_hw=c.img_hw,
                                           num_iterations=batch_n, emit_uint8=True)
    batch15 = torch.from_numpy(np.stack([ds[i] for i in range(batch_n)])).to(device)
    start = {k: v.detach().clone() for k, v in src_model.state_dict().items()}

    def one_step(x):
        m_ = FlowModel(FlowModelConfig(), device=c.device)
        o_ = make_optimizer(m_)
        ckpt.restore_checkpoint(last_a, m_, o_)
        train_step(m_, o_, x, loss_weights_from_config(train_cli.recipe_config()), FlowModelConfig())
        return m_.state_dict()

    def delta(sd):
        return torch.cat([(sd[k].float() - start[k]).ravel() for k in sorted(start)])

    mem = delta(one_step(batch15))
    nudged15 = torch.nextafter(batch15.float() / 255.0, torch.tensor(2.0, device=c.device))
    noise15 = _rel_l2(delta(one_step(nudged15)), mem)
    err15 = _rel_l2(delta(resumed), mem)
    print(f"entry points complete (b): export_pth's .pth and the .ckpt load bit-equal weights "
          f"({len(same)} tensors); a .ckpt with Adam state restores exp_avg, exp_avg_sq and "
          f"step (= {it_src + 1}) bit for bit; train.main --resume from it: {counts_b} "
          f"launches, one step's change vs the same step in memory rel L2 {err15:.3e} "
          f"(snippets one ulp away {noise15:.3e})")
    if err15 > max(1e-4, noise15):
        raise AssertionError("the step resumed from .ckpt departs from the step in memory")
    del src_opt, start

    # (c) preemption: SIGTERM to a trainer process after iteration 2
    dir_c = os.path.join(root15, "models_c")
    cmd = [sys.executable, "-u", "-m", "unopticalflow_tpu_torch.train", "-c",
           yaml15("long.yaml", num_iterations=100000), "--no_test", "--batch_size", str(batch_n),
           "--num_workers", "4", "--log_interval", "1", "--save_interval", "100000",
           "--init_scheme", "pwc", "--model_dir", dir_c, *c.cli]
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=repo, env=env)
    seen, t_sig = [], None
    try:
        import selectors

        with selectors.DefaultSelector() as sel:
            sel.register(proc.stdout, selectors.EVENT_READ)
            while t_sig is None and time.perf_counter() - t0 < 300:
                if not sel.select(timeout=1):
                    continue
                line = proc.stdout.readline()
                if not line and proc.poll() is not None:
                    break
                seen.append(line)
                if line.startswith("iter: 2,"):
                    proc.send_signal(signal.SIGTERM)
                    t_sig = time.perf_counter()
        if t_sig is None:
            raise AssertionError("preemption: the trainer never logged iteration 2:\n"
                                 + "".join(seen[-30:]))
        rest, _ = proc.communicate(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    t_exit = time.perf_counter() - t_sig
    log_c = "".join(seen) + rest
    logged = [int(x) for x in re.findall(r"^iter: (\d+),", log_c, flags=re.M)]
    last_c = os.path.join(dir_c, "flow", "last.pth")
    stored = (torch.load(last_c, map_location="cpu", weights_only=True)["iteration"]
              if os.path.exists(last_c) else None)
    if proc.returncode != 0 or not logged or stored != logged[-1] \
            or f"preemption signal {int(signal.SIGTERM)}" not in log_c:
        raise AssertionError(f"preemption: exit {proc.returncode}, last.pth at {stored}, "
                             f"logged {logged}, log:\n{log_c[-3000:]}")
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()) as out_c:
        rc = train_cli.main(["-c", yaml15("more.yaml", num_iterations=stored + 2), "--no_test",
                             "--batch_size", str(batch_n), "--num_workers", "4", "--log_interval",
                             "1", "--resume", "--model_dir", dir_c, *c.cli])
    resumed_iters = [int(x) for x in re.findall(r"^iter: (\d+),", out_c.getvalue(), flags=re.M)]
    if rc != 0 or resumed_iters != [stored, stored + 1] \
            or counts() != {k: 2 * v for k, v in per_step.items()}:
        raise AssertionError(f"resume after preemption: rc {rc}, iterations {resumed_iters}")
    print(f"entry points complete (c): SIGTERM after iteration 2 of a trainer process: exit 0 "
          f"{t_exit:.2f} s after the signal, last.pth at iteration {stored} (the last logged), "
          f"--resume continued at iterations {resumed_iters}")

    # (d) sintel_flow and demo through the correlation kernel
    sintel = os.path.join(root15, "sintel", "training")
    sh, sw = c.sintel_hw
    sframes = SyntheticSnippets(c.sintel_hw, 1, seed=SEED + 16).snippets[0]
    yy, xx = np.mgrid[0:sh, 0:sw].astype(np.float32)
    for sub in ("clean", "final", "flow", "occlusions"):
        os.makedirs(os.path.join(sintel, sub, "alley_1"), exist_ok=True)
    for n in (1, 2, 3):
        for sub in ("clean", "final"):
            imageio.imwrite(os.path.join(sintel, sub, "alley_1", f"frame_{n:04d}.png"),
                            np.ascontiguousarray(sframes[(n - 1) * sh:n * sh]))
    for n in (1, 2):
        flo = np.dstack([2.0 + 0.5 * np.sin(yy / 40.0), 1.0 + 0.5 * np.cos(xx / 50.0)])
        with open(os.path.join(sintel, "flow", "alley_1", f"frame_{n:04d}.flo"), "wb") as f:
            f.write(encode_flow(flo.astype(np.float32)))
        imageio.imwrite(os.path.join(sintel, "occlusions", "alley_1", f"frame_{n:04d}.png"),
                        ((xx > sw - 4) * 255).astype(np.uint8))
    yaml_d = os.path.join(root15, "sintel.yaml")
    with open(yaml_d, "w") as f:
        f.write(f"img_hw: [{c.sintel_img_hw[0]}, {c.sintel_img_hw[1]}]\nnum_scales: 3\n"
                f"sintel_training_dir: '{sintel}'\n")
    kept = []
    batched = evaluation._batched_flows

    def keep(*a, **k):
        kept.append(batched(*a, **k))
        return kept[-1]

    reset_counts()
    t0 = time.perf_counter()
    evaluation._batched_flows = keep
    try:
        sres = evaluation.main(["-c", yaml_d, "--task", "sintel_flow", "--pretrained_model",
                                export, *c.cli])
    finally:
        evaluation._batched_flows = batched
    sintel_counts = counts()
    reset_counts()
    demo_dir = os.path.join(root15, "demo")
    pair = [os.path.join(sintel, "clean", "alley_1", f"frame_{n:04d}.png") for n in (1, 2)]
    dflow = evaluation.main(["-c", yaml_d, "--task", "demo", "--pretrained_model", warm_ckpt,
                             "--image_path", pair[0], "--image_path2", pair[1],
                             "--result_dir", demo_dir, *c.cli])
    demo_counts = counts()
    t_d = time.perf_counter() - t0
    png = imageio.imread(os.path.join(demo_dir, "demo_flow.png"))
    first = kept[0][0].cpu().numpy()
    peak = float(np.abs(first).max())
    gap = float(np.abs(dflow - first).max())
    svals = {k: _values(v) for k, v in sres.items()}
    if sorted(svals) != ["clean", "final"] \
            or not all(len(v) == 4 and all(math.isfinite(x) for x in v) for v in svals.values()) \
            or sintel_counts != c.want({**zero_counts, "corr_fwd": 10}) \
            or demo_counts != c.want({**zero_counts, "corr_fwd": 5}) \
            or dflow.shape != (*c.sintel_img_hw, 2) or not np.array_equal(png, flow_to_image(dflow)) \
            or gap > 1e-4 * (1 + peak):
        raise AssertionError(f"sintel_flow {sres} launches {sintel_counts}; demo launches "
                             f"{demo_counts}, flow {dflow.shape}, gap to the batched flow "
                             f"{gap} (peak {peak})")
    print(f"entry points complete (d): test.main sintel_flow on 2 pairs a pass at "
          f"{c.sintel_hw} -> {c.sintel_img_hw} (weights from the exported .pth), EPE "
          + ", ".join(f"{k} {v[0]:.4f}" for k, v in svals.items())
          + f", {sintel_counts['corr_fwd']} corr_fwd launches; demo (weights from the .ckpt): "
          f"{demo_counts['corr_fwd']} launches, its PNG equals flow_to_image of its flow, max "
          f"gap to the batched flow of the pair {gap:.2e} px (peak {peak:.2f}); {t_d:.2f} s")

    # (e) the loop's stall in a save: asynchronous against synchronous
    snap_paths = [os.path.join(root15, "save", f) for f in ("iter_0.pth", "last.pth")]
    os.makedirs(os.path.dirname(snap_paths[0]), exist_ok=True)
    src_opt = make_optimizer(src_model)
    ckpt.restore_checkpoint(last_a, src_model, src_opt)
    stall, drain, sync = [], [], []
    for _ in range(SAVE_REPS):
        saver = ckpt.AsyncCheckpointer()
        try:
            c.sync()
            t0 = time.perf_counter()
            saver.save(snap_paths, it_src, src_model, src_opt)
            stall.append(time.perf_counter() - t0)
            saver.wait()
            drain.append(time.perf_counter() - t0)
        finally:
            saver.close()
        c.sync()
        t0 = time.perf_counter()
        ckpt.save_checkpoint(snap_paths, it_src, src_model, src_opt)
        sync.append(time.perf_counter() - t0)
    reads = []
    for _ in range(SAVE_REPS):
        t0 = time.perf_counter()
        ckpt.load_pretrained(src_model, warm_ckpt)
        c.sync()
        reads.append(time.perf_counter() - t0)
    mb = {name: os.path.getsize(path) / 2**20 for name, path in
          (("pth", snap_paths[1]), ("ckpt", warm_ckpt))}
    print(f"entry points complete (e): save of the full-width state ({mb['pth']:.1f} MiB .pth, "
          f"model and Adam): the loop blocked in AsyncCheckpointer.save() "
          f"{statistics.median(stall) * 1e3:.3f} ms (median of {SAVE_REPS}; written "
          f"{statistics.median(drain) * 1e3:.1f} ms after), synchronous save_checkpoint "
          f"{statistics.median(sync) * 1e3:.1f} ms; .ckpt read into the model "
          f"({mb['ckpt']:.1f} MiB, weights only) {statistics.median(reads) * 1e3:.1f} ms "
          f"(median of {SAVE_REPS}); phase 15 in {time.perf_counter() - t15:.1f} s ({c.smi})")


def flowpose(c) -> None:
    """Phase 16 (see the module): ``c`` as for ``entry_points_complete``, with
    the step counts (``fp_steps``, ``fp_bf16_steps``, ``freeze_steps``), the
    NYU and odometry shapes (``nyu_frame_hw``, ``nyu_hw``, ``nyu_snippets``,
    ``odo_hw``, ``odo_frames``), ``flow_ms`` (phases 6 and 7's ms per flow
    step by dtype) and ``empty_cache``, so that a CPU rehearsal can shrink
    them."""
    import numpy as np
    import torch

    from unopticalflow_tpu_torch import test as evaluation
    from unopticalflow_tpu_torch import train as train_cli
    from unopticalflow_tpu_torch.data import NYU_v2, preparers
    from unopticalflow_tpu_torch.data.loader import BatchLoader
    from unopticalflow_tpu_torch.data.synthetic import SyntheticSnippets
    from unopticalflow_tpu_torch.evaluation.eval_odom import KittiEvalOdom
    from unopticalflow_tpu_torch.models import FlowModelConfig, FlowPoseModel, inference_pose
    from unopticalflow_tpu_torch.models.layers import set_compute_dtype
    from unopticalflow_tpu_torch.ops.cost_volume import (
        corr_df1_reference,
        corr_df2_reference,
        cost_volume,
        cost_volume_reference,
    )
    from unopticalflow_tpu_torch.ops.photometric import photometric_pack_reference
    from unopticalflow_tpu_torch.training import loss_fn, loss_weights_from_config
    from unopticalflow_tpu_torch.utils import imageio
    from unopticalflow_tpu_torch.utils.checkpoint import load_pretrained

    device, (h, w), batch_n = c.device, c.img_hw, c.batch
    counts, reset_counts = c.counts, c.reset_counts
    t16 = time.perf_counter()
    root = c.root
    os.makedirs(root, exist_ok=True)

    def kitti_k(hw, rng):
        """KITTI's P_rect_02 at 375x1242, scaled to ``hw``, moved a little."""
        k = np.array([[721.5377, 0.0, 609.5593], [0.0, 721.5377, 172.854], [0.0, 0.0, 1.0]])
        k[0] *= hw[1] / KITTI_HW[1]
        k[1] *= hw[0] / KITTI_HW[0]
        k[:2, :] *= 1.0 + 0.01 * rng.randn(2, 1)
        return k.astype(np.float32), np.linalg.inv(k).astype(np.float32)

    class PoseSnippets(SyntheticSnippets):
        """SyntheticSnippets with per-snippet intrinsics: (img, K, K_inv)."""

        def __init__(self, hw, n, seed):
            super().__init__(hw, n, seed)
            rng = np.random.RandomState(seed)
            self.ks = [kitti_k(hw, rng) for _ in range(len(self.snippets))]

        def __getitem__(self, idx):
            return (super().__getitem__(idx), *self.ks[idx % len(self.ks)])

    def step_events():
        events, metrics = [], []

        def on_step(it, m):
            ev = torch.cuda.Event(enable_timing=True) if device.type == "cuda" else None
            if ev is not None:
                ev.record()
            events.append(ev)
            metrics.append(m)

        def ms(skip=2):
            if device.type != "cuda" or len(events) < skip + 2:
                return float("nan")
            return statistics.median(events[i].elapsed_time(events[i + 1])
                                     for i in range(skip, len(events) - 1))

        return on_step, metrics, ms

    fp_weights = loss_weights_from_config(types.SimpleNamespace(mode="flowposenet"))
    # (a) the flowposenet step at config/odo.yaml's recipe: parity, launches, ms/step
    rates = {}
    for dtype, steps in (("float32", c.fp_steps), ("bfloat16", c.fp_bf16_steps)):
        cfg = train_cli.recipe_config(
            mode="flowposenet", num_iterations=steps, init_scheme="pwc", seed=SEED + 20,
            precision=dtype, loss_precision=dtype, log_interval=1000, save_interval=100000,
            model_dir=os.path.join(root, f"a_{dtype}"), num_workers=4, batch_size=batch_n,
            img_hw=c.img_hw)
        os.makedirs(cfg.model_dir, exist_ok=True)
        on_step, metrics, ms = step_events()
        reset_counts()
        res = train_cli.train(cfg, dataset=PoseSnippets(c.img_hw, steps * batch_n, SEED + 20),
                              device=device, on_step=on_step)
        c.sync()
        got = counts()
        want = {k: steps * v for k, v in c.want(PER_STEP).items()}
        bad = [k for m in metrics for k, v in m.items() if not bool(torch.isfinite(v))]
        if got != want or bad or res.step != steps \
                or sorted(metrics[0]) != sorted([*fp_weights, "loss_total"]):
            raise AssertionError(f"flowposenet {dtype}: launches {got} (want {want}), "
                                 f"non-finite {bad}, {res.step} steps")
        rates[dtype] = ms()
        del res
    print(f"flowpose (a): flowposenet steps at {batch_n}x{h}x{w}, 3 scales: ms/step float32 "
          f"{rates['float32']:.3f} ({c.fp_steps} steps; phase 6's flow step "
          f"{c.flow_ms['float32']:.3f}), bfloat16 {rates['bfloat16']:.3f} ({c.fp_bf16_steps} "
          f"steps; phase 7's {c.flow_ms['bfloat16']:.3f}), median CUDA-event intervals; "
          f"launches per step {_launched(c.want(PER_STEP))} ({c.smi})")

    data = PoseSnippets(c.img_hw, batch_n, SEED + 21)
    imgs = torch.from_numpy(data.snippets[:batch_n].astype(np.float32) / 255.0).to(device)
    ks = [torch.from_numpy(np.stack([data.ks[i][j] for i in range(batch_n)])).to(device)
          for j in range(2)]
    plain = dict(corr_fn=cost_volume_reference, photo_fn=photometric_pack_reference)
    model = FlowPoseModel(FlowModelConfig(), device=device, scheme="pwc",
                          generator=torch.Generator().manual_seed(SEED + 21))
    for dtype, rtol in (("bfloat16", 2e-2), ("float32", 1e-4)):
        mcfg = FlowModelConfig(compute_dtype=dtype, loss_dtype=dtype)
        set_compute_dtype(model, getattr(torch, dtype))
        with torch.no_grad():
            _, want = loss_fn(model, mcfg, (imgs, *ks), fp_weights, "flowposenet", **plain)
            reset_counts()
            _, got = loss_fn(model, mcfg, (imgs, *ks), fp_weights, "flowposenet")
        fwd_counts = counts()
        for k in want:
            if not (torch.isfinite(got[k]) and torch.isfinite(want[k])):
                raise AssertionError(f"flowposenet parity {dtype}: non-finite {k}")
            torch.testing.assert_close(got[k], want[k], rtol=rtol, atol=1e-6)
        if fwd_counts != c.want({**dict.fromkeys(KERNELS, 0), "corr_fwd": 5,
                                 "photometric_fwd": 3}):
            raise AssertionError(f"flowposenet forward launches {fwd_counts}")
        print(f"flowpose (a): losses {dtype} kernels vs plain (rtol {rtol}): "
              + json.dumps({k: [float(got[k]), float(want[k])] for k in want}))
    cfg32 = FlowModelConfig()

    def grads(x, **fns):
        model.zero_grad(set_to_none=True)
        total, _ = loss_fn(model, cfg32, (x, *ks), fp_weights, "flowposenet", **fns)
        total.backward()
        return torch.cat([p.grad.ravel() for _, p in sorted(model.named_parameters())])

    want_g = grads(imgs, **plain)
    noise = _rel_l2(grads(torch.nextafter(imgs, torch.full_like(imgs, 2.0)), **plain), want_g)
    err = _rel_l2(grads(imgs), want_g)
    print(f"flowpose (a): float32 weighted-total gradient (flow and pose, "
          f"{want_g.numel()} values), kernels vs plain rel L2 {err:.3e}, plain vs plain on "
          f"snippets one ulp away {noise:.3e}")
    if err > max(1e-4, noise):
        raise AssertionError("flowposenet step parity failed: total gradient")
    del model, want_g
    c.empty_cache()

    # (b) --freeze_flow: the flow branch bit-identical, every pose tensor moved
    cfg = train_cli.recipe_config(
        mode="flowposenet", freeze_flow=True, num_iterations=c.freeze_steps, init_scheme="pwc",
        seed=SEED + 22, log_interval=1000, save_interval=100000, batch_size=batch_n,
        model_dir=os.path.join(root, "b"), num_workers=4, img_hw=c.img_hw)
    os.makedirs(cfg.model_dir, exist_ok=True)
    start = FlowPoseModel(FlowModelConfig(), device=device, scheme="pwc",
                          generator=torch.Generator().manual_seed(SEED + 22))
    on_step, metrics, ms = step_events()
    reset_counts()
    res = train_cli.train(cfg, dataset=PoseSnippets(c.img_hw, c.freeze_steps * batch_n,
                                                    SEED + 22), device=device, on_step=on_step)
    c.sync()
    frozen_counts = counts()
    flow_same = [torch.equal(a, b) for a, b in zip(start.flow.parameters(),
                                                   res.model.flow.parameters())]
    pose_moved = [not torch.equal(a, b) for a, b in zip(start.pose.parameters(),
                                                        res.model.pose.parameters())]
    want = {k: c.freeze_steps * v for k, v in c.want(PER_STEP_FROZEN).items()}
    if not all(flow_same) or not all(pose_moved) or frozen_counts != want \
            or any(p.requires_grad for p in res.model.flow.parameters()):
        raise AssertionError(f"--freeze_flow: {sum(flow_same)} of {len(flow_same)} flow tensors "
                             f"unchanged, {sum(pose_moved)} of {len(pose_moved)} pose tensors "
                             f"moved, launches {frozen_counts} (want {want})")
    print(f"flowpose (b): --freeze_flow, {c.freeze_steps} float32 steps: {len(flow_same)} flow "
          f"tensors bit-identical, all {len(pose_moved)} pose tensors moved; launches "
          f"{_launched(frozen_counts)} ({_launched(c.want(PER_STEP_FROZEN))} a step: no "
          f"correlation- or photometric-backward kernel, the flow branch has "
          f"requires_grad=False); ms/step {ms(1):.3f}")
    del res, start
    c.empty_cache()

    # (c) train.main: flowposenet on a raw KITTI odometry tree, then NYU 2-frame
    seqs = os.path.join(root, "odometry", "sequences")
    frames = SyntheticSnippets(c.kitti_hw, 2, seed=SEED + 23).snippets[:2].reshape(
        6, c.kitti_hw[0], c.kitti_hw[1], 3)
    img_dir = os.path.join(seqs, "00", "image_2")
    os.makedirs(img_dir, exist_ok=True)
    for i, f in enumerate(frames):
        imageio.imwrite(os.path.join(img_dir, f"{i:06d}.png"), f)
    with open(os.path.join(seqs, "00", "calib.txt"), "w") as f:
        f.write("P2: 721.5 0.0 609.6 44.9 0.0 721.5 172.9 0.2 0.0 0.0 1.0 0.003\n")

    def yaml16(name, **keys):
        path = os.path.join(root, name)
        with open(path, "w") as f:
            f.write("".join(f"{k}: {v}\n" for k, v in {
                "num_scales": 3, "w_ssim": 0.85, "w_flow_smooth": 10.0, "w_flow_consis": 0.01,
                "w_pose_epipolar": 1.0, **keys}.items()))
        return path

    odo = dict(raw_base_dir=f"'{seqs}'", prepared_base_dir=f"'{os.path.join(root, 'odo_prep')}'",
               dataset="'kitti_odo'", img_hw=f"[{h}, {w}]")
    dir_c = os.path.join(root, "models_odo")
    main_args = ["--no_test", "--batch_size", str(batch_n), "--num_workers", "4",
                 "--log_interval", "1", "--mode", "flowposenet", "--model_dir", dir_c, *c.cli]
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = train_cli.main(["-c", yaml16("odo.yaml", num_iterations=c.steps, **odo),
                             "--save_interval", "1000", "--init_scheme", "pwc", *main_args])
    c.sync()
    t_odo = time.perf_counter() - t0
    odo_counts = counts()
    log = out.getvalue()
    n_odo = sum(1 for _ in open(os.path.join(root, "odo_prep", "data_s1", "train.txt")))
    last_odo = os.path.join(dir_c, "flowposenet", "last.pth")
    if rc != 0 or odo_counts != {k: c.steps * v for k, v in c.want(PER_STEP).items()} \
            or "Data Preparation Finished." not in log or n_odo != len(frames) - 1 \
            or log.count("loss_pose_epipolar") != c.steps or not os.path.exists(last_odo):
        raise AssertionError(f"train.main flowposenet kitti_odo: rc {rc}, launches {odo_counts}, "
                             f"{n_odo} snippets, log:\n{log}")
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = train_cli.main(["-c", yaml16("odo_resume.yaml", num_iterations=c.steps + 1, **odo),
                             "--resume", *main_args])
    log_r = out.getvalue()
    resumed = [int(x) for x in re.findall(r"^iter: (\d+),", log_r, flags=re.M)]
    # last.pth holds the last iteration done, c.steps - 1, where the resume starts
    if rc != 0 or counts() != {k: 2 * v for k, v in c.want(PER_STEP).items()} \
            or f"at iteration {c.steps - 1}." not in log_r or resumed != [c.steps - 1, c.steps]:
        raise AssertionError(f"--resume flowposenet: rc {rc}, log:\n{log_r}")
    print(f"flowpose (c): train.main --mode flowposenet on a raw KITTI odometry sequence "
          f"({len(frames)} frames at {c.kitti_hw}) prepared by KITTI_Odo into {n_odo} "
          f"snippets, {c.steps} float32 steps at batch {batch_n} {h}x{w} in {t_odo:.2f} s, "
          f"launches {_launched(odo_counts)}; --resume from last.pth ran iterations {resumed}")

    nh, nw = c.nyu_hw
    nyu = os.path.join(root, "nyu_prep", "data_s1")
    os.makedirs(os.path.join(nyu, "scene"), exist_ok=True)
    nyu_frames = SyntheticSnippets(c.nyu_frame_hw, 2, seed=SEED + 24).snippets
    lines = []
    for i in range(c.nyu_snippets):
        snip = nyu_frames[i % 2]
        pair = snip[:2 * c.nyu_frame_hw[0]] if i % 4 < 2 else snip[c.nyu_frame_hw[0]:]
        imageio.imwrite(os.path.join(nyu, "scene", f"{i:04d}.png"), np.ascontiguousarray(pair))
        lines.append(f"scene/{i:04d}.png calib_cam_to_cam.txt\n")
    with open(os.path.join(nyu, "calib_cam_to_cam.txt"), "w") as f:
        f.write(preparers._NYU_INTRINSICS_LINE)
    with open(os.path.join(nyu, "train.txt"), "w") as f:
        f.writelines(lines)
    nyu_keys = dict(prepared_base_dir=f"'{os.path.dirname(nyu)}'", dataset="'nyuv2'",
                    img_hw=f"[{nh}, {nw}]")
    nyu_rates = {}
    for mode in ("flowposenet", "flow"):
        on_step, metrics, ms = step_events()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = train_cli.main(["-c", yaml16(f"nyu_{mode}.yaml", num_iterations=c.steps,
                                              **nyu_keys),
                                 "--no_test", "--batch_size", str(batch_n), "--num_workers",
                                 "4", "--log_interval", "1", "--save_interval", "1000",
                                 "--init_scheme", "pwc", "--mode", mode, "--model_dir",
                                 os.path.join(root, "models_nyu"), *c.cli])
        c.sync()
        t_nyu = time.perf_counter() - t0
        nyu_counts = counts()
        log = out.getvalue()
        if rc != 0 or nyu_counts != {k: c.steps * v for k, v in c.want(PER_STEP_PAIR).items()} \
                or log.count("loss_pixel") != c.steps \
                or (mode == "flowposenet") != ("loss_pose_epipolar" in log):
            raise AssertionError(f"train.main {mode} nyuv2: rc {rc}, launches {nyu_counts}, "
                                 f"log:\n{log}")
        rates_logged = [float(x) for x in re.findall(r"snippets_per_sec: ([0-9.e+-]+)", log)]
        nyu_rates[mode] = (t_nyu, statistics.median(rates_logged) if rates_logged else
                           float("nan"))
    ds = NYU_v2(nyu, num_scales=3, img_hw=c.nyu_hw, num_iterations=c.loader_snippets)
    ds[0]  # the maps, once
    t0 = time.perf_counter()
    n_loaded = sum(len(b[0]) for b in BatchLoader(ds, batch_size=batch_n, num_workers=4))
    nyu_loader = n_loaded / (time.perf_counter() - t0)

    class PairSnippets:
        """NYU_v2's samples in memory: (2H, W, 3) float32 pairs, K_ms, K_inv_ms
        (NYU's intrinsics rescaled as NYU_v2 rescales them)."""

        num_frames = 2

        def __init__(self, n):
            snips = SyntheticSnippets(c.nyu_hw, n, seed=SEED + 28).snippets
            self.pairs = snips[:, :2 * nh].astype(np.float32) / 255.0
            k = np.array(preparers._NYU_INTRINSICS_LINE.split()[1:], float).reshape(3, 4)[:, :3]
            k[0] *= nh / c.nyu_frame_hw[0]
            k[1] *= nw / c.nyu_frame_hw[1]
            ks = [np.diag([0.5**s, 0.5**s, 1.0]) @ k for s in range(3)]
            self.k = np.stack(ks).astype(np.float32)
            self.k_inv = np.stack([np.linalg.inv(x) for x in ks]).astype(np.float32)
            self.n = n

        def __len__(self):
            return self.n

        def __getitem__(self, idx):
            if idx >= self.n:
                raise IndexError(idx)
            return self.pairs[idx % len(self.pairs)], self.k, self.k_inv

    pair_rates = {}
    for mode in ("flowposenet", "flow"):
        cfg = train_cli.recipe_config(
            mode=mode, dataset="nyuv2", num_iterations=c.fp_steps, init_scheme="pwc",
            seed=SEED + 28, img_hw=c.nyu_hw, log_interval=1000, save_interval=100000,
            batch_size=batch_n, model_dir=os.path.join(root, f"pair_{mode}"), num_workers=4)
        os.makedirs(cfg.model_dir, exist_ok=True)
        on_step, metrics, ms = step_events()
        reset_counts()
        train_cli.train(cfg, dataset=PairSnippets(c.fp_steps * batch_n), device=device,
                        on_step=on_step)
        c.sync()
        got = counts()
        if got != {k: c.fp_steps * v for k, v in c.want(PER_STEP_PAIR).items()} \
                or not all(bool(torch.isfinite(v)) for m in metrics for v in m.values()):
            raise AssertionError(f"2-frame {mode} steps: launches {got}")
        pair_rates[mode] = ms()

    # the 2-frame step against its plain version on one batch of these pairs:
    # each decoder level's correlation forward and backward at this step's
    # shapes, the losses of both modes, the float32 whole-step gradient
    pairs = PairSnippets(batch_n)
    x2 = torch.from_numpy(np.stack([pairs[i][0] for i in range(batch_n)])).to(device)
    k2 = [torch.from_numpy(np.repeat(a[:1], batch_n, 0)).to(device) for a in (pairs.k, pairs.k_inv)]
    model2 = FlowPoseModel(FlowModelConfig(), device=device, scheme="pwc",
                           generator=torch.Generator().manual_seed(SEED + 29))
    levels = []

    def record(f1, f2, md=MD):
        levels.append((f1.detach(), f2.detach()))
        return cost_volume(f1, f2, md)

    with torch.no_grad():
        loss_fn(model2, cfg32, (x2, *k2), fp_weights, "flowposenet", 2, corr_fn=record)
    gen2 = torch.Generator().manual_seed(SEED + 29)
    reset_counts()
    held = []
    for f1, f2 in levels:
        a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
        got = cost_volume(a, b, MD)
        g = torch.randn(got.shape, generator=gen2).to(device)
        d1, d2 = torch.autograd.grad(got, (a, b), g)
        torch.testing.assert_close(got.detach(), cost_volume_reference(f1, f2, MD),
                                   rtol=1e-5, atol=1e-6)
        held.append([_hold_bwd(torch, d1, corr_df1_reference(g, f2, MD), 1e-5, 1e-6,
                               lambda: corr_df1_reference(g.abs(), f2.abs(), MD)),
                     _hold_bwd(torch, d2, corr_df2_reference(g, f1, MD), 1e-5, 1e-6,
                               lambda: corr_df2_reference(g.abs(), f1.abs(), MD))])
    n_lv = len(levels)
    level_counts = counts()
    if n_lv != 5 or level_counts != c.want({**dict.fromkeys(KERNELS, 0), "corr_fwd": n_lv,
                                            "corr_bwd_df1": n_lv, "corr_bwd_df2": n_lv}):
        raise AssertionError(f"2-frame decoder levels: {n_lv} levels, launches {level_counts}")
    pair_losses = {}
    for mode in ("flowposenet", "flow"):
        w2 = loss_weights_from_config(types.SimpleNamespace(mode=mode))
        m2, batch2 = (model2, (x2, *k2)) if mode == "flowposenet" else (model2.flow, x2)
        with torch.no_grad():
            _, want = loss_fn(m2, cfg32, batch2, w2, mode, 2, corr_fn=cost_volume_reference)
            _, got = loss_fn(m2, cfg32, batch2, w2, mode, 2)
        for k in want:
            if not (torch.isfinite(got[k]) and torch.isfinite(want[k])):
                raise AssertionError(f"2-frame {mode} parity: non-finite {k}")
            torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-6)
        pair_losses[mode] = {k: [float(got[k]), float(want[k])] for k in want}

    def grads2(x, **fns):
        model2.zero_grad(set_to_none=True)
        total, _ = loss_fn(model2, cfg32, (x, *k2), fp_weights, "flowposenet", 2, **fns)
        total.backward()
        return torch.cat([p.grad.ravel() for _, p in sorted(model2.named_parameters())])

    want_g2 = grads2(x2, corr_fn=cost_volume_reference)
    noise2 = _rel_l2(grads2(torch.nextafter(x2, torch.full_like(x2, 2.0)),
                            corr_fn=cost_volume_reference), want_g2)
    err2 = _rel_l2(grads2(x2), want_g2)
    print(f"flowpose (c): the 2-frame step at {batch_n}x{nh}x{nw} against its plain version: "
          f"the decoder's {n_lv} correlation levels "
          f"{[tuple(f1.shape) for f1, _ in levels]} forward within 1e-5, backward (df1, df2) "
          f"held by {held}; losses float32 kernels vs plain (rtol 1e-4): "
          + json.dumps(pair_losses) + f"; flowposenet weighted-total gradient "
          f"({want_g2.numel()} values) rel L2 {err2:.3e}, plain vs plain on pairs one ulp "
          f"away {noise2:.3e}")
    if err2 > max(1e-4, noise2):
        raise AssertionError("2-frame step parity failed: total gradient")
    del model2, want_g2, levels
    c.empty_cache()
    print(f"flowpose (c): train.main dataset nyuv2 ({c.nyu_snippets} prepared 2-frame snippets "
          f"of {c.nyu_frame_hw} frames, NYU's calibration) at {nh}x{nw}, {c.steps} float32 steps "
          f"at batch {batch_n} each: " + ", ".join(
              f"{m} {t:.2f} s, {r:.1f} snippets/s logged" for m, (t, r) in nyu_rates.items())
          + f"; launches per 2-frame step {_launched(c.want(PER_STEP_PAIR))}; the NYU loader "
          f"(numpy undistortion, decode, resize, 4 threads): {nyu_loader:.1f} snippets/s "
          f"against the "
          f"2-frame float32 step from memory ({c.fp_steps} steps, median CUDA-event interval): "
          + ", ".join(f"{m} {v:.3f} ms/step ({batch_n / v * 1e3:.1f} snippets/s)"
                      for m, v in pair_rates.items()) + f" ({c.smi})")

    # (d) test.main --task kitti_odo with (c)'s weights, then the odometry metric
    seq16 = os.path.join(root, "seq16", "image_2")
    os.makedirs(seq16, exist_ok=True)
    odo_frames = SyntheticSnippets(c.odo_hw, 1, seed=SEED + 25).snippets
    odo_frames = odo_frames.reshape(-1, c.odo_hw[0], c.odo_hw[1], 3)[:c.odo_frames]
    for i, f in enumerate(odo_frames):
        imageio.imwrite(os.path.join(seq16, f"{i:06d}.png"), np.ascontiguousarray(f))
    result = os.path.join(root, "seq16_poses.txt")
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        path = evaluation.main(["-c", yaml16("odo_test.yaml", img_hw=f"[{h}, {w}]"), "--mode",
                                "flowposenet", "--task", "kitti_odo", "--seq_dir",
                                os.path.dirname(seq16), "--result_txt", result,
                                "--pretrained_model", last_odo, *c.cli])
    c.sync()
    t_test = time.perf_counter() - t0
    poses = np.loadtxt(path)
    if path != result or poses.shape != (c.odo_frames, 12) or not np.isfinite(poses).all() \
            or counts() != dict.fromkeys(KERNELS, 0):
        raise AssertionError(f"kitti_odo: {poses.shape} poses from {path}, launches {counts()}")
    pose_model = FlowPoseModel(FlowModelConfig(), device=device)
    ckpt_iter = load_pretrained(pose_model, last_odo)
    pair = torch.rand((2, 1, h, w, 3), generator=torch.Generator().manual_seed(SEED + 26))
    pair = pair.to(device)

    def pose_call():
        with torch.inference_mode():
            inference_pose(pose_model, pair[0], pair[1])

    pose_ms = _time_ms(torch, pose_call, reps=5, inner=5) if device.type == "cuda" \
        else float("nan")
    n = 240
    yaw = np.cumsum(np.random.RandomState(SEED + 27).randn(n) * 0.02)
    gt = np.zeros((n, 3, 4))
    pos = np.cumsum(np.stack([np.sin(yaw), np.zeros(n), np.cos(yaw)], 1), 0)
    for i, (a, p) in enumerate(zip(yaw, pos)):
        gt[i, :, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        gt[i, :, 3] = p
    pred = gt.copy()
    pred[:, :, 3] *= 0.5
    for name, arr in (("gt.txt", gt), ("pred.txt", pred)):
        np.savetxt(os.path.join(root, name), arr.reshape(n, 12), fmt="%.12e")
    with contextlib.redirect_stdout(io.StringIO()):
        t_err, r_err = KittiEvalOdom().eval(os.path.join(root, "gt.txt"),
                                            os.path.join(root, "pred.txt"), plot=False)
    if not (t_err < 1e-9 and r_err < 1e-9):
        raise AssertionError(f"eval_odom: the 0.5-scaled trajectory aligns to errors "
                             f"{t_err}, {r_err}")
    print(f"flowpose (d): test.main --mode flowposenet --task kitti_odo (weights of (c), "
          f"iteration {ckpt_iter}) on {c.odo_frames} frames at {c.odo_hw}: {len(poses)} pose "
          f"lines in {t_test:.2f} s ({t_test / (c.odo_frames - 1) * 1e3:.1f} ms a pose pair, "
          f"reading and resizing included; the pose net alone {pose_ms:.3f} ms a pair at "
          f"{h}x{w}, CUDA events); KittiEvalOdom on {n} poses 1 m apart against the same "
          f"trajectory with translations x 0.5: t_err {t_err:.3e}, r_err {r_err:.3e} after "
          f"Umeyama; phase 16 in {time.perf_counter() - t16:.1f} s ({c.smi})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs a GPU",
              file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    import numpy as np

    from unopticalflow_tpu_torch.data.synthetic import SyntheticSnippets
    from unopticalflow_tpu_torch import test as evaluation
    from unopticalflow_tpu_torch.benchmarks import block_gather_probe, gather_probe
    from unopticalflow_tpu_torch.evaluation import eval_flow_avg
    from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig, inference_flow
    from unopticalflow_tpu_torch.ops import (
        _build,
        correlation_cuda,
        gather_cuda,
        photometric_cuda,
        regularizer_cuda,
    )
    from unopticalflow_tpu_torch.ops.cost_volume import (
        corr_df1_hpad_reference,
        corr_df1_reference,
        corr_df2_hpad_reference,
        corr_df2_reference,
        corr_fwd_hpad_reference,
        cost_volume_reference,
    )
    from unopticalflow_tpu_torch.ops.cost_volume_spmd import cost_volume_sharded
    from unopticalflow_tpu_torch.ops.gather import (
        REPS,
        lane_gather_reference,
        row_gather_reference,
        sublane_gather_reference,
    )
    from unopticalflow_tpu_torch.ops.photometric import photometric_pack_reference
    from unopticalflow_tpu_torch.ops.regularizer import regularizer_pack_reference
    from unopticalflow_tpu_torch.parallel import gather_rows, make_spatial_infer, spatial_mesh
    from unopticalflow_tpu_torch.serve import FlowServer
    from unopticalflow_tpu_torch.train import recipe_config, train
    from unopticalflow_tpu_torch.training import loss_fn, loss_weights_from_config
    from unopticalflow_tpu_torch.utils.device import resolve_device

    def counts():
        return {**correlation_cuda.launches, **photometric_cuda.launches,
                **regularizer_cuda.launches, **gather_cuda.launches}

    def reset_counts():
        for d in (correlation_cuda.launches, photometric_cuda.launches,
                  regularizer_cuda.launches, gather_cuda.launches):
            for k in d:
                d[k] = 0

    # ---- 1. setup -------------------------------------------------------
    device = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("tf32: cudnn.allow_tf32=False cuda.matmul.allow_tf32=False")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {sorted(libs.values())} in {time.perf_counter() - t0:.2f} s")
    for src, kernel in (("correlation", "corr_fwd_kernel"), ("correlation", "corr_df1_kernel"),
                        ("correlation", "corr_df2_kernel"), ("gather", "row_gather_kernel"),
                        ("gather", "lane_gather"),
                        ("photometric", "photo_fwd_kernel"),
                        ("photometric", "photo_bwd_kernel"),
                        ("regularizer", "reg_fwd_kernel"), ("regularizer", "reg_bwd_kernel")):
        report = _ptxas_registers(_build.ptxas_log.get(src, ""), kernel)
        if src == "regularizer":  # 256-thread blocks
            report = [f"{r_} ({_blocks_per_sm(*map(int, m_.groups()))} blocks an SM)"
                      if (m_ := re.search(r"(\d+) registers, (\d+) bytes smem", r_)) else r_
                      for r_ in report]
        print(f"ptxas {src}: " + "; ".join(report))

    gen = torch.Generator(device=device).manual_seed(SEED)
    max_err = dict.fromkeys(KERNELS, 0.0)
    ms = dict.fromkeys(KERNELS, 0.0)
    plain_ms = dict.fromkeys(KERNELS, 0.0)
    library_ms = dict.fromkeys(KERNELS)
    # bytes and operations of the float32 training step's calls, for bound_ms
    work = {k: [0.0, 0.0] for k in KERNELS}
    # the loss kernels with bfloat16 images, per bf16 training step:
    # [kernel ms, plain ms, bytes, operations]
    bf16_step = {k: [0.0, 0.0, 0.0, 0.0] for k in KERNELS
                 if k.startswith(("photometric", "regularizer"))}
    zero_counts = dict.fromkeys(KERNELS, 0)

    def add_work(name, nbytes, ops):
        work[name][0] += nbytes
        work[name][1] += ops

    def add_bf16(name, k_ms, p_ms, nbytes, ops):
        for i, v in enumerate((k_ms, p_ms, nbytes, ops)):
            bf16_step[name][i] += v

    def note(name, got, want):
        max_err[name] = max(max_err[name], float((got.float() - want.float()).abs().max()))

    # ---- 2. correlation forward vs plain --------------------------------
    corr_tols = ((torch.float32, 1e-5, 1e-6), (torch.bfloat16, 2e-2, 2e-2))
    serve_k = serve_p = 0.0
    level_ms = {}  # (level, dtype) -> kernel ms at the training shapes
    for name, shape in [*SERVE_LEVELS.items(), *(("ragged", r) for r in RAGGED_CORR),
                        *(("train_" + k, v) for k, v in TRAIN_LEVELS.items())]:
        for dtype, rtol, atol in corr_tols:
            f1 = torch.randn(shape, generator=gen, device=device).to(dtype)
            f2 = torch.randn(shape, generator=gen, device=device).to(dtype)
            got = correlation_cuda.correlation(f1, f2, 4)
            torch.cuda.synchronize()
            want = cost_volume_reference(f1, f2, 4)
            if got.dtype != dtype or got.shape != (shape[0], 81) + shape[2:]:
                raise AssertionError(f"corr {name}: kernel gave {got.dtype} {tuple(got.shape)}")
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
            note("corr_fwd", got, want)
            if name == "ragged":
                continue
            k_ms = _time_ms(torch, lambda: correlation_cuda.correlation(f1, f2, 4))
            p_ms = _time_ms(torch, lambda: cost_volume_reference(f1, f2, 4), inner=2)
            if name.startswith("train_"):
                level_ms[f"{name[6:]} {str(dtype)[6:]}"] = round(k_ms, 4)
            if name.startswith("train_") and dtype == torch.float32:
                ms["corr_fwd"] += k_ms
                plain_ms["corr_fwd"] += p_ms
                b_, c_, h_, w_ = shape
                add_work("corr_fwd", (2 * c_ + 81) * b_ * h_ * w_ * 4, 2 * 81 * c_ * b_ * h_ * w_)
            elif not name.startswith("train_") and dtype == torch.bfloat16:
                serve_k += k_ms
                serve_p += p_ms
            print(f"corr_fwd {name} {shape} {str(dtype)[6:]}: max_abs_err="
                  f"{float((got.float() - want.float()).abs().max()):.3e} kernel_ms={k_ms:.4f} "
                  f"plain_ms={p_ms:.4f}")
    print(f"corr_fwd per serving batch (5 levels, bfloat16): kernel_ms={serve_k:.4f} "
          f"plain_ms={serve_p:.4f}")
    print(f"corr_fwd per training step (5 levels at 2B=16, float32): kernel_ms="
          f"{ms['corr_fwd']:.4f} plain_ms={plain_ms['corr_fwd']:.4f}")
    print("corr_fwd kernel ms per training level (2B=16): " + json.dumps(level_ms))

    # ---- 3. the serving slice: FlowServer at the KITTI serving shape ----
    h, w = IMG_HW
    cfg = FlowModelConfig(compute_dtype="bfloat16")
    model = FlowModel(cfg, device=device, scheme="pwc",
                      generator=torch.Generator().manual_seed(SEED))
    rng = np.random.RandomState(SEED)
    pairs = [rng.rand(2 * h, w, 3).astype(np.float32) for _ in range(N_REQUESTS)]
    server = FlowServer(types.SimpleNamespace(img_hw=IMG_HW), model,
                        max_batch=BATCH, max_wait_ms=5.0)
    try:
        flows = [None] * N_REQUESTS

        def client(k):
            for i in range(k, N_REQUESTS, N_CLIENTS):
                flows[i] = server.infer(pairs[i], timeout=300.0)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(N_CLIENTS)]
        reset_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        serve_counts = counts()
        if any(t.is_alive() for t in threads):
            raise AssertionError("client threads did not finish")
        stats = json.loads(json.dumps(server.stats))
    finally:
        server.close()
    for i, f in enumerate(flows):
        if f is None or f.shape != (h, w, 2) or f.dtype != np.float32 or not np.isfinite(f).all():
            raise AssertionError(f"request {i}: bad flow {None if f is None else (f.shape, f.dtype)}")
    if stats["served"] != N_REQUESTS or stats["errors"] or stats["shed"]:
        raise AssertionError(f"server stats {stats}")
    if serve_counts != {**dict.fromkeys(KERNELS, 0), "corr_fwd": 5 * stats["batches"]}:
        raise AssertionError(f"serving launches {serve_counts} for {stats['batches']} batches")
    print(f"served {stats['served']} requests in {stats['batches']} batches, "
          f"occupancy {stats['occupancy']}, corr_fwd launches {serve_counts['corr_fwd']} "
          f"(5 per batch), wall {wall:.3f} s")
    i1 = torch.from_numpy(np.stack([p[:h] for p in pairs[:BATCH]])).to(device)
    i2 = torch.from_numpy(np.stack([p[h:] for p in pairs[:BATCH]])).to(device)
    with torch.inference_mode():
        ms_batch = _time_ms(torch, lambda: inference_flow(model, i1, i2), reps=10, inner=1)
        print(f"serving slice bfloat16 {BATCH}x{h}x{w}: {ms_batch:.3f} ms/batch "
              "(device path, CUDA events)")
        flow_k = inference_flow(model, i1, i2)
        flow_p = inference_flow(model, i1, i2, corr_fn=cost_volume_reference)
        served = torch.from_numpy(np.stack(flows[:BATCH])).to(device)
        peak = float(flow_p.abs().max())
        err = float((flow_k - flow_p).abs().max())
        err_served = float((served - flow_k).abs().max())
        print(f"serving parity bfloat16 kernel vs plain corr: max_abs_err={err:.4e} "
              f"max|flow|={peak:.4f}; served vs direct {err_served:.4e}")
        if not (err <= 2e-2 * peak and err_served <= 2e-2 * peak):
            raise AssertionError("bfloat16 serving parity failed")
        model32 = FlowModel(cfg._replace(compute_dtype="float32"), device=device)
        model32.load_state_dict(model.state_dict())
        flow_k = inference_flow(model32, i1, i2)
        flow_p = inference_flow(model32, i1, i2, corr_fn=cost_volume_reference)
        peak = float(flow_p.abs().max())
        err = float((flow_k - flow_p).abs().max())
        print(f"serving parity float32 kernel vs plain corr: max_abs_err={err:.4e} "
              f"max|flow|={peak:.4f}")
        if not err <= 1e-4 * (1 + peak):
            raise AssertionError("float32 serving parity failed")
    del model, model32, server
    torch.cuda.empty_cache()

    # ---- 4. correlation backward vs plain --------------------------------
    bwd_level_ms = {}  # "kernel level dtype" -> kernel ms at the training shapes
    bwd_device_ms = {}  # the same keys -> the profiler's device ms per launch
    for name, shape in [*TRAIN_LEVELS.items(), *(("ragged", r) for r in RAGGED_BWD)]:
        for dtype, rtol, atol in corr_tols:
            f1 = torch.randn(shape, generator=gen, device=device).to(dtype)
            f2 = torch.randn(shape, generator=gen, device=device).to(dtype)
            g = torch.randn((shape[0], 81) + shape[2:], generator=gen, device=device).to(dtype)
            for kname, kern, ref, src in (
                ("corr_bwd_df1", correlation_cuda.corr_df1, corr_df1_reference, f2),
                ("corr_bwd_df2", correlation_cuda.corr_df2, corr_df2_reference, f1),
            ):
                got = kern(g, src, 4)
                again = kern(g, src, 4)
                torch.cuda.synchronize()
                want = ref(g, src, 4)
                if got.dtype != dtype or got.shape != shape:
                    raise AssertionError(f"{kname} {name}: kernel gave {got.dtype} {tuple(got.shape)}")
                if not torch.equal(got, again):
                    raise AssertionError(f"{kname} {name} {shape}: two calls differ")
                held = _hold_bwd(torch, got, want, rtol, atol,
                                 lambda: ref(g.abs(), src.abs(), 4))
                note(kname, got, want)
                err = float((got.float() - want.float()).abs().max())
                if name == "ragged":
                    print(f"{kname} ragged {shape} {str(dtype)[6:]}: max_abs_err={err:.3e} "
                          f"({held}), two calls bit-equal")
                    continue
                k_ms = _time_ms(torch, lambda: kern(g, src, 4))
                p_ms = _time_ms(torch, lambda: ref(g, src, 4), inner=2)
                key = f"{kname[9:]} {name} {str(dtype)[6:]}"
                bwd_level_ms[key] = round(k_ms, 4)
                bwd_device_ms[key] = _device_ms(torch, lambda: kern(g, src, 4),
                                                f"corr_{kname[9:]}_kernel")
                if dtype == torch.float32:
                    ms[kname] += k_ms
                    plain_ms[kname] += p_ms
                    b_, c_, h_, w_ = shape
                    add_work(kname, (81 + 2 * c_) * b_ * h_ * w_ * 4,
                             2 * 81 * c_ * b_ * h_ * w_)
                print(f"{kname} {name} {shape} {str(dtype)[6:]}: max_abs_err={err:.3e} "
                      f"({held}), two calls bit-equal, kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}")
    for kname in ("corr_bwd_df1", "corr_bwd_df2"):
        print(f"{kname} per training step (5 levels at 2B=16, float32): "
              f"kernel_ms={ms[kname]:.4f} plain_ms={plain_ms[kname]:.4f}")
    print("corr_bwd kernel ms per training level (2B=16): " + json.dumps(bwd_level_ms))
    print("corr_bwd device ms per launch (profiler, 2B=16): " + json.dumps(bwd_device_ms))

    # ---- 5. photometric forward and backward vs plain --------------------
    def photo_case(b, hh, ww, dtype):
        r = np.random.RandomState(hh * ww + b)
        imgs = [torch.from_numpy(r.rand(b, 3, hh, ww).astype(np.float32)).to(device, dtype)
                for _ in range(3)]
        fl = [torch.from_numpy(r.uniform(-5, 5, (b, 2, hh, ww)).astype(np.float32)).to(device)
              for _ in range(2)]
        return imgs[0], imgs[1], fl[0], fl[1], imgs[2]

    def photo_loss(out):
        return ((out["s_dw"] / (out["s_w"] + 1.0)).sum()
                + (out["s_cl"] / (out["s_w"] + 1.0)).sum())

    def photo_run(fn, case):
        il, ir, fb, ff, im = case
        fb = fb.clone().requires_grad_(True)
        ff = ff.clone().requires_grad_(True)
        out = fn(il, ir, fb, ff, im)
        gb, gf = torch.autograd.grad(photo_loss(out), [fb, ff])
        return out, gb, gf

    def photo_bits(t):
        """A digest of a tensor's bits (equal digests: equal bits)."""
        ints = t.detach().contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                                            else torch.int32)
        return f"{zlib.crc32(ints.cpu().numpy().tobytes()):08x}"

    photo_scale_ms = {}  # "kernel scale dtype" -> kernel ms (CUDA events)
    photo_device_ms = {}  # the same keys -> the profiler's device ms per launch
    photo_step = {}  # (kernel, dtype) -> [kernel ms, [device ms], bytes, operations] per step
    photo_cases = [*PHOTO_SCALES.items(), *(("ragged", r) for r in PHOTO_RAGGED)]
    for name, (b, hh, ww) in photo_cases:
        for dtype in (torch.float32, torch.bfloat16):
            case = photo_case(b, hh, ww, dtype)
            want, wb, wf = photo_run(photometric_pack_reference, case)
            reset_counts()
            got, gb, gf = photo_run(photometric_cuda.photometric, case)
            torch.cuda.synchronize()
            one = counts()
            if one != {**zero_counts, "photometric_fwd": 1, "photometric_bwd": 1}:
                raise AssertionError(f"photometric {name}: launches {one}, not 1 + 1")
            if got["weights"].dtype != dtype or got["weights"].shape != (2 * b, 1, hh, ww) \
                    or any(got[k].shape != (2 * b,) for k in ("s_dw", "s_w", "s_cl")):
                raise AssertionError(f"photometric {name}: kernel gave "
                                     f"{ {k: (v.dtype, tuple(v.shape)) for k, v in got.items()} }")
            if dtype == torch.float32:
                ref32, rb32, rf32 = want, wb, wf
            else:
                for k in ("s_dw", "s_w", "s_cl"):
                    torch.testing.assert_close(got[k], want[k], rtol=2e-2, atol=2e-2)
                wdiff = float((got["weights"].float() - want["weights"].float()).abs().mean())
                if wdiff > 2e-2:
                    raise AssertionError(f"photometric {name} bf16 weights: mean |diff| {wdiff}")
                ref32, rb32, rf32 = photo_run(photometric_pack_reference,
                                              [t.float() for t in case])
            for k in ("s_dw", "s_w", "s_cl"):
                torch.testing.assert_close(got[k], ref32[k], rtol=1e-4, atol=1e-4)
            wtol = 1e-5 if dtype == torch.float32 else 2**-8
            torch.testing.assert_close(got["weights"].float(), ref32["weights"].float(),
                                       rtol=wtol, atol=1e-5)
            gerr = max(float((gb - rb32).abs().max()), float((gf - rf32).abs().max()))
            gmax = max(float(rb32.abs().max()), float(rf32.abs().max()))
            if gerr > 1e-4 * gmax:
                raise AssertionError(f"photometric {name} {dtype}: d(flow) err {gerr} vs max {gmax}")
            ferr = max(float((got[k] - ref32[k]).detach().abs().max())
                       for k in ("s_dw", "s_w", "s_cl"))
            max_err["photometric_fwd"] = max(max_err["photometric_fwd"], ferr)
            max_err["photometric_bwd"] = max(max_err["photometric_bwd"], gerr)
            # two calls on the same inputs: the same bits (no atomics)
            il, ir, fb, ff, im = case
            gdw = torch.rand(2 * b, generator=gen, device=device)
            gcl = torch.rand(2 * b, generator=gen, device=device)
            f1, f2 = (photometric_cuda.photo_fwd(il, ir, fb, ff, im) for _ in range(2))
            d1, d2 = (photometric_cuda.photo_bwd(il, ir, fb, ff, im, gdw, gcl) for _ in range(2))
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in (*zip(f1, f2), *zip(d1, d2))):
                raise AssertionError(f"photometric {name} {(b, hh, ww)} {dtype}: two calls differ")
            bits = f"weights bits {photo_bits(got['weights'])}"
            if name == "ragged":
                print(f"photometric ragged {(b, 3, hh, ww)} {str(dtype)[6:]}: sums max_abs_err="
                      f"{ferr:.3e} d(flow) max_abs_err={gerr:.3e} (max {gmax:.3e}), 1 + 1 "
                      f"launches, two calls bit-equal, {bits}")
                continue
            fbg = fb.clone().requires_grad_(True)
            ffg = ff.clone().requires_grad_(True)
            with torch.no_grad():
                k_fwd = _time_ms(torch, lambda: photometric_cuda.photo_fwd(il, ir, fb, ff, im))
                dev_fwd = _device_ms(torch, lambda: photometric_cuda.photo_fwd(il, ir, fb, ff, im),
                                     "photo_fwd_kernel")
                p_fwd = _time_ms(torch, lambda: photometric_pack_reference(il, ir, fb, ff, im),
                                 inner=2)
            k_bwd = _time_ms(torch, lambda: photometric_cuda.photo_bwd(il, ir, fb, ff, im, gdw, gcl))
            dev_bwd = _device_ms(torch, lambda: photometric_cuda.photo_bwd(il, ir, fb, ff, im, gdw,
                                                                           gcl),
                                 "photo_bwd_kernel")
            loss = photo_loss(photometric_pack_reference(il, ir, fbg, ffg, im))
            p_bwd = _time_ms(torch, lambda: torch.autograd.grad(loss, [fbg, ffg],
                                                                 retain_graph=True), inner=2)
            n = b * hh * ww
            esz = 4 if dtype == torch.float32 else 2
            # fwd: 3 images and 2 flows read, 2B weights written; bwd: the
            # same inputs read, 2 flow gradients written
            works = {"photometric_fwd": ((9 * esz + 4 * 4 + 2 * esz) * n,
                                         OPS_PER_POSITION["photometric_fwd"] * n),
                     "photometric_bwd": ((9 * esz + 4 * 4 + 4 * 4) * n,
                                         OPS_PER_POSITION["photometric_bwd"] * n)}
            dt = str(dtype)[6:]
            for kname, k_ms, dev, p_ms in (("photometric_fwd", k_fwd, dev_fwd, p_fwd),
                                           ("photometric_bwd", k_bwd, dev_bwd, p_bwd)):
                key = f"{kname[12:]} {name} {dt}"
                photo_scale_ms[key] = round(k_ms, 4)
                photo_device_ms[key] = dev
                acc = photo_step.setdefault((kname, dt), [0.0, [], 0.0, 0.0])
                acc[0] += k_ms
                acc[1].append(dev)
                acc[2] += works[kname][0]
                acc[3] += works[kname][1]
                if dtype == torch.float32:
                    ms[kname] += k_ms
                    plain_ms[kname] += p_ms
                    add_work(kname, *works[kname])
                else:  # bf16 images and weights, float32 flows
                    add_bf16(kname, k_ms, p_ms, *works[kname])
            print(f"photometric {name} {(b, 3, hh, ww)} {dt}: sums max_abs_err="
                  f"{ferr:.3e} d(flow) max_abs_err={gerr:.3e} (max {gmax:.3e}), 1 + 1 launches, "
                  f"two calls bit-equal, {bits}; fwd kernel_ms={k_fwd:.4f} device_ms={dev_fwd} "
                  f"plain_ms={p_fwd:.4f} bwd kernel_ms={k_bwd:.4f} device_ms={dev_bwd} "
                  f"plain_ms={p_bwd:.4f}")
    print("photometric kernel ms per scale (batch 8): " + json.dumps(photo_scale_ms))
    print("photometric device ms per launch (profiler, batch 8): " + json.dumps(photo_device_ms))
    for (kname, dt), (k_ms, dev, nbytes, ops) in photo_step.items():
        bound_ms, bound_by = _bound(nbytes, ops)
        dev_s = ("not measured" if "not measured" in dev
                 else f"{sum(float(v) for v in dev):.4f}")
        print(f"{kname} per training step (3 scales, {dt} images): kernel_ms={k_ms:.4f} "
              f"device_ms={dev_s} bound_ms={bound_ms:.4f} ({bound_by}), "
              f"{k_ms / bound_ms:.1f}x the bound")
    # the flows above are uniform in +-5 px pixel by pixel, the worst case for
    # the kernels' gathers; the decoder's flows are smooth: s0 again on flows
    # bilinearly upsampled from a field 32 times coarser, in the same range
    smooth_ms = {}
    b, hh, ww = PHOTO_SCALES["s0"]
    r = np.random.RandomState(SEED + 5)
    fb, ff = (torch.nn.functional.interpolate(
        torch.from_numpy(r.uniform(-5, 5, (b, 2, hh // 32, ww // 32)).astype(np.float32)).to(
            device), size=(hh, ww), mode="bilinear", align_corners=False).contiguous()
        for _ in range(2))
    gdw = torch.rand(2 * b, generator=gen, device=device)
    gcl = torch.rand(2 * b, generator=gen, device=device)
    for dtype in (torch.float32, torch.bfloat16):
        il, ir, _, _, im = photo_case(b, hh, ww, dtype)
        dt = str(dtype)[6:]
        with torch.no_grad():
            smooth_ms[f"fwd s0 {dt}"] = _device_ms(
                torch, lambda: photometric_cuda.photo_fwd(il, ir, fb, ff, im), "photo_fwd_kernel")
        smooth_ms[f"bwd s0 {dt}"] = _device_ms(
            torch, lambda: photometric_cuda.photo_bwd(il, ir, fb, ff, im, gdw, gcl),
            "photo_bwd_kernel")
    print("photometric device ms per launch at s0 on smooth flows (profiler): "
          + json.dumps(smooth_ms))
    torch.cuda.empty_cache()

    # ---- 6. the training slice: train() at the KITTI recipe --------------
    model_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(model_dir, exist_ok=True)
    tcfg = recipe_config(num_iterations=TRAIN_STEPS, init_scheme="pwc", seed=SEED,
                         log_interval=5, save_interval=1000, model_dir=model_dir,
                         num_workers=4)
    data = SyntheticSnippets(IMG_HW, TRAIN_STEPS * BATCH, seed=SEED)
    events, metrics = [], []

    def on_step(it, m):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        metrics.append(m)

    init = FlowModel(FlowModelConfig(), device=device, scheme="pwc",
                     generator=torch.Generator().manual_seed(SEED))
    reset_counts()
    t0 = time.perf_counter()
    res = train(tcfg, dataset=data, device="cuda", on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_counts = counts()
    if train_counts != {k: TRAIN_STEPS * v for k, v in PER_STEP.items()}:
        raise AssertionError(f"training launches {train_counts} for {TRAIN_STEPS} steps")
    if res.step != TRAIN_STEPS or len(metrics) != TRAIN_STEPS:
        raise AssertionError(f"trained {res.step} steps, {len(metrics)} reported")
    for i, m in enumerate(metrics):
        bad = [k for k, v in m.items() if not bool(torch.isfinite(v))]
        if bad:
            raise AssertionError(f"step {i}: non-finite {bad}")
    moved = sum(not torch.equal(a, b) for a, b in zip(init.parameters(), res.model.parameters()))
    if moved != len(list(init.parameters())):
        raise AssertionError(f"only {moved} parameter tensors changed")
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(2, TRAIN_STEPS - 1)]
    ms_step = statistics.median(step_ms)
    print(f"training slice float32 {BATCH}x{h}x{w}, 3 scales: {TRAIN_STEPS} steps in "
          f"{wall:.2f} s; ms/step median {ms_step:.3f} (min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f}, CUDA events); {BATCH / ms_step * 1e3:.2f} snippets/s; "
          f"launches per step {PER_STEP}")
    print("losses: " + json.dumps([{k: float(v) for k, v in m.items()} for m in metrics[::3]]))
    del res, init
    torch.cuda.empty_cache()

    # ---- 7. step parity with the plain versions, and bf16 training ---------
    cfg32 = FlowModelConfig()
    model = FlowModel(cfg32, device=device, scheme="pwc",
                      generator=torch.Generator().manual_seed(SEED))
    batch = torch.from_numpy(data.snippets[:BATCH].astype(np.float32) / 255.0).to(device)
    nudged = torch.nextafter(batch, torch.full_like(batch, 2.0))
    weights = loss_weights_from_config(tcfg)
    plain = dict(corr_fn=cost_volume_reference, photo_fn=photometric_pack_reference)

    def grads(x, wts, **fns):
        model.zero_grad(set_to_none=True)
        total, means = loss_fn(model, cfg32, x, wts, **fns)
        total.backward()
        return ({k: v.detach() for k, v in means.items()},
                {k: p.grad.clone() for k, p in model.named_parameters()})

    def flat(g):
        return torch.cat([g[k].ravel() for k in sorted(g)])

    want, _ = grads(batch, weights, **plain)
    got, _ = grads(batch, weights)
    for k in want:
        if not (torch.isfinite(got[k]) and torch.isfinite(want[k])):
            raise AssertionError(f"step parity: non-finite {k}")
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-6)
    print("step parity float32 kernels vs plain, losses: "
          + json.dumps({k: [float(got[k]), float(want[k])] for k in want}))
    for part, wts in (("photometric", PHOTO_W), ("total", weights)):
        _, want_g = grads(batch, wts, **plain)
        _, noise_g = grads(nudged, wts, **plain)
        _, got_g = grads(batch, wts)
        err = _rel_l2(flat(got_g), flat(want_g))
        noise = _rel_l2(flat(noise_g), flat(want_g))
        worst = sorted(((_rel_l2(got_g[k], want_g[k]), _rel_l2(noise_g[k], want_g[k]), k)
                        for k in want_g), reverse=True)[:3]
        print(f"step parity float32 {part} gradient: kernels vs plain rel L2 {err:.3e}, plain "
              f"vs plain on snippets one ulp away {noise:.3e}; worst tensors (kernels, "
              f"nudged): " + ", ".join(f"{k} {a:.2e} {n:.2e}" for a, n, k in worst))
        if err > max(1e-4, noise):
            raise AssertionError(f"step parity failed: {part} gradient")
        del want_g, noise_g, got_g
    del model
    torch.cuda.empty_cache()

    bcfg = recipe_config(num_iterations=BF16_STEPS, init_scheme="pwc", seed=SEED,
                         precision="bfloat16", loss_precision="bfloat16", log_interval=1,
                         save_interval=1000, model_dir=model_dir, num_workers=4)
    bmetrics, bevents = [], []

    def on_bf16_step(it, m):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        bevents.append(ev)
        bmetrics.append(m)

    reset_counts()
    train(bcfg, dataset=SyntheticSnippets(IMG_HW, BF16_STEPS * BATCH, seed=SEED + 1),
          device="cuda", on_step=on_bf16_step)
    torch.cuda.synchronize()
    bf16_counts = counts()
    if bf16_counts != {k: BF16_STEPS * v for k, v in PER_STEP.items()}:
        raise AssertionError(f"bf16 training launches {bf16_counts}")
    if not all(bool(torch.isfinite(v)) for m in bmetrics for v in m.values()):
        raise AssertionError("bf16 training: non-finite loss")
    ms_step_bf16 = statistics.median(bevents[i].elapsed_time(bevents[i + 1])
                                     for i in range(2, BF16_STEPS - 1))
    print(f"bf16 training: {BF16_STEPS} steps, finite losses, ms/step median "
          f"{ms_step_bf16:.3f} (CUDA events), launches {bf16_counts}")
    torch.cuda.empty_cache()

    # ---- 8. regularizer forward and backward vs plain -----------------------
    def reg_case(b, hh, ww, dtype):
        r = np.random.RandomState(hh * ww + b + 1)
        coarse = torch.from_numpy(
            r.uniform(-5, 5, (b, 4, (hh + 3) // 4, (ww + 3) // 4)).astype(np.float32))
        fl = torch.nn.functional.interpolate(coarse, scale_factor=4, mode="nearest")
        noise = (r.rand(b, 4, hh, ww) < 0.3) * r.uniform(-1, 1, (b, 4, hh, ww))
        fl = (fl[:, :, :hh, :ww] + torch.from_numpy(noise).float()).to(device)
        img = torch.from_numpy(r.rand(b, 3, hh, ww).astype(np.float32)).to(device, dtype)
        w_fwd = torch.from_numpy(r.rand(b, 1, hh, ww).astype(np.float32)).to(device, dtype)
        return fl[:, :2].contiguous(), fl[:, 2:].contiguous(), img, w_fwd

    def reg_run(fn, case, cot):
        fb, ff, img, w_fwd = case
        fb = fb.clone().requires_grad_(True)
        ff = ff.clone().requires_grad_(True)
        out = fn(fb, ff, img, w_fwd)
        gb, gf = torch.autograd.grad(sum((out[k] * cot[k]).sum() for k in out), [fb, ff])
        return {k: v.detach() for k, v in out.items()}, gb, gf

    reg_keys = ("s_sx", "s_sy", "s_consis")
    reg_scale_ms = {}  # "kernel scale dtype" -> kernel ms (CUDA events)
    reg_device_ms = {}  # the same keys -> the profiler's device ms per launch
    reg_call_ms = {}  # the same keys -> device ms per call, the calls queued behind a sleep
    reg_step = {}  # (kernel, dtype) -> [kernel ms, [device ms], [call ms], bytes, operations]
    for name, (b, hh, ww) in [*PHOTO_SCALES.items(), *(("ragged", r) for r in REG_RAGGED)]:
        cot = {"s_sx": torch.rand(2 * b, generator=gen, device=device),
               "s_sy": torch.rand(2 * b, generator=gen, device=device),
               "s_consis": torch.rand(b, generator=gen, device=device)}
        for dtype in (torch.float32, torch.bfloat16):
            case = reg_case(b, hh, ww, dtype)
            reset_counts()
            got, gb, gf = reg_run(regularizer_cuda.regularizer, case, cot)
            torch.cuda.synchronize()
            one = counts()
            if one != {**zero_counts, "regularizer_fwd": 1, "regularizer_bwd": 1}:
                raise AssertionError(f"regularizer {name}: launches {one}, not 1 + 1")
            refs = [reg_run(regularizer_pack_reference, case, cot)]
            if dtype == torch.bfloat16:
                for k in reg_keys:
                    torch.testing.assert_close(got[k], refs[0][0][k], rtol=2e-2, atol=2e-2)
                refs = [reg_run(regularizer_pack_reference,
                                [t.float() for t in case], cot)]
            want, wb, wf = refs[0]
            for k in reg_keys:
                if got[k].dtype != torch.float32 or got[k].shape != want[k].shape:
                    raise AssertionError(f"regularizer {name}: kernel gave {got[k].dtype} "
                                         f"{tuple(got[k].shape)}")
                torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4)
            gerr = max(float((gb - wb).abs().max()), float((gf - wf).abs().max()))
            gmax = max(float(wb.abs().max()), float(wf.abs().max()))
            zeros = int(((gb == 0) != (wb == 0)).sum() + ((gf == 0) != (wf == 0)).sum())
            if gerr > 1e-4 * gmax or zeros:
                raise AssertionError(f"regularizer {name} {dtype}: d(flow) err {gerr} vs max "
                                     f"{gmax}, {zeros} positions zero in one gradient only")
            ferr = max(float((got[k] - want[k]).abs().max()) for k in reg_keys)
            max_err["regularizer_fwd"] = max(max_err["regularizer_fwd"], ferr)
            max_err["regularizer_bwd"] = max(max_err["regularizer_bwd"], gerr)
            # two calls of each kernel on the same inputs: one launch each, the same bits
            fb, ff, img, w_fwd = case
            reset_counts()
            f1, f2 = (regularizer_cuda.reg_fwd(fb, ff, img, w_fwd) for _ in range(2))
            d1, d2 = (regularizer_cuda.reg_bwd(fb, ff, img, w_fwd, cot["s_sx"], cot["s_sy"],
                                               cot["s_consis"]) for _ in range(2))
            torch.cuda.synchronize()
            if counts() != {**zero_counts, "regularizer_fwd": 2, "regularizer_bwd": 2}:
                raise AssertionError(f"regularizer {name}: two calls launched {counts()}")
            if not all(torch.equal(x, y) for x, y in (*zip(f1, f2), *zip(d1, d2))):
                raise AssertionError(f"regularizer {name} {(b, hh, ww)} {dtype}: two calls differ")
            # a digest of d(flow)'s bits, to hold this kernel's against another's
            bits = f"d(flow) bits {photo_bits(torch.cat([d1[0].ravel(), d1[1].ravel()]))}"
            dt = str(dtype)[6:]
            head = (f"regularizer {name} {(b, 3, hh, ww)} {dt}: sums max_abs_err={ferr:.3e} "
                    f"d(flow) max_abs_err={gerr:.3e} (max {gmax:.3e}), 1 + 1 launches, two "
                    f"calls bit-equal, {bits}")
            if name == "ragged":
                print(head)
                continue
            bwd_call = (lambda: regularizer_cuda.reg_bwd(fb, ff, img, w_fwd, cot["s_sx"],
                                                         cot["s_sy"], cot["s_consis"]))
            with torch.no_grad():
                k_fwd = _time_ms(torch, lambda: regularizer_cuda.reg_fwd(fb, ff, img, w_fwd))
                dev_fwd = _device_ms(torch, lambda: regularizer_cuda.reg_fwd(fb, ff, img, w_fwd),
                                     "reg_fwd_kernel")
                call_fwd = _queued_ms(torch, lambda: regularizer_cuda.reg_fwd(fb, ff, img, w_fwd))
                p_fwd = _time_ms(torch, lambda: regularizer_pack_reference(fb, ff, img, w_fwd),
                                 inner=2)
            k_bwd = _time_ms(torch, bwd_call)
            dev_bwd = _device_ms(torch, bwd_call, "reg_bwd_kernel")
            call_bwd = _queued_ms(torch, bwd_call)
            fbg = fb.clone().requires_grad_(True)
            ffg = ff.clone().requires_grad_(True)
            out = regularizer_pack_reference(fbg, ffg, img, w_fwd)
            loss = sum((out[k] * cot[k]).sum() for k in out)
            p_bwd = _time_ms(torch, lambda: torch.autograd.grad(loss, [fbg, ffg],
                                                                 retain_graph=True), inner=2)
            n = b * hh * ww
            esz = 4 if dtype == torch.float32 else 2
            # fwd: 4 flow values, 3 image values and 1 weight read per position;
            # bwd: the same read, 4 flow gradients written
            works = {"regularizer_fwd": ((4 * 4 + 4 * esz) * n,
                                         OPS_PER_POSITION["regularizer_fwd"] * n),
                     "regularizer_bwd": ((4 * 4 + 4 * esz + 4 * 4) * n,
                                         OPS_PER_POSITION["regularizer_bwd"] * n)}
            for kname, k_ms, dev, call, p_ms in (
                    ("regularizer_fwd", k_fwd, dev_fwd, call_fwd, p_fwd),
                    ("regularizer_bwd", k_bwd, dev_bwd, call_bwd, p_bwd)):
                key = f"{kname[12:]} {name} {dt}"
                reg_scale_ms[key] = round(k_ms, 4)
                reg_device_ms[key] = dev
                reg_call_ms[key] = round(call, 5)
                acc = reg_step.setdefault((kname, dt), [0.0, [], [], 0.0, 0.0])
                acc[0] += k_ms
                acc[1].append(dev)
                acc[2].append(call)
                acc[3] += works[kname][0]
                acc[4] += works[kname][1]
                if dtype == torch.float32:
                    ms[kname] += k_ms
                    plain_ms[kname] += p_ms
                    add_work(kname, *works[kname])
                else:  # bf16 images and weights, float32 flows
                    add_bf16(kname, k_ms, p_ms, *works[kname])
            print(f"{head}; fwd kernel_ms={k_fwd:.4f} device_ms={dev_fwd} call_device_ms="
                  f"{call_fwd:.4f} plain_ms={p_fwd:.4f} bwd kernel_ms={k_bwd:.4f} device_ms="
                  f"{dev_bwd} call_device_ms={call_bwd:.4f} plain_ms={p_bwd:.4f}")
    print("regularizer kernel ms per scale (batch 8): " + json.dumps(reg_scale_ms))
    print("regularizer device ms per launch (profiler, batch 8): " + json.dumps(reg_device_ms))
    print("regularizer device ms per call (every kernel and memset of a call, the calls "
          "queued behind a sleep): " + json.dumps(reg_call_ms))
    for (kname, dt), (k_ms, dev, call, nbytes, ops) in reg_step.items():
        bound_ms, bound_by = _bound(nbytes, ops)
        dev_s = "not measured" if "not measured" in dev else f"{sum(map(float, dev)):.4f}"
        print(f"{kname} per training step (3 scales, {dt} images): kernel_ms={k_ms:.4f} "
              f"device_ms={dev_s} call_device_ms={sum(call):.4f} bound_ms={bound_ms:.4f} "
              f"({bound_by}), {k_ms / bound_ms:.1f}x the bound")
    for kname, (k_ms, p_ms, nbytes, ops) in bf16_step.items():
        bound_ms, bound_by = _bound(nbytes, ops)
        print(f"{kname} per training step (3 scales, bfloat16 images): kernel_ms={k_ms:.4f} "
              f"plain_ms={p_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by})")
    torch.cuda.empty_cache()

    # ---- 9. training with the regularizer kernels, one interleaved evaluation
    eval_rng = np.random.RandomState(SEED + 7)

    def gt_set(n):
        gh, gw = KITTI_GT_HW
        gts, nocs, movs = [], [], []
        for _ in range(n):
            gt = np.zeros((gh, gw, 3), np.float64)
            gt[:, :, :2] = np.round(eval_rng.uniform(-20, 20, (gh, gw, 2)) * 64) / 64
            gt[:, :, 2] = eval_rng.rand(gh, gw) > 0.2
            gts.append(gt)
            nocs.append(gt[:, :, 2] * (eval_rng.rand(gh, gw) > 0.3))
            movs.append((eval_rng.rand(gh, gw) > 0.6).astype(np.uint16))
        return gts, nocs, movs

    def eval_pairs(n, seed):
        snips = SyntheticSnippets(IMG_HW, n, seed=seed).snippets
        return [snips[i % len(snips), :2 * h].astype(np.float32) / 255.0 for i in range(n)]

    g12, n12, _ = gt_set(EVAL_SET_PAIRS)
    g15, n15, m15 = gt_set(EVAL_SET_PAIRS)
    sets = {"2012": evaluation.EvalSet(eval_pairs(EVAL_SET_PAIRS, SEED + 2), g12, n12),
            "2015": evaluation.EvalSet(eval_pairs(EVAL_SET_PAIRS, SEED + 3), g15, n15, m15)}
    reg_model_dir = os.path.join(model_dir, "reg")
    os.makedirs(reg_model_dir, exist_ok=True)
    rcfg = recipe_config(num_iterations=REG_STEPS, init_scheme="pwc", seed=SEED,
                         log_interval=REG_STEPS, save_interval=1000, model_dir=reg_model_dir,
                         num_workers=4, no_test=False, test_interval=REG_STEPS)
    rmetrics = []
    reset_counts()
    t0 = time.perf_counter()
    train(rcfg, dataset=SyntheticSnippets(IMG_HW, REG_STEPS * BATCH, seed=SEED + 4),
          device="cuda", on_step=lambda it, m: rmetrics.append(m),
          model_overrides={"use_pallas_reg": True}, eval_sets=sets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reg_counts = counts()
    eval_batches = 2 * math.ceil(EVAL_SET_PAIRS / BATCH)
    want_counts = {k: REG_STEPS * v for k, v in PER_STEP_REG.items()}
    want_counts["corr_fwd"] += 5 * eval_batches
    if reg_counts != want_counts:
        raise AssertionError(f"regularizer training launches {reg_counts}, want {want_counts}")
    if len(rmetrics) != REG_STEPS or not all(bool(torch.isfinite(v))
                                              for m in rmetrics for v in m.values()):
        raise AssertionError("regularizer training: missing or non-finite losses")
    with open(os.path.join(reg_model_dir, "log.pkl"), "rb") as f:
        log = pickle.load(f)
    if len(log) != 1 or len(_values(log[0]["eval_2015_res"])) != 8 \
            or len(_values(log[0]["eval_2012_res"])) != 4 \
            or not all(math.isfinite(v) for r in log[0].values() for v in _values(r)):
        raise AssertionError(f"interleaved evaluation log {log}")
    print(f"training with use_pallas_reg, float32: {REG_STEPS} steps and one interleaved "
          f"evaluation ({eval_batches} batches) in {wall:.2f} s; launches {reg_counts}")
    print("interleaved evaluation: " + json.dumps(log[0]))

    rcfg32 = FlowModelConfig(use_pallas_reg=True)
    model = FlowModel(rcfg32, device=device, scheme="pwc",
                      generator=torch.Generator().manual_seed(SEED))

    def reg_grads(x, **fns):
        model.zero_grad(set_to_none=True)
        total, means = loss_fn(model, rcfg32, x, weights, **fns)
        total.backward()
        return ({k: v.detach() for k, v in means.items()},
                {k: p.grad.clone() for k, p in model.named_parameters()})

    plain_reg = dict(reg_fn=regularizer_pack_reference)
    want, want_g = reg_grads(batch, **plain_reg)
    _, noise_g = reg_grads(nudged, **plain_reg)
    got, got_g = reg_grads(batch)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-6)
    err = _rel_l2(flat(got_g), flat(want_g))
    noise = _rel_l2(flat(noise_g), flat(want_g))
    print("step parity float32, regularizer kernels vs plain regularizer, losses: "
          + json.dumps({k: [float(got[k]), float(want[k])] for k in want})
          + f"; total gradient rel L2 {err:.3e}, plain vs plain one ulp away {noise:.3e}")
    if err > max(1e-4, noise):
        raise AssertionError("step parity failed: regularizer total gradient")
    del model, want_g, noise_g, got_g
    torch.cuda.empty_cache()

    bcfg = recipe_config(num_iterations=REG_BF16_STEPS, init_scheme="pwc", seed=SEED,
                         precision="bfloat16", loss_precision="bfloat16", log_interval=1,
                         save_interval=1000, model_dir=reg_model_dir, num_workers=4)
    bmetrics = []
    reset_counts()
    train(bcfg, dataset=SyntheticSnippets(IMG_HW, REG_BF16_STEPS * BATCH, seed=SEED + 5),
          device="cuda", on_step=lambda it, m: bmetrics.append(m),
          model_overrides={"use_pallas_reg": True})
    torch.cuda.synchronize()
    bf16_reg_counts = counts()
    if bf16_reg_counts != {k: REG_BF16_STEPS * v for k, v in PER_STEP_REG.items()}:
        raise AssertionError(f"bf16 regularizer training launches {bf16_reg_counts}")
    if not all(bool(torch.isfinite(v)) for m in bmetrics for v in m.values()):
        raise AssertionError("bf16 regularizer training: non-finite loss")
    print(f"bf16 training with use_pallas_reg: {REG_BF16_STEPS} steps, finite losses, "
          f"launches {bf16_reg_counts}")
    torch.cuda.empty_cache()

    # ---- 10. evaluation: batched inference and the KITTI metrics ------------
    emodel = FlowModel(FlowModelConfig(), device=device, scheme="pwc",
                       generator=torch.Generator().manual_seed(SEED))
    pairs = eval_pairs(EVAL_PAIRS, SEED + 6)
    batches = []

    def infer(i1, i2):
        before = correlation_cuda.launches["corr_fwd"]
        out = evaluation.make_infer(emodel)(i1, i2)
        batches.append((tuple(i1.shape), correlation_cuda.launches["corr_fwd"] - before))
        return out

    reset_counts()
    t0 = time.perf_counter()
    flows = evaluation._batched_flows(infer, iter(pairs), EVAL_PAIRS, device)
    torch.cuda.synchronize()
    t_infer = time.perf_counter() - t0
    if batches != [((BATCH, h, w, 3), 5)] * math.ceil(EVAL_PAIRS / BATCH) \
            or counts()["corr_fwd"] != 5 * len(batches):
        raise AssertionError(f"evaluation batches {batches}")
    if len(flows) != EVAL_PAIRS or any(f.shape != (h, w, 2) or not f.is_cuda for f in flows):
        raise AssertionError("evaluation: bad flows")
    gts, nocs, movs = gt_set(EVAL_PAIRS)
    ecfg = types.SimpleNamespace(img_hw=IMG_HW)
    t0 = time.perf_counter()
    res = eval_flow_avg(gts, nocs, flows, ecfg, moving_masks=movs)
    t_metrics = time.perf_counter() - t0
    res_cpu = eval_flow_avg(gts, nocs, [f.cpu() for f in flows], ecfg, moving_masks=movs)
    got_v, cpu_v = _values(res), _values(res_cpu)
    if res.split("\n")[0] != res_cpu.split("\n")[0] or len(got_v) != 8 \
            or not all(math.isfinite(v) for v in got_v) \
            or max(abs(a - b) for a, b in zip(got_v, cpu_v)) > 1e-4 + 1e-9:
        raise AssertionError(f"evaluation metrics: card\n{res}CPU\n{res_cpu}")
    print(f"evaluation: {EVAL_PAIRS} pairs in {len(batches)} batches of {BATCH} (5 correlation "
          f"launches each), inference {t_infer:.3f} s, metrics at {KITTI_GT_HW} "
          f"{t_metrics:.3f} s; card and CPU agree:\n{res}", end="")
    del emodel, flows
    torch.cuda.empty_cache()

    # ---- 11. spatial (height-sharded) inference and serving -----------------
    n_cards = torch.cuda.device_count()

    def shard_devices(n):
        return [f"cuda:{i}" for i in range(n)] if n_cards >= n else ["cuda:0"] * n

    for n in (1, *SPATIAL_N):
        print(f"spatial n={n}: shards on {shard_devices(n)} ({n_cards} card(s) visible)")

    # (a) the halo-prepadded kernels against their plain versions, per shard
    hpad_kernels = (
        ("corr_fwd_hpad", correlation_cuda.corr_fwd_hpad, corr_fwd_hpad_reference),
        ("corr_bwd_df1_hpad", correlation_cuda.corr_df1_hpad, corr_df1_hpad_reference),
        ("corr_bwd_df2_hpad", correlation_cuda.corr_df2_hpad, corr_df2_hpad_reference),
    )
    hpad_cases = [(f"n{n}_{lvl}", n, (b_, c_, h_ // n, w_))
                  for n in SPATIAL_N for lvl, (b_, c_, h_, w_) in SERVE_LEVELS.items()]
    hpad_level_ms = {}
    hpad_device_ms = {}  # the hpad backward's device ms per launch (profiler)
    for name, n, (b_, c_, h_, w_) in [*hpad_cases, *(("ragged", 0, r) for r in RAGGED_HPAD)]:
        for dtype, rtol, atol in corr_tols:
            def rnd(*shape):
                return torch.randn(shape, generator=gen, device=device).to(dtype)

            f1, f2h, f1h = rnd(b_, c_, h_, w_), rnd(b_, c_, h_ + 2 * MD, w_), rnd(
                b_, c_, h_ + 2 * MD, w_)
            g, gh = rnd(b_, 81, h_, w_), rnd(b_, 81, h_ + 2 * MD, w_)
            args = {"corr_fwd_hpad": (f1, f2h), "corr_bwd_df1_hpad": (g, f2h),
                    "corr_bwd_df2_hpad": (gh, f1h)}
            line = []
            for kname, kern, ref in hpad_kernels:
                got = kern(*args[kname], MD)
                torch.cuda.synchronize()
                want = ref(*args[kname], MD)
                want_shape = (b_, 81 if kname == "corr_fwd_hpad" else c_, h_, w_)
                if got.dtype != dtype or tuple(got.shape) != want_shape:
                    raise AssertionError(f"{kname} {name}: kernel gave {got.dtype} "
                                         f"{tuple(got.shape)}")
                if kname == "corr_fwd_hpad":
                    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
                    held = ""
                else:
                    held = " (" + _hold_bwd(torch, got, want, rtol, atol, lambda: ref(
                        *(a.abs() for a in args[kname]), MD)) + ")"
                note(kname, got, want)
                err = float((got.float() - want.float()).abs().max())
                if name == "ragged":
                    line.append(f"{kname} max_abs_err={err:.3e}{held}")
                    continue
                k_ms = _time_ms(torch, lambda: kern(*args[kname], MD))
                p_ms = _time_ms(torch, lambda: ref(*args[kname], MD), inner=2)
                line.append(f"{kname} max_abs_err={err:.3e}{held} kernel_ms={k_ms:.4f} "
                            f"plain_ms={p_ms:.4f}")
                hpad_level_ms[f"{kname[5:]} {name} {str(dtype)[6:]}"] = round(k_ms, 4)
                if kname != "corr_fwd_hpad":
                    hpad_device_ms[f"{kname[5:]} {name} {str(dtype)[6:]}"] = _device_ms(
                        torch, lambda: kern(*args[kname], MD), f"corr_{kname[9:12]}_kernel")
                if n == 2 and dtype == torch.float32:  # both shards of a level
                    ms[kname] += n * k_ms
                    plain_ms[kname] += n * p_ms
                    in_rows = h_ + 2 * MD  # the operands that carry the halo
                    nbytes = {"corr_fwd_hpad": c_ * h_ + c_ * in_rows + 81 * h_,
                              "corr_bwd_df1_hpad": 81 * h_ + c_ * in_rows + c_ * h_,
                              "corr_bwd_df2_hpad": 81 * in_rows + c_ * in_rows + c_ * h_}
                    add_work(kname, n * nbytes[kname] * b_ * w_ * 4,
                             n * 2 * 81 * c_ * b_ * h_ * w_)
            print(f"hpad {name} {(b_, c_, h_, w_)} {str(dtype)[6:]}: " + "; ".join(line))
    for kname, _, _ in hpad_kernels:
        print(f"{kname} per spatial batch (n=2: 5 levels x 2 shards, float32): "
              f"kernel_ms={ms[kname]:.4f} plain_ms={plain_ms[kname]:.4f}")
    print("hpad kernel ms per shard launch: " + json.dumps(hpad_level_ms))
    print("hpad backward device ms per launch (profiler): " + json.dumps(hpad_device_ms))

    # (b) make_spatial_infer against the unsharded inference_flow
    sp_model32 = FlowModel(FlowModelConfig(), device=device, scheme="pwc",
                           generator=torch.Generator().manual_seed(SEED))
    sp_model16 = FlowModel(FlowModelConfig(compute_dtype="bfloat16"), device=device)
    sp_model16.load_state_dict(sp_model32.state_dict())
    sp_rng = np.random.RandomState(SEED + 8)
    i1, i2 = (torch.from_numpy(sp_rng.rand(BATCH, h, w, 3).astype(np.float32)).to(device)
              for _ in range(2))
    spatial_fns = {n: {} for n in (1, *SPATIAL_N)}
    refs = {}
    for prec, model in (("float32", sp_model32), ("bfloat16", sp_model16)):
        with torch.inference_mode():
            ref = refs[prec] = inference_flow(model, i1, i2)
            peak = float(ref.abs().max())
            # bfloat16: the slabs' convolutions sum in other orders than the
            # whole map's and round differently to bf16 (probe.py spatial_gap),
            # so the sharded flow is held to the float32 flow, no farther from
            # it than BF16_SPATIAL_FACTOR times the unsharded bf16 flow is
            gap = 0.0 if prec == "float32" else float((ref - refs["float32"]).abs().max())
            tol = 1e-4 * (1 + peak) if prec == "float32" else BF16_SPATIAL_FACTOR * gap
            dense_ms = _time_ms(torch, lambda: inference_flow(model, i1, i2), reps=10, inner=1)
            line = [f"unsharded {dense_ms:.3f}"]
            for n in spatial_fns:
                fn = make_spatial_infer(model, spatial_mesh(n, devices=shard_devices(n)))
                spatial_fns[n][prec] = fn
                reset_counts()
                grid = fn(i1, i2)
                torch.cuda.synchronize()
                got_counts = counts()
                if got_counts != {**zero_counts, "corr_fwd_hpad": 5 * n}:
                    raise AssertionError(f"spatial n={n} {prec}: launches {got_counts}")
                out = gather_rows(grid, device)
                err = float((out - ref).abs().max())
                if prec == "float32":
                    held = f"tolerance {tol:.4e}, {err / tol:.3f} of it"
                else:  # held to the float32 flow
                    err_32 = float((out - refs["float32"]).abs().max())
                    held = (f"against float32 {err_32:.4e}, the unsharded bf16 flow's "
                            f"{gap:.4e}, {err_32 / gap:.3f} of it (limit {BF16_SPATIAL_FACTOR})")
                print(f"spatial n={n} {prec} {BATCH}x{h}x{w}: max_abs_err={err:.4e} against "
                      f"unsharded (max|flow|={peak:.4f}); {held}; launches {5 * n} "
                      "corr_fwd_hpad, 0 corr_fwd")
                if out.shape != ref.shape or not (err if prec == "float32" else err_32) <= tol:
                    raise AssertionError(f"spatial n={n} {prec}: parity failed")
                sp_ms = _time_ms(torch, lambda: fn(i1, i2), reps=10, inner=1)
                line.append(f"n={n} {sp_ms:.3f}")
        print(f"spatial {prec} ms/batch (CUDA events, one card): " + ", ".join(line))

    # (c) the sharded cost volume and the spatial path's parameter gradient
    for lvl, shape in TRAIN_LEVELS.items():
        n = SPATIAL_N[-1]
        f1 = torch.randn(shape, generator=gen, device=device)
        f2 = torch.randn(shape, generator=gen, device=device)
        g = torch.randn((shape[0], 81) + shape[2:], generator=gen, device=device)
        want = (correlation_cuda.corr_fwd(f1, f2, MD), correlation_cuda.corr_df1(g, f2, MD),
                correlation_cuda.corr_df2(g, f1, MD))
        a = [x.contiguous().requires_grad_(True) for x in torch.chunk(f1, n, 2)]
        b = [x.contiguous().requires_grad_(True) for x in torch.chunk(f2, n, 2)]
        cv = cost_volume_sharded(a, b, MD)
        torch.autograd.backward(cv, [x.contiguous() for x in torch.chunk(g, n, 2)])
        torch.cuda.synchronize()
        got = (torch.cat([x.detach() for x in cv], 2), torch.cat([x.grad for x in a], 2),
               torch.cat([x.grad for x in b], 2))
        rows = torch.arange(shape[2], device=device)
        hs = shape[2] // n
        seam = torch.zeros(shape[2], dtype=torch.bool, device=device)
        for k in range(1, n):
            seam |= (rows >= k * hs - MD) & (rows < k * hs + MD)
        line = []
        for what, x, y in zip(("values", "d(f1)", "d(f2)"), got, want):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
            e = (x - y).abs()
            line.append(f"{what} max_abs_err={float(e.max()):.3e} "
                        f"(seam rows {float(e[:, :, seam].max()):.3e})")
        print(f"sharded cost volume n={n} {lvl} {shape}: " + "; ".join(line))

    cot = torch.from_numpy(sp_rng.randn(BATCH, h, w, 2).astype(np.float32)).to(device)

    def param_grad(run):
        sp_model32.zero_grad(set_to_none=True)
        (run() * cot).sum().backward()
        return {k: p.grad.clone() for k, p in sp_model32.named_parameters()}

    g_dense = param_grad(lambda: inference_flow(sp_model32, i1, i2))
    g_noise = param_grad(lambda: inference_flow(
        sp_model32, *(torch.nextafter(x, torch.full_like(x, 2.0)) for x in (i1, i2))))
    reset_counts()
    g_sp = param_grad(lambda: gather_rows(spatial_fns[2]["float32"](i1, i2), device))
    torch.cuda.synchronize()
    grad_counts = counts()
    want_counts = {**zero_counts, "corr_fwd_hpad": 10, "corr_bwd_df1_hpad": 10,
                   "corr_bwd_df2_hpad": 10}
    # the last layer's gradient reads no warp and no activation after it: 1e-4;
    # the whole gradient passes every warp's flow derivative and LeakyReLU's
    # kink, so it is held to the unsharded path's own change on images moved by
    # one ulp (phase 7's rule)
    last = "pwc_model.dc_conv7.weight"
    rel_last = _rel_l2(g_sp[last], g_dense[last])
    rel = _rel_l2(flat(g_sp), flat(g_dense))
    noise = _rel_l2(flat(g_noise), flat(g_dense))
    worst = sorted(((_rel_l2(g_sp[k], g_dense[k]), k) for k in g_dense), reverse=True)[:3]
    print(f"spatial n=2 float32 parameter gradient of sum(flow * cot) against unsharded: "
          f"{last} rel L2 {rel_last:.3e}; all parameters rel L2 {rel:.3e}, unsharded vs "
          f"unsharded on images one ulp away {noise:.3e}; worst tensors "
          + ", ".join(f"{k} {e:.2e}" for e, k in worst) + f"; launches {grad_counts}")
    if grad_counts != want_counts or not rel_last <= 1e-4 or not rel <= max(1e-4, noise):
        raise AssertionError("spatial gradient check failed")
    sp_model32.zero_grad(set_to_none=True)
    del g_dense, g_noise, g_sp

    # (d) FlowServer(spatial=2) against the unsharded server
    sp_pairs = [np.concatenate([sp_rng.rand(h, w, 3), sp_rng.rand(h, w, 3)]).astype(np.float32)
                for _ in range(SPATIAL_REQUESTS)]
    server = FlowServer(types.SimpleNamespace(img_hw=IMG_HW), sp_model16, max_batch=BATCH,
                        max_wait_ms=5.0, spatial=2, devices=shard_devices(2))
    try:
        flows = [None] * SPATIAL_REQUESTS

        def sp_client(k):
            for i in range(k, SPATIAL_REQUESTS, SPATIAL_CLIENTS):
                flows[i] = server.infer(sp_pairs[i], timeout=300.0)

        threads = [threading.Thread(target=sp_client, args=(k,))
                   for k in range(SPATIAL_CLIENTS)]
        reset_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        sp_serve_counts = counts()
        if any(t.is_alive() for t in threads):
            raise AssertionError("spatial client threads did not finish")
        stats = json.loads(json.dumps(server.stats))
    finally:
        server.close()
    for i, f in enumerate(flows):
        if f is None or f.shape != (h, w, 2) or f.dtype != np.float32 or not np.isfinite(f).all():
            raise AssertionError(f"spatial request {i}: bad flow")
    if stats["served"] != SPATIAL_REQUESTS or stats["errors"] or stats["shed"] \
            or sp_serve_counts != {**zero_counts, "corr_fwd_hpad": 10 * stats["batches"]}:
        raise AssertionError(f"spatial server stats {stats}, launches {sp_serve_counts}")
    dense_server = FlowServer(types.SimpleNamespace(img_hw=IMG_HW), sp_model16,
                              max_batch=BATCH, max_wait_ms=5.0)
    try:
        want = dense_server.infer(sp_pairs[0], timeout=300.0)
    finally:
        dense_server.close()
    peak = float(np.abs(want).max())
    err = float(np.abs(flows[0] - want).max())
    with torch.inference_mode():
        pair = torch.from_numpy(sp_pairs[0]).to(device)
        want32 = inference_flow(sp_model32, pair[None, :h], pair[None, h:])[0].cpu().numpy()
    gap = float(np.abs(want - want32).max())
    err_32 = float(np.abs(flows[0] - want32).max())
    print(f"spatial server (n=2, bfloat16): {stats['served']} requests in {stats['batches']} "
          f"batches, occupancy {stats['occupancy']}, corr_fwd_hpad launches "
          f"{sp_serve_counts['corr_fwd_hpad']} (10 per batch), wall {wall:.3f} s; request 0 "
          f"against the unsharded server max_abs_err={err:.4e} (max|flow|={peak:.4f}); "
          f"against the float32 flow {err_32:.4e}, the unsharded server's {gap:.4e}, "
          f"{err_32 / gap:.3f} of it (limit {BF16_SPATIAL_FACTOR})")
    if not err_32 <= BF16_SPATIAL_FACTOR * gap:
        raise AssertionError("spatial server parity failed")
    del sp_model32, sp_model16, spatial_fns, server, dense_server
    torch.cuda.empty_cache()

    # ---- 12. the gather probes' kernels (TPU kernel rows 11-12) -------------
    # (a) each kernel against its plain version, bit for bit, timed
    for name, (b_, h_, w_, c_) in ROW_GATHER_CASES.items():
        n_src, rows = (h_ + 1) * (w_ + 1), b_ * h_ * w_
        r = np.random.RandomState(SEED + c_)
        img32 = torch.from_numpy(r.rand(b_, n_src, c_).astype(np.float32)).to(device)
        idx_np = r.randint(0, n_src, (b_, h_ * w_, 1)).astype(np.int32)
        idx_np[0, 0, 0], idx_np[-1, -1, 0] = 0, n_src - 1
        idx_np[0, 1, 0], idx_np[-1, 0, 0] = -3, n_src + 5  # out of range: clamped
        idx = torch.from_numpy(idx_np).to(device)
        idx_ok = idx.clamp(0, n_src - 1)  # torch.gather faults on an index out of range
        # the source rows this run's indices touch, each read once
        offs = torch.arange(b_, device=device)[:, None, None] * n_src
        touched = int(torch.unique(idx_ok.long() + offs).numel())
        for dtype in (torch.bfloat16, torch.float32):
            img = img32.to(dtype)
            got = gather_cuda.row_gather(img, idx)
            torch.cuda.synchronize()
            want = row_gather_reference(img, idx_ok)
            if got.dtype != dtype or not torch.equal(got, want):
                raise AssertionError(f"row_gather {name} {dtype}: differs from the plain version")
            note("row_gather", got, want)
            if name != "probe":
                print(f"row_gather {name} {(b_, n_src, c_)} -> {tuple(got.shape)} "
                      f"{str(dtype)[6:]}: equal to the plain version")
                continue
            idx_lib = idx_ok.long().expand(-1, -1, c_)  # the library call's index, made once
            k_ms = _time_ms(torch, lambda: gather_cuda.row_gather(img, idx))
            p_ms = _time_ms(torch, lambda: row_gather_reference(img, idx_ok))
            l_ms = _time_ms(torch, lambda: torch.gather(img, 1, idx_lib))
            k_dev = _device_ms(torch, lambda: gather_cuda.row_gather(img, idx),
                               "row_gather_kernel")
            l_dev = _device_ms(torch, lambda: torch.gather(img, 1, idx_lib), "gather")
            es = img.element_size()
            nbytes = rows * c_ * es + rows * 4 + touched * c_ * es
            bound_ms, _ = _bound(nbytes, 0.0)
            if dtype == torch.bfloat16:  # the probe's dtype: the record
                ms["row_gather"], plain_ms["row_gather"] = k_ms, p_ms
                library_ms["row_gather"] = l_ms
                add_work("row_gather", nbytes, 0.0)
            print(f"row_gather {name} {(b_, n_src, c_)} -> {tuple(got.shape)} "
                  f"{str(dtype)[6:]}: equal to the plain version; kernel_ms={k_ms:.4f} "
                  f"({k_ms * 1e6 / rows:.3f} ns/row) plain_ms={p_ms:.4f} torch.gather_ms="
                  f"{l_ms:.4f} bound_ms={bound_ms:.4f} ({touched} of {b_ * n_src} source "
                  f"rows touched); device ms per launch (profiler): kernel {k_dev}, "
                  f"torch.gather {l_dev}")
    torch.cuda.empty_cache()

    block = {"lane": (gather_cuda.lane_gather, lane_gather_reference),
             "sublane": (gather_cuda.sublane_gather, sublane_gather_reference)}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    recorded, block_lines = set(), []
    for kind, shape, dtype_name in BLOCK_GATHER_CASES:
        kname, dtype = f"{kind}_gather", getattr(torch, dtype_name)
        kern, ref = block[kind]
        plan = gather_cuda.block_gather_plan(kind, shape, dtype)
        r = np.random.RandomState(SEED + shape[0])
        x = torch.from_numpy(r.rand(*shape).astype(np.float32)).to(device, dtype)
        span = shape[1] if kind == "lane" else shape[0]
        idx_sets = {name: torch.from_numpy(_block_indices(r, shape, span, kind, name)).to(device)
                    for name in BLOCK_GATHER_INDICES}
        for name, idx in idx_sets.items():  # one launch a call, two calls the same bits
            before = gather_cuda.launches[kname]
            got, again = kern(x, idx), kern(x, idx)
            torch.cuda.synchronize()
            want = ref(x, idx)
            if gather_cuda.launches[kname] != before + 2:
                raise AssertionError(f"{kname} {shape} {name}: not one launch a call")
            if got.dtype != dtype or not (torch.equal(got, want) and torch.equal(got, again)):
                raise AssertionError(f"{kname} {shape} {dtype_name} {name} indices: differs from "
                                     "the plain version or between two calls")
            note(kname, got, want)
        idx, col = idx_sets["uniform"], idx_sets["column"]
        k_ms = _time_ms(torch, lambda: kern(x, idx))
        p_ms = _time_ms(torch, lambda: ref(x, idx))
        k_dev = _device_ms(torch, lambda: kern(x, idx), plan["kernel"])
        # the same kernel on indices that are the column (lane) or row (sublane)
        # number: 32 neighbouring lanes start in 32 banks
        c_dev = _device_ms(torch, lambda: kern(x, col), plan["kernel"])
        # x and idx read once, the output written once; REPS adds per element
        nbytes, ops = x.numel() * (2 * x.element_size() + 4), x.numel() * REPS
        bound_ms, bound_by = _bound(nbytes, ops)
        # one shared-memory read of 32 bits a tap, 32 a clock on each SM
        floor_ms = x.numel() * REPS / (32 * sms * clock_mhz * 1e6) * 1e3
        if kname not in recorded:
            recorded.add(kname)
            ms[kname], plain_ms[kname] = k_ms, p_ms
            add_work(kname, nbytes, ops)
        block_lines.append({"kind": kind, "shape": list(shape), "dtype": dtype_name,
                            "kernel": plan["kernel"], "device_ms": k_dev,
                            "device_ms_column_indices": c_dev, "call_ms": k_ms,
                            "plain_ms": p_ms, "bound_ms": bound_ms, "smem_floor_ms": floor_ms})
        print(f"{kname} {shape} {dtype_name}: {plan['kernel']} ({plan['threads']} threads, "
              f"{plan['smem_bytes']} B dynamic shared memory, grid {plan['grid_x']} x "
              f"{plan['grid_y']}, {plan['blocks_per_sm']} blocks an SM, {plan['registers']} "
              f"registers, {plan['local_bytes']} B local); equal to the plain version on "
              f"{', '.join(BLOCK_GATHER_INDICES)} indices, one launch a call, two calls "
              f"bit-equal; kernel_ms={k_ms:.5f} ({k_ms * 1e6 / (x.numel() * REPS):.4f} "
              f"ns/gather) plain_ms={p_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}); "
              f"shared-memory floor {floor_ms:.5f} ms (a 32-bit read a tap, 32 a clock on "
              f"{sms} SMs at {clock_mhz:.0f} MHz); device ms per launch (profiler) {k_dev}, "
              f"on column-number indices {c_dev}")
    print(json.dumps({"block_gathers": block_lines}))

    # (b) the probes' entry points on the card, every mode
    probe_runs = [(gather_probe, argv) for argv in GATHER_PROBE_MODES]
    probe_runs.append((block_gather_probe, []))
    reset_counts()
    for probe, argv in probe_runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = probe.main([*argv, "--device", "cuda"])
        text = buf.getvalue()
        print(text, end="")
        rec = json.loads(text.strip().splitlines()[-1])
        if rc != 0 or "FAIL" in text or rec["device"] != torch.cuda.get_device_name(device):
            raise AssertionError(f"{probe.__name__} {argv}: rc {rc} or a FAIL line")
    torch.cuda.synchronize()
    probe_counts = counts()
    gathers = ("row_gather", "lane_gather", "sublane_gather")
    if any(probe_counts[k] == 0 for k in gathers) or any(
            v for k, v in probe_counts.items() if k not in gathers):
        raise AssertionError(f"gather probes: launches {probe_counts}")
    print("gather probes, every mode on the card: launches "
          + json.dumps({k: probe_counts[k] for k in gathers}))

    # ---- 13. the entry points as a user runs them, without yaml and cv2 ------
    from unopticalflow_tpu_torch import train as train_cli
    from unopticalflow_tpu_torch.data.loader import BatchLoader
    from unopticalflow_tpu_torch.evaluation.flowlib import flow_png_samples
    from unopticalflow_tpu_torch.utils import imageio

    root = os.path.join(model_dir, "entry")
    prep = os.path.join(root, "prepared", "data_s1")
    gt = os.path.join(root, "kitti2015")
    for d in (os.path.join(prep, "d", "r"), *(os.path.join(gt, s) for s in
                                              ("image_2", "flow_occ", "flow_noc", "obj_map"))):
        os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    snips = SyntheticSnippets(KITTI_HW, ENTRY_SNIPPETS, seed=SEED + 9).snippets
    lines = []
    # the port's writer filters each row as libpng (cv2.imwrite, KITTI's own
    # files) does: mostly Average and Paeth rows
    for i, snip in enumerate(snips):
        with open(os.path.join(prep, "d", "r", f"{i:010d}.png"), "wb") as f:
            f.write(imageio.encode_png(snip, level=1))
        lines.append(f"d/r/{i:010d}.png d/calib.txt\n")
    with open(os.path.join(prep, "d", "calib.txt"), "w") as f:
        f.write("P_rect_02: 721.5 0.0 609.6 44.9 0.0 721.5 172.9 0.2 0.0 0.0 1.0 0.003\n")
    with open(os.path.join(prep, "train.txt"), "w") as f:
        f.writelines(lines)
    # 8 distinct pairs and ground truths, each written under 25 frame numbers
    frame_px = [np.ascontiguousarray(snip[j * KITTI_HW[0]:(j + 1) * KITTI_HW[0]])
                for snip in snips for j in range(2)]
    frames = [imageio.encode_png(f, level=1) for f in frame_px]
    gts_e, nocs_e, movs_e = gt_set(ENTRY_SNIPPETS)
    gh_e, gw_e = ENTRY_GT_HW
    occ_png = [imageio.encode_png(flow_png_samples(g[:gh_e, :gw_e]), level=1)
               for g in gts_e]
    noc_png = [imageio.encode_png(flow_png_samples(np.dstack([g[:gh_e, :gw_e, :2],
                                                                nc[:gh_e, :gw_e]])), level=1) for g, nc in zip(gts_e, nocs_e)]
    obj_png = [imageio.encode_png(m[:gh_e, :gw_e].astype(np.uint8), level=1)
               for m in movs_e]
    for i in range(ENTRY_PAIRS):
        k = i % ENTRY_SNIPPETS
        for rel, data in ((f"image_2/{i:06d}_10.png", frames[2 * k]),
                          (f"image_2/{i:06d}_11.png", frames[2 * k + 1]),
                          (f"flow_occ/{i:06d}_10.png", occ_png[k]),
                          (f"flow_noc/{i:06d}_10.png", noc_png[k]),
                          (f"obj_map/{i:06d}_10.png", obj_png[k])):
            with open(os.path.join(gt, rel), "wb") as f:
                f.write(data)
    cfg_path = os.path.join(root, "kitti.yaml")
    with open(cfg_path, "w") as f:
        f.write("# config/kitti.yaml, with this run's directories and steps\n"
                f"prepared_base_dir: '{os.path.join(root, 'prepared')}'\n"
                f"gt_2012_dir: '{gt}'\ngt_2015_dir: '{gt}'\n"
                f"dataset: 'kitti_depth'\nnum_scales: 3\nnum_iterations: {ENTRY_STEPS}\n"
                "w_ssim: 0.85\nw_flow_smooth: 10.0\nw_flow_consis: 0.01\n"
                f"img_hw: [{h}, {w}]\n")
    t_write = time.perf_counter() - t0
    filters = np.zeros(5, np.int64)  # the row filters the frames hold
    for data in frames:
        idat = b"".join(body for kind, body in imageio._chunks(data) if kind == b"IDAT")
        rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(KITTI_HW[0], -1)
        filters += np.bincount(rows[:, 0], minlength=5)
    t0 = time.perf_counter()
    for i in range(20):
        if not np.array_equal(imageio.decode_png(frames[i % len(frames)]),
                              frame_px[i % len(frames)]):
            raise AssertionError(f"PNG reader: frame {i % len(frames)} differs")
    decode_rate = 20 / (time.perf_counter() - t0)
    # the training loader on the prepared snippets: decode, resize, 4 threads
    loader = BatchLoader(train_cli.PREPARED["kitti_depth"](
        prep, num_scales=3, img_hw=IMG_HW, num_iterations=LOADER_SNIPPETS, emit_uint8=True),
        batch_size=BATCH, num_workers=4)
    t0 = time.perf_counter()
    n_loaded = sum(len(b) for b in loader)
    loader_rate = n_loaded / (time.perf_counter() - t0)
    need = {"float32": BATCH / ms_step * 1e3, "bfloat16": BATCH / ms_step_bf16 * 1e3}
    print(f"entry points: wrote {ENTRY_SNIPPETS} prepared snippets at {KITTI_HW} and a KITTI "
          f"2015 tree of {ENTRY_PAIRS} pairs (ground truth {ENTRY_GT_HW}) in {t_write:.2f} s, "
          f"every PNG filtered as libpng filters it (frames' rows None/Sub/Up/Average/Paeth: "
          f"{filters.tolist()}); the port's PNG reader: {decode_rate:.1f} frames/s of "
          f"{KITTI_HW} on one thread; the training loader (decode and resize, 4 threads): "
          f"{loader_rate:.1f} snippets/s against the steps' " + ", ".join(
              f"{k} {v:.1f} ({'kept up' if loader_rate >= v else 'fell behind'})"
              for k, v in need.items()))

    blocked = {m: sys.modules.get(m) for m in ("yaml", "cv2")}
    entry_dir = os.path.join(root, "models")
    try:
        for m in blocked:
            sys.modules[m] = None  # as on a machine without pyyaml and opencv
        torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
        torch.backends.cuda.matmul.allow_tf32 = True
        reset_counts()
        t0 = time.perf_counter()
        rc = train_cli.main(["-c", cfg_path, "--no_test", "-g", "0", "--batch_size", str(BATCH),
                             "--num_workers", "4", "--log_interval", "1", "--save_interval",
                             "1000", "--init_scheme", "pwc", "--model_dir", entry_dir])
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        entry_train = counts()
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        last = os.path.join(entry_dir, "flow", "last.pth")
        if rc != 0 or entry_train != {k: ENTRY_STEPS * v for k, v in PER_STEP.items()} \
                or tf32 != (False, False) or not os.path.exists(last):
            raise AssertionError(f"train.main: rc {rc}, launches {entry_train}, TF32 {tf32}, "
                                 f"checkpoint {os.path.exists(last)}")
        reset_counts()
        t0 = time.perf_counter()
        res = evaluation.main(["-c", cfg_path, "--task", "kitti_flow", "--pretrained_model", last,
                               "-g", "0"])
        torch.cuda.synchronize()
        t_test = time.perf_counter() - t0
        entry_test = counts()
    finally:
        for m, mod in blocked.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod
    n_batches = math.ceil(ENTRY_PAIRS / BATCH)
    vals = _values(res)
    if entry_test != {**zero_counts, "corr_fwd": 5 * n_batches} or len(vals) != 8 \
            or not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"test.main: launches {entry_test}, result {res!r}")
    print(f"entry points (yaml and cv2 blocked): train.main {ENTRY_STEPS} float32 steps at "
          f"batch {BATCH} from {KITTI_HW} PNGs in {t_train:.2f} s, launches {entry_train}, "
          f"TF32 off, {last} written; test.main on {ENTRY_PAIRS} pairs in {t_test:.2f} s, "
          f"{entry_test['corr_fwd']} corr_fwd launches ({n_batches} batches)")

    # ---- 14. learning: the port's sanity_train on the card ----------------
    from unopticalflow_tpu_torch.benchmarks import sanity_train

    for bf16 in (False, True):
        reset_counts()
        res = sanity_train.run(iters=LEARN_ITERS, batch=LEARN_BATCH, hw=LEARN_HW,
                               shift=LEARN_SHIFT, lr=1e-4, bf16=bf16, device="cuda", seed=SEED)
        learn_counts = counts()
        # every step through the training kernels, and one inference_flow after
        want = {k: LEARN_ITERS * v for k, v in PER_STEP.items()}
        want["corr_fwd"] += 5
        if learn_counts != want:
            raise AssertionError(f"sanity_train {res['precision']}: launches {learn_counts}, "
                                 f"want {want}")
        print(f"learning {res['precision']}: sanity_train {LEARN_ITERS} iterations at batch "
              f"{LEARN_BATCH} {LEARN_HW[0]}x{LEARN_HW[1]}, shift {LEARN_SHIFT} px: EPE "
              f"{res['epe']:.4f} px against zero flow's {res['zero_flow_epe']:.1f} (bar "
              f"{LEARN_EPE}), mean u {res['mean_u']:.4f} v {res['mean_v']:.4f}, ms/step "
              f"{res['ms_per_step']:.3f} (CUDA events), {res['train_seconds']:.2f} s; "
              f"launches per step {PER_STEP}")
        if not res["epe"] < LEARN_EPE:
            raise AssertionError(f"sanity_train {res['precision']}: EPE {res['epe']} px "
                                 f"is not under {LEARN_EPE}")
        torch.cuda.empty_cache()

    # ---- 15. the entry points complete: .ckpt, cache, preemption, Sintel ----
    entry_points_complete(types.SimpleNamespace(
        device=device, img_hw=IMG_HW, kitti_hw=KITTI_HW, sintel_hw=SINTEL_HW,
        sintel_img_hw=SINTEL_IMG_HW, batch=BATCH, steps=ENTRY_STEPS,
        loader_snippets=LOADER_SNIPPETS, root=os.path.join(model_dir, "entry15"),
        counts=counts, reset_counts=reset_counts, want=lambda d: d,
        sync=torch.cuda.synchronize, cli=[], smi=smi, loader_rate=loader_rate, need=need))
    torch.cuda.empty_cache()

    # ---- 16. flow + pose: the flowposenet step, --freeze_flow, NYU, odometry --
    flowpose(types.SimpleNamespace(
        device=device, img_hw=IMG_HW, kitti_hw=KITTI_HW, batch=BATCH, steps=ENTRY_STEPS,
        fp_steps=FP_STEPS, fp_bf16_steps=FP_BF16_STEPS, freeze_steps=FREEZE_STEPS,
        nyu_frame_hw=NYU_FRAME_HW, nyu_hw=NYU_HW, nyu_snippets=NYU_SNIPPETS,
        odo_hw=KITTI_HW, odo_frames=ODO_FRAMES, loader_snippets=LOADER_SNIPPETS,
        root=os.path.join(model_dir, "flowpose16"), counts=counts, reset_counts=reset_counts,
        want=lambda d: d, sync=torch.cuda.synchronize, empty_cache=torch.cuda.empty_cache,
        cli=[], smi=smi, flow_ms={"float32": ms_step, "bfloat16": ms_step_bf16}))
    torch.cuda.empty_cache()

    launches = {**train_counts, "regularizer_fwd": reg_counts["regularizer_fwd"],
                "regularizer_bwd": reg_counts["regularizer_bwd"],
                "corr_fwd_hpad": sp_serve_counts["corr_fwd_hpad"],
                "corr_bwd_df1_hpad": grad_counts["corr_bwd_df1_hpad"],
                "corr_bwd_df2_hpad": grad_counts["corr_bwd_df2_hpad"],
                "row_gather": probe_counts["row_gather"],
                "lane_gather": probe_counts["lane_gather"],
                "sublane_gather": probe_counts["sublane_gather"]}
    records = []
    for name, (src, replaces) in KERNELS.items():
        bound_ms, bound_by = _bound(*work[name])
        records.append({
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": ms[name],
            "plain_ms": plain_ms[name],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms[name],
        })
    # ---- 17. the host modules: JPEG, the NYU .mat, depth and mask evaluation --
    host_modules(types.SimpleNamespace(
        device=device, img_hw=IMG_HW, precision="bfloat16", batch=BATCH,
        root=os.path.join(model_dir, "host17"), counts=counts, reset_counts=reset_counts,
        want=lambda d: d, cli=[], smi=smi))
    torch.cuda.empty_cache()

    print(f"chip_smoke: 17 phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
