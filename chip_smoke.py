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


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


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
    print(f"chip_smoke: 14 phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
