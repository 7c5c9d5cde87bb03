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
17. The host modules without opencv, h5py, matplotlib or PIL
   (``host_modules``; fixtures of ``tests/torch_fixtures/``, written by its
   ``make_fixtures.py`` with cv2, PIL, h5py and the JAX package).  (a) With
   cv2, PIL, h5py and matplotlib blocked: every committed JPEG, baseline
   (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, grey, qualities 10 to 100, a restart
   interval, optimised tables, an odd size, an Exif orientation, a 512x832
   stacked pair), progressive (4:4:4, 4:2:2, 4:2:0, a restart interval,
   PIL's, an odd size, the stacked pair, and the progression cut after its
   third scan, through libjpeg's block smoothing) and CMYK (PIL's), decodes
   to cv2's decode beside it, bit for bit; the interlaced (Adam7) PNGs of
   colour types 0, 2, 3, 4 and 6 decode to cv2's decodes; every fixture of
   ``tests/torch_fixtures/formats/`` (BMP, PNM, PAM, PFM, Sun raster, HDR,
   TIFF) has the SHA-256 of cv2's decode under each of the three flags (or
   raises where cv2's output is undefined); every fixture of
   ``tests/torch_fixtures/webp/`` (lossy VP8, lossless VP8L, ALPH raw and
   VP8L-coded under each filter, animations, Exif orientation) has the
   SHA-256 of cv2's decode under each flag, and each body cv2 refuses
   raises; every fixture of ``tests/torch_fixtures/jpeg2000/`` (JP2 and
   J2K, 5/3 and 9/7, every progression, code-block style, tiles, layers,
   POC, ROI, PPM/PPT, colour boxes) has the SHA-256 of cv2's decode under
   each flag, and gives no image where cv2 gives none; every fixture of
   ``tests/torch_fixtures/grey/`` (colour PNGs read as grey through
   libpng's gamma tables, grey-and-alpha TIFF tiles) has cv2's digest or
   the port's raise; the 512x832 stacked pair as BMP, P6, Sun raster,
   uncompressed, LZW and Deflate TIFF and HDR (built here by this module's
   writers from the committed pair's pixels), as PIL's JPEG-compressed TIFF,
   as lossy, lossless and lossy-with-alpha WebP and as lossless JP2 and
   irreversible J2K (committed) decodes to the pair's pixels (the lossless
   ones) or its cv2 digest, and the host ms of
   decoding it in each format, as the baseline and progressive JPEG and as
   the PNG (median of 20 each, this machine's CPU; a JSON line).  (b)
   ``FlowServer`` and its HTTP handler on the card at 256x832, bfloat16,
   ``max_batch`` 8: each of those bodies (the PNG among them) and
   the cut progression gets a 200 whose ``.flo`` reply is byte-equal to the
   reply to a PNG of the body's decoded pixels, with exactly 5 ``corr_fwd``
   launches a body; the baseline and progressive JPEG replies are equal; an
   AVIF body gets a 400 naming AVIF; the median ms of 8 requests with each
   body (a JSON line).  (c) ``test.main --task demo`` on two JPEG, two BMP,
   two LZW TIFF, two WebP and two JP2 frames equals the demo on PNGs of
   their decoded pixels (5 launches each).  (d) NYUv2
   without h5py: ``NYU_Prepare`` on raw ``.ppm`` scenes this phase writes
   and the MATLAB-layout labeled set (``train.txt`` names the train scenes
   only), ``load_nyu_test_data`` equal to the JAX package's arrays (by
   SHA-256; the ``.mat`` read's ms), ``test_nyu`` with an oracle whose
   disparities are resized on the card (near-zero error, as the JAX test's
   oracle), ``eval_depth`` (both protocols) and ``eval_mask`` on seeded
   inputs equal to the JAX package's numbers (rtol 1e-6) and PNG pixels.
   (e) ``depth_harness.test_single_image`` on a JPEG frame with a
   disparity computed on the card writes ``demo_depth.jpg``, the JPEG of
   its magma pixels, and ``imageio.encode_jpeg`` of the committed magma
   pixels is byte-equal to the JPEG PIL wrote of them.  (f)
   ``VisualizerDebug``'s ``show_corres`` and ``show_epipolar_line`` on
   ``drawing_inputs(17)`` write PNGs whose pixels have the SHA-256 of the
   JAX package's (cv2-drawn) ones.
18. K training steps a dispatch (``dispatch_graph``): the KITTI recipe
   (256x832, batch 8, 3 scales, regularizer off), K = 8, float32 and
   bfloat16, 8 seeded in-memory batches.  (b) A capturable Adam against
   ``make_optimizer``'s, one step from the same state (step 2) on the same
   float32 gradients: every parameter within 2 ulps plus the update's
   rounding.  (c) ``make_multi_train_step``'s eager first dispatch and its
   capture each launch 8 x (5, 5, 5, 3, 3) training kernels, and replays
   none (the counters count host launches).  (a) From the fresh state (the
   weights at their init, Adam's moments and step at zero, set in place
   after the timed dispatches: 56 steps on these repeated batches take the
   bf16 step past its rise, where it is chaotic, PERF.md q14), one graph
   dispatch against 8 eager capturable-Adam steps: the 8 losses and the
   parameters' change within 3 times the eager steps' own distance on
   snippets moved by one ulp of the compute dtype (phase 7's rule, floor
   1e-4; one float32 ulp rounds away in bfloat16), or 3 times their
   distance from a second eager run on the same snippets where that is
   larger (the backward's atomic sums differ run to run, and the bf16
   steps, which rise from the first, carry it on: phases 20 and 21 hold to
   it too), and in float32 the first sub-step's loss bit-equal.  (d)
   ms/step of the graph (median of 2 dispatches over 8) against the
   trainer's K = 1 eager step (median of 8, ``make_optimizer``'s Adam) in
   the same process, each with the idle share of a profiled window (1
   dispatch, or 2 eager steps: 1 - the profiler's busy device time over
   the window's CUDA-event time, which holds the profiler's own overhead,
   and beside it 1 - the busy time over the unprofiled ms/step), its device
   operations a step and its peak memory, in both dtypes.  (e) ``python -m
   unopticalflow_tpu_torch.train --steps_per_dispatch auto`` (a subprocess;
   log and save every 8, 16
   iterations, bfloat16, batch 8, 256x832) on a warm ``--cache_decoded``
   tree of 8 prepared snippets at 375x1242: it prints ``auto -> 8``, logs
   iterations 0 and 8, writes ``iter_7.pth``, ``iter_15.pth`` and
   ``last.pth``; a ``--resume`` from ``iter_7.pth`` runs 16 more at K = 8
   (2 x 8 x (5, 5, 5, 3, 3) launches: the eager dispatch and the capture),
   ``last.pth`` at 22; the loader's cold and warm snippets/s beside the
   graph's bfloat16 step rate say which bound the run.  (f) The other
   training modes at the K that ``auto`` picks at the yamls' intervals (log
   100, save 2000, test 2000: K = 4), float32, batch 8: flowposenet and
   ``--freeze_flow`` at 256x832 (odo.yaml), the 2-frame nyuv2 flowposenet
   and flow steps at 192x256 (nyu_posenet_192.yaml).  ``train()`` on
   in-memory snippets for 12 iterations prints ``auto -> 4`` and launches
   4 x the mode's per-step kernels in its eager dispatch and in its capture,
   none in its replay; then a new step function from the state it left,
   after its own eager dispatch and capture, holds one graph dispatch to 4
   eager capturable-Adam steps as (a) does (first sub-step's loss
   bit-equal, parameters the optimizer does not hold unchanged).  (g)
   ``synthetic_epe.run`` with ``--lr-schedule cosine``, 16 iterations,
   batch 4, 128x256, bfloat16, at K = 8 (a graph) and K = 1: every step's
   learning rate, read back from the graph, within one float32 ulp of
   ``cosine_decay_lr``, evaluation points labelled 7 and 15, finite EPEs
   printed side by side.
19. The measuring and learning tools (``tools``; rehearsable on the CPU), at
   256x832, batch 8, K = 8 where a step runs.  (a) The device generator
   (``benchmarks/synth_device_gen.py``, max_bg 16, max_fg 32, tex_power 1)
   on the card: shapes and range, integer motions within their bounds and
   the rectangle in frame at every t, the exact-warp invariant (1e-6), the
   moments within 0.05 / 0.04 of the host generator's; its ms a batch (CUDA
   events) against the host generator's ms a snippet.  (b)
   ``synthetic_epe.run --device-gen``, bfloat16, 32 iterations at K = 8:
   launches by dispatch 8 x (5, 5, 5, 3, 3) eager, the same in the capture,
   none in the replays; the EPE beside zero flow's, ms/step beside the
   generator's.  (c) ``make_prepared_synth`` writes 8 snippets, ``train()``
   runs 16 bfloat16 steps from the tree at K = 8 (2 x 8 x (5, 5, 5, 3, 3)
   launches), the loader's snippets/s from it; ``loader_bench`` at 4
   snippets and 4 batches, its device rate measured in the call (2 x 8 x
   (5, 5, 5, 3, 3) launches).  (d) ``profile_step``: 2 interleaved trials (a
   timed dispatch each) of
   ``use_pallas_reg`` off and on in float32 and bfloat16 at K = 8, each
   setup's launches a step (5, 5, 5, 3, 3, and 3, 3 with the regularizer).
   (e) ``ablate``'s seven variants, bfloat16, K = 8, 1 timed replay: ``full`` and
   ``no-ssim`` launch (5, 5, 5, 3, 3) a step, ``no-corr`` none of rows 1-3,
   ``convs-only`` no photometric kernel.  (f) ``probe.trace_run``: the K = 8
   graph step by kind in float32 and bfloat16 (1 profiled replay, 1
   timed), idle share against the unprofiled step, launches of the eager
   dispatch and the capture.  (g)
   ``loss_landscape_probe.run`` through the kernels against the plain
   photometric pack on the card, float32 (rtol 1e-4) and bfloat16 (2e-2),
   3 photometric launches a point.  (h) PERF.md's q14: 32 bfloat16 steps on
   phase 18's 8 repeated batches, once as K = 8 graph dispatches and
   once as eager capturable-Adam steps, from one seed: each run's 8-step
   block means, whether it rose (a block above 1.2 x the lowest before
   it), the graph's distance from eager, and one float32 eager run of the
   same steps beside them; it fails on a loss that is not finite.
20. Data parallelism on one card (``data_parallel``; rehearsable on the
   CPU).  (a) The card's compute mode (``nvidia-smi --query-gpu=name,
   power.limit,compute_mode``); ``Exclusive_Process`` fails (c).  (b) The
   trainer's CLI (``train.main`` with a shell's argv, in this process so
   that its launches are counted) at 256x832, batch 8, ``--steps_per_dispatch
   auto`` (K = 4), 12 iterations from a prepared tree with ``--cache_decoded``,
   in float32 and bfloat16: ``--multi_host --coordinator_address
   127.0.0.1:<free> --num_processes 1 --process_id 0`` (NCCL, world size 1,
   the all-reduce inside the K-step graph) against the same recipe without
   it: the weights after the eager dispatch, after the capturing dispatch
   and at the end (checkpoints every K iterations), each bit-equal, or else
   their change from the initial weights no further from the plain run's
   than max(1e-4, 3 x) a second plain run's and at least half as long;
   each run launches 2K x the flow row (eager dispatch and capture, replays
   none); ms/step of the replay dispatches from the trainer's
   snippets_per_sec; then ``--multi_gpu`` in bfloat16 (one spawned process a
   card) under the same rule.  (c) A K = 4 dispatch under a gloo group on
   the card raises; two gloo ranks on the card (spawned, each joining with
   ``initialize_multi_host(backend="gloo")`` before ``train()``), batch 4
   each of a global 8, float32, K = 1, 3 steps, against one process on the
   global batch: the first step's loss to rtol 1e-4, the losses and the
   weights' change within max(1e-4, 3 x) those of one process on images one
   ulp away (phase 7's rule), a bound that must reject one process on rank
   0's blocks alone (every rank applying rank 0's gradient), every weight within
   JAX's DP tolerances (rtol 5e-3, atol 3e-4 a step: Adam's +-lr sign
   slack), the two ranks bit-equal, each launching 3 x the flow row;
   their ms a step beside one process's.  (d) ``FlowServer(data_devices=
   ["cuda:0", "cuda:0"])`` against one-device serving on phase 10's 37
   pairs from 8 clients at max_batch 8: flows within 1e-4 x (1 + peak), 10
   ``corr_fwd`` launches a split batch.
21. Spatial training (``spatial_training``; rehearsable on the CPU): the
   training forward with each frame's rows split over n shards (on their
   own cards when there are enough, else all on ``cuda:0``), at the KITTI
   recipe (256x832, batch 8, 3 loss scales).  (a) The halo-prepadded
   photometric and regularizer kernels (``photometric_fwd_hpad``,
   ``photometric_bwd_hpad``, ``regularizer_fwd_hpad``,
   ``regularizer_bwd_hpad``) on every shard of n = 2 and 4 at the three
   loss scales' slabs (one halo row a side; flows bilinear from a field 8
   times coarser in +-6 px, so the warps cross the seams and the frame's
   edges, plus +-1 px on 30% of the pixels) against their plain rows
   versions, each pack 1 + 1 launches: sums rtol 1e-4, weights 1e-5,
   d(flow) within 1e-4 of its largest value (regularizer: and zero where
   the plain gradient is), float32; bfloat16 values within 2e-2 of the
   bfloat16 plain versions and against the plain versions on the widened
   images at the float32 rules, d(flow) within 2e-2 of its largest.
   Positions where the L1 term's argument |img - warped| is within 1e-6 of
   zero are left out of the photometric d(flow) (its sign is rounding
   noise, which the kernel and ``bilinear_warp`` round apart; the whole-map
   kernel does the same there), and counted.  Each kernel timed per shard
   at n = 2, float32 and bfloat16, beside its plain version and its bound.
   (b) A sharded forward and
   backward launches exactly 3n of each photometric hpad kernel, 3n of each
   regularizer hpad kernel with ``use_pallas_reg`` (else none), 5n of each
   correlation hpad kernel, and no whole-map kernel.  (c) The sharded pack,
   the photometric losses' gradient and the weighted total's over every
   parameter against the unsharded ``forward`` on the same weights, float32
   and bfloat16, ``use_pallas_reg`` off and on, n = 2 and 4: rel L2 within 3
   times the unsharded step's own distance on snippets moved by one ulp of
   the compute dtype (in bfloat16 one bfloat16 ulp: a float32 ulp rounds
   away), or from another run of itself where that is larger (in (d) also
   one on PyTorch's own convolutions in place of cuDNN's: a slab's
   convolutions take other algorithms than the frame's), floor 1e-4 (phase
   7's rule, with phase 20's second run).  (d) 4 Adam steps
   (``make_optimizer``) at n = 2 against 4 unsharded ones, float32 and
   bfloat16: the losses and the parameters' change after each step under the
   same rule (in bfloat16 the yardstick is ~0.3 from the first step on:
   Adam's first update is lr * sign(g), so there (c) carries the check), and
   every parameter tensor's change at least half as long as the unsharded
   one's after every step (phase 20's check against a run that never
   updates, per tensor).  (e) ms
   per forward + backward (one timed run after 1, CUDA events) and peak GiB,
   unsharded and at n = 1, 2, 4, float32 and bfloat16, beside the card's name
   and power limit.  (f) One mesh over two devices: shard 0 on the CPU (the
   plain versions), shard 1 on the card, float32 with ``use_pallas_reg`` at
   batch 2, 128x256: the card's shard launches 3 of each hpad loss kernel
   and 5 of each correlation hpad kernel, the pack lands on the CPU and every
   gradient on its parameter's card, and the pack and gradients hold to the
   unsharded step on the card under (c)'s rule.  (g)-(i) The sharded forms
   beyond the 3-frame flow forward, float32 and bfloat16, against their
   unsharded forms on the same weights under (c)'s rule (pack, photometric
   and weighted total's gradients), each forward + backward launching 5n of
   each correlation hpad kernel and, where the form takes them, 3n of each
   photometric and regularizer hpad kernel, no whole-map kernel; ms per
   forward + backward and peak GiB beside the unsharded form's (the
   yardstick also holds an unsharded run on PyTorch's own convolutions, as
   in (d)): (g)
   ``forward_flowpose`` with ``use_pallas_reg`` (every hpad kernel) at the
   recipe (config/odo.yaml's 256x832, batch 8, phase 16's intrinsics), n =
   1, 2, 4; (h) ``forward_pair`` and ``forward_flowpose_pair`` at
   config/nyu_posenet_192.yaml's 192x256 (NYU's intrinsics), n = 1 and 3,
   the correlation kernels only; (i) ``forward`` with
   ``use_occlusion_weights=False`` at the recipe, n = 1, 2, 4, the
   correlation kernels only.
22. The bfloat16 step's gradient gap (``bf16_gap``; rehearsable on the
   CPU): at the recipe's 256x832, the "pwc" init, on seeded noise frames at
   batch 1 (``benchmarks/bf16_gap.py::snippets``, the frames its CPU run
   holds to the JAX package) and on synthetic snippets at batch 8 (phase
   21's), the rel L2 of the bfloat16 step's gradients (photometric weights,
   full weights) from the float32 step's, with the kernels (exactly 5 + 10 +
   10 correlation and 3 + 6 photometric launches a dtype: one forward, two
   gradients) and with the plain versions on the card; it fails if the
   kernels' gap exceeds 2 x the plain versions' + 1e-3.  Then PERF.md q14's
   32 eager steps on 8 repeated batches once more with a float32 loss stack
   (``loss_dtype`` float32 under bfloat16 convolutions): the block means
   and whether they rose.
23. The bench module (``bench_module``; rehearsable on the CPU), the root
   ``bench.py`` inside the port, at the recipe (256x832, batch 8).  (a)-(e)
   ``python -m unopticalflow_tpu_torch.bench --iters 8`` as a user runs it,
   one process each, started together: (a) bfloat16 at K = 8, (b)
   ``--scan-steps 0``, (c) ``--fp32``, (d) ``--infer``, (e) ``--validate``
   writing its report into ``build/chip_smoke/bench23/``.  Each prints
   exactly one stdout line: (a)-(d) the JAX bench's keys, ``metric`` and
   ``unit`` and a finite positive ``value`` (printed with the windows and
   warm-up from stderr, as read on the shared card); (e) ``ok`` true, every
   check's errors printed beside its tolerance, and the report's launches 2
   of each correlation and photometric kernel and 1 of each regularizer
   kernel.  (f) In this process, with the launch counters: ``bench_train``
   bfloat16 and ``bench_infer`` while the five import torch, then
   ``bench_train`` float32 after them; each K = 8 run launches 2 x 8 x (5,
   5, 5, 3, 3), the eager dispatch and the capture, as phase 18 (c), its
   rate printed beside 8 / phase 18 (d)'s graph ms/step (no time is
   asserted); ``bench_infer`` 5 ``corr_fwd`` a batch, its last flow finite.

The second-to-last line is the kernels' JSON record (``launches`` from the
training run of phase 6, of phase 9 for the regularizer, of phase 11 (d) for
``corr_fwd_hpad`` and 11 (c)'s gradient for the hpad backward, of phase 12
(b)'s probe runs for the gathers, of phase 21 (b)'s float32 step at n = 2
with ``use_pallas_reg`` for the hpad loss kernels; ``ms``/``plain_ms`` per
float32 training step: the sum over the five decoder levels or the three
loss scales, for the correlation hpad kernels per float32 spatial batch at
n = 2: 5 levels x 2 shards, for the hpad loss kernels per float32 sharded
step at n = 2: 3 scales x 2 shards (of the whole sources, the bytes count
the rows this run's warps reach), for the
gathers per call at the probes' default shapes: ``row_gather`` bfloat16,
``lane_gather`` and ``sublane_gather`` float32; ``bound_ms``: the larger of
the bytes the function must move over 3.35 TB/s and its operations over 67
TFLOP/s (float32), from this run's shapes, for ``row_gather`` the source
rows that this run's indices touch, each once; ``library_ms``: the time of
``torch.gather`` on the expanded int64 index for ``row_gather``, null for
the others: no single PyTorch call computes any of them); the last line is
``{"ok": true, "device": {...}}``.  Only the CUDA path is driven: with no
GPU the script exits non-zero before printing any result.  The trainer runs
of phases 6-16 take K = 1 (their intervals make ``--steps_per_dispatch
auto`` pick 1, or they set it, so that their per-step launch counts and
step times keep their meaning); phase 18 drives K = 8 in flow mode and
K = 4, the default intervals' ``auto``, in the other modes; phase 19 K = 8;
phase 20 K = 4 through the CLI and K = 1 for the gloo ranks; phase 23 K = 8
and K = 0 (eager).
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
SPATIAL_TIMED = 1  # phase 21 (e)-(i): timed forward + backward runs after 1 warm-up
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
# phase 18: K steps a dispatch (the JAX trainer's auto K at log and save
# intervals of 8), dispatches timed and profiled, eager steps profiled, and the
# prepared snippets of its trainer run
DISPATCH_K = 8
DISPATCH_TIMED = 2
DISPATCH_PROFILED = 1
EAGER_PROFILED = 2
DISPATCH_SNIPPETS = 8
DISPATCH_LOADER_SNIPPETS = 32  # (e): the loader's cold and warm rates
# phase 18 (f): what --steps_per_dispatch auto picks at the flags' default
# intervals (log 100, save 2000, test 2000); (g): synthetic_epe's iterations
DISPATCH_AUTO_K = 4
EPE_ITERS = 16
EPE_HW = (128, 256)
# phase 19: the tools at the recipe's shape; the generator's motions as
# make_pool's and make_prepared_synth's defaults (the 256x832 campaign's);
# synthetic_epe --device-gen's iterations, make_prepared_synth's snippets and
# train()'s steps on them, loader_bench's snippets and batches, profile_step's
# dispatches a trial and trials, ablate's and the trace's timed replays, and
# q14's runs of each kind and steps a run; a run "rose" when a block of K
# steps' mean loss exceeds Q14_RISE times the lowest block mean before it
TOOLS_MAX_BG, TOOLS_MAX_FG = 16, 32
TOOLS_EPE_ITERS = 32
PREP_SNIPPETS = 8
PREP_STEPS = 16
LB_SNIPPETS, LB_BATCHES = 4, 4
PS_ITERS, PS_TRIALS = 1, 2
TOOLS_REPLAYS = 1
Q14_RUNS, Q14_STEPS = 1, 32  # a run a kind shows whether eager rises as the graph does
Q14_RISE = 1.2
FP_STEPS = 10
FP_BF16_STEPS = 8
FREEZE_STEPS = 3
# phase 20: the trainer's CLI at K = 4 (auto at log interval 4) for 3 dispatches
# (eager, capture, 1 replay), and two gloo ranks of K = 1 for 3 steps
DP_K = 4
DP_ITERS = 12
DP_STEPS = 3
NYU_FRAME_HW = (480, 640)
NYU_HW = (192, 256)
NYU_SNIPPETS = 8
ODO_FRAMES = 16
# phase 23: --iters of each run of the bench module (3 windows of 4 dispatches,
# its least), and what its --validate launches (f32 and bf16 correlation and
# photometric packs with their gradients, one float32 regularizer pack)
BENCH_ITERS = 8
BENCH_VALIDATE_LAUNCHES = {"corr_fwd": 2, "corr_bwd_df1": 2, "corr_bwd_df2": 2,
                           "photometric_fwd": 2, "photometric_bwd": 2, "regularizer_fwd": 1,
                           "regularizer_bwd": 1}
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
            "row_gather": 0, "lane_gather": 0, "sublane_gather": 0,
            "photometric_fwd_hpad": 0, "photometric_bwd_hpad": 0,
            "regularizer_fwd_hpad": 0, "regularizer_bwd_hpad": 0}
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
    "photometric_fwd_hpad": ("unopticalflow_tpu_torch/csrc/photometric.cu",
                             "unopticalflow_tpu/ops/pallas_photometric.py:198"),
    "photometric_bwd_hpad": ("unopticalflow_tpu_torch/csrc/photometric.cu",
                             "unopticalflow_tpu/ops/pallas_photometric.py:261"),
    "regularizer_fwd_hpad": ("unopticalflow_tpu_torch/csrc/regularizer.cu",
                             "unopticalflow_tpu/ops/pallas_regularizer.py:151"),
    "regularizer_bwd_hpad": ("unopticalflow_tpu_torch/csrc/regularizer.cu",
                             "unopticalflow_tpu/ops/pallas_regularizer.py:179"),
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


def drawing_inputs(seed: int):
    """Seeded inputs of phase 17 (f)'s drawing tools (and of
    ``tests/torch_fixtures/make_fixtures.py``, which stores the SHA-256 of
    the pixels of the JAX package's PNGs on them): two 48x80 BGR images, a
    (4, 12) match [x1, y1, x2, y2] whose first four points lie on and past
    the borders, and a fundamental matrix near a rectified pair's, whose
    epipolar lines cross the images and run far past them."""
    import numpy as np

    rng = np.random.RandomState(seed)
    img1 = rng.randint(0, 255, (48, 80, 3)).astype(np.uint8)
    img2 = rng.randint(0, 255, (48, 80, 3)).astype(np.uint8)
    n = 12
    match = np.stack([rng.uniform(-4, 84, n), rng.uniform(-4, 52, n),
                      rng.uniform(-4, 84, n), rng.uniform(-4, 52, n)])
    match[:, :4] = [[0, 79, 0.5, 80.5], [0, 47, 47.5, -0.5], [2, 79, -1, 40], [3, 0, 47, -1.5]]
    fundamental = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
    fundamental += 0.01 * rng.randn(3, 3)
    return img1, img2, match, fundamental


# ---------------------------------------------------------------------------
# writers of the image formats phase 17 serves (the format tests and
# tests/torch_fixtures/make_fixtures.py build their files with them too)
# ---------------------------------------------------------------------------


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW as libtiff's encoder writes it: codes of 9 to 12 bits, high
    bits first, a clear code first and at entry 4094, the width grown once
    the next free entry passes 2**width - 1, and EOI last."""
    out = bytearray()
    acc, nbits = 0, 0

    def emit(code, width):
        nonlocal acc, nbits
        acc = (acc << width) | code
        nbits += width
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 255)
        acc &= (1 << nbits) - 1

    table = {bytes([i]): i for i in range(256)}
    free, width = 258, 9
    emit(256, width)

    def grow():
        nonlocal table, free, width
        free += 1
        if free == 4094:
            emit(256, width)
            table, free, width = {bytes([i]): i for i in range(256)}, 258, 9
        elif free > (1 << width) - 1:
            width += 1

    cur = b""
    for c in data:
        nxt = cur + bytes((c,))
        if nxt in table:
            cur = nxt
            continue
        emit(table[cur], width)
        table[nxt] = free
        grow()
        cur = bytes((c,))
    if cur:
        emit(table[cur], width)
        grow()
    emit(257, width)
    if nbits:
        out.append((acc << (8 - nbits)) & 255)
    return bytes(out)


def packbits_encode(row: bytes) -> bytes:
    """PackBits of one row: runs of 2 to 128 equal bytes, literals of up to 128."""
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        j = i
        while j + 1 < n and row[j + 1] == row[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes((257 - (j - i + 1), row[i]))
            i = j + 1
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n and row[j + 1] == row[j]):
            j += 1
        out += bytes((j - i - 1,)) + row[i:j]
        i = j
    return bytes(out)


def write_bmp(w, h, bpp, pixels: bytes, palette=None, rle=0, hsize=40, topdown=False,
              masks=None) -> bytes:
    """A BMP around ``pixels`` (the rows as stored): a palette of (B, G, R)
    entries, compression ``rle`` (1 RLE8, 2 RLE4, 3 BI_BITFIELDS with
    ``masks``, after a 40-byte header or inside a larger one), a header of
    12 (OS/2), 40, 108 or 124 bytes, rows bottom-up unless ``topdown``."""
    import struct

    pal = b""
    if palette is not None:
        pal = b"".join(bytes((b, g, r)) + (b"" if hsize == 12 else b"\0") for b, g, r in palette)
    if hsize == 12:
        head = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        n = 0 if palette is None else len(palette)
        head = struct.pack("<IiiHHIIiiII", hsize, w, -h if topdown else h, 1, bpp, rle,
                           len(pixels), 2835, 2835, n, 0) + b"\0" * (hsize - 40)
        if masks and hsize >= 52:
            head = head[:40] + struct.pack("<" + "I" * len(masks), *masks) \
                + head[40 + 4 * len(masks):]
    extra = struct.pack("<III", *masks[:3]) if masks and hsize == 40 else b""
    off = 14 + len(head) + len(extra) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off) + head + extra + pal + pixels


def bmp_rows(rows) -> bytes:
    """BMP rows (each ``bytes``), each padded to 4 bytes, bottom row first."""
    return b"".join(r + b"\0" * (-len(r) % 4) for r in rows[::-1])


def write_p6(bgr) -> bytes:
    """A binary PPM (P6, maxval 255) of a BGR uint8 image."""
    h, w = bgr.shape[:2]
    return b"P6\n%d %d\n255\n" % (w, h) + bgr[:, :, ::-1].tobytes()


def write_sun(bgr) -> bytes:
    """A 24-bit ``RT_STANDARD`` Sun raster of a BGR uint8 image (rows padded to 16 bits)."""
    import struct

    import numpy as np

    h, w = bgr.shape[:2]
    rows = np.zeros((h, (3 * w + 1) & ~1), np.uint8)
    rows[:, :3 * w] = bgr.reshape(h, 3 * w)
    return struct.pack(">8I", 0x59A66A95, w, h, 24, rows.size, 1, 0, 0) + rows.tobytes()


def write_hdr(bgr_float) -> bytes:
    """A Radiance HDR (``#?RADIANCE``, new-style scanline RLE) of a float BGR
    image: each channel of each row as runs of 4 to 127 equal bytes and
    literals of up to 128."""
    import numpy as np

    h, w = bgr_float.shape[:2]
    rgb = bgr_float[:, :, ::-1].astype(np.float64)
    peak = rgb.max(axis=2)
    mant, expo = np.frexp(peak)
    scale = np.where(peak > 1e-32, mant * 256.0 / np.where(peak > 1e-32, peak, 1.0), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[:, :, :3] = np.floor(rgb * scale[:, :, None]).astype(np.uint8)
    rgbe[:, :, 3] = np.where(peak > 1e-32, expo + 128, 0)
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n" % (h, w))
    for y in range(h):
        out += bytes((2, 2, w >> 8, w & 255))
        for ch in range(4):
            line, i = rgbe[y, :, ch].tobytes(), 0
            while i < w:
                j = i
                while j < w and line[j] == line[i] and j - i < 127:
                    j += 1
                if j - i >= 4:
                    out += bytes((128 + j - i, line[i]))
                    i = j
                    continue
                j = i + 1  # a literal up to the next run of 4
                while j < w and j - i < 128 and line[j:j + 4] != line[j:j + 1] * 4:
                    j += 1
                out += bytes((j - i,)) + line[i:j]
                i = j
    return bytes(out)


def write_tiff(arr, photometric, bps=8, order="<", big=False, tile=None, rows_per_strip=None,
               planar=1, compression=1, predictor=1, extra=None, colormap=None,
               orientation=None, jpeg=None, tables=None) -> bytes:
    """A TIFF of ``arr`` ((H, W) or (H, W, samples), uint8 / uint16, 0/1 for
    ``bps`` 1) as stored: either byte order, classic or BigTIFF, strips of
    ``rows_per_strip`` or ``tile`` (w, h) tiles, planar 1 or 2, compression
    1, 5 (LZW), 8 (Deflate), 32773 (PackBits) or 7 (``jpeg(block)`` gives
    each strip's bytes, ``tables`` the JPEGTables), Predictor 2, and the
    ExtraSamples, ColorMap ((n, 3) 16-bit) and Orientation tags."""
    import struct

    import numpy as np

    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, spp = arr.shape
    dtype = np.dtype(order + "u2") if bps == 16 else np.dtype(np.uint8)

    def encode(block):
        bh = block.shape[0]
        if bps == 1:
            raw = np.packbits(block[:, :, 0].astype(np.uint8), axis=1).tobytes()
        else:
            x = block.astype(np.int64)
            if predictor == 2:
                x[:, 1:] -= block[:, :-1].astype(np.int64)
            raw = (x % (1 << bps)).astype(dtype).tobytes()
        if compression == 5:
            return lzw_encode(raw)
        if compression == 8:
            return zlib.compress(raw, 9)
        if compression == 32773:
            n = len(raw) // bh
            return b"".join(packbits_encode(raw[k * n:(k + 1) * n]) for k in range(bh))
        if compression == 7:
            return jpeg(block)
        return raw

    chunks = []
    for plane in ([arr] if planar == 1 else [arr[:, :, k:k + 1] for k in range(spp)]):
        if tile:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    blk = np.zeros((th, tw, plane.shape[2]), arr.dtype)
                    sub = plane[ty:ty + th, tx:tx + tw]
                    blk[:sub.shape[0], :sub.shape[1]] = sub
                    chunks.append(encode(blk))
        else:
            rps = rows_per_strip or h
            chunks += [encode(plane[y:y + rps]) for y in range(0, h, rps)]
    long_kind = 16 if big else 4
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra is not None:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, [int(v) for v in np.asarray(colormap).T.ravel()])
    if orientation:
        tags[274] = (3, [orientation])
    if tables is not None:
        tags[347] = (7, list(tables))
    head_len = 16 if big else 8
    offsets, body, pos = [], bytearray(), head_len
    for chunk in chunks:
        offsets.append(pos)
        body += chunk + b"\0" * (len(chunk) % 2)
        pos = head_len + len(body)
    if tile:
        tags.update({322: (3, [tile[0]]), 323: (3, [tile[1]]), 324: (long_kind, offsets),
                     325: (long_kind, [len(c) for c in chunks])})
    else:
        tags.update({278: (4, [rows_per_strip or h]), 273: (long_kind, offsets),
                     279: (long_kind, [len(c) for c in chunks])})
    code = {3: "H", 4: "I", 16: "Q", 7: "B"}
    inline, entry = (8, "HHQ") if big else (4, "HHI")
    ifd_len = (8 if big else 2) + len(tags) * (20 if big else 12) + (8 if big else 4)
    ext_at, ext, entries = pos + ifd_len, bytearray(), bytearray()
    for tag in sorted(tags):
        kind, vals = tags[tag]
        raw = struct.pack(order + code[kind] * len(vals), *vals)
        if len(raw) <= inline:
            val = raw + b"\0" * (inline - len(raw))
        else:
            val = struct.pack(order + ("Q" if big else "I"), ext_at + len(ext))
            ext += raw + b"\0" * (len(raw) % 2)
        entries += struct.pack(order + entry, tag, kind, len(vals)) + val
    ifd = struct.pack(order + ("Q" if big else "H"), len(tags)) + entries \
        + struct.pack(order + ("Q" if big else "I"), 0)
    mark = b"II" if order == "<" else b"MM"
    head = mark + (struct.pack(order + "HHHQ", 43, 8, 0, pos) if big
                   else struct.pack(order + "HI", 42, pos))
    return head + bytes(body) + ifd + bytes(ext)


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
    formats_dir = os.path.join(fixtures, "formats")
    webp_dir = os.path.join(fixtures, "webp")
    j2k_dir, grey_dir = os.path.join(fixtures, "jpeg2000"), os.path.join(fixtures, "grey")
    zero_counts = dict.fromkeys(KERNELS, 0)
    counts, reset_counts = c.counts, c.reset_counts
    os.makedirs(c.root, exist_ok=True)

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    def digest(*arrays):
        hd = hashlib.sha256()
        for a in arrays:
            a = np.ascontiguousarray(a)
            hd.update(str(a.dtype.str).encode() + str(a.shape).encode() + a.tobytes())
        return hd.hexdigest()

    @contextlib.contextmanager
    def host_libraries_blocked():
        blocked = {m: sys.modules.get(m) for m in ("h5py", "cv2", "matplotlib", "PIL")}
        try:
            for m in blocked:
                sys.modules[m] = None  # as on a machine without them
            yield
        finally:
            for m, mod in blocked.items():
                if mod is None:
                    sys.modules.pop(m, None)
                else:
                    sys.modules[m] = mod

    # (a) the committed fixtures against cv2's decodes, cv2 and PIL blocked
    with host_libraries_blocked():
        checked = []
        for path in sorted(glob.glob(os.path.join(jpeg_dir, "*.jpg"))):
            name = os.path.basename(path)[:-4]
            if name == "disp_magma_q75":  # (e)'s
                continue
            want = imageio.decode_png(read(os.path.join(
                jpeg_dir, "pair_512x832.png" if name == "pair_512x832_progressive" else
                name + ".png")))
            got = imageio.decode_jpeg(read(path))
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"JPEG {name}: differs from cv2's decode")
            checked.append(name)
        if "prog_cut3" not in checked or not any(n.startswith("cmyk") for n in checked):
            raise AssertionError(f"JPEG fixtures: {checked}")
        adam7 = []
        for path in sorted(glob.glob(os.path.join(fixtures, "png", "adam7_ct?.png"))):
            got = imageio.decode_png(read(path), imageio.IMREAD_UNCHANGED)
            want = imageio.decode_png(read(path[:-4] + "_cv2.png"), imageio.IMREAD_UNCHANGED)
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"PNG {os.path.basename(path)}: differs from cv2's decode")
            adam7.append(os.path.basename(path)[:-4])
        if len(adam7) != 5:
            raise AssertionError(f"interlaced PNG fixtures: {adam7}")
        with open(os.path.join(formats_dir, "expected.json")) as f:
            formats_want = json.load(f)
        for name, entry in sorted(formats_want.items()):
            data = read(os.path.join(formats_dir, name))
            for flags, want in entry.items():
                if want.startswith("raises: "):  # where cv2's output is undefined
                    try:
                        imageio.imdecode(data, int(flags))
                    except ValueError as e:
                        if want[len("raises: "):] not in str(e):
                            raise
                    else:
                        raise AssertionError(f"{name} (flags {flags}) decodes; expected a raise")
                elif digest(imageio.imdecode(data, int(flags))) != want:
                    raise AssertionError(f"{name} (flags {flags}): differs from cv2's decode")
        with open(os.path.join(webp_dir, "expected.json")) as f:
            webp_want = json.load(f)
        for name, entry in sorted(webp_want.items()):
            data = read(os.path.join(webp_dir, name))
            for flags, want in entry.items():
                if want == "none":  # a body cv2 refuses: the port raises
                    try:
                        imageio.imdecode(data, int(flags))
                    except ValueError:
                        continue
                    raise AssertionError(f"{name} (flags {flags}) decodes; cv2 refuses it")
                if digest(imageio.imdecode(data, int(flags))) != want:
                    raise AssertionError(f"{name} (flags {flags}): differs from cv2's decode")
        with open(os.path.join(j2k_dir, "expected.json")) as f:
            j2k_want = json.load(f)
        for name, entry in sorted(j2k_want.items()):
            data = read(os.path.join(j2k_dir, name))
            for flags, want in entry.items():
                try:
                    got = imageio.imdecode(data, int(flags))
                except ValueError:
                    got = None  # no image, as where cv2 gives None
                if (digest(got) if got is not None else "none") != want:
                    raise AssertionError(f"{name} (flags {flags}): differs from cv2's decode")
        with open(os.path.join(grey_dir, "expected.json")) as f:
            grey_want = json.load(f)
        for name, entry in sorted(grey_want.items()):
            data = read(os.path.join(grey_dir, name))
            for flags, want in entry.items():
                if want.startswith("raises: "):  # where the port raises by design
                    try:
                        imageio.imdecode(data, int(flags))
                    except ValueError as e:
                        if want[len("raises: "):] not in str(e):
                            raise
                    else:
                        raise AssertionError(f"{name} (flags {flags}) decodes; expected a raise")
                elif digest(imageio.imdecode(data, int(flags))) != want:
                    raise AssertionError(f"{name} (flags {flags}): differs from cv2's decode")
        # the 512x832 stacked pair in each format, the bodies built here from
        # the committed pair's pixels (TIFF JPEG: PIL's file, committed)
        pair_px = imageio.decode_png(read(os.path.join(jpeg_dir, "pair_512x832.png")))
        rgb = np.ascontiguousarray(pair_px[:, :, ::-1])
        pair_bodies = {
            "BMP": write_bmp(pair_px.shape[1], pair_px.shape[0], 24,
                             bmp_rows([r.tobytes() for r in pair_px])),
            "P6": write_p6(pair_px),
            "Sun raster": write_sun(pair_px),
            "TIFF": write_tiff(rgb, 2, rows_per_strip=64),
            "TIFF LZW": write_tiff(rgb, 2, compression=5, predictor=2, rows_per_strip=64),
            "TIFF Deflate": write_tiff(rgb, 2, compression=8, predictor=2, rows_per_strip=64),
            "TIFF JPEG": read(os.path.join(formats_dir, "pair_512x832_jpeg.tif")),
            "HDR": write_hdr(pair_px.astype(np.float32) / 255.0),
            **{f"WebP{tag}": read(os.path.join(webp_dir, f"pair_512x832_{name}.webp"))
               for tag, name in (("", "lossy"), (" lossless", "lossless"),
                                 (" alpha", "alpha"))},
            "JP2 lossless": read(os.path.join(j2k_dir, "pair_512x832_lossless.jp2")),
            "J2K irreversible": read(os.path.join(j2k_dir, "pair_512x832_irreversible.j2k")),
        }
        pair_bodies = {"PNG": read(os.path.join(jpeg_dir, "pair_512x832.png")),
                       "JPEG": read(os.path.join(jpeg_dir, "pair_512x832.jpg")),
                       "progressive JPEG": read(os.path.join(
                           jpeg_dir, "pair_512x832_progressive.jpg")), **pair_bodies}
        t_dec = {k: [] for k in pair_bodies}
        decoded = {}
        for _ in range(20):
            for kind, body in pair_bodies.items():
                t0 = time.perf_counter()
                decoded[kind] = imageio.imdecode(body)
                t_dec[kind].append((time.perf_counter() - t0) * 1e3)
    lossless = ("PNG", "JPEG", "progressive JPEG", "BMP", "P6", "Sun raster", "TIFF", "TIFF LZW",
                "TIFF Deflate", "WebP lossless", "JP2 lossless")
    differ = [k for k in lossless if not np.array_equal(decoded[k], pair_px)]
    differ += [k for k, name in (("WebP", "lossy"), ("WebP alpha", "alpha"))
               if digest(decoded[k]) != webp_want[f"pair_512x832_{name}.webp"]["1"]]
    if digest(decoded["J2K irreversible"]) != j2k_want["pair_512x832_irreversible.j2k"]["1"]:
        differ.append("J2K irreversible")
    if differ or digest(decoded["TIFF JPEG"]) != formats_want["pair_512x832_jpeg.tif"]["1"] \
            or decoded["HDR"].shape != pair_px.shape:
        raise AssertionError(f"the stacked pair: {differ} differ from its pixels, TIFF JPEG "
                             f"{digest(decoded['TIFF JPEG'])[:12]}, HDR {decoded['HDR'].shape}")
    host_ms = {k: statistics.median(v) for k, v in t_dec.items()}
    print(f"host modules (a), cv2, PIL, h5py and matplotlib blocked: {len(checked)} JPEGs decode "
          f"bit-equal to cv2's decodes ({', '.join(checked)}; prog_cut3, the progression cut "
          f"after scan 3, through libjpeg's block smoothing); the interlaced PNGs "
          f"{', '.join(adam7)}; {len(formats_want)} BMP, PNM, PAM, PFM, Sun raster, HDR and TIFF "
          f"fixtures, {len(webp_want)} WebP fixtures, {len(j2k_want)} JPEG 2000 fixtures and "
          f"{len(grey_want)} gamma-PNG and grey-and-alpha TIFF fixtures equal cv2's decodes "
          f"under IMREAD_COLOR, IMREAD_GRAYSCALE and IMREAD_UNCHANGED (SHA-256; the "
          f"{sum('none' in e.values() for e in webp_want.values())} WebP bodies cv2 refuses "
          f"raise, the {sum('none' in e.values() for e in j2k_want.values())} JPEG 2000 bodies "
          f"it refuses give no image); host ms to decode the {pair_px.shape[0]}x"
          f"{pair_px.shape[1]} stacked pair (median of 20, one thread; {c.smi}): "
          + ", ".join(f"{k} {v:.3f} ({len(pair_bodies[k])} bytes)" for k, v in host_ms.items()))
    print(json.dumps({"host_decode_ms": host_ms, "body_bytes": {
        k: len(v) for k, v in pair_bodies.items()}, "smi": c.smi}))

    # (b) serving each format on the card, against the PNG of the same pixels
    h, w = c.img_hw
    cfg = types.SimpleNamespace(img_hw=c.img_hw)
    model = FlowModel(FlowModelConfig(compute_dtype=c.precision), device=c.device, scheme="pwc",
                      generator=torch.Generator().manual_seed(SEED + 17))
    server = FlowServer(cfg, model, max_batch=c.batch, max_wait_ms=5.0)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server, cfg))
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/flow"
    served_bodies = {**pair_bodies, "cut progression": read(os.path.join(jpeg_dir,
                                                                         "prog_cut3.jpg"))}
    # an AVIF header (an ISO BMFF ftyp box of brand avif): refused before any decode
    avif = (28).to_bytes(4, "big") + b"ftypavif" + bytes(16)

    def post(body):
        req = urllib.request.Request(url, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.read()

    try:
        faults, launches, replies = [], {}, {}
        for kind, body in served_bodies.items():
            reset_counts()
            replies[kind] = post(body)
            launches[kind] = counts()
            png_of_pixels = imageio.encode_png(imageio.imdecode(body))
            if replies[kind] != post(png_of_pixels):
                faults.append(f"{kind}: reply differs from the PNG of its pixels'")
            if launches[kind] != c.want({**zero_counts, "corr_fwd": 5}):
                faults.append(f"{kind}: launches {_launched(launches[kind])}")
        try:
            post(avif)
        except urllib.error.HTTPError as e:
            refusal = (e.code, json.loads(e.read())["error"])
        else:
            refusal = (200, "")
        lat = {}
        for kind, body in pair_bodies.items():
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
    flow = np.frombuffer(replies["JPEG"][12:], np.float32).reshape(-1)
    if replies["JPEG"] != replies["progressive JPEG"] or flow.size != h * w * 2 \
            or not np.isfinite(flow).all() or refusal[0] != 400 or "AVIF" not in refusal[1]:
        faults.append(f"JPEG and progressive replies equal "
                      f"{replies['JPEG'] == replies['progressive JPEG']}, {flow.size} values, "
                      f"AVIF {refusal}")
    if faults:
        raise AssertionError("serving: " + "; ".join(faults))
    serve_ms = {k: statistics.median(v) for k, v in lat.items()}
    print(f"host modules (b): FlowServer + HTTP on {c.device} at {h}x{w}, {c.precision}, "
          f"max_batch {c.batch}: {len(served_bodies)} bodies ({', '.join(served_bodies)}) each "
          f"get a 200 with the .flo reply ({len(replies['JPEG'])} bytes) of the PNG of their "
          f"decoded pixels, each with exactly {launches['JPEG']['corr_fwd']} corr_fwd launches; "
          f"an AVIF body: {refusal[0]} {refusal[1]!r}; median ms a request (8 in turn, decode + "
          f"resize + inference + reply; {c.smi}): "
          + ", ".join(f"{k} {v:.2f}" for k, v in serve_ms.items()))
    print(json.dumps({"served_ms": serve_ms, "smi": c.smi}))

    # (c) the demo on JPEG, BMP and TIFF frames against the demo on PNGs of their pixels
    pth = evaluation.export_pth(os.path.join(c.root, "demo.pth"), model)
    del model
    yaml = os.path.join(c.root, "demo.yaml")
    with open(yaml, "w") as f:
        f.write(f"img_hw: [{h}, {w}]\nnum_scales: 3\n")
    frames = {kind: [] for kind in ("jpeg", "bmp", "tiff", "png", "webp", "webp_png", "jp2",
                                    "jp2_png")}
    for k in ("a", "b"):
        jpg = os.path.join(jpeg_dir, f"frame_{k}.jpg")
        px = imageio.decode_jpeg(read(jpg))
        writers = {"bmp": lambda: write_bmp(px.shape[1], px.shape[0], 24,
                                            bmp_rows([r.tobytes() for r in px])),
                   "tiff": lambda: write_tiff(px[:, :, ::-1], 2, compression=5, predictor=2),
                   "png": lambda: imageio.encode_png(px)}
        frames["jpeg"].append(jpg)
        for kind, write in writers.items():
            path = os.path.join(c.root, f"frame_{k}.{kind}")
            with open(path, "wb") as f:
                f.write(write())
            frames[kind].append(path)
        for kind, frame in (("webp", os.path.join(webp_dir, f"frame_{k}.webp")),
                            ("jp2", os.path.join(j2k_dir, f"frame_{k}.jp2"))):
            frames[kind].append(frame)
            path = os.path.join(c.root, f"frame_{k}_{kind}.png")
            with open(path, "wb") as f:
                f.write(imageio.encode_png(imageio.imread(frame)))
            frames[f"{kind}_png"].append(path)
    demo, demo_counts = {}, {}
    for kind, (a, b) in frames.items():
        reset_counts()
        demo[kind] = evaluation.main([
            "-c", yaml, "--task", "demo", "--pretrained_model", pth, "--image_path", a,
            "--image_path2", b, "--result_dir", os.path.join(c.root, f"demo_{kind}"), *c.cli])
        demo_counts[kind] = counts()
    def reference(kind):  # lossy WebP and JPEG 2000: the PNGs of their own decoded pixels
        return demo[f"{kind.split('_')[0]}_png" if kind.startswith(("webp", "jp2")) else "png"]

    if any(not np.array_equal(v, reference(k)) for k, v in demo.items()) \
            or demo["png"].shape != (h, w, 2) \
            or any(v != c.want({**zero_counts, "corr_fwd": 5}) for v in demo_counts.values()):
        equal = {k: np.array_equal(v, reference(k)) for k, v in demo.items()}
        raise AssertionError(f"demo: equal to the PNG demo {equal}, launches {demo_counts}")
    print(f"host modules (c): test.main --task demo on two JPEG, two BMP, two LZW TIFF, two "
          f"WebP and two JP2 frames equals the demo on PNGs of their decoded pixels ({h}x{w} "
          f"flow, mean |flow| "
          f"{float(np.abs(demo['png']).mean()):.4f} px), "
          f"{demo_counts['jpeg']['corr_fwd']} corr_fwd launches each")

    # (d) NYUv2 without h5py: the preparer, the test split, the metrics
    with open(os.path.join(nyu_dir, "expected.json")) as f:
        expected = json.load(f)

    with host_libraries_blocked():
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

    # (e) the disparity's JPEG, and (f) the drawing tools
    from unopticalflow_tpu_torch.utils.visualizer import VisualizerDebug, _magma_rgb

    with open(os.path.join(fixtures, "drawing", "expected.json")) as f:
        drawn_want = json.load(f)["png_pixels_sha256"]
    with host_libraries_blocked():
        demo_dir = os.path.join(c.root, "depth_demo")

        def disparity(images):  # a disparity computed on the card from the frame
            x = torch.as_tensor(images, device=c.device)
            return 0.05 + 0.3 * x.mean(dim=-1, keepdim=True)

        disp, _ = depth_harness.test_single_image(os.path.join(jpeg_dir, "frame_a.jpg"),
                                                  disparity, (128, 416), save_dir=demo_dir)
        demo_jpg = read(os.path.join(demo_dir, "demo_depth.jpg"))
        demo_px = imageio.decode_jpeg(demo_jpg)
        magma = imageio.decode_png(read(os.path.join(jpeg_dir, "disp_magma.png")))
        magma_jpg = imageio.encode_jpeg(magma)
        draw_dir = os.path.join(c.root, "drawing")
        vis = VisualizerDebug(draw_dir)
        img1, img2, match, fundamental = drawing_inputs(17)
        vis.show_corres(img1, img2, match, "draw")
        np.random.seed(17)
        vis.show_epipolar_line(img1, img2, match, fundamental, "draw")
        drawn = {n: digest(imageio.imread(os.path.join(draw_dir, n), imageio.IMREAD_UNCHANGED))
                 for n in sorted(os.listdir(draw_dir))}
    if demo_jpg != imageio.encode_jpeg(_magma_rgb(disp)[:, :, ::-1]) \
            or demo_px.shape != disp.shape + (3,) \
            or magma_jpg != read(os.path.join(jpeg_dir, "disp_magma_q75.jpg")):
        raise AssertionError(f"disparity JPEG: demo_depth.jpg {demo_px.shape}, the magma "
                             f"fixture's encode {len(magma_jpg)} bytes differs")
    if drawn != drawn_want:
        differ = sorted(n for n in drawn_want if drawn.get(n) != drawn_want[n])
        raise AssertionError(f"drawing tools: {differ} differ from the JAX package's pixels")
    print(f"host modules (e), (f), cv2, matplotlib and PIL blocked: test_single_image wrote "
          f"demo_depth.jpg ({len(demo_jpg)} bytes, {demo_px.shape[1]}x{demo_px.shape[0]}), the "
          f"JPEG of its magma pixels; encode_jpeg of the committed magma pixels is byte-equal to "
          f"PIL's file ({len(magma_jpg)} bytes); {', '.join(drawn)} have the pixels of the JAX "
          f"package's (SHA-256)")
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


def pose_snippets(hw, n: int, seed: int):
    """``SyntheticSnippets`` with per-snippet intrinsics, (img, K, K_inv)
    samples: KITTI's P_rect_02 at 375x1242, scaled to ``hw``, moved a little."""
    import numpy as np

    from unopticalflow_tpu_torch.data.synthetic import SyntheticSnippets

    def kitti_k(rng):
        k = np.array([[721.5377, 0.0, 609.5593], [0.0, 721.5377, 172.854], [0.0, 0.0, 1.0]])
        k[0] *= hw[1] / KITTI_HW[1]
        k[1] *= hw[0] / KITTI_HW[0]
        k[:2, :] *= 1.0 + 0.01 * rng.randn(2, 1)
        return k.astype(np.float32), np.linalg.inv(k).astype(np.float32)

    class PoseSnippets(SyntheticSnippets):
        def __init__(self):
            super().__init__(hw, n, seed)
            rng = np.random.RandomState(seed)
            self.ks = [kitti_k(rng) for _ in range(len(self.snippets))]

        def __getitem__(self, idx):
            return (super().__getitem__(idx), *self.ks[idx % len(self.ks)])

    return PoseSnippets()


def pair_snippets(hw, frame_hw, n: int, seed: int):
    """NYU_v2's samples in memory: (2H, W, 3) float32 pairs at ``hw``, K_ms,
    K_inv_ms (NYU's intrinsics at ``frame_hw`` rescaled as NYU_v2 rescales
    them)."""
    import numpy as np

    from unopticalflow_tpu_torch.data import preparers
    from unopticalflow_tpu_torch.data.synthetic import SyntheticSnippets

    class PairSnippets:
        num_frames = 2

        def __init__(self):
            nh, nw = hw
            snips = SyntheticSnippets(hw, n, seed=seed).snippets
            self.pairs = snips[:, :2 * nh].astype(np.float32) / 255.0
            k = np.array(preparers._NYU_INTRINSICS_LINE.split()[1:], float).reshape(3, 4)[:, :3]
            k[0] *= nh / frame_hw[0]
            k[1] *= nw / frame_hw[1]
            ks = [np.diag([0.5**s, 0.5**s, 1.0]) @ k for s in range(3)]
            self.k = np.stack(ks).astype(np.float32)
            self.k_inv = np.stack([np.linalg.inv(x) for x in ks]).astype(np.float32)

        def __len__(self):
            return n

        def __getitem__(self, idx):
            if idx >= n:
                raise IndexError(idx)
            return self.pairs[idx % len(self.pairs)], self.k, self.k_inv

    return PairSnippets()


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
            img_hw=c.img_hw, steps_per_dispatch=1)
        os.makedirs(cfg.model_dir, exist_ok=True)
        on_step, metrics, ms = step_events()
        reset_counts()
        res = train_cli.train(cfg, dataset=pose_snippets(c.img_hw, steps * batch_n, SEED + 20),
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

    data = pose_snippets(c.img_hw, batch_n, SEED + 21)
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
        model_dir=os.path.join(root, "b"), num_workers=4, img_hw=c.img_hw, steps_per_dispatch=1)
    os.makedirs(cfg.model_dir, exist_ok=True)
    start = FlowPoseModel(FlowModelConfig(), device=device, scheme="pwc",
                          generator=torch.Generator().manual_seed(SEED + 22))
    on_step, metrics, ms = step_events()
    reset_counts()
    res = train_cli.train(cfg, dataset=pose_snippets(c.img_hw, c.freeze_steps * batch_n,
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

    pair_rates = {}
    for mode in ("flowposenet", "flow"):
        cfg = train_cli.recipe_config(
            mode=mode, dataset="nyuv2", num_iterations=c.fp_steps, init_scheme="pwc",
            seed=SEED + 28, img_hw=c.nyu_hw, log_interval=1000, save_interval=100000,
            batch_size=batch_n, model_dir=os.path.join(root, f"pair_{mode}"), num_workers=4,
            steps_per_dispatch=1)
        os.makedirs(cfg.model_dir, exist_ok=True)
        on_step, metrics, ms = step_events()
        reset_counts()
        pairs = pair_snippets(c.nyu_hw, c.nyu_frame_hw, c.fp_steps * batch_n, SEED + 28)
        train_cli.train(cfg, dataset=pairs, device=device, on_step=on_step)
        c.sync()
        got = counts()
        if got != {k: c.fp_steps * v for k, v in c.want(PER_STEP_PAIR).items()} \
                or not all(bool(torch.isfinite(v)) for m in metrics for v in m.values()):
            raise AssertionError(f"2-frame {mode} steps: launches {got}")
        pair_rates[mode] = ms()

    # the 2-frame step against its plain version on one batch of these pairs:
    # each decoder level's correlation forward and backward at this step's
    # shapes, the losses of both modes, the float32 whole-step gradient
    pairs = pair_snippets(c.nyu_hw, c.nyu_frame_hw, batch_n, SEED + 28)
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


def graph_vs_eager(c, multi, model, opt, batch, cfg, weights, label, dtype, mode="flow",
                   frames=3) -> dict:
    """From one state (weights and Adam's): one graph dispatch of ``multi``
    (warmed up and captured) on ``batch``, a tuple of (K, ...) leaves,
    against K eager capturable-Adam ``train_step`` calls on its slots, a
    second eager run, and eager steps on images moved by one ulp of
    ``dtype``: the K losses and the parameters' change within 3 times the
    eager steps' own distance on the moved images (phase 7's rule, floor
    1e-4) or from the second run, whichever is larger; in float32 the first
    sub-step's loss bit-equal.  Restores the state after each.
    ``c``: the launch counters."""
    import warnings

    import torch

    from unopticalflow_tpu_torch.training import train_step

    params = list(model.parameters())
    snap_p = [p.detach().clone() for p in params]
    # opt.state is a defaultdict: a parameter it does not hold stays out of it
    snap_s = [{n: t.clone() for n, t in opt.state[p].items()} if p in opt.state else {}
              for p in params]
    held = {id(p) for g in opt.param_groups for p in g["params"]}

    def restore():
        with torch.no_grad():
            for p, sp, ss in zip(params, snap_p, snap_s):
                p.copy_(sp)
                for n, t in ss.items():
                    opt.state[p][n].copy_(t)

    def change():
        return torch.cat([(p.detach() - sp).double().ravel()
                          for p, sp in zip(params, snap_p)])

    def slot(b, j):
        return b[0][j] if len(b) == 1 else tuple(x[j] for x in b)

    c.reset_counts()
    loss_graph = multi(batch)["loss_total"].double()
    replay_launches = {n: v for n, v in c.counts().items() if v}
    d_graph = change()
    others_same = all(torch.equal(p.detach(), sp) for p, sp in zip(params, snap_p)
                      if id(p) not in held)
    restore()

    def eager(b):
        with warnings.catch_warnings():
            # capturable Adam warns when it steps outside a capture
            warnings.filterwarnings("ignore", message=".*capturable=True.*")
            losses = [train_step(model, opt, slot(b, j), weights, cfg, mode,
                                 frames)["loss_total"] for j in range(multi.steps)]
        out = torch.stack(losses).double(), change()
        restore()
        return out

    loss_eager, d_eager = eager(batch)
    # the eager steps again on the same batches: the backward's atomic
    # sums (the warps' scatter-adds) make two runs differ after step one
    loss_again, d_again = eager(batch)
    # the images one ulp of the compute dtype up: the model casts them to it,
    # so one float32 ulp would round away in bfloat16 and leave a rerun
    imgs = batch[0].float() / 255.0 if batch[0].dtype == torch.uint8 else batch[0]
    imgs = imgs.to(getattr(torch, dtype))
    loss_noise, d_noise = eager((torch.nextafter(imgs, torch.full_like(imgs, 2.0)).float(),
                                 *batch[1:]))
    del imgs
    # the larger of the two spreads, as phases 20 and 21 hold their steps: the
    # bf16 loss rises 1.6 -> 10 in these 8 steps (PERF.md q14), where one
    # sample of a chaotic spread is too few
    loss_err, d_err = _rel_l2(loss_graph, loss_eager), _rel_l2(d_graph, d_eager)
    loss_tol = max(_rel_l2(loss_noise, loss_eager), _rel_l2(loss_again, loss_eager))
    d_tol = max(_rel_l2(d_noise, d_eager), _rel_l2(d_again, d_eager))
    first_equal = bool(loss_graph[0] == loss_eager[0])
    print(f"steps per dispatch {label}: one graph dispatch of {multi.steps} steps against "
          f"{multi.steps} eager capturable-Adam steps from the same weights and Adam "
          f"state: losses rel L2 {loss_err:.3e} (eager vs eager on images one {dtype} ulp "
          f"away {_rel_l2(loss_noise, loss_eager):.3e}), the parameters' change rel L2 "
          f"{d_err:.3e} ({_rel_l2(d_noise, d_eager):.3e}); eager vs eager on the same "
          f"batches {_rel_l2(loss_again, loss_eager):.3e} and "
          f"{_rel_l2(d_again, d_eager):.3e}; bounds 3 x the larger, floor 1e-4: "
          f"{max(1e-4, 3 * loss_tol):.3e} and {max(1e-4, 3 * d_tol):.3e}; first sub-step's loss "
          f"{'bit-equal' if first_equal else 'differs'} ({float(loss_graph[0])!r}, "
          f"{float(loss_eager[0])!r}); the replay launched {replay_launches or 'nothing'}; "
          f"graph losses " + json.dumps([round(float(v), 6) for v in loss_graph]))
    if loss_err > max(1e-4, 3 * loss_tol) or d_err > max(1e-4, 3 * d_tol):
        raise AssertionError(f"{label}: the graph's {multi.steps} steps depart from the "
                             "eager steps")
    if dtype == "float32" and not first_equal:
        raise AssertionError(f"{label}: the graph's first sub-step's loss is not the eager "
                             "step's, bit for bit")
    if not others_same:
        raise AssertionError(f"{label}: the graph moved a parameter the optimizer does "
                             "not hold")
    return {"loss_err": loss_err, "loss_tol": loss_tol, "d_err": d_err, "d_tol": d_tol,
            "first_equal": first_equal, "replay_launches": replay_launches}


def dispatch_graph(c) -> dict:
    """Phase 18 (see the module): K training steps a dispatch, one CUDA graph.
    ``c`` holds the device, the shapes, K, the launch counters, the card's
    nvidia-smi line and the trainer's device flags ``cli``.  Returns (d)'s
    graph ms/step by dtype."""
    import copy
    import warnings

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from unopticalflow_tpu_torch import train as train_cli
    from unopticalflow_tpu_torch.data.loader import BatchLoader
    from unopticalflow_tpu_torch.data.synthetic import SyntheticSnippets
    from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig
    from unopticalflow_tpu_torch.probe import _busy_us, device_ops_per_step
    from unopticalflow_tpu_torch.training import (
        loss_fn,
        loss_weights_from_config,
        make_multi_train_step,
        make_optimizer,
        set_capturable,
        train_step,
    )
    from unopticalflow_tpu_torch.utils import imageio

    device, k, batch_n = c.device, c.k, c.batch
    h, w = c.img_hw
    t18 = time.perf_counter()
    weights = loss_weights_from_config(train_cli.recipe_config())
    data = SyntheticSnippets(c.img_hw, k * batch_n, seed=SEED + 18)
    xs = torch.from_numpy(np.stack([data[i] for i in range(k * batch_n)])).to(device)
    xs = xs.reshape(k, batch_n, 3 * h, w, 3)  # the dispatch's K batches, uint8

    @contextlib.contextmanager
    def quiet():
        # capturable Adam warns when it steps outside a capture
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*capturable=True.*")
            yield

    def fresh(cfg):
        return FlowModel(cfg, device=device, scheme="pwc",
                         generator=torch.Generator().manual_seed(SEED + 18))

    def profiled(fn):
        """(device busy ms, the window's CUDA-event ms, device operations) of
        one call of ``fn`` under the profiler: the idle share is the window's."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
        return (_busy_us(prof.events()) / 1e3, start.elapsed_time(end),
                device_ops_per_step(prof.key_averages(), 1))

    # (b) capturable Adam against make_optimizer's, one step from one state
    cfg32 = FlowModelConfig()
    model_a = fresh(cfg32)
    opt_a = make_optimizer(model_a)
    train_step(model_a, opt_a, xs[0], weights, cfg32)  # Adam's state at step 1
    model_b = FlowModel(cfg32, device=device)
    model_b.load_state_dict(model_a.state_dict())
    opt_b = make_optimizer(model_b)
    # a deep copy: load_state_dict keeps the tensors it is given where their
    # device and dtype fit, so the two optimizers would share their moments
    opt_b.load_state_dict(copy.deepcopy(opt_a.state_dict()))
    set_capturable(opt_b)
    opt_a.zero_grad(set_to_none=True)
    total, _ = loss_fn(model_a, cfg32, xs[1], weights)
    total.backward()
    for p, q in zip(model_a.parameters(), model_b.parameters()):
        q.grad = p.grad.clone()
    before = [p.detach().clone() for p in model_a.parameters()]
    opt_a.step()
    with quiet():
        opt_b.step()
    # capturable Adam computes the bias corrections 1 - beta**t in float32 on
    # the device (as optax does), the eager one in float64 on the host: at t =
    # 2 sqrt(1 - beta2**2) differs by ~1e-5, so each update may move by that
    # share of itself, beside its own float32 roundings and p + update's one
    t = torch.tensor(2.0, device=device)
    d1 = abs(float(1 - torch.tensor(0.9, device=device) ** t) / (1 - 0.9 ** 2) - 1)
    d2 = abs(float((1 - torch.tensor(0.999, device=device) ** t).sqrt())
             / math.sqrt(1 - 0.999 ** 2) - 1)
    worst, n_diff, n_all, moments_equal, bad = 0.0, 0, 0, True, []
    for (name, p), q, p0 in zip(model_a.named_parameters(), model_b.parameters(), before):
        pa, pb = p.detach(), q.detach()
        ulp = torch.nextafter(pa.abs(), torch.full_like(pa, math.inf)) - pa.abs()
        diff = (pa - pb).abs()
        tol = 2 * ulp + (pa - p0).abs() * (d1 + d2 + 16 * 2.0 ** -24)
        if bool((diff > tol).any()):
            bad.append(name)
        worst = max(worst, float((diff / tol).max()))
        n_diff += int((diff > 0).sum())
        n_all += pa.numel()
        sa, sb = opt_a.state[p], opt_b.state[q]
        moments_equal &= torch.equal(sa["exp_avg"], sb["exp_avg"]) and \
            torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
        if float(sb["step"]) != 2 or sb["step"].device != pb.device:
            bad.append(f"{name} step")
    print(f"steps per dispatch (b): capturable Adam against make_optimizer's, one step from "
          f"the same state (step 2, float32 gradients at the KITTI recipe): {n_diff} of {n_all} "
          f"parameters differ, at most {worst:.3f} of the bound (2 ulps + the update times "
          f"the float32 bias corrections' relative error {d1:.2e} + {d2:.2e} + 16 x 2**-24); "
          f"exp_avg, exp_avg_sq {'bit-equal' if moments_equal else 'differ'}")
    if bad:
        raise AssertionError(f"capturable Adam departs from make_optimizer's: {bad[:8]}")
    del model_a, model_b, opt_a, opt_b, total, before
    torch.cuda.empty_cache()

    records = []
    for dtype in ("float32", "bfloat16"):
        cfg = FlowModelConfig(compute_dtype=dtype, loss_dtype=dtype)
        # (c) launches, (d) the graph's time, idle share and memory
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        model = fresh(cfg)
        init = [p.detach().clone() for p in model.parameters()]
        opt = make_optimizer(model)
        set_capturable(opt)
        multi = make_multi_train_step(model, opt, cfg, weights, k)
        c.reset_counts()
        t0 = time.perf_counter()
        multi(xs)
        torch.cuda.synchronize()
        t_warm, counts_warm = time.perf_counter() - t0, c.counts()
        c.reset_counts()
        t0 = time.perf_counter()
        multi(xs)
        torch.cuda.synchronize()
        t_capture, counts_capture = time.perf_counter() - t0, c.counts()
        c.reset_counts()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(DISPATCH_TIMED + 1)]
        events[0].record()
        for i in range(DISPATCH_TIMED):
            m = multi(xs)
            events[i + 1].record()
        torch.cuda.synchronize()
        counts_replay = c.counts()
        per_dispatch = [events[i].elapsed_time(events[i + 1]) for i in range(DISPATCH_TIMED)]
        ms_graph = statistics.median(per_dispatch) / k
        peak_graph = (torch.cuda.max_memory_allocated(device) - base) / 2**30
        want = {n: k * v for n, v in PER_STEP.items()}
        if counts_warm != want or counts_capture != want or any(counts_replay.values()):
            raise AssertionError(f"{dtype}: launches of the eager dispatch {counts_warm}, of "
                                 f"the capture {counts_capture}, of {DISPATCH_TIMED} replays "
                                 f"{counts_replay}; want {want}, {want}, none")
        if not all(bool(torch.isfinite(v).all()) for v in m.values()):
            raise AssertionError(f"{dtype}: a replay's losses are not finite: {m}")
        busy_graph, window_graph, ops_graph = (v / (DISPATCH_PROFILED * k) for v in profiled(
            lambda: [multi(xs) for _ in range(DISPATCH_PROFILED)]))
        print(f"steps per dispatch (c) {dtype}: the eager first dispatch launched {counts_warm} "
              f"in {t_warm:.2f} s, the capture {_launched(counts_capture)} ({k} x {PER_STEP}) "
              f"with its replay in {t_capture:.2f} s, {DISPATCH_TIMED} replays none")

        # (a) from one state: one replay against 8 eager capturable-Adam steps,
        # and against eager steps on batches moved by one ulp.  The state is the
        # fresh one, set in place: the weights at their init, Adam's moments and
        # step at zero (what a new Adam starts from).  After the dispatches
        # above (56 steps on 8 repeated batches) the bf16 step is past its rise
        # and chaotic (PERF.md q14), where two runs part by more than the
        # one-ulp nudge's distance whatever the capture does.
        with torch.no_grad():
            for p, p0 in zip(model.parameters(), init):
                p.copy_(p0)
                for t in opt.state[p].values():
                    t.zero_()
        del init
        held = graph_vs_eager(c, multi, model, opt, (xs,), cfg, weights, f"(a) {dtype}",
                              dtype)
        if held["replay_launches"]:
            raise AssertionError(f"{dtype}: a replay launched {held['replay_launches']}")
        del multi, model, opt, m
        torch.cuda.empty_cache()

        # (d) K = 1 eager, the trainer's step at K = 1 (make_optimizer's Adam)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        model = fresh(cfg)
        opt = make_optimizer(model)
        for j in range(2):
            train_step(model, opt, xs[j], weights, cfg)
        torch.cuda.synchronize()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(k + 1)]
        events[0].record()
        for j in range(k):
            train_step(model, opt, xs[j], weights, cfg)
            events[j + 1].record()
        torch.cuda.synchronize()
        ms_eager = statistics.median(events[j].elapsed_time(events[j + 1]) for j in range(k))
        peak_eager = (torch.cuda.max_memory_allocated(device) - base) / 2**30
        busy_eager, window_eager, ops_eager = (v / EAGER_PROFILED for v in profiled(
            lambda: [train_step(model, opt, xs[j], weights, cfg) for j in range(EAGER_PROFILED)]))
        del model, opt
        torch.cuda.empty_cache()

        def idle(busy, window):
            return f"{1 - busy / window:.2%}" if busy > 0 else "not measured"

        # the idle share two ways: against the profiled window's own CUDA-event
        # time (which holds the profiler's overhead on every launch and
        # replay), and against the unprofiled ms/step of the timed runs
        rec = {"dtype": dtype, "k": k, "ms_step_eager_k1": ms_eager, "ms_step_graph": ms_graph,
               "ms_dispatch_graph": per_dispatch, "idle_eager": idle(busy_eager, window_eager),
               "idle_graph": idle(busy_graph, window_graph),
               "idle_eager_vs_ms_step": idle(busy_eager, ms_eager),
               "idle_graph_vs_ms_step": idle(busy_graph, ms_graph), "busy_ms_eager": busy_eager,
               "busy_ms_graph": busy_graph, "profiled_ms_eager": window_eager,
               "profiled_ms_graph": window_graph, "device_ops_per_step_eager": ops_eager,
               "device_ops_per_step_graph": ops_graph, "peak_gib_eager": peak_eager,
               "peak_gib_graph": peak_graph, "capture_s": t_capture, "warm_up_s": t_warm}
        records.append(rec)
        print(f"steps per dispatch (d) {dtype}: K = 1 eager {ms_eager:.3f} ms/step (idle "
              f"{rec['idle_eager']} of the profiled window, {rec['idle_eager_vs_ms_step']} of "
              f"the unprofiled step, {ops_eager:.1f} device operations a step, peak "
              f"{peak_eager:.3f} GiB) against K = {k} graph {ms_graph:.3f} ms/step (idle "
              f"{rec['idle_graph']}, {rec['idle_graph_vs_ms_step']} of the unprofiled step, "
              f"{ops_graph:.1f} operations a step, peak "
              f"{peak_graph:.3f} GiB); {BATCH / ms_graph * 1e3:.1f} against "
              f"{BATCH / ms_eager * 1e3:.1f} snippets/s ({c.smi})")
    print(json.dumps({"steps_per_dispatch": records}))

    # (e) the trainer as a user runs it: --steps_per_dispatch auto on a warm cache
    prep = os.path.join(c.root, "prepared", "data_s1")
    os.makedirs(os.path.join(prep, "d", "r"), exist_ok=True)
    lines = []
    for i, snip in enumerate(SyntheticSnippets(c.kitti_hw, c.snippets, seed=SEED + 18).snippets):
        with open(os.path.join(prep, "d", "r", f"{i:010d}.png"), "wb") as f:
            f.write(imageio.encode_png(snip, level=1))
        lines.append(f"d/r/{i:010d}.png d/calib.txt\n")
    with open(os.path.join(prep, "d", "calib.txt"), "w") as f:
        f.write("P_rect_02: 721.5 0.0 609.6 44.9 0.0 721.5 172.9 0.2 0.0 0.0 1.0 0.003\n")
    with open(os.path.join(prep, "train.txt"), "w") as f:
        f.writelines(lines)

    def yaml18(name, num_iterations):
        path = os.path.join(c.root, name)
        with open(path, "w") as f:
            f.write(f"prepared_base_dir: '{os.path.join(c.root, 'prepared')}'\n"
                    f"dataset: 'kitti_depth'\nnum_scales: 3\nnum_iterations: {num_iterations}\n"
                    "w_ssim: 0.85\nw_flow_smooth: 10.0\nw_flow_consis: 0.01\n"
                    f"img_hw: [{h}, {w}]\n")
        return path

    cache = os.path.join(prep, f"decoded_cache_{h}x{w}")
    rates = {}
    for name in ("cache (cold)", "cache (warm)"):
        ds = train_cli.PREPARED["kitti_depth"](prep, num_scales=3, img_hw=c.img_hw,
                                               num_iterations=c.loader_snippets, cache_dir=cache,
                                               emit_uint8=True)
        t0 = time.perf_counter()
        n_loaded = sum(len(b) for b in BatchLoader(ds, batch_size=batch_n, num_workers=4))
        rates[name] = n_loaded / (time.perf_counter() - t0)
    dir_e = os.path.join(c.root, "models")
    args = ["--no_test", "--batch_size", str(batch_n), "--num_workers", "4", "--log_interval",
            str(k), "--save_interval", str(k), "--cache_decoded", "--init_scheme", "pwc",
            "--precision", "bfloat16", "--steps_per_dispatch", "auto", "--model_dir", dir_e,
            *c.cli]
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-u", "-m", "unopticalflow_tpu_torch.train", "-c",
                           yaml18("train.yaml", 2 * k), *args], capture_output=True, text=True,
                          cwd=repo, env=env, timeout=600)
    t_proc = time.perf_counter() - t0
    out = proc.stdout
    logged = [int(x) for x in re.findall(r"^iter: (\d+),", out, flags=re.M)]
    rate = re.findall(r"snippets_per_sec: ([0-9.]+)", out)
    files = set(os.listdir(os.path.join(dir_e, "flow"))) if os.path.isdir(
        os.path.join(dir_e, "flow")) else set()
    if proc.returncode != 0 or f"steps_per_dispatch auto -> {k}" not in out \
            or logged != [0, k] or not {f"iter_{k - 1}.pth", f"iter_{2 * k - 1}.pth",
                                        "last.pth"} <= files:
        raise AssertionError(f"trainer --steps_per_dispatch auto: rc {proc.returncode}, "
                             f"logged {logged}, files {sorted(files)}:\n{out[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    # resume from iter_<k-1>.pth: 2k more iterations, K = 8 again, captured after the load
    c.reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as resumed:
        rc = train_cli.main(["-c", yaml18("resume.yaml", 3 * k - 1), "--resume", "--iter_start",
                             str(k - 1), *args])
    torch.cuda.synchronize()
    t_resume, counts_resume = time.perf_counter() - t0, c.counts()
    log_r = resumed.getvalue()
    last = torch.load(os.path.join(dir_e, "flow", "last.pth"), map_location="cpu",
                      weights_only=True)
    want = {n: 2 * k * v for n, v in PER_STEP.items()}
    if rc != 0 or f"at iteration {k - 1}." not in log_r \
            or f"steps_per_dispatch auto -> {k}" not in log_r or counts_resume != want \
            or last["iteration"] != 3 * k - 2:
        raise AssertionError(f"--resume at K = {k}: rc {rc}, launches {counts_resume} (want "
                             f"{want}), last.pth at {last['iteration']}:\n{log_r[-3000:]}")
    step_rate = BATCH / records[1]["ms_step_graph"] * 1e3
    print(f"steps per dispatch (e): python -m unopticalflow_tpu_torch.train --steps_per_dispatch "
          f"auto (log and save every {k}, {2 * k} iterations, bfloat16, batch {batch_n}, "
          f"{h}x{w}, --cache_decoded) printed 'auto -> {k}', logged {logged} "
          f"(snippets_per_sec at {k}: {rate[-1] if rate else 'none'}, over the eager and the "
          f"capturing dispatch), wrote {sorted(files)} in {t_proc:.2f} s; --resume from "
          f"iter_{k - 1}.pth ran {2 * k} more at K = {k} in {t_resume:.2f} s with launches "
          f"{_launched(counts_resume)} (the eager dispatch and the capture), last.pth at "
          f"{last['iteration']}; loader snippets/s (4 threads) "
          + ", ".join(f"{n} {v:.1f}" for n, v in rates.items())
          + f" against the graph's bf16 step {step_rate:.1f}: the run is bound by the "
          + ("loader" if rates["cache (warm)"] < step_rate else "step")
          + f" ({c.smi})")
    dispatch_modes(c)
    print(f"steps per dispatch: phase 18 in {time.perf_counter() - t18:.1f} s")
    return {r["dtype"]: r["ms_step_graph"] for r in records}


def dispatch_modes(c) -> None:
    """Phase 18 (f) and (g) (see the module): ``c`` as for ``dispatch_graph``
    with ``want``, ``sync``, ``empty_cache``, the NYU shapes and
    ``synthetic_epe``'s ``epe_iters`` and ``epe_hw``, so that a CPU rehearsal
    (K eager steps a dispatch, no launches) can shrink them."""
    import numpy as np
    import torch

    from unopticalflow_tpu_torch import train as train_cli
    from unopticalflow_tpu_torch.benchmarks import synthetic_epe
    from unopticalflow_tpu_torch.models import FlowModelConfig
    from unopticalflow_tpu_torch.training import loss_weights_from_config, make_multi_train_step

    device, k, batch_n = c.device, c.k, c.batch
    # (f) the other training modes at the K that auto picks at the yamls'
    # intervals (log 100, save 2000, test 2000): the trainer on in-memory
    # snippets, float32, three dispatches (the eager one, the capture, a
    # replay) with each dispatch's launches, then (a)'s check from the state
    # it left, through a new step function (its own eager dispatch and capture)
    kk = DISPATCH_AUTO_K
    cases = (
        ("flowposenet", dict(mode="flowposenet", img_hw=c.img_hw), PER_STEP,
         lambda n: pose_snippets(c.img_hw, n, SEED + 19)),
        ("flowposenet --freeze_flow", dict(mode="flowposenet", freeze_flow=True,
                                           img_hw=c.img_hw),
         PER_STEP_FROZEN, lambda n: pose_snippets(c.img_hw, n, SEED + 19)),
        ("nyuv2 flowposenet (2-frame)", dict(mode="flowposenet", dataset="nyuv2",
                                             img_hw=c.nyu_hw), PER_STEP_PAIR,
         lambda n: pair_snippets(c.nyu_hw, c.nyu_frame_hw, n, SEED + 19)),
        ("nyuv2 flow (2-frame)", dict(mode="flow", dataset="nyuv2", img_hw=c.nyu_hw),
         PER_STEP_PAIR, lambda n: pair_snippets(c.nyu_hw, c.nyu_frame_hw, n, SEED + 19)),
    )
    for i, (label, over, per_step, make_data) in enumerate(cases):
        cfg = train_cli.recipe_config(num_iterations=3 * kk, init_scheme="pwc", seed=SEED + 19,
                                      batch_size=batch_n, num_workers=4,
                                      model_dir=os.path.join(c.root, f"f{i}"), **over)
        os.makedirs(cfg.model_dir, exist_ok=True)
        data = make_data(3 * kk * batch_n)
        marks, metrics = [], []

        def on_step(it, m):
            if it % kk == 0:  # after each dispatch: the launches so far
                marks.append(c.counts())
            metrics.append(m)

        c.reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            res = train_cli.train(cfg, dataset=data, device=device, on_step=on_step)
        c.sync()
        t_train = time.perf_counter() - t0
        per_dispatch = [{n: v - (marks[j - 1][n] if j else 0) for n, v in mark.items()}
                        for j, mark in enumerate(marks)]
        want = [{n: kk * v for n, v in c.want(per_step).items()}] * 2 \
            + [dict.fromkeys(per_step, 0)]
        if f"steps_per_dispatch auto -> {kk}" not in out.getvalue() or res.step != 3 * kk \
                or per_dispatch != want or len(metrics) != 3 * kk \
                or not all(bool(torch.isfinite(v)) for m in metrics for v in m.values()):
            raise AssertionError(f"(f) {label}: {res.step} steps, launches by dispatch "
                                 f"{per_dispatch} (want {want}):\n{out.getvalue()[-3000:]}")
        model, opt = res.model, res.optimizer
        mcfg = FlowModelConfig()
        mode, frames = cfg.mode, data.num_frames
        w_case = loss_weights_from_config(cfg)
        multi = make_multi_train_step(model, opt, mcfg, w_case, kk, mode, frames,
                                      bool(getattr(cfg, "freeze_flow", False)))
        samples = [data[j] for j in range(kk * batch_n)]
        leaves = [torch.from_numpy(np.stack([smp[j] for smp in samples])).to(device)
                  for j in range(len(samples[0]))]
        batch = train_cli.model_inputs(
            cfg, tuple(x.reshape(kk, batch_n, *x.shape[1:]) for x in leaves), stacked=True)
        batch = batch if isinstance(batch, tuple) else (batch,)
        launches = []
        for _ in range(2):  # the eager dispatch, then the capture and its replay
            c.reset_counts()
            multi(batch)
            launches.append(c.counts())
        capturable = all(g["capturable"] for g in opt.param_groups)
        if launches != want[:2] or capturable != (device.type == "cuda"):
            raise AssertionError(f"(f) {label}: launches of the eager dispatch and the capture "
                                 f"{launches} (want {want[:2]}), capturable Adam {capturable}")
        held = graph_vs_eager(c, multi, model, opt, batch, mcfg, w_case, f"(f) {label}",
                              "float32", mode, frames)
        if held["replay_launches"]:
            raise AssertionError(f"(f) {label}: a replay launched {held['replay_launches']}")
        print(f"steps per dispatch (f) {label}: train() with --steps_per_dispatch auto at the "
              f"yamls' intervals printed 'auto -> {kk}', {res.step} float32 steps at batch "
              f"{batch_n} {tuple(cfg.img_hw)} in {t_train:.2f} s, launches by dispatch "
              f"{[_launched(d) for d in per_dispatch]} (eager, capture, replay); a new step "
              f"function's eager dispatch and capture {_launched(launches[1])} each")
        del res, model, opt, multi, batch, leaves, metrics
        c.empty_cache()

    # (g) synthetic_epe's graph path: the cosine rate computed inside the
    # graph, read back a step at a time, and the EPE against K = 1
    epe = {}
    for kd in (1, k):
        argv = ["--device", device.type, "--iters", str(c.epe_iters), "--batch", "4", "--hw",
                *map(str, c.epe_hw), "--lr-schedule", "cosine", "--eval-snippets", "16",
                "--eval-every", str(c.epe_iters // 2), "--steps-per-dispatch", str(kd)]
        with contextlib.redirect_stdout(io.StringIO()):
            epe[kd] = synthetic_epe.run(synthetic_epe.build_arg_parser().parse_args(argv))
    r1, rk = epe[1], epe[k]
    # one float32 rounding of the float64 schedule, at most an ulp of the rate
    if rk["lr_max_rel_err"] > 2.0 ** -23 or r1["lr_max_rel_err"] != 0.0 \
            or not all(math.isfinite(r["epe_all"]) for r in (r1, rk)) \
            or [p["iter"] for p in rk["eval_points"]] != [k - 1, c.epe_iters // 2 + k - 1]:
        raise AssertionError(f"(g) synthetic_epe: K = 1 {json.dumps(r1)}, K = {k} "
                             f"{json.dumps(rk)}")
    print(f"steps per dispatch (g): synthetic_epe --iters {c.epe_iters} --batch 4 --hw "
          f"{c.epe_hw[0]} {c.epe_hw[1]} --lr-schedule cosine (bfloat16), K = {k} graph against "
          f"K = 1: each step's learning "
          f"rate read back from the graph within {rk['lr_max_rel_err']:.3e} of cosine_decay_lr "
          f"(relative; the last {rk['lr_last']!r}, K = 1 {r1['lr_last']!r}); EPE all "
          f"{rk['epe_all']} against {r1['epe_all']} (zero flow {r1['zero_flow']['epe_all']}), "
          f"eval points " + json.dumps({kd: [(p['iter'], p['epe_all']) for p in r['eval_points']]
                                        for kd, r in epe.items()})
          + f", ms/step {rk['ms_per_step']} against {r1['ms_per_step']} ({c.smi})")


def q14_runs(c, cfg, weights, xs, runs: int, steps: int, kinds=("graph", "eager")) -> dict:
    """Phase 19 (h): ``runs`` runs of ``steps`` steps on the K repeated
    batches ``xs`` of each of ``kinds``: K-step graph dispatches, eager
    capturable-Adam steps; each from the same seeded weights.  Each run's
    losses, a step at a time, by kind."""
    import warnings

    import torch

    from unopticalflow_tpu_torch.models import FlowModel
    from unopticalflow_tpu_torch.training import (
        make_multi_train_step,
        make_optimizer,
        set_capturable,
        train_step,
    )

    k = xs.shape[0]
    out = {kind: [] for kind in kinds}
    for kind in kinds * runs:
        model = FlowModel(cfg, device=c.device, scheme="pwc",
                          generator=torch.Generator().manual_seed(SEED + 18))
        opt = make_optimizer(model)
        if c.device.type == "cuda":
            set_capturable(opt)
        losses = []
        with warnings.catch_warnings():
            # capturable Adam warns when it steps outside a capture
            warnings.filterwarnings("ignore", message=".*capturable=True.*")
            if kind == "graph":
                multi = make_multi_train_step(model, opt, cfg, weights, k)
                for _ in range(steps // k):
                    losses.append(multi(xs)["loss_total"].float())
            else:
                for j in range(steps):
                    losses.append(train_step(model, opt, xs[j % k], weights, cfg)
                                  ["loss_total"].float().reshape(1))
        out[kind].append(torch.cat(losses).cpu().double())
        del model, opt, losses
        c.empty_cache()
    return out


def _rose(losses, k: int, factor: float = Q14_RISE) -> tuple[bool, list[float]]:
    """(whether a block of ``k`` steps' mean loss exceeds ``factor`` times the
    lowest block mean before it, the block means)."""
    means = [float(b.mean()) for b in losses.split(k)]
    return any(m > factor * min(means[:i]) for i, m in enumerate(means) if i), means


def tools(c) -> None:
    """Phase 19 (see the module): the measuring and learning tools on the
    main path.  ``c`` holds the device, the shapes and counts of each part,
    the launch counters, ``want`` (the card's launch counts; a CPU rehearsal
    gives zeros), ``device_rate`` (None: measured on the card), ``trace``
    (the profiler phase, card only) and the card's nvidia-smi line."""
    import numpy as np
    import torch

    from unopticalflow_tpu_torch import probe
    from unopticalflow_tpu_torch import train as train_cli
    from unopticalflow_tpu_torch.benchmarks import (
        ablate,
        loader_bench,
        loss_landscape_probe,
        make_prepared_synth,
        profile_step,
        synthetic_epe,
        time_ms,
    )
    from unopticalflow_tpu_torch.benchmarks.synth_device_gen import make_device_batch
    from unopticalflow_tpu_torch.data.datasets import KITTI_Prepared
    from unopticalflow_tpu_torch.data.loader import BatchLoader
    from unopticalflow_tpu_torch.data.synthetic import SyntheticSnippets
    from unopticalflow_tpu_torch.models import FlowModelConfig
    from unopticalflow_tpu_torch.ops.photometric import photometric_pack_reference
    from unopticalflow_tpu_torch.training import loss_weights_from_config

    device, k, batch_n = c.device, c.k, c.batch
    h, w = c.img_hw
    t19 = time.perf_counter()
    dev = device.type
    gen_kw = dict(max_bg=TOOLS_MAX_BG, max_fg=TOOLS_MAX_FG, tex_power=1.0)

    # (a) the device generator: the four checks on the card, and its time
    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    stacked, flow, nonocc, d = make_device_batch(gen, batch_n, h, w, return_draws=True, **gen_kw)
    m_fg = min(TOOLS_MAX_FG, h // 8, w // 8)
    bg = flow[:, :1, :1]
    fg_frac = ((flow - bg).abs().amax(-1) > 0).float().mean((1, 2))
    ys = torch.arange(h, device=device)[None, :, None]
    xs_ = torch.arange(w, device=device)[None, None, :]
    b_ix = torch.arange(batch_n, device=device)[:, None, None]
    dy, dx = ys + flow[..., 1].long(), xs_ + flow[..., 0].long()
    f_t, f_n = stacked[:, h:2 * h], stacked[:, 2 * h:]
    warped = f_n[b_ix, dy.clamp(0, h - 1), dx.clamp(0, w - 1)]
    warp_err = float((warped - f_t).abs().amax(-1)[nonocc].max())
    host = synthetic_epe.make_batch(np.random.RandomState(SEED + 19), batch_n, h, w, **gen_kw)[0]
    moments = (abs(float(stacked.mean()) - host.mean()), abs(float(stacked.std()) - host.std()))
    checks = {
        "shapes": stacked.shape == (batch_n, 3 * h, w, 3) and flow.shape == (batch_n, h, w, 2)
        and nonocc.shape == (batch_n, h, w) and stacked.dtype == torch.float32,
        "range": 0.0 <= float(stacked.min()) and float(stacked.max()) <= 1.0
        and float(stacked.std()) > 0.05,
        "motions": bool((flow == flow.round()).all()) and float(bg.abs().max()) <= TOOLS_MAX_BG
        and float(flow.abs().max()) <= max(TOOLS_MAX_BG, m_fg)
        and float(fg_frac.max()) <= 1 / 6 + 1e-6,
        "rectangle in frame": all(
            bool((d[r] + t * d[m] >= 0).all()) and bool((d[r] + t * d[m] + d[s] <= e).all())
            for r, m, s, e in (("ry", "v_f", "rh", h), ("rx", "u_f", "rw", w))
            for t in (-1, 0, 1)),
        "exact warp": warp_err <= 1e-6,
        "moments": moments[0] < 0.05 and moments[1] < 0.04,
    }
    dev_ms = time_ms(lambda: make_device_batch(gen, batch_n, h, w, **gen_kw), (), device,
                     iters=5, warmup=1)
    rng = np.random.RandomState(SEED + 19)
    host_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        synthetic_epe.make_snippet(rng, h, w, **gen_kw)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(host_ms)
    print(f"tools (a) the device generator at {h}x{w}, batch {batch_n} (max_bg {TOOLS_MAX_BG}, "
          f"max_fg {TOOLS_MAX_FG}, tex_power 1.0): " + ", ".join(
              f"{n} {'ok' if v else 'FAILED'}" for n, v in checks.items())
          + f" (warp error {warp_err:.1e}, mean and std {moments[0]:.4f}, {moments[1]:.4f} "
          f"from the host generator's); {dev_ms:.3f} ms a batch of {batch_n} on the device "
          f"against the host's {host_ms:.1f} ms a snippet ({c.smi})")
    if not all(checks.values()):
        raise AssertionError(f"the device generator fails {checks}")
    del stacked, flow, nonocc, warped, f_t, f_n
    c.empty_cache()

    # (b) synthetic_epe --device-gen at the recipe's shape, bf16, K graph
    marks = []
    real_multi = synthetic_epe.make_multi_train_step

    def counting(*a, **kw):
        step = real_multi(*a, **kw)

        def dispatch(batch):
            c.reset_counts()
            out = step(batch)
            marks.append(c.counts())
            return out
        return dispatch

    argv = ["--device", dev, "--iters", str(c.epe_iters), "--batch", str(batch_n), "--hw",
            str(h), str(w), "--device-gen", "--steps-per-dispatch", str(k), "--eval-snippets",
            str(batch_n), "--max-bg", str(TOOLS_MAX_BG), "--max-fg", str(TOOLS_MAX_FG),
            "--tex-power", "1.0"]
    synthetic_epe.make_multi_train_step = counting
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            res = synthetic_epe.run(synthetic_epe.build_arg_parser().parse_args(argv))
    finally:
        synthetic_epe.make_multi_train_step = real_multi
    want = [{n: k * v for n, v in c.want(PER_STEP).items()}] * 2 \
        + [dict.fromkeys(PER_STEP, 0)] * (c.epe_iters // k - 2)
    if marks != want or not math.isfinite(res["epe_all"]) or not res["device_gen"]:
        raise AssertionError(f"synthetic_epe --device-gen: launches by dispatch {marks} (want "
                             f"{want}): {json.dumps(res)}")
    print(f"tools (b) synthetic_epe {' '.join(argv)} (bfloat16): launches by dispatch "
          f"{[_launched(m) for m in marks]} (eager, capture, replays); EPE all "
          f"{res['epe_all']} against zero flow's {res['zero_flow']['epe_all']} after "
          f"{c.epe_iters} iterations; {res['ms_per_step']} ms/step against the generator's "
          f"{dev_ms / batch_n:.3f} ms a snippet, {dev_ms:.3f} ms a batch, on the device "
          f"({c.smi})")

    # (c) from disk: a make_prepared_synth tree, train() on it, the loader bench
    prep = os.path.join(c.root, "prep")
    t0 = time.perf_counter()
    make_prepared_synth.write_tree(prep, c.prep_snippets, c.img_hw)
    t_tree = time.perf_counter() - t0
    cfg = train_cli.recipe_config(
        num_iterations=c.prep_steps, init_scheme="pwc", seed=SEED + 19, batch_size=batch_n,
        num_workers=4, log_interval=k, save_interval=c.prep_steps, steps_per_dispatch=k,
        precision="bfloat16", prepared_base_dir=c.root, prepared_save_dir="prep",
        model_dir=os.path.join(c.root, "m"), img_hw=c.img_hw)
    os.makedirs(cfg.model_dir, exist_ok=True)
    metrics = []
    c.reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as log:
        res_t = train_cli.train(cfg, device=device, on_step=lambda it, m: metrics.append(m))
    c.sync()
    t_train, counts_train = time.perf_counter() - t0, c.counts()
    want = {n: 2 * k * v for n, v in c.want(PER_STEP).items()}
    if res_t.step != c.prep_steps or counts_train != want or len(metrics) != c.prep_steps \
            or not all(bool(torch.isfinite(v)) for m in metrics for v in m.values()):
        raise AssertionError(f"train() from the make_prepared_synth tree: {res_t.step} steps, "
                             f"launches {counts_train} (want {want}):\n{log.getvalue()[-2000:]}")
    with contextlib.redirect_stdout(io.StringIO()):
        ds = KITTI_Prepared(prep, img_hw=c.img_hw, num_iterations=4 * batch_n, emit_uint8=True)
    t0 = time.perf_counter()
    n_loaded = sum(len(b) for b in BatchLoader(ds, batch_size=batch_n, num_workers=4))
    tree_rate = n_loaded / (time.perf_counter() - t0)
    logged = re.findall(r"snippets_per_sec: ([0-9.]+)", log.getvalue())
    args_lb = ["--snippets", str(c.loader_snippets), "--batch", str(batch_n), "--batches",
               str(c.loader_batches), "--dir", os.path.join(c.root, "loader_bench"),
               "--device", dev]
    if c.device_rate is not None:
        args_lb += ["--device-rate", str(c.device_rate)]
    c.reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        lb = loader_bench.run(loader_bench.build_arg_parser().parse_args(args_lb))
    c.sync()
    counts_lb = c.counts()
    want_lb = {n: 2 * loader_bench.RATE_K * v for n, v in c.want(PER_STEP).items()}
    if c.device_rate is None and counts_lb != want_lb:
        raise AssertionError(f"loader_bench's device rate: launches {counts_lb} (want "
                             f"{want_lb})")
    print(f"tools (c) make_prepared_synth: {c.prep_snippets} snippets at {h}x{w} in "
          f"{t_tree:.1f} s; train() on them, bfloat16, K = {k}, {c.prep_steps} steps in "
          f"{t_train:.1f} s, launches {_launched(counts_train)} (the eager dispatch and the "
          f"capture), logged snippets/s {logged}; the loader (4 threads, PNG decode) "
          f"{tree_rate:.1f} snippets/s from the tree ({c.smi})")
    print("tools (c) loader_bench " + " ".join(args_lb) + ": " + json.dumps(lb))

    # (d) profile_step: interleaved trials, use_pallas_reg off/on, both dtypes, K graph
    args_ps = ["--device", dev, "--batch", str(batch_n), "--hw", str(h), str(w), "--iters",
               str(c.ps_iters), "--trials", str(c.trials), "--precisions", "float32",
               "bfloat16", "--steps-per-dispatch", str(k)]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        ps = profile_step.run(profile_step.build_arg_parser().parse_args(args_ps))
    for rec in ps["setups"]:
        per = PER_STEP_REG if "reg-on" in rec["setup"] else PER_STEP
        if rec["launches_per_step"] != {n: float(v) for n, v in c.want(per).items()
                                        if n in rec["launches_per_step"]}:
            raise AssertionError(f"profile_step {rec['setup']}: launches a step "
                                 f"{rec['launches_per_step']}")
    print("tools (d) profile_step " + " ".join(args_ps) + ":\n  " + "\n  ".join(
        ln for ln in out.getvalue().splitlines() if ln.startswith(("trial", "float32",
                                                                     "bfloat16")))
        + f"\n  ({c.smi})")
    c.empty_cache()

    # (e) ablate: the seven variants, bf16, K graph, with their launches
    args_ab = ["--device", dev, "--batch", str(batch_n), "--hw", str(h), str(w),
               "--steps-per-dispatch", str(k), "--replays", str(c.replays), "--eager-steps",
               str(c.replays)]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        ab = ablate.run(ablate.build_arg_parser().parse_args(args_ab))
    launch = {r["variant"]: r["launches_per_step"] for r in ab}
    corr = ("corr_fwd", "corr_bwd_df1", "corr_bwd_df2")
    photo = ("photometric_fwd", "photometric_bwd")
    expect = {"full": c.want(PER_STEP),
              "no-corr": {**c.want(PER_STEP), **dict.fromkeys(corr, 0)},
              "no-ssim": c.want(PER_STEP),
              "convs-only": {**c.want(PER_STEP), **dict.fromkeys(photo, 0)}}
    for name, per in expect.items():
        got = {n: v for n, v in launch[name].items() if n in per}
        if got != {n: float(v) for n, v in per.items() if n in got}:
            raise AssertionError(f"ablate {name}: launches a step {launch[name]}")
    print("tools (e) ablate " + " ".join(args_ab) + ":\n  " + "\n  ".join(
        ln.strip() for ln in out.getvalue().splitlines() if ":" in ln and "ms/step" in ln)
        + f"\n  ({c.smi})")
    print(json.dumps({"ablations": ab}))
    c.empty_cache()

    # (f) probe.py's trace: the K graph step by kind, both dtypes
    if c.trace:
        os.makedirs(os.path.join(c.root, "trace"), exist_ok=True)
        for precision in ("float32", "bfloat16"):
            rec = probe.trace_run(device, precision, os.path.join(c.root, "trace"), SEED,
                                  k=k, timed=c.replays, profiled=1)
            if rec["launches_per_step"] != {n: float(v) for n, v in c.want(PER_STEP).items()
                                            if n in rec["launches_per_step"]}:
                raise AssertionError(f"trace {precision}: launches {rec['launches_per_step']}")
            print(f"tools (f) trace {precision}: {rec['ms_step']:.3f} ms/step at K = {k} "
                  f"(graph), busy {rec['busy_ms_step']:.3f} ms, idle "
                  f"{rec['idle_share']:.2%} of the unprofiled step, "
                  f"{rec['device_ops_per_step']:.1f} device ops a step, peak "
                  f"{rec['peak_allocated_gib']:.3f} GiB allocated and "
                  f"{rec['reserved_gib']:.3f} GiB reserved after the capture; ms a step by kind "
                  + json.dumps({n: round(v, 3) for n, v in rec["device_ms_by_kind"].items()})
                  + f" ({c.smi})")
            print(json.dumps(rec))
            c.empty_cache()

    # (g) the loss landscape through the kernels and through the plain versions
    for dtype, rtol in (("float32", 1e-4), ("bfloat16", 2e-2)):
        c.reset_counts()
        got = loss_landscape_probe.run(c.img_hw, batch_n, 5, device, dtype, verbose=False)
        c.sync()
        counts_ls = c.counts()
        plain = loss_landscape_probe.run(c.img_hw, batch_n, 5, device, dtype,
                                         photo_fn=photometric_pack_reference, verbose=False)
        points = got["alpha"] + got["constant"]
        want_ls = {n: v * len(points) for n, v in c.want(
            {**dict.fromkeys(PER_STEP, 0), "photometric_fwd": 3}).items()}
        worst = max(abs(g[t] - p[t]) / max(abs(p[t]), 1e-12)
                    for g, p in zip(points, plain["alpha"] + plain["constant"])
                    for t in ("pixel", "ssim", "smooth", "total"))
        totals = [r["total"] for r in got["alpha"]]
        print(f"tools (g) loss landscape {dtype} at {h}x{w}, batch {batch_n}: the kernels "
              f"against the plain versions on the card, largest relative gap {worst:.2e} "
              f"(rtol {rtol:g}); launches {_launched(counts_ls)}; least total at alpha "
              f"{loss_landscape_probe.ALPHAS[int(np.argmin(totals))]}: "
              + json.dumps([(r["a"], round(r["total"], 4)) for r in got["alpha"]]))
        if worst > rtol or counts_ls != want_ls:
            raise AssertionError(f"loss landscape {dtype}: gap {worst}, launches {counts_ls} "
                                 f"(want {want_ls})")

    # (h) q14: does bf16's loss on repeated batches rise in the graph alone?
    cfg16 = FlowModelConfig(compute_dtype="bfloat16", loss_dtype="bfloat16")
    weights = loss_weights_from_config(train_cli.recipe_config())
    data = SyntheticSnippets(c.img_hw, k * batch_n, seed=SEED + 18)
    xs = torch.from_numpy(np.stack([data[i] for i in range(k * batch_n)])).to(device)
    xs = xs.reshape(k, batch_n, 3 * h, w, 3)
    t0 = time.perf_counter()
    runs = q14_runs(c, cfg16, weights, xs, c.q14_runs, c.q14_steps)
    verdict = {}
    for kind, losses in runs.items():
        rose = [_rose(x, k) for x in losses]
        verdict[kind] = sum(r for r, _ in rose)
        print(f"tools (h) q14 {kind}: {c.q14_steps} bfloat16 steps on {k} repeated batches at "
              f"{h}x{w}, batch {batch_n}, {c.q14_runs} runs from one seed: means of "
              f"{k}-step blocks " + json.dumps([[round(m, 4) for m in ms] for _, ms in rose])
              + f"; rose (a block above {Q14_RISE} x the lowest before it) in "
              f"{verdict[kind]} of {c.q14_runs}")
        if not all(bool(torch.isfinite(x).all()) for x in losses):
            raise AssertionError(f"q14 {kind}: a loss is not finite")
    first = {float(x[0]) for xs_ in runs.values() for x in xs_}
    spread = {kind: max(_rel_l2(x, losses[0]) for x in losses[1:]) if len(losses) > 1 else 0.0
              for kind, losses in runs.items()}
    across = _rel_l2(torch.stack(runs["graph"]).mean(0), torch.stack(runs["eager"]).mean(0))
    print(f"tools (h) q14: first step's loss {'one value' if len(first) == 1 else first} "
          f"over the {2 * c.q14_runs} runs; the runs' largest distance from their kind's first "
          f"run (rel L2 over the {c.q14_steps} losses) graph {spread['graph']:.3e}, eager "
          f"{spread['eager']:.3e}; graph mean against eager mean {across:.3e}; "
          + ("only the graph rose: a fault of the capture"
             if verdict["graph"] and not verdict["eager"]
             else "eager rose too: not the capture" if verdict["eager"]
             else "no run rose")
          + f" ({time.perf_counter() - t0:.1f} s, {c.smi})")
    # the same eager steps in float32: is the rise bfloat16's?
    cfg32 = FlowModelConfig()
    f32 = q14_runs(c, cfg32, weights, xs, 1, c.q14_steps, kinds=("eager",))["eager"][0]
    rose32, means32 = _rose(f32, k)
    print(f"tools (h) q14 float32 eager, one run of the same {c.q14_steps} steps: means of "
          f"{k}-step blocks {json.dumps([round(m, 4) for m in means32])}; "
          f"{'rose' if rose32 else 'did not rise'}")
    if not bool(torch.isfinite(f32).all()):
        raise AssertionError("q14 float32: a loss is not finite")
    print(f"tools: phase 19 in {time.perf_counter() - t19:.1f} s")


def _dp_rank(rank: int, world: int, address: str, out: str, img_hw, batch: int, steps: int,
             device: str, backend: str) -> None:
    """Phase 20 (c): one rank of a data-parallel job through ``train()``, its
    losses, weights and launch counts written to ``out/rank<r>.pt``."""
    import torch

    from unopticalflow_tpu_torch.data.synthetic import SyntheticSnippets
    from unopticalflow_tpu_torch.ops import (
        correlation_cuda,
        gather_cuda,
        photometric_cuda,
        regularizer_cuda,
    )
    from unopticalflow_tpu_torch.parallel import initialize_multi_host
    from unopticalflow_tpu_torch.train import recipe_config, train

    tables = (correlation_cuda.launches, photometric_cuda.launches, regularizer_cuda.launches,
              gather_cuda.launches)
    for t in tables:
        t.update(dict.fromkeys(t, 0))
    cfg = recipe_config(num_iterations=steps, batch_size=batch, img_hw=tuple(img_hw),
                        init_scheme="pwc", seed=SEED, log_interval=1, save_interval=1000,
                        model_dir=os.path.join(out, f"rank{rank}"), num_workers=2,
                        steps_per_dispatch=1, multi_host=True)
    os.makedirs(cfg.model_dir, exist_ok=True)
    losses, stamps = [], []

    def on_step(it, m):
        losses.append(float(m["loss_total"]))  # waits for the step, all-reduce included
        stamps.append(time.perf_counter())

    device = initialize_multi_host(address, world, rank, backend=backend, device=device)
    try:
        res = train(cfg, dataset=SyntheticSnippets(img_hw, steps * batch, seed=SEED + 20),
                    device=device, on_step=on_step)
    finally:
        torch.distributed.destroy_process_group()
    counts = {k: v for t in tables for k, v in t.items()}
    torch.save({"state": {k: v.cpu() for k, v in res.model.state_dict().items()},
                "losses": losses, "counts": counts,
                "ms": [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]},
               os.path.join(out, f"rank{rank}.pt"))


def data_parallel(c) -> None:
    """Phase 20 (see the module): data-parallel training and serving on one
    card.  ``c`` holds the device, the shapes, the launch counters, ``want``
    (the card's launch counts; a CPU rehearsal gives zeros), the card's
    compute mode (``compute_mode``; None on the CPU), the trainer's device
    flags ``cli`` and the card's nvidia-smi line."""
    import socket

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from unopticalflow_tpu_torch import train as train_cli
    from unopticalflow_tpu_torch.data.synthetic import SyntheticSnippets
    from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig
    from unopticalflow_tpu_torch.parallel import initialize_multi_host
    from unopticalflow_tpu_torch.serve import FlowServer
    from unopticalflow_tpu_torch.utils import imageio

    device, batch_n, k = c.device, c.batch, c.k
    # the card by its index, as a user lists it
    dev_name = f"cuda:{device.index or 0}" if device.type == "cuda" else str(device)
    h, w = c.img_hw
    t20 = time.perf_counter()

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def init_state(dtype):
        """The trainer's initial weights (seed, "pwc"), on the CPU."""
        m = FlowModel(FlowModelConfig(compute_dtype=dtype), device=device, scheme="pwc",
                      generator=torch.Generator().manual_seed(SEED))
        return {n: v.detach().cpu() for n, v in m.state_dict().items()}

    def change(state, init):
        return torch.cat([(state[n].double() - init[n].double()).ravel() for n in sorted(init)])

    # (a) whether the card takes two processes
    print(f"data parallel (a): compute mode {c.compute_mode} ({c.smi})")

    # (b) world size 1 over NCCL through the trainer's CLI, against the plain recipe
    prep = os.path.join(c.root, "prepared", "data_s1")
    os.makedirs(os.path.join(prep, "d", "r"), exist_ok=True)
    lines = []
    for i, snip in enumerate(SyntheticSnippets(c.img_hw, batch_n, seed=SEED + 20).snippets):
        with open(os.path.join(prep, "d", "r", f"{i:010d}.png"), "wb") as f:
            f.write(imageio.encode_png(snip, level=1))
        lines.append(f"d/r/{i:010d}.png d/calib.txt\n")
    with open(os.path.join(prep, "d", "calib.txt"), "w") as f:
        f.write("P_rect_02: 721.5 0.0 609.6 44.9 0.0 721.5 172.9 0.2 0.0 0.0 1.0 0.003\n")
    with open(os.path.join(prep, "train.txt"), "w") as f:
        f.writelines(lines)
    yaml_path = os.path.join(c.root, "train.yaml")
    with open(yaml_path, "w") as f:
        f.write(f"prepared_base_dir: '{os.path.join(c.root, 'prepared')}'\n"
                f"dataset: 'kitti_depth'\nnum_scales: 3\nnum_iterations: {c.dp_iters}\n"
                "w_ssim: 0.85\nw_flow_smooth: 10.0\nw_flow_consis: 0.01\n"
                f"img_hw: [{h}, {w}]\n")

    # the weights are compared after the eager dispatch, after the capturing
    # one (the all-reduce's first run in the graph), where runs have barely
    # separated, and at the end
    marks = (k - 1, 2 * k - 1, c.dp_iters - 1)

    def cli_run(name, dtype, extra=()):
        """``train.main`` with a shell's argv: ({iteration: weights} at
        ``marks``, launches, ms/step of the replay dispatches, log)."""
        model_dir = os.path.join(c.root, name)
        argv = ["-c", yaml_path, "--no_test", "--batch_size", str(batch_n), "--num_workers",
                "4", "--log_interval", str(k), "--save_interval", str(k),
                "--cache_decoded", "--init_scheme", "pwc", "--precision", dtype,
                "--steps_per_dispatch", "auto", "--model_dir", model_dir, *c.cli, *extra]
        c.reset_counts()
        with contextlib.redirect_stdout(io.StringIO()) as log:
            rc = train_cli.main(argv)
        c.sync()
        counts, out = c.counts(), log.getvalue()
        rates = [float(r) for r in re.findall(r"snippets_per_sec: ([0-9.]+)", out)]
        if rc != 0 or f"steps_per_dispatch auto -> {k}" not in out \
                or len(rates) != c.dp_iters // k - 1:
            raise AssertionError(f"{name}: rc {rc}, log:\n{out[-3000:]}")
        states = {i: torch.load(os.path.join(model_dir, "flow", f"iter_{i}.pth"),
                                map_location="cpu", weights_only=True)["model_state_dict"]
                  for i in marks}
        if not all(bool(torch.isfinite(v).all()) for st in states.values() for v in st.values()):
            raise AssertionError(f"{name}: weights not finite")
        c.empty_cache()
        # a rate at each log point after the first: the first closes the
        # capturing dispatch, each later one a replay dispatch
        return states, counts, [1e3 * batch_n / r for r in rates[1:]], out

    def held(got, plain, again, init, what):
        """The weights' change from ``init`` at each mark: bit-equal to the
        plain run's, or within max(1e-4, 3x) of it a second plain run's
        distance (``again``; None where every mark was bit-equal), and at
        least half as long as the plain run's (a run that never updated
        reads 1.0 against a distance the chaotic later steps can push past
        that)."""
        parts = []
        for i in marks:
            d_plain = change(plain[i], init)
            err = _rel_l2(change(got[i], init), d_plain)
            moved = float(change(got[i], init).norm() / d_plain.norm())
            if all(torch.equal(got[i][n], plain[i][n]) for n in plain[i]):
                parts.append(f"iteration {i}: bit-equal")
                continue
            tol = _rel_l2(change(again[i], init), d_plain)
            parts.append(f"iteration {i}: rel L2 {err:.3e} against two plain runs' {tol:.3e}, "
                         f"length {moved:.3f} of the plain run's")
            if not err <= max(1e-4, 3 * tol) or not moved > 0.5:
                raise AssertionError(f"{what}: the weights depart from the plain recipe's "
                                     f"({'; '.join(parts)}; bound max(1e-4, 3x), length > 0.5)")
        return "; ".join(parts)

    want_run = c.want({n: 2 * k * v for n, v in PER_STEP.items()})
    records, spread = {}, {}
    for dtype in ("float32", "bfloat16"):
        init = init_state(dtype)
        plain, plain_counts, plain_ms, _ = cli_run(f"plain_{dtype}", dtype)
        multi, multi_counts, multi_ms, log = cli_run(
            f"nccl_{dtype}", dtype, ["--multi_host", "--coordinator_address",
                                     f"127.0.0.1:{free_port()}", "--num_processes", "1",
                                     "--process_id", "0"])
        if "data parallel over 1 processes" not in log:
            raise AssertionError(f"--multi_host {dtype}: no process group:\n{log[-3000:]}")
        if plain_counts != want_run or multi_counts != want_run:
            raise AssertionError(f"{dtype}: launches plain {plain_counts}, --multi_host "
                                 f"{multi_counts}, want {want_run} (2K x the flow row)")
        bit_equal = all(torch.equal(multi[i][n], plain[i][n]) for i in marks for n in plain[i])
        again = None
        if not bit_equal:
            # the plain recipe again: where two plain runs differ (the
            # backward's atomic sums, cuDNN's choice by the process's history)
            again, _, again_ms, _ = cli_run(f"plain2_{dtype}", dtype)
            plain_ms += again_ms
        rule = held(multi, plain, again, init, f"--multi_host {dtype}")
        spread[dtype] = (plain, again, init)
        records[dtype] = {"plain_ms": plain_ms, "nccl_ms": multi_ms, "bit_equal": bit_equal,
                          "rel_l2": {i: _rel_l2(change(multi[i], init), change(plain[i], init))
                                     for i in marks}}
        print(f"data parallel (b) {dtype}: train.main --multi_host --num_processes 1 (NCCL, "
              f"its all-reduce in the K = {k} graph) against the plain recipe, {c.dp_iters} "
              f"iterations at batch {batch_n}, {h}x{w}: weights {rule}; launches a run "
              f"{_launched(multi_counts)} (2K x the flow row, eager dispatch and capture, "
              f"replays none); ms/step of the replay dispatches (the trainer's "
              f"snippets_per_sec) plain " + ", ".join(f"{v:.3f}" for v in plain_ms)
              + ", --multi_host " + ", ".join(f"{v:.3f}" for v in multi_ms) + f" ({c.smi})")
    print(json.dumps({"data_parallel_b": records}))
    if device.type == "cuda":
        # --multi_gpu: one spawned --multi_host process a visible card (world
        # size 1 here), whose launches its own process counts
        plain, again, init = spread["bfloat16"]
        if again is None:
            again = cli_run("plain2_bfloat16", "bfloat16")[0]
        model_dir = os.path.join(c.root, "multi_gpu_bfloat16")
        t0 = time.perf_counter()
        rc = train_cli.main(["-c", yaml_path, "--no_test", "--batch_size", str(batch_n),
                             "--num_workers", "4", "--log_interval", str(k), "--save_interval",
                             str(k), "--cache_decoded", "--init_scheme", "pwc",
                             "--precision", "bfloat16", "--model_dir", model_dir, "--multi_gpu"])
        t_spawn = time.perf_counter() - t0
        got = {i: torch.load(os.path.join(model_dir, "flow", f"iter_{i}.pth"),
                             map_location="cpu", weights_only=True)["model_state_dict"]
               for i in marks}
        if rc != 0:
            raise AssertionError(f"--multi_gpu on one card: rc {rc}")
        rule = held(got, plain, again, init, "--multi_gpu bfloat16")
        print(f"data parallel (b) --multi_gpu bfloat16: {torch.cuda.device_count()} spawned "
              f"process(es) in {t_spawn:.1f} s; the weights' change against the plain run's: "
              f"{rule}")

    # (c) two gloo ranks on one card against one process on the global batch
    if c.compute_mode is not None and "exclusive" in c.compute_mode.lower():
        raise AssertionError(f"the card's compute mode is {c.compute_mode}: two processes "
                             "cannot share it, so (c) cannot run")
    out = os.path.join(c.root, "gloo")
    os.makedirs(out, exist_ok=True)
    if device.type == "cuda":
        # no fallback: a gloo group cannot be captured in the K-step graph
        gcfg = train_cli.recipe_config(
            num_iterations=2 * k, batch_size=batch_n, img_hw=c.img_hw, init_scheme="pwc",
            log_interval=k, save_interval=1000, num_workers=2, steps_per_dispatch=k,
            model_dir=os.path.join(out, "gloo_k"), multi_host=True)
        os.makedirs(gcfg.model_dir, exist_ok=True)
        c.reset_counts()
        gdev = initialize_multi_host(f"127.0.0.1:{free_port()}", 1, 0, backend="gloo",
                                     device=dev_name)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                train_cli.train(gcfg, dataset=SyntheticSnippets(c.img_hw, 2 * k * batch_n,
                                                                seed=SEED + 20), device=gdev)
        except RuntimeError as e:
            if "cannot be captured in a CUDA graph" not in str(e):
                raise
            print(f"data parallel (c): a K = {k} dispatch under gloo on the card raised "
                  f"({e}); launches {_launched(c.counts()) or 'none'}")
        else:
            raise AssertionError(f"a gloo group ran a K = {k} dispatch on the card")
        finally:
            torch.distributed.destroy_process_group()
    t0 = time.perf_counter()
    mp.start_processes(_dp_rank, args=(2, f"127.0.0.1:{free_port()}", out, c.img_hw,
                                       batch_n, c.dp_steps, dev_name, "gloo"),
                       nprocs=2, join=True, start_method="spawn")
    t_ranks = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=True) for r in (0, 1)]
    data = SyntheticSnippets(c.img_hw, c.dp_steps * batch_n, seed=SEED + 20)
    one_cfg = dict(num_iterations=c.dp_steps, batch_size=batch_n, img_hw=c.img_hw,
                   init_scheme="pwc", seed=SEED, log_interval=1, save_interval=1000,
                   num_workers=2, steps_per_dispatch=1)

    def one_process(name, dataset, batch=batch_n):
        cfg = train_cli.recipe_config(model_dir=os.path.join(out, name),
                                      **{**one_cfg, "batch_size": batch})
        os.makedirs(cfg.model_dir, exist_ok=True)
        losses, stamps = [], []

        def on_step(it, m):
            losses.append(float(m["loss_total"]))
            stamps.append(time.perf_counter())

        with contextlib.redirect_stdout(io.StringIO()):
            res = train_cli.train(cfg, dataset=dataset, device=device, on_step=on_step)
        return ({n: v.detach().cpu() for n, v in res.model.state_dict().items()},
                torch.tensor(losses), [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])])

    class Nudged:
        """The snippets moved by one ulp: float [0, 1] images (the loss casts
        uint8 by / 255, the same values)."""

        def __len__(self):
            return len(data)

        def __getitem__(self, i):
            x = data[i].astype(np.float32) / np.float32(255.0)
            return np.nextafter(x, np.float32(2.0))

    class RankZero:
        """Rank 0's blocks of the global batches: where every rank applied
        rank 0's gradient instead of the mean, the weights would follow one
        process on these (the fault the weights' bound must reject)."""

        def __len__(self):
            return len(data) // 2

        def __getitem__(self, i):
            half = batch_n // 2
            return data[(i // half) * batch_n + i % half]

    init = init_state("float32")
    single, single_loss, single_ms = one_process("single", data)
    nudged, nudged_loss, _ = one_process("nudged", Nudged())
    fault_state = one_process("rank0_only", RankZero(), batch_n // 2)[0]
    d_single = change(single, init)
    tol = _rel_l2(change(nudged, init), d_single)
    fault = _rel_l2(change(fault_state, init), d_single)
    print(f"data parallel (c): one process on rank 0's blocks alone (every rank applying rank "
          f"0's gradient) sits {fault:.3e} from one process on the global batch, the bound "
          f"max(1e-4, 3 x {tol:.3e})")
    if not fault > max(1e-4, 3 * tol):
        raise AssertionError("(c): the weights' bound does not reject the rank-0-gradient fault")
    loss_tol = _rel_l2(nudged_loss, single_loss)
    # Adam's sign slack: JAX's DP test allows 3e-4 (3 x lr) after one step
    # (tests/test_training.py); each further step may flip as many signs
    atol = 3e-4 * c.dp_steps
    want_rank = c.want({n: c.dp_steps * v for n, v in PER_STEP.items()})
    for r, got in enumerate(ranks):
        loss = torch.tensor(got["losses"])
        err = _rel_l2(change(got["state"], init), d_single)
        gap = torch.cat([(got["state"][n] - single[n]).abs().ravel() for n in single])
        close = all(torch.allclose(got["state"][n], single[n], rtol=5e-3, atol=atol)
                    for n in single)
        loss_err = _rel_l2(loss, single_loss)
        print(f"data parallel (c) rank {r} of 2 (gloo, {dev_name}, batch {batch_n // 2} of "
              f"{batch_n}, float32, K = 1, {c.dp_steps} steps) against one process on the "
              f"global batch: losses {[round(float(v), 6) for v in loss]} against "
              f"{[round(float(v), 6) for v in single_loss]} (rel L2 {loss_err:.3e}, one "
              f"process on images one ulp away {loss_tol:.3e}), the weights' change rel L2 "
              f"{err:.3e} ({tol:.3e}), {int((gap > 1e-4).sum())} parameters more than lr "
              f"apart, at most {float(gap.max()):.3e} (Adam's sign slack; allowed rtol 5e-3, "
              f"atol {atol:.1e}), launches {_launched(got['counts'])}; ms a step after the "
              f"first (host clock, both ranks on the card at once) "
              + ", ".join(f"{v:.3f}" for v in got["ms"]) + " against one process's "
              + ", ".join(f"{v:.3f}" for v in single_ms) + f" ({c.smi})")
        # the first step starts from the same state: rtol 1e-4; the later
        # ones by phase 7's one-ulp rule, the reference's own noise
        if not torch.allclose(loss[:1], single_loss[:1], rtol=1e-4) \
                or not loss_err <= max(1e-4, 3 * loss_tol) or not err <= max(1e-4, 3 * tol) \
                or not close:
            raise AssertionError(f"(c) rank {r}: the data-parallel step departs from one "
                                 "process on the global batch")
        if got["counts"] != want_rank:
            raise AssertionError(f"(c) rank {r}: launches {got['counts']}, want {want_rank}")
    if not all(torch.equal(ranks[0]["state"][n], ranks[1]["state"][n]) for n in single):
        raise AssertionError("(c): the two ranks' weights differ")
    print(f"data parallel (c): the two ranks' weights bit-equal; spawned, ran and joined in "
          f"{t_ranks:.1f} s")

    # (d) served batches split over two entries of one card
    model = FlowModel(FlowModelConfig(), device=device, scheme="pwc",
                      generator=torch.Generator().manual_seed(SEED))
    snips = SyntheticSnippets(c.img_hw, c.eval_pairs, seed=SEED + 6).snippets
    pairs = [snips[i % len(snips), :2 * h].astype(np.float32) / 255.0
             for i in range(c.eval_pairs)]
    scfg = types.SimpleNamespace(img_hw=c.img_hw)
    served = {}
    for name, devices in (("one", None), ("split", [dev_name] * 2)):
        server = FlowServer(scfg, model, max_batch=batch_n, max_wait_ms=20.0,
                            data_devices=devices)
        flows = [None] * len(pairs)

        def client(i0):
            for i in range(i0, len(pairs), batch_n):
                flows[i] = server.infer(pairs[i], timeout=300.0)

        c.reset_counts()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(batch_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        stats, counts = dict(server.stats), c.counts()
        server.close()
        if any(t.is_alive() for t in threads) or any(f is None for f in flows):
            raise AssertionError(f"(d) {name}: not every request was answered")
        served[name] = (np.stack(flows), stats, counts)
    got, want_f = served["split"][0], served["one"][0]
    peak = float(np.abs(want_f).max())
    gap = float(np.abs(got - want_f).max())
    launches = served["split"][2].get("corr_fwd", 0)
    print(f"data parallel (d): FlowServer(data_devices=[{dev_name}, {dev_name}]) against one "
          f"device, {len(pairs)} requests from {batch_n} clients at max_batch {batch_n}: "
          f"max |flow gap| {gap:.3e} (bound 1e-4 x (1 + {peak:.2f})), batches "
          f"{served['split'][1]['batches']} and {served['one'][1]['batches']}, corr_fwd "
          f"launches {launches} (10 a split batch) and {served['one'][2].get('corr_fwd', 0)}")
    if not gap <= 1e-4 * (1 + peak) \
            or launches != c.want({"n": 10 * served["split"][1]["batches"]})["n"]:
        raise AssertionError("(d): split serving departs from one device")
    print(f"data parallel: phase 20 in {time.perf_counter() - t20:.1f} s")


def spatial_training(c) -> dict:
    """Phase 21 (see the module): the training forward with each frame's rows
    split over n shards (rehearsable on the CPU: the plain versions, no
    timing).  ``c`` holds the device, the recipe's shape and batch, the
    shards' devices by n (``shard_devices``), the launch counters, ``want``
    (the card's launch counts; a CPU rehearsal gives zeros), the card's
    nvidia-smi line, and the kernel record's ``max_err``, ``ms``,
    ``plain_ms`` and ``work``, which (a) fills for the four hpad loss
    kernels.  Returns the launches of one sharded float32 step at n = 2 with
    ``use_pallas_reg``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from unopticalflow_tpu_torch import train as train_cli
    from unopticalflow_tpu_torch.data.synthetic import SyntheticSnippets
    from unopticalflow_tpu_torch.models import (FlowModel, FlowModelConfig, FlowPoseModel,
                                                forward, forward_flowpose,
                                                forward_flowpose_pair, forward_pair)
    from unopticalflow_tpu_torch.ops import photometric_cuda, regularizer_cuda
    from unopticalflow_tpu_torch.ops.cost_volume_spmd import take_rows
    from unopticalflow_tpu_torch.ops.photometric import (
        photometric_pack_rows,
        photometric_pack_rows_reference,
    )
    from unopticalflow_tpu_torch.ops.regularizer import (
        regularizer_pack_rows,
        regularizer_pack_rows_reference,
    )
    from unopticalflow_tpu_torch.ops.warp import bilinear_warp
    from unopticalflow_tpu_torch.parallel import make_spatial_forward, spatial_mesh
    from unopticalflow_tpu_torch.training import loss_weights_from_config, make_optimizer

    device, batch_n = c.device, c.batch
    on_card = device.type == "cuda"
    h, w = c.img_hw
    t21 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    zero = dict.fromkeys(KERNELS, 0)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # (a) the four hpad loss kernels against their plain rows versions, every
    # shard of n = 2 and 4 at the three loss scales' slabs
    def slabs(x, n):
        """n row-shards of x with one halo row each side (zeros outside)."""
        parts = list(torch.chunk(x, n, 2))
        hs = x.shape[2] // n
        return [take_rows(parts, i * hs - 1, (i + 1) * hs + 1, x.device) for i in range(n)]

    def rows_case(s, dtype):
        """Seeded images and flows at loss scale s: flows bilinear from a field
        8 times coarser in +-6 px (the warps cross the seams and the frame's
        edges) plus +-1 px on 30% of the pixels (second differences off zero)."""
        hh, ww = h >> s, w >> s
        r = np.random.RandomState(SEED + 21 + s)
        imgs = [torch.from_numpy(r.rand(batch_n, 3, hh, ww).astype(np.float32)).to(device, dtype)
                for _ in range(3)]
        coarse = torch.from_numpy(r.uniform(-6, 6, (batch_n, 4, hh // 8, ww // 8))
                                  .astype(np.float32))
        noise = (r.rand(batch_n, 4, hh, ww) < 0.3) * r.uniform(-1, 1, (batch_n, 4, hh, ww))
        fl = (F.interpolate(coarse, size=(hh, ww), mode="bilinear", align_corners=False)
              + torch.from_numpy(noise).float()).to(device)
        w_fwd = torch.from_numpy(r.rand(batch_n, 1, hh, ww).astype(np.float32)).to(device, dtype)
        return imgs, fl[:, :2].contiguous(), fl[:, 2:].contiguous(), w_fwd

    def photo_grads(fn, il, ir, fb, ff, im, row0, height):
        fb = fb.clone().requires_grad_(True)
        ff = ff.clone().requires_grad_(True)
        out = fn(il, ir, fb, ff, im, row0, height)
        loss = ((out["s_dw"] / (out["s_w"] + 1.0)).sum()
                + (out["s_cl"] / (out["s_w"] + 1.0)).sum())
        return {k: v.detach() for k, v in out.items()}, torch.autograd.grad(loss, [fb, ff])

    def reg_grads(fn, fb, ff, im, w_fwd, row0, height, cot):
        fb = fb.clone().requires_grad_(True)
        ff = ff.clone().requires_grad_(True)
        out = fn(fb, ff, im, w_fwd, row0, height)
        loss = sum((out[k] * cot[k]).sum() for k in out)
        return {k: v.detach() for k, v in out.items()}, torch.autograd.grad(loss, [fb, ff])

    def dflow_err(got, want, skip=(None, None)):
        """(max |got - want| outside ``skip``'s positions, max |want|)."""
        err = max(float((a - b).abs().masked_fill(t, 0).max() if t is not None
                        else (a - b).abs().max()) for a, b, t in zip(got, want, skip))
        return err, max(float(b.abs().max()) for b in want)

    def l1_ties(il, ir, fb, ff, im, row0):
        """(bwd, fwd) positions whose L1 term's argument |img - warped| is
        within 1e-6 of zero in a channel: its sign there is rounding noise,
        and the kernel rounds the warped value apart from ``bilinear_warp``
        (phase 7's ill-conditioning; a pixel or two a scale on these inputs).
        A warped value of 0 is no tie: the pixel's warp is masked out."""
        warps = [bilinear_warp(src.float(), fl, use_mask=True, row0=row0 - 1)
                 for src, fl in ((il, fb), (ir, ff))]
        return [(((im.float() - wp).abs() < 1e-6) & (wp != 0)).any(1, keepdim=True)
                for wp in warps]

    photo_keys, reg_keys = ("s_dw", "s_w", "s_cl"), ("s_sx", "s_sy", "s_consis")
    kernel_ms = {}  # "kernel scale dtype" -> ms over the shards of n = 2 (CUDA events)
    bf16_hpad = {}  # kernel -> [ms, plain ms, bytes, operations] of a bfloat16 step at n = 2
    for s in range(3):
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            (il, ir, im), fb, ff, w_full = rows_case(s, dtype)
            height = im.shape[2]
            cot = {"s_sx": torch.rand(2 * batch_n, generator=gen, device=device),
                   "s_sy": torch.rand(2 * batch_n, generator=gen, device=device),
                   "s_consis": torch.rand(batch_n, generator=gen, device=device)}
            worst = {"photo": [0.0, 0.0], "reg": [0.0, 0.0]}  # [sums err, d(flow) err / max]
            n_ties = 0
            for n in SPATIAL_N:
                hs = height // n
                for i, (fbh, ffh, imh) in enumerate(zip(slabs(fb, n), slabs(ff, n),
                                                        slabs(im, n))):
                    row0 = i * hs
                    wf = w_full[:, :, row0:row0 + hs].contiguous()
                    where = f"s{s} n={n} shard {i} {tuple(imh.shape)} {dt}"
                    c.reset_counts()
                    got, g_got = photo_grads(photometric_pack_rows, il, ir, fbh, ffh, imh, row0,
                                             height)
                    got_r, gr_got = reg_grads(regularizer_pack_rows, fbh, ffh, imh, wf, row0,
                                              height, cot)
                    sync()
                    launched = c.counts()
                    if launched != c.want({**zero, "photometric_fwd_hpad": 1,
                                           "photometric_bwd_hpad": 1,
                                           "regularizer_fwd_hpad": 1,
                                           "regularizer_bwd_hpad": 1}):
                        raise AssertionError(f"hpad loss kernels {where}: launches {launched}")
                    if got["weights"].dtype != dtype or \
                            got["weights"].shape != (2 * batch_n, 1, hs, imh.shape[3]):
                        raise AssertionError(f"photometric hpad {where}: weights "
                                             f"{got['weights'].dtype} "
                                             f"{tuple(got['weights'].shape)}")
                    if any(g.shape != fbh.shape for g in (*g_got, *gr_got)):
                        raise AssertionError(f"hpad {where}: d(flow) not the slab's shape")
                    args = (il, ir, fbh, ffh, imh)
                    if dtype == torch.bfloat16:
                        # values against the bfloat16 plain versions (their d(flow)
                        # takes sign(0) wherever the warped value rounds to the
                        # image's: phase 5's rule holds it to the widened images only)
                        want, _ = photo_grads(photometric_pack_rows_reference, *args, row0,
                                              height)
                        want_r, _ = reg_grads(regularizer_pack_rows_reference, fbh, ffh,
                                              imh, wf, row0, height, cot)
                        for k in photo_keys:
                            torch.testing.assert_close(got[k], want[k], rtol=2e-2, atol=2e-2)
                        for k in reg_keys:
                            torch.testing.assert_close(got_r[k], want_r[k], rtol=2e-2, atol=2e-2)
                        wdiff = float((got["weights"].float() - want["weights"].float()).abs()
                                      .mean())
                        if wdiff > 2e-2:
                            raise AssertionError(f"photometric hpad {where} against the "
                                                 f"bfloat16 plain version: weights {wdiff}")
                    if dtype == torch.bfloat16 and not on_card:
                        continue  # a rehearsal's "kernels" are the bfloat16 plain versions
                    # float32 (bfloat16: the kernels compute in float32 and never
                    # round, so the plain versions on the widened images)
                    a32 = [t.float() for t in args]
                    want, g_want = photo_grads(photometric_pack_rows_reference, *a32, row0,
                                               height)
                    want_r, gr_want = reg_grads(regularizer_pack_rows_reference, fbh, ffh,
                                                imh.float(), wf.float(), row0, height, cot)
                    for k in photo_keys:
                        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4)
                    for k in reg_keys:
                        torch.testing.assert_close(got_r[k], want_r[k], rtol=1e-4, atol=1e-4)
                    torch.testing.assert_close(
                        got["weights"].float(), want["weights"],
                        rtol=1e-5 if dtype == torch.float32 else 2**-8, atol=1e-5)
                    ties = l1_ties(*a32, row0)
                    n_ties += sum(int(t.sum()) for t in ties)
                    e_p, m_p = dflow_err(g_got, g_want, ties)
                    e_r, m_r = dflow_err(gr_got, gr_want)
                    zeros = sum(int(((a == 0) != (b == 0)).sum()) for a, b in zip(gr_got, gr_want))
                    gtol = 1e-4 if dtype == torch.float32 else 2e-2
                    if e_p > gtol * m_p or e_r > gtol * m_r or zeros:
                        raise AssertionError(f"hpad {where}: d(flow) {e_p} (max {m_p}), {e_r} "
                                             f"(max {m_r}), {zeros} positions zero in one "
                                             "regularizer gradient only")
                    f_p = max(float((got[k] - want[k]).abs().max()) for k in photo_keys)
                    f_r = max(float((got_r[k] - want_r[k]).abs().max()) for k in reg_keys)
                    for kname, err in (("photometric_fwd_hpad", f_p), ("photometric_bwd_hpad", e_p),
                                       ("regularizer_fwd_hpad", f_r),
                                       ("regularizer_bwd_hpad", e_r)):
                        c.max_err[kname] = max(c.max_err[kname], err)
                    worst["photo"] = [max(worst["photo"][0], f_p), max(worst["photo"][1],
                                                                       e_p / m_p)]
                    worst["reg"] = [max(worst["reg"][0], f_r), max(worst["reg"][1], e_r / m_r)]
                    if not (on_card and n == 2):
                        continue
                    # timed at n = 2 (the record: a float32 sharded step, 3 scales x 2
                    # shards; bfloat16 printed beside it); bytes: each input read
                    # once (of the whole sources, the rows this run's warps reach),
                    # each output written once
                    isz = im.element_size()
                    gdw = torch.rand(2 * batch_n, generator=gen, device=device)
                    gcl = torch.rand(2 * batch_n, generator=gen, device=device)
                    hh, ww = imh.shape[2], imh.shape[3]
                    ys = torch.arange(row0 - 1, row0 - 1 + hh, device=device)[None, :, None]
                    reach = [(ys + f[:, 1]).floor() for f in (fbh, ffh)]
                    lo = max(0, int(min(float(r_.min()) for r_ in reach)))
                    hi = min(height, int(max(float(r_.max()) for r_ in reach)) + 2)
                    src = 2 * batch_n * 3 * max(hi - lo, 0) * ww * isz
                    pos = batch_n * hh * ww
                    slab_in = batch_n * (3 * isz + 2 * 2 * 4) * hh * ww
                    works = {"photometric_fwd_hpad": (src + slab_in + 2 * batch_n * hs * ww * isz,
                                                      OPS_PER_POSITION["photometric_fwd"] * pos),
                             "photometric_bwd_hpad": (src + slab_in + 2 * batch_n * 2 * hh * ww * 4,
                                                      OPS_PER_POSITION["photometric_bwd"] * pos),
                             "regularizer_fwd_hpad": (slab_in + batch_n * hs * ww * isz,
                                                      OPS_PER_POSITION["regularizer_fwd"] * pos),
                             "regularizer_bwd_hpad": (slab_in + batch_n * hs * ww * isz
                                                      + 2 * batch_n * 2 * hh * ww * 4,
                                                      OPS_PER_POSITION["regularizer_bwd"] * pos)}
                    pcall = (il, ir, fbh, ffh, imh, row0, height)
                    rcall = (fbh, ffh, imh, wf, row0, height)
                    fbg, ffg = (t.clone().requires_grad_(True) for t in (fbh, ffh))
                    ploss = photometric_pack_rows_reference(il, ir, fbg, ffg, imh, row0, height)
                    ploss = (ploss["s_dw"].sum() + ploss["s_cl"].sum())
                    rout = regularizer_pack_rows_reference(fbg, ffg, imh, wf, row0, height)
                    rloss = sum(v.sum() for v in rout.values())
                    with torch.no_grad():
                        timed = {
                            "photometric_fwd_hpad": (
                                _time_ms(torch, lambda: photometric_cuda.photo_fwd_hpad(*pcall)),
                                _time_ms(torch, lambda: photometric_pack_rows_reference(*pcall),
                                         reps=5, inner=2)),
                            "regularizer_fwd_hpad": (
                                _time_ms(torch, lambda: regularizer_cuda.reg_fwd_hpad(*rcall)),
                                _time_ms(torch, lambda: regularizer_pack_rows_reference(*rcall),
                                         reps=5, inner=2))}
                    timed["photometric_bwd_hpad"] = (
                        _time_ms(torch, lambda: photometric_cuda.photo_bwd_hpad(*pcall, gdw, gcl)),
                        _time_ms(torch, lambda: torch.autograd.grad(ploss, [fbg, ffg],
                                                                     retain_graph=True),
                                 reps=5, inner=2))
                    timed["regularizer_bwd_hpad"] = (
                        _time_ms(torch, lambda: regularizer_cuda.reg_bwd_hpad(
                            *rcall, cot["s_sx"], cot["s_sy"], cot["s_consis"])),
                        _time_ms(torch, lambda: torch.autograd.grad(rloss, [fbg, ffg],
                                                                     retain_graph=True),
                                 reps=5, inner=2))
                    for kname, (k_ms, p_ms) in timed.items():
                        if dtype == torch.float32:
                            c.ms[kname] += k_ms
                            c.plain_ms[kname] += p_ms
                            c.work[kname][0] += works[kname][0]
                            c.work[kname][1] += works[kname][1]
                        else:
                            acc = bf16_hpad.setdefault(kname, [0.0, 0.0, 0.0, 0.0])
                            for j, v in enumerate((k_ms, p_ms, *works[kname])):
                                acc[j] += v
                        key = f"{kname} s{s} {dt}"
                        kernel_ms[key] = round(kernel_ms.get(key, 0.0) + k_ms, 4)
                    del ploss, rloss, rout, fbg, ffg
            print(f"spatial training (a) s{s} {(batch_n, 3, height, im.shape[3])} {dt}: the hpad "
                  f"loss kernels on every shard of n = {SPATIAL_N}, 1 + 1 launches each; "
                  f"photometric sums max_abs_err={worst['photo'][0]:.3e} d(flow) "
                  f"{worst['photo'][1]:.3e} of its max ({n_ties} L1 ties left out); "
                  f"regularizer sums "
                  f"max_abs_err={worst['reg'][0]:.3e} d(flow) {worst['reg'][1]:.3e} of its max "
                  "(float32 references; bfloat16 values also against the bfloat16 plain "
                  "versions)")
    if on_card:
        print("spatial training (a): hpad kernel ms summed over the 2 shards of n = 2 "
              f"(CUDA events; {c.smi}): " + json.dumps(kernel_ms))
        for kname, (k_ms, p_ms, nbytes, ops) in bf16_hpad.items():
            bound_ms, bound_by = _bound(nbytes, ops)
            print(f"spatial training (a) {kname} per sharded step at n = 2 (3 scales x 2 "
                  f"shards, bfloat16 images): kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by}) ({c.smi})")

    # (b), (c) the sharded pack and gradient against the unsharded forward
    weights = loss_weights_from_config(train_cli.recipe_config())
    data = SyntheticSnippets(c.img_hw, batch_n, seed=SEED + 21)
    x = torch.from_numpy(np.stack([data[i] for i in range(batch_n)])).to(device).float() / 255.0

    def nudged(dtype, images=x):
        """The snippets one ulp of the compute dtype up: the model casts them
        to it, so in bfloat16 every value moves by one bfloat16 ulp (one
        float32 ulp would round away)."""
        xd = images.to(getattr(torch, dtype))
        return torch.nextafter(xd, torch.full_like(xd, 2.0)).float()

    def fresh(cfg):
        return FlowModel(cfg, device=device, scheme="pwc",
                         generator=torch.Generator().manual_seed(SEED + 21))

    def meshed(n):
        return spatial_mesh(n, devices=c.shard_devices(n))

    def total(pack, wts=weights):
        return sum(wts[k] * v.mean() for k, v in pack.items())

    def step(model, fn, *args, wts=weights):
        """(pack, the photometric losses' gradient, the weighted total's
        gradient), each flat over every parameter."""
        params = list(model.parameters())
        pack = fn(*args)

        def flat(loss, **kw):
            return torch.cat([g.double().ravel() for g in torch.autograd.grad(loss, params, **kw)])

        g_photo = flat(total(pack, {k: PHOTO_W.get(k, 0.0) for k in pack}), retain_graph=True)
        return (torch.stack([v.detach().double() for v in pack.values()]), g_photo,
                flat(total(pack, wts)))

    def timed_fb(model, fn, *args, wts=weights):
        """(ms per forward + backward of the weighted total, median of
        SPATIAL_TIMED after 1, CUDA events; the peak GiB above what was
        allocated before)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        step(model, fn, *args, wts=wts)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(SPATIAL_TIMED + 1)]
        events[0].record()
        for j in range(SPATIAL_TIMED):
            model.zero_grad(set_to_none=True)
            total(fn(*args), wts).backward()
            events[j + 1].record()
        torch.cuda.synchronize()
        ms_n = statistics.median(events[j].elapsed_time(events[j + 1])
                                 for j in range(SPATIAL_TIMED))
        return ms_n, (torch.cuda.max_memory_allocated(device) - base) / 2**30

    def sharded_launches(n, reg):
        return c.want({**zero, "photometric_fwd_hpad": 3 * n, "photometric_bwd_hpad": 3 * n,
                       "regularizer_fwd_hpad": 3 * n if reg else 0,
                       "regularizer_bwd_hpad": 3 * n if reg else 0,
                       "corr_fwd_hpad": 5 * n, "corr_bwd_df1_hpad": 5 * n,
                       "corr_bwd_df2_hpad": 5 * n})

    # phase 7's rule: a sharded step against the unsharded one, within 3 x the
    # unsharded step's own distance on snippets moved by one ulp (of the
    # compute dtype), floor 1e-4, or 3 x its distance from another run of
    # itself where that is larger (the warps' scatter-adds make two runs
    # differ, and Adam's steps carry it on: phase 18 (a) prints both, phase
    # 20 holds to the second); the photometric losses' gradient is held
    # beside the weighted total's, as phase 7 holds it
    def bounds(dense, *others):
        """(reference, bound) for each of the compared vectors: ``others``
        are the unsharded runs on moved snippets and again."""
        return [(d, max(1e-4, *(3 * _rel_l2(o, d) for o in rest)))
                for d, *rest in zip(dense, *others)]

    def held(dtype, label, got, refs):
        errs = [_rel_l2(g, r) for g, (r, _) in zip(got, refs)]
        print(f"spatial training {label} {dtype}: rel L2 from the unsharded step "
              + ", ".join(f"{e:.3e} (bound {b:.3e})" for e, (_, b) in zip(errs, refs)))
        if not all(e <= b for e, (_, b) in zip(errs, refs)):
            raise AssertionError(f"spatial training {label} {dtype}: the sharded step departs "
                                 "from the unsharded one")

    record_launches = {}
    # a rehearsal runs float32 only: this PyTorch's CPU bfloat16 convolutions
    # give other values from one run to the next, and NaN with several threads
    dtypes = ("float32", "bfloat16") if on_card else ("float32",)
    for dtype in dtypes:
        for reg in (False, True):
            cfg = FlowModelConfig(compute_dtype=dtype, loss_dtype=dtype, use_pallas_reg=reg)
            model = fresh(cfg)
            dense = lambda im: forward(model, cfg, im)  # noqa: E731
            d_step = step(model, dense, x)
            u_step = step(model, dense, nudged(dtype))
            a_step = step(model, dense, x)
            refs = bounds(d_step, u_step, a_step)
            for n in SPATIAL_N:
                fn = make_spatial_forward(model, cfg, meshed(n))
                # (b) one forward and backward, as a training step runs them
                c.reset_counts()
                total(fn(x)).backward()
                sync()
                launched = c.counts()
                sp = step(model, fn, x)
                if dtype == "float32" and reg and n == 2:
                    record_launches = launched
                print(f"spatial training (b) {dtype} use_pallas_reg={reg} n={n}: launches "
                      f"{_launched(launched)}; against the unsharded {dtype} step, rel L2 of "
                      "the pack, the photometric and the weighted total's gradients: "
                      + ", ".join(f"{_rel_l2(a, b):.3e}" for a, b in zip(sp, d_step))
                      + "; the unsharded step on snippets one ulp away: "
                      + ", ".join(f"{_rel_l2(a, b):.3e}" for a, b in zip(u_step, d_step))
                      + "; again: " + ", ".join(f"{_rel_l2(a, b):.3e}"
                                                for a, b in zip(a_step, d_step)))
                if launched != sharded_launches(n, reg):
                    raise AssertionError(f"spatial training {dtype} reg={reg} n={n}: launches "
                                         f"{launched}, want {sharded_launches(n, reg)}")
                held(dtype, f"(c) use_pallas_reg={reg} n={n} pack, gradients", sp, refs)
            del model, d_step, u_step, a_step, refs, sp
            if on_card:
                torch.cuda.empty_cache()

    # (d) four Adam steps on the sharded gradients against four unsharded ones,
    # the parameters' change held after each step.  In bfloat16 the yardstick
    # stays near 0.3 from the first step on (Adam's first update is lr *
    # sign(g), and a one-ulp nudge flips the sign of many small gradients), so
    # there (c)'s gradients carry the check, and (d) adds what a run that
    # skips an update would fail: every parameter tensor's change at least
    # half as long as the unsharded one's, after every step
    steps_n = 4
    for dtype in dtypes:
        cfg = FlowModelConfig(compute_dtype=dtype, loss_dtype=dtype)

        def run(images, n, cudnn=True):
            """(the losses, the parameters' change after each of steps_n Adam
            steps); ``cudnn=False``: PyTorch's own convolutions in place of
            cuDNN's."""
            model = fresh(cfg)
            opt = make_optimizer(model)
            fn = (make_spatial_forward(model, cfg, meshed(n)) if n
                  else (lambda im: forward(model, cfg, im)))
            start = [p.detach().clone() for p in model.parameters()]
            losses, changes = [], []
            b = torch.backends.cudnn
            with b.flags(enabled=cudnn, benchmark=b.benchmark, deterministic=b.deterministic,
                         allow_tf32=b.allow_tf32):
                for _ in range(steps_n):
                    opt.zero_grad(set_to_none=True)
                    loss = total(fn(images))
                    loss.backward()
                    opt.step()
                    losses.append(loss.detach().double())
                    changes.append(torch.cat([(p.detach() - p0).double().ravel()
                                              for p, p0 in zip(model.parameters(), start)]))
            return torch.stack(losses), *changes

        d_run = run(x, 0)
        # the yardstick also takes the unsharded run on another convolution
        # algorithm: cuDNN picks a slab's algorithms apart from the frame's
        # (and by the process's history, PERF.md q15), and 3 Adam updates
        # carry that rounding into the losses
        t_d = time.perf_counter()
        native = run(x, 0, cudnn=False)
        t_native = time.perf_counter() - t_d
        refs = bounds(d_run, run(nudged(dtype), 0), run(x, 0), native)
        sp = run(x, 2)
        print(f"spatial training (d) {dtype}: {steps_n} Adam steps at n=2, losses "
              + json.dumps([round(float(v), 6) for v in sp[0]]) + ", unsharded "
              + json.dumps([round(float(v), 6) for v in d_run[0]]) + ", unsharded without "
              f"cuDNN {json.dumps([round(float(v), 6) for v in native[0]])} ({t_native:.1f} s)")
        held(dtype, f"(d) {steps_n} Adam steps' losses, parameters' change after each step",
             sp, refs)
        names, sizes = zip(*((k, p.numel()) for k, p in fresh(cfg).named_parameters()))
        shortest = []  # after each step: (the least length ratio over the tensors, its name)
        for a, (r, _) in zip(sp[1:], refs[1:]):
            ratios = [(float(ta.norm() / tr.norm()), nm)
                      for ta, tr, nm in zip(a.split(sizes), r.split(sizes), names)
                      if float(tr.norm()) > 0]
            shortest.append(min(ratios))
        print(f"spatial training (d) {dtype}: each step's shortest sharded parameter change "
              "over the unsharded one's (at least 0.5): "
              + ", ".join(f"{v:.4f} ({nm})" for v, nm in shortest)
              + "; the whole change's: "
              + ", ".join(f"{float(a.norm() / r.norm()):.4f}"
                          for a, (r, _) in zip(sp[1:], refs[1:])))
        if not all(v > 0.5 for v, _ in shortest):
            raise AssertionError(f"spatial training (d) {dtype}: a sharded parameter moved less "
                                 "than half as far as the unsharded one")

    # (e) ms per forward + backward by n, and peak memory
    if on_card:
        for dtype in ("float32", "bfloat16"):
            cfg = FlowModelConfig(compute_dtype=dtype, loss_dtype=dtype)
            model = fresh(cfg)
            line = {}
            for n in (0, 1, *SPATIAL_N):
                fn = (make_spatial_forward(model, cfg, meshed(n)) if n
                      else (lambda im: forward(model, cfg, im)))
                ms_n, peak = timed_fb(model, fn, x)
                line["unsharded" if n == 0 else f"n={n}"] = f"{ms_n:.3f} ms, {peak:.3f} GiB"
            print(f"spatial training (e) {dtype}, use_pallas_reg off, batch {batch_n} at "
                  f"{h}x{w}: ms per forward + backward (median of {SPATIAL_TIMED} after 1, CUDA "
                  f"events) and peak GiB: {json.dumps(line)} ({c.smi})")
            del model
            torch.cuda.empty_cache()
    # (f) one mesh over two devices, also where there is one card: shard 0 on
    # the CPU, shard 1 on the card, so the halos, the shards' sums (on the
    # CPU, the first shard's device) and every weight's gradient (read on
    # both, held on the card) cross between devices; float32, use_pallas_reg,
    # at a small frame (the CPU shard runs the plain versions)
    if on_card:
        hw_f, b_f = (128, 256), 2
        small = SyntheticSnippets(hw_f, b_f, seed=SEED + 22)
        x_f = torch.from_numpy(np.stack([small[i] for i in range(b_f)])).to(device).float() / 255
        cfg = FlowModelConfig(use_pallas_reg=True)
        model = fresh(cfg)
        dense = lambda im: forward(model, cfg, im)  # noqa: E731
        refs = bounds(step(model, dense, x_f), step(model, dense, nudged("float32", x_f)),
                      step(model, dense, x_f))
        fn = make_spatial_forward(model, cfg, spatial_mesh(2, devices=["cpu", device]))
        c.reset_counts()
        pack = fn(x_f)
        total(pack).backward()
        sync()
        launched = c.counts()
        want_f = c.want({**zero, "photometric_fwd_hpad": 3, "photometric_bwd_hpad": 3,
                         "regularizer_fwd_hpad": 3, "regularizer_bwd_hpad": 3,
                         "corr_fwd_hpad": 5, "corr_bwd_df1_hpad": 5, "corr_bwd_df2_hpad": 5})
        pack_on = sorted({str(v.device) for v in pack.values()})
        grads_on = sorted({str(p.grad.device) for p in model.parameters()})
        print(f"spatial training (f) float32 use_pallas_reg=True, shards on ['cpu', "
              f"'{device}'] at batch {b_f}, {hw_f}: launches {_launched(launched)} (the card's "
              f"shard); pack on {pack_on}, gradients on {grads_on}")
        if launched != want_f or pack_on != ["cpu"] or any(
                p.grad.device != p.device for p in model.parameters()):
            raise AssertionError(f"spatial training (f): launches {launched} (want {want_f}), "
                                 f"pack on {pack_on}, gradients on {grads_on}")
        sp = step(model, fn, x_f)
        held("float32", "(f) shards on the CPU and the card, pack, gradients",
             [v.to(device) for v in sp], refs)
        del model, pack, refs, sp
        torch.cuda.empty_cache()

    # (g)-(i): the sharded forms beyond the 3-frame flow forward, each against
    # its unsharded form on the same weights: launches of one forward +
    # backward (5n of each hpad correlation kernel, 3n of the hpad photometric
    # pair and 3n of the regularizer pair where the form takes them, none of a
    # whole-map kernel), the pack and both gradients under (c)'s rule with
    # (d)'s yardstick of an unsharded run on PyTorch's own convolutions (the
    # epipolar loss's gradient follows the convolutions' rounding: at n = 1,
    # 192x256, the weighted total's sat 3.4e-4 from the unsharded one's, where
    # a one-ulp move of the pairs and a rerun stayed under the 1e-4 floor's
    # third), and on the card ms
    # per forward + backward beside the unsharded form's (e's timing) and
    # peak GiB
    fp_weights = loss_weights_from_config(types.SimpleNamespace(mode="flowposenet"))
    pose_data = pose_snippets(c.img_hw, batch_n, SEED + 21)
    x_fp = torch.from_numpy(pose_data.snippets[:batch_n].astype(np.float32) / 255.0).to(device)
    ks_fp = [torch.from_numpy(np.stack([pose_data.ks[i][j] for i in range(batch_n)])).to(device)
             for j in range(2)]
    pairs = pair_snippets(c.pair_hw, c.pair_frame_hw, batch_n, SEED + 28)
    x_pair = torch.from_numpy(np.stack([pairs[i][0] for i in range(batch_n)])).to(device)
    ks_pair = [torch.from_numpy(np.repeat(a[:1], batch_n, 0)).to(device)
               for a in (pairs.k, pairs.k_inv)]

    def form_case(label, cls, cfg, frames, dense_fn, args, ns, loss_kernels, wts):
        model = cls(cfg, device=device, scheme="pwc",
                    generator=torch.Generator().manual_seed(SEED + 21))
        dense = lambda *a: dense_fn(model, cfg, *a)  # noqa: E731
        dtype = cfg.compute_dtype
        b = torch.backends.cudnn
        with b.flags(enabled=False, benchmark=b.benchmark, deterministic=b.deterministic,
                     allow_tf32=b.allow_tf32):
            native = step(model, dense, *args, wts=wts)
        refs = bounds(step(model, dense, *args, wts=wts),
                      step(model, dense, nudged(dtype, args[0]), *args[1:], wts=wts),
                      step(model, dense, *args, wts=wts), native)
        line = {}
        if on_card:
            ms_n, peak = timed_fb(model, dense, *args, wts=wts)
            line["unsharded"] = f"{ms_n:.3f} ms, {peak:.3f} GiB"
        for n in ns:
            fn = make_spatial_forward(model, cfg, meshed(n), frames=frames)
            c.reset_counts()
            total(fn(*args), wts).backward()
            sync()
            launched = c.counts()
            want_n = c.want({**zero, "corr_fwd_hpad": 5 * n, "corr_bwd_df1_hpad": 5 * n,
                             "corr_bwd_df2_hpad": 5 * n,
                             **{f"{kind}_{way}_hpad": 3 * n for kind in loss_kernels
                                for way in ("fwd", "bwd")}})
            print(f"spatial training {label} {dtype} n={n}: launches {_launched(launched)} "
                  f"(want {_launched(want_n)})")
            if launched != want_n:
                raise AssertionError(f"spatial training {label} {dtype} n={n}: launches "
                                     f"{launched}, want {want_n}")
            held(dtype, f"{label} n={n} pack, gradients", step(model, fn, *args, wts=wts), refs)
            if on_card:
                ms_n, peak = timed_fb(model, fn, *args, wts=wts)
                line[f"n={n}"] = f"{ms_n:.3f} ms, {peak:.3f} GiB"
        if on_card:
            print(f"spatial training {label} {dtype}, batch {batch_n} at "
                  f"{tuple(args[0].shape[1:3])} stacked: ms per forward + backward (median of "
                  f"{SPATIAL_TIMED} after 1, CUDA events) and peak GiB: {json.dumps(line)} "
                  f"({c.smi})")
            torch.cuda.empty_cache()

    for dtype in dtypes:
        cfg_d = dict(compute_dtype=dtype, loss_dtype=dtype)
        # (g) flowposenet, 3 frames, with use_pallas_reg: every hpad kernel
        form_case("(g) flowposenet use_pallas_reg=True", FlowPoseModel,
                  FlowModelConfig(use_pallas_reg=True, **cfg_d), 3, forward_flowpose,
                  (x_fp, *ks_fp), (1, *SPATIAL_N), ("photometric", "regularizer"), fp_weights)
        # (h) the 2-frame forms: the correlation kernels only, as unsharded
        form_case("(h) forward_pair", FlowModel, FlowModelConfig(**cfg_d), 2, forward_pair,
                  (x_pair,), (1, 3), (), weights)
        form_case("(h) forward_flowpose_pair", FlowPoseModel, FlowModelConfig(**cfg_d), 2,
                  forward_flowpose_pair, (x_pair, *ks_pair), (1, 3), (), fp_weights)
        # (i) the occlusion ablation: the plain loss sums, as unsharded
        form_case("(i) use_occlusion_weights=False", FlowModel,
                  FlowModelConfig(use_occlusion_weights=False, **cfg_d), 3, forward, (x,),
                  (1, *SPATIAL_N), (), weights)

    print(f"spatial training: phase 21 in {time.perf_counter() - t21:.1f} s")
    return record_launches


def bf16_gap(c) -> None:
    """Phase 22 (see the module): ``c`` holds the device, the recipe's size
    and batch, K and q14's steps, the launch counters (``want`` maps an
    expected count to what this device launches), ``sync``, ``empty_cache``
    and the card's nvidia-smi line."""
    import numpy as np
    import torch

    from unopticalflow_tpu_torch import train as train_cli
    from unopticalflow_tpu_torch.benchmarks import bf16_gap as gap
    from unopticalflow_tpu_torch.data.synthetic import SyntheticSnippets
    from unopticalflow_tpu_torch.models import FlowModel, FlowModelConfig
    from unopticalflow_tpu_torch.ops.cost_volume import cost_volume_reference
    from unopticalflow_tpu_torch.ops.photometric import photometric_pack_reference
    from unopticalflow_tpu_torch.training import loss_weights_from_config

    t22 = time.perf_counter()
    (h, w), batch_n = c.img_hw, c.batch
    plain = dict(corr_fn=cost_volume_reference, photo_fn=photometric_pack_reference)
    # one forward and two gradients a dtype, in float32 and in bfloat16
    want = c.want({**dict.fromkeys(KERNELS, 0), "corr_fwd": 10, "corr_bwd_df1": 20,
                   "corr_bwd_df2": 20, "photometric_fwd": 6, "photometric_bwd": 12})
    data = SyntheticSnippets(c.img_hw, batch_n, seed=SEED + 21)
    cases = {
        "seeded noise frames, batch 1": (SEED + 22, gap.snippets(1, h, w, seed=SEED)),
        f"synthetic snippets, batch {batch_n}": (
            SEED + 21, np.stack([data[i] for i in range(batch_n)]).astype(np.float32) / 255.0),
    }
    for label, (seed, x) in cases.items():
        init = FlowModel(device="cpu", scheme="pwc", generator=torch.Generator().manual_seed(seed))
        state = {k: v.numpy() for k, v in init.state_dict().items()}
        c.reset_counts()
        kern = gap.port_steps(state, x, c.device)
        c.sync()
        launched = c.counts()
        ref = gap.port_steps(state, x, c.device, **plain)
        c.empty_cache()
        g_k, g_p = gap.gaps(kern), gap.gaps(ref)
        apart = {name: [gap.rel_l2(kern[dt][1][name], ref[dt][1][name]) for dt in gap.DTYPES]
                 for name in gap.WEIGHT_SETS}
        packs = {dt: {k: round(float(v.mean()), 6) for k, v in kern[dt][0].items()}
                 for dt in gap.DTYPES}
        print(f"bf16 gap ({label}, {h}x{w}, pwc init; {c.smi}): rel L2 of the bfloat16 step's "
              f"gradient from the float32 step's, kernels / plain versions: "
              + "; ".join(f"{name} {g_k[name]['gap_port']:.4f} / {g_p[name]['gap_port']:.4f} "
                          f"(kernels vs plain, float32 {apart[name][0]:.3e}, bfloat16 "
                          f"{apart[name][1]:.3e})" for name in gap.WEIGHT_SETS)
              + f"; packs (batch means) {json.dumps(packs)}; launches {_launched(launched)}")
        if launched != want:
            raise AssertionError(f"bf16 gap {label}: launches {launched}, want {want}")
        for name in gap.WEIGHT_SETS:
            if not all(np.isfinite(kern[dt][1][name]).all() for dt in gap.DTYPES):
                raise AssertionError(f"bf16 gap {label}: a {name} gradient is not finite")
            if g_k[name]["gap_port"] > 2 * g_p[name]["gap_port"] + 1e-3:
                raise AssertionError(f"bf16 gap {label} {name}: the kernels' gap "
                                     f"{g_k[name]['gap_port']} exceeds 2 x the plain versions' "
                                     f"{g_p[name]['gap_port']} + 1e-3")
        del kern, ref
    # q14 once more: bfloat16 convolutions, the loss stack in float32
    k = c.k
    weights = loss_weights_from_config(train_cli.recipe_config())
    data = SyntheticSnippets(c.img_hw, k * batch_n, seed=SEED + 18)
    xs = torch.from_numpy(np.stack([data[i] for i in range(k * batch_n)])).to(c.device)
    xs = xs.reshape(k, batch_n, 3 * h, w, 3)
    cfg = FlowModelConfig(compute_dtype="bfloat16", loss_dtype="float32")
    losses = q14_runs(c, cfg, weights, xs, 1, c.q14_steps, kinds=("eager",))["eager"][0]
    rose, means = _rose(losses, k)
    print(f"bf16 gap: q14 with loss_dtype float32 (bfloat16 convolutions), {c.q14_steps} eager "
          f"steps on {k} repeated batches at {h}x{w}, batch {batch_n}: means of {k}-step blocks "
          f"{json.dumps([round(m, 4) for m in means])}; {'rose' if rose else 'did not rise'} "
          f"(a block above {Q14_RISE} x the lowest before it); phase 22 in "
          f"{time.perf_counter() - t22:.1f} s")
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError("q14 float32 loss stack: a loss is not finite")


def bench_module(c) -> None:
    """Phase 23 (see the module): ``c`` holds the device, the recipe's size
    and batch, K, the bench's ``--iters``, the directory of the processes'
    output and the validate report, the launch counters (``want`` maps an
    expected count to what this device launches), ``sync``, ``empty_cache``,
    the module's device flags ``cli``, phase 18's graph ms/step by dtype
    (``graph_ms``, None when not measured) and the card's nvidia-smi line.

    On an H100 machine a process spends ~11 s importing torch and ~11 s in
    its first training setup (PERF.md q20), before its first step: one after
    the other the five would take ~110 s longer than together.  So they start together; (f)'s bfloat16 and infer
    runs go while the five import torch, before any of them touches the
    card, and (f)'s float32 run after the five are done (two float32 K = 8
    graphs at once, with cuDNN's workspaces, do not fit beside this
    process's own memory).  The five processes' rates are printed as read
    on a shared card."""
    import gc

    import torch

    from unopticalflow_tpu_torch import bench

    t23 = time.perf_counter()
    (h, w), batch_n, k = c.img_hw, c.batch, c.k
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    os.makedirs(c.root, exist_ok=True)
    report_path = os.path.join(c.root, "validate.json")
    shape = ["--batch", str(batch_n), "--hw", str(h), str(w), "--iters", str(c.iters)]
    runs = {"(a) bfloat16": [*shape, "--scan-steps", str(k)],
            "(b) --scan-steps 0": [*shape, "--scan-steps", "0"],
            "(c) --fp32": [*shape, "--scan-steps", str(k), "--fp32"],
            "(d) --infer": [*shape, "--infer"],
            "(e) --validate": ["--validate", "--validate-out", report_path]}

    def in_process(label, fn, want):
        """One of (f)'s runs with the launch counters: its result and launches."""
        c.reset_counts()
        res = fn()
        c.sync()
        launched = c.counts()
        if launched != c.want(want(res)):
            raise AssertionError(f"bench (f) {label}: launches {launched}, want "
                                 f"{c.want(want(res))}")
        gc.collect()
        c.empty_cache()
        return res, launched

    per_k = {n: 2 * k * v for n, v in PER_STEP.items()}
    inproc = {}

    def train(precision):
        """(f) ``bench_train`` at K = 8 with the launch counters."""
        res, launched = in_process(precision, lambda: bench.bench_train(
            batch_n, c.img_hw, c.iters, precision, k, c.device), lambda _: per_k)
        inproc[precision] = res["value"]
        print(f"bench (f) {precision}: bench_train at K = {k}, {res['value']:.2f} snippets/s "
              f"(median {res['median_step_ms']:.3f} ms/step), {res['dispatches']} dispatches, "
              f"launches {_launched(launched)}: the eager dispatch and the capture, {k} x "
              f"{_launched(PER_STEP)} each, as phase 18 (c); loss {res['loss']:.6f}")
        if not math.isfinite(res["loss"]):
            raise AssertionError(f"bench (f) {precision}: loss {res['loss']}")

    # (a)-(e) as a user runs them, one process each, started together
    procs = {}
    try:
        for label, args in runs.items():
            name = os.path.join(c.root, label[1])
            with open(name + ".out", "w") as out, open(name + ".err", "w") as err:
                procs[label] = subprocess.Popen(
                    [sys.executable, "-m", "unopticalflow_tpu_torch.bench", *args, *c.cli],
                    stdout=out, stderr=err, cwd=repo, env=env)
        # (f) bfloat16 and infer while the five import torch
        t_f = time.perf_counter()
        train("bfloat16")
        res, launched = in_process("--infer", lambda: bench.bench_infer(
            batch_n, c.img_hw, c.iters, "bfloat16", c.device),
            lambda r: {**dict.fromkeys(KERNELS, 0), "corr_fwd": 5 * r["dispatches"]})
        print(f"bench (f) --infer: bench_infer {res['value']:.2f} pairs/s, {res['dispatches']} "
              f"batches, launches {_launched(launched)} (5 corr_fwd a batch), the last flow "
              f"{'finite' if res['flow_ok'] else 'NOT finite'}; (f)'s bfloat16 and infer runs "
              f"took {time.perf_counter() - t_f:.1f} s from the five processes' start")
        if not res["flow_ok"]:
            raise AssertionError("bench (f) --infer: the last flow is not a finite "
                                 "(B, H, W, 2) float32 array")
        del res
        gc.collect()
        c.empty_cache()
        if c.device.type == "cuda":
            free, total = torch.cuda.mem_get_info(c.device)
            print(f"bench: beside the five processes this one holds "
                  f"{torch.cuda.memory_allocated(c.device) / 2**30:.2f} GiB allocated, "
                  f"{torch.cuda.memory_reserved(c.device) / 2**30:.2f} GiB reserved; the card "
                  f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free")
        deadline = time.perf_counter() + 600
        for proc in procs.values():
            proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    t_wave = time.perf_counter() - t_f
    # (f) float32 with the card to itself
    train("float32")
    took = time.perf_counter() - t23

    rates = {}
    for label, proc in procs.items():
        name = os.path.join(c.root, label[1])
        with open(name + ".out") as f:
            stdout = f.read()
        with open(name + ".err") as f:
            stderr = f.read()
        lines = stdout.splitlines()
        if label.startswith("(e)") and c.device.type != "cuda":
            # without the card both sides would be the plain version: it refuses
            if proc.returncode == 0 or lines or "CUDA" not in stderr:
                raise AssertionError(f"bench {label} off the card: rc {proc.returncode}, "
                                     f"stdout {stdout!r}\n{stderr[-2000:]}")
            print(f"bench {label}: refused off the card, rc {proc.returncode}: "
                  f"{stderr.strip().splitlines()[-1]}")
            continue
        if proc.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"bench {label}: rc {proc.returncode}, {len(lines)} stdout "
                                 f"lines:\n{stdout[-2000:]}\n{stderr[-3000:]}")
        line = json.loads(lines[0])
        if label.startswith("(e)"):
            with open(report_path) as f:
                report = json.load(f)
            errs = "; ".join(
                f"{name} " + ", ".join(f"{e:.3e}" for e in bench.check_errors(v))
                + f" (tol {v['tol']}, {'ok' if v['ok'] else 'FAILED'})"
                for name, v in report["checks"].items())
            print(f"bench {label}: {lines[0]}; {errs}; launches {report['launches']} on "
                  f"{report['device']} ({c.smi})")
            if list(line) != ["validate", "ok", "platform", "worst"] or line["ok"] is not True \
                    or report["launches"] != BENCH_VALIDATE_LAUNCHES \
                    or report["device"] != torch.cuda.get_device_name(c.device):
                raise AssertionError(f"bench {label}: {line}, launches {report['launches']} "
                                     f"(want {BENCH_VALIDATE_LAUNCHES}), {report['device']}")
            continue
        infer = label.startswith("(d)")
        value = line.get("value")
        # the JAX bench's line for this rate (vs_baseline from the unrounded rate)
        jax_line = bench.result_line(batch_n, c.img_hw, value or 0.0, infer,
                                     0 if label.startswith("(b)") else k)
        if list(line) != list(jax_line) \
                or not (isinstance(value, float) and math.isfinite(value) and value > 0) \
                or [line["metric"], line["unit"]] != [jax_line["metric"], jax_line["unit"]] \
                or abs(line["vs_baseline"] - jax_line["vs_baseline"]) > 0.011:
            raise AssertionError(f"bench {label}: {line}, want {jax_line}")
        rates[label] = value
        diag = json.loads(stderr.strip().splitlines()[-1])
        print(f"bench {label}: {lines[0]}; median {diag['median_step_ms']:.3f} ms a "
              f"{'batch' if infer else 'step'}, IQR {diag['window_iqr_ms']:.3f}, windows "
              f"{json.dumps([round(x, 3) for x in diag['windows']])} of "
              f"{diag['steps_per_window']} dispatches after {diag['warmup_dispatches']} warm-up "
              f"dispatches, setup {diag['setup_s']:.1f} s, on {diag['device']} shared by the "
              f"five ({c.smi})")
    graph = {dt: (f"{batch_n / c.graph_ms[dt] * 1e3:.2f}" if c.graph_ms else "not measured")
             for dt in ("bfloat16", "float32")}
    print(f"bench: K = {k} snippets/s in this process beside {batch_n} / phase 18 (d)'s graph "
          f"ms/step: bfloat16 {inproc['bfloat16']:.2f} and {graph['bfloat16']}, float32 "
          f"{inproc['float32']:.2f} and {graph['float32']} ({c.smi}); the processes on the "
          f"shared card (a) {rates['(a) bfloat16']:.2f}, (c) {rates['(c) --fp32']:.2f}; the "
          f"five processes {t_wave:.1f} s, phase 23 in {took:.1f} s")


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
                 if k.startswith(("photometric", "regularizer")) and not k.endswith("_hpad")}
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
    # an earlier run's trees (phase 15's prepared data) would skip what this
    # run must do, so every run starts from an empty one
    shutil.rmtree(model_dir, ignore_errors=True)
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

    # ---- 17. the host modules: JPEG, the NYU .mat, depth and mask evaluation --
    host_modules(types.SimpleNamespace(
        device=device, img_hw=IMG_HW, precision="bfloat16", batch=BATCH,
        root=os.path.join(model_dir, "host17"), counts=counts, reset_counts=reset_counts,
        want=lambda d: d, cli=[], smi=smi))
    torch.cuda.empty_cache()

    # ---- 18. K steps a dispatch: one CUDA graph of the whole step -----------
    graph_ms = dispatch_graph(types.SimpleNamespace(
        device=device, img_hw=IMG_HW, kitti_hw=KITTI_HW, batch=BATCH, k=DISPATCH_K,
        nyu_hw=NYU_HW, nyu_frame_hw=NYU_FRAME_HW, snippets=DISPATCH_SNIPPETS,
        loader_snippets=DISPATCH_LOADER_SNIPPETS, epe_iters=EPE_ITERS, epe_hw=EPE_HW,
        want=lambda d: d, sync=torch.cuda.synchronize, empty_cache=torch.cuda.empty_cache,
        root=os.path.join(model_dir, "dispatch18"), counts=counts, reset_counts=reset_counts,
        cli=[], smi=smi))
    torch.cuda.empty_cache()

    # ---- 19. the measuring and learning tools on the main path ----------------
    tools(types.SimpleNamespace(
        device=device, img_hw=IMG_HW, batch=BATCH, k=DISPATCH_K, epe_iters=TOOLS_EPE_ITERS,
        prep_snippets=PREP_SNIPPETS, prep_steps=PREP_STEPS, loader_snippets=LB_SNIPPETS,
        loader_batches=LB_BATCHES, device_rate=None, ps_iters=PS_ITERS, trials=PS_TRIALS,
        replays=TOOLS_REPLAYS, trace=True, q14_runs=Q14_RUNS, q14_steps=Q14_STEPS,
        want=lambda d: d, sync=torch.cuda.synchronize, empty_cache=torch.cuda.empty_cache,
        root=os.path.join(model_dir, "tools19"), counts=counts, reset_counts=reset_counts,
        smi=smi))
    torch.cuda.empty_cache()

    # ---- 20. data parallel: training over a process group, split serving --------
    smi_mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi_mode)
    data_parallel(types.SimpleNamespace(
        device=device, img_hw=IMG_HW, batch=BATCH, k=DP_K, dp_iters=DP_ITERS,
        dp_steps=DP_STEPS, eval_pairs=EVAL_PAIRS, compute_mode=smi_mode.split(",")[-1].strip(),
        want=lambda d: d, sync=torch.cuda.synchronize, empty_cache=torch.cuda.empty_cache,
        root=os.path.join(model_dir, "parallel20"), counts=counts, reset_counts=reset_counts,
        cli=[], smi=smi))
    torch.cuda.empty_cache()

    # ---- 21. spatial training: the loss stack and its gradients over row-shards --
    hpad_loss_counts = spatial_training(types.SimpleNamespace(
        device=device, img_hw=IMG_HW, batch=BATCH, pair_hw=NYU_HW, pair_frame_hw=NYU_FRAME_HW,
        shard_devices=shard_devices, counts=counts,
        reset_counts=reset_counts, want=lambda d: d, smi=smi, max_err=max_err, ms=ms,
        plain_ms=plain_ms, work=work))
    torch.cuda.empty_cache()

    # ---- 22. the bfloat16 step's gradient gap, kernels against plain -----------
    bf16_gap(types.SimpleNamespace(
        device=device, img_hw=IMG_HW, batch=BATCH, k=DISPATCH_K, q14_steps=Q14_STEPS,
        counts=counts, reset_counts=reset_counts, want=lambda d: d,
        sync=torch.cuda.synchronize, empty_cache=torch.cuda.empty_cache, smi=smi))
    torch.cuda.empty_cache()

    # ---- 23. the bench module as a user runs it, and its launches ----------------
    bench_module(types.SimpleNamespace(
        device=device, img_hw=IMG_HW, batch=BATCH, k=DISPATCH_K, iters=BENCH_ITERS,
        root=os.path.join(model_dir, "bench23"), counts=counts, reset_counts=reset_counts,
        want=lambda d: d, sync=torch.cuda.synchronize, empty_cache=torch.cuda.empty_cache,
        cli=[], graph_ms=graph_ms, smi=smi))
    torch.cuda.empty_cache()

    launches = {**train_counts, "regularizer_fwd": reg_counts["regularizer_fwd"],
                "regularizer_bwd": reg_counts["regularizer_bwd"],
                "corr_fwd_hpad": sp_serve_counts["corr_fwd_hpad"],
                "corr_bwd_df1_hpad": grad_counts["corr_bwd_df1_hpad"],
                "corr_bwd_df2_hpad": grad_counts["corr_bwd_df2_hpad"],
                "row_gather": probe_counts["row_gather"],
                "lane_gather": probe_counts["lane_gather"],
                "sublane_gather": probe_counts["sublane_gather"],
                **{k: hpad_loss_counts[k] for k in ("photometric_fwd_hpad", "photometric_bwd_hpad",
                                                    "regularizer_fwd_hpad",
                                                    "regularizer_bwd_hpad")}}
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
    print(f"chip_smoke: 23 phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
