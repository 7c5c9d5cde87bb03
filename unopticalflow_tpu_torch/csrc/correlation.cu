// Cost-volume (correlation) forward and backward for Hopper (sm_90a), NCHW.
//
//   out[b, k, y, x] = (1/C) * sum_c f1[b, c, y, x] * f2[b, c, y + dy - md, x + dx - md]
//   k = dy * (2md+1) + dx, dy-major; f2 reads outside the map are zero.
//
// Replaces the TPU kernels of unopticalflow_tpu/ops/pallas_kernels.py:
// _corr_fwd_kernel (driven by _corr_fwd_nchw), and for the backward
// _corr_df1_kernel and _corr_df2_kernel (driven by _corr_df1_nchw/_corr_df2_nchw).
// Inputs are contiguous NCHW float32 or bfloat16; outputs have the input dtype
// and every sum is accumulated in float32.
//
// What bounds the forward on the card: per output pixel 2*C*81 flops against C
// reads of f1, the f2 window and 81 writes.  The decoder's levels do 1.96 GFLOP
// per float32 training step against ~190 MB of traffic, so a kernel that feeds
// its FMAs from registers is bound by the float32 FMA rate and then by the 81
// output planes it writes; one that loads every tap (the first version: one
// thread per pixel, 81 global loads per pixel per channel) is bound by load
// issue and, at the coarse levels, by too few threads.
//
// Design of the forward (corr_fwd_kernel).  A block owns a tile of kTY x kTX
// output pixels of one image and DYB of the 9 displacement rows dy (all 9, or
// 3 when the level has too few tiles to fill the card: the grid's z then
// carries the dy group).  For each chunk of kCC channels it stages f1's tile
// and f2's tile plus its 4-pixel halo on every side in shared memory, widened
// to float32; a tap outside the map is zero-filled at the copy, so the inner
// loop has no bounds checks.  A thread owns kPX = 4 neighbouring pixels and
// one dy row: 36 float32 accumulators.  Per channel it reads its 4 f1 values
// and the 12 f2 values of its window row (four 16-byte shared-memory loads,
// eight neighbouring threads on eight neighbouring 16-byte words: no bank
// conflicts) and does 36 FMAs with them.  Float32 copies use cp.async
// (16 bytes where W % 4 == 0 and the rows are aligned, else 4), double
// buffered so the next chunk's copy overlaps this chunk's FMAs; bfloat16 is
// loaded through registers and widened at the copy (cp.async moves 4, 8 or 16
// bytes, a bf16 tap at an odd column is 2).  Each block owns whole sums, taken
// over c in the order 0..C-1 with fmaf as before: no cross-block reduction,
// and the result does not depend on the tiling.  HPAD only moves the staged
// f2 rows by PRE.
//
// Design of the backward (corr_df1_kernel, corr_df2_kernel; the note above
// them has the details).  The first version put one thread on each output
// element and re-read g's 81 planes for every channel: bound by the L2
// cache's bandwidth on those re-reads.  Now a block owns a tile of kTY x kTX
// output pixels of one image, stages g's 81 planes for it once (df2 each plane
// at its own shift) and walks over the channels, kBCC at a time, staging the
// feature map's tile with its halo as the forward stages f2; each output's
// sum runs over the 81 taps in order with fmaf.
//
// Halo-prepadded variants (h_prepad = 1).  A row-shard of a height-sharded map
// (parallel/spatial.py) gets its md real neighbour rows above and below from the
// shards next to it (ops/cost_volume_spmd.py), so the operand the window reads
// carries H + 2md rows and output row y finds tap dy at its row y + dy.  They
// replace the same Pallas kernels run with h_prepad=True by
// unopticalflow_tpu/ops/pallas_spmd.py (_fwd_hpad, _df1_hpad, _df2_hpad).  The
// kernels below take it as a template parameter HPAD: the read operand carries
// PRE = HPAD ? MD : 0 rows on each side, and a tap of global row r is read at
// row r + PRE of an operand with H + 2*PRE rows.  One body serves both forms: a
// staged row outside the operand is zero-filled, which covers the image's
// edges in the first and never happens in the second; every H is taken (the
// TPU kernel's H % 8 tiling does not apply).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

// ---- forward ----------------------------------------------------------------

constexpr int kMD = 4;            // the decoder's window, +-4 px
constexpr int kS = 2 * kMD + 1;   // 9 displacements per axis
constexpr int kPX = 4;            // neighbouring output pixels per thread
constexpr int kTX = 32;           // tile columns: 8 threads of 4 px
constexpr int kGX = kTX / kPX;
constexpr int kTY = 4;            // tile rows: a warp is 8 x 4 threads of one dy
constexpr int kCC = 8;            // channels per staged chunk
constexpr int kW2 = kTX + 2 * kMD;  // staged f2 columns: the tile and its halo
constexpr int kSMs = 132;         // H100 SXM: below 2 blocks per SM, split dy

template <int DYB>
struct FwdTile {
  static constexpr int kThreads = kGX * kTY * DYB;  // one warp per dy row
  static constexpr int kR2 = kTY + DYB - 1;         // staged f2 rows
  static constexpr int kS1 = kCC * kTY * kTX;       // floats of one f1 chunk
  static constexpr int kS2 = kCC * kR2 * kW2;       // floats of one f2 chunk
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One row segment of `n` elements, starting at column x of a source row that
// holds W columns (row_ok false: the whole row is outside the map), into dst
// as float32: columns outside [0, W) are zero.  vec: W % 4 == 0, x % 4 == 0 and
// the row is 16-byte aligned, so 4-element units lie wholly in or out.
template <typename T>
__device__ __forceinline__ void stage_unit(float* dst, const T* row, int x, int W, bool row_ok,
                                           bool vec);

template <>
__device__ __forceinline__ void stage_unit<float>(float* dst, const float* row, int x, int W,
                                                  bool row_ok, bool vec) {
  if (vec) {
    const bool ok = row_ok && x >= 0 && x < W;
    cp_async16(dst, ok ? row + x : row, ok);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = row_ok && x + i >= 0 && x + i < W;
      cp_async4(dst + i, ok ? row + x + i : row, ok);
    }
  }
}

template <>
__device__ __forceinline__ void stage_unit<__nv_bfloat16>(float* dst, const __nv_bfloat16* row,
                                                          int x, int W, bool row_ok, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec) {
    if (row_ok && x >= 0 && x < W) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(row + x));
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      v = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
  } else {
    float t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      t[i] = (row_ok && x + i >= 0 && x + i < W) ? __bfloat162float(row[x + i]) : 0.f;
    v = make_float4(t[0], t[1], t[2], t[3]);
  }
  *reinterpret_cast<float4*>(dst) = v;
}

// Stage channels [c0, c0 + kCC) of f1's tile and of f2's tile with its halo
// (rows from y0 + dy0 - MD) into s1, s2; channels past C are zero.
template <typename T, int DYB, bool HPAD>
__device__ __forceinline__ void stage_chunk(float* s1, float* s2, const T* f1b, const T* f2b,
                                            int c0, int C, int H, int W, int x0, int y0,
                                            int dy0, bool vec) {
  using Tile = FwdTile<DYB>;
  constexpr int PRE = HPAD ? kMD : 0;
  const int Hs = H + 2 * PRE;
  const int64_t plane = (int64_t)H * W;
  const int64_t plane2 = (int64_t)Hs * W;
  constexpr int kU2 = kW2 / 4;  // 4-element units of an f2 row
  for (int e = threadIdx.x; e < kCC * Tile::kR2 * kU2; e += Tile::kThreads) {
    const int q = e / kU2, u = e - q * kU2;
    const int cl = q / Tile::kR2, i = q - cl * Tile::kR2;
    const int r = y0 + dy0 - kMD + i + PRE;  // row of f2
    const bool ok = c0 + cl < C && r >= 0 && r < Hs;
    const T* row = f2b + (ok ? (int64_t)(c0 + cl) * plane2 + (int64_t)r * W : 0);
    stage_unit<T>(s2 + q * kW2 + 4 * u, row, x0 - kMD + 4 * u, W, ok, vec);
  }
  constexpr int kU1 = kTX / 4;
  for (int e = threadIdx.x; e < kCC * kTY * kU1; e += Tile::kThreads) {
    const int q = e / kU1, u = e - q * kU1;
    const int cl = q / kTY, i = q - cl * kTY;
    const bool ok = c0 + cl < C && y0 + i < H;
    const T* row = f1b + (ok ? (int64_t)(c0 + cl) * plane + (int64_t)(y0 + i) * W : 0);
    stage_unit<T>(s1 + q * kTX + 4 * u, row, x0 + 4 * u, W, ok, vec);
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* o, const float* v, int n, bool vec);

template <>
__device__ __forceinline__ void store4<float>(float* o, const float* v, int n, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int p = 0; p < kPX; ++p)
      if (p < n) o[p] = v[p];
  }
}

template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* o, const float* v, int n,
                                                      bool vec) {
  if (vec) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(o) = u;
  } else {
#pragma unroll
    for (int p = 0; p < kPX; ++p)
      if (p < n) o[p] = __float2bfloat16(v[p]);
  }
}

// grid (ceil(W / kTX), ceil(H / kTY), B * (kS / DYB)); block FwdTile<DYB>::kThreads.
// vec: W % 4 == 0 and f1, f2, out 16-byte aligned (4-element copies and stores).
template <typename T, int DYB, bool HPAD>
__global__ void __launch_bounds__(FwdTile<DYB>::kThreads)
corr_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2, T* __restrict__ out,
                int C, int H, int W, float inv_c, bool vec) {
  using Tile = FwdTile<DYB>;
  constexpr int PRE = HPAD ? kMD : 0;
  __shared__ __align__(16) float s1[2][Tile::kS1];
  __shared__ __align__(16) float s2[2][Tile::kS2];

  constexpr int kGroups = kS / DYB;
  const int b = blockIdx.z / kGroups;
  const int dy0 = (blockIdx.z - b * kGroups) * DYB;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int gx = threadIdx.x % kGX;
  const int ty = (threadIdx.x / kGX) % kTY;
  const int dyl = threadIdx.x / (kGX * kTY);
  const int64_t plane = (int64_t)H * W;
  const T* f1b = f1 + (int64_t)b * C * plane;
  const T* f2b = f2 + (int64_t)b * C * (H + 2 * PRE) * W;

  float acc[kPX * kS];
#pragma unroll
  for (int k = 0; k < kPX * kS; ++k) acc[k] = 0.f;

  const int chunks = (C + kCC - 1) / kCC;
  stage_chunk<T, DYB, HPAD>(s1[0], s2[0], f1b, f2b, 0, C, H, W, x0, y0, dy0, vec);
  cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    const int buf = k & 1;
    if (k + 1 < chunks) {
      stage_chunk<T, DYB, HPAD>(s1[buf ^ 1], s2[buf ^ 1], f1b, f2b, (k + 1) * kCC, C, H, W,
                                x0, y0, dy0, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* a_base = s1[buf] + ty * kTX + kPX * gx;
    const float* w_base = s2[buf] + (ty + dyl) * kW2 + kPX * gx;
#pragma unroll 2
    for (int cl = 0; cl < kCC; ++cl) {
      const float4 a4 = *reinterpret_cast<const float4*>(a_base + cl * kTY * kTX);
      const float* wr = w_base + cl * Tile::kR2 * kW2;
      const float4 w0 = *reinterpret_cast<const float4*>(wr);
      const float4 w1 = *reinterpret_cast<const float4*>(wr + 4);
      const float4 w2 = *reinterpret_cast<const float4*>(wr + 8);
      const float a[kPX] = {a4.x, a4.y, a4.z, a4.w};
      const float w[kPX + 2 * kMD] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y,
                                      w1.z, w1.w, w2.x, w2.y, w2.z, w2.w};
#pragma unroll
      for (int p = 0; p < kPX; ++p)
#pragma unroll
        for (int dx = 0; dx < kS; ++dx) acc[p * kS + dx] = fmaf(a[p], w[p + dx], acc[p * kS + dx]);
    }
    __syncthreads();  // the buffer is restaged two chunks on
  }

  const int y = y0 + ty, x = x0 + kPX * gx;
  if (y >= H || x >= W) return;
  T* o = out + ((int64_t)b * kS * kS + (dy0 + dyl) * kS) * plane + (int64_t)y * W + x;
#pragma unroll
  for (int dx = 0; dx < kS; ++dx) {
    float v[kPX];
#pragma unroll
    for (int p = 0; p < kPX; ++p) v[p] = acc[p * kS + dx] * inv_c;
    store4<T>(o + (int64_t)dx * plane, v, W - x, vec);
  }
}

// ---- backward ---------------------------------------------------------------
//
//   df1[b, c, q] = (1/C) * sum_k g[b, k, q]       * f2[b, c, q + s_k]
//   df2[b, c, q] = (1/C) * sum_k g[b, k, q - s_k] * f1[b, c, q - s_k]
//
// with s_k = (dy - md, dx - md), k = dy * 9 + dx, and taps outside the map
// reading zero.  df2 is the gather form of the transpose (each output sums the
// 81 pixels whose window covered it): no atomics, and the result is
// deterministic.
//
// What bounds them on the card: the same 2 * 81 flops per output element as
// the forward, against reads of g (81 planes), one feature map and a write of
// C planes.  The first version (one thread per output element) issued 162
// global loads behind bounds checks for 81 FMAs and re-read the 81 g planes
// for every channel, more than the L2 holds at the finest level: it was bound
// by the L2 cache's bandwidth on those re-reads.  The tiled kernels read each
// operand from memory about once; at the fine levels their shared-memory
// reads bound them (per dy, 9 + 3 * kBNC 16-byte loads a thread for
// 36 * kBNC FMAs), at the coarse ones the host's call does.
//
// Design (corr_df1_kernel, corr_df2_kernel: one body, DF2 picks the form).  A
// block owns a tile of kTY x kTX output pixels of one image.  It stages g's 81
// planes for that tile once, widened to float32 (df2: plane k at its own shift,
// G'[k, i, j] = g[k, y0 + i - dy + md, x0 + j - dx + md], so each plane is
// still one tile and not a haloed one), then walks over its channels kBCC at a
// time, staging the feature map's tile plus its md-pixel halo on every side
// (f2 for df1, f1 for df2) double buffered with cp.async, as the forward
// stages f2.  Taps outside the map are zero-filled at the copy, so the inner
// loop has no bounds checks.  A thread owns kPX = 4 neighbouring pixels and
// kBNC = 2 channels (8 accumulators): for each dy it loads the 9 x 4 g values
// of its pixels once and, for each of its channels, the 12 values of the
// window row (df2 reads the row and columns reversed) and does 36 FMAs.  Two
// channels a thread rather than more keep 256 threads a block, whose extra
// warps hide the bfloat16 copies' load latency (they go through registers);
// float32 is as fast with 4.  The g tile is the largest operand, so it is
// read from memory once per block; a level with too few tiles to fill the
// card splits its channel chunks over the grid's z, as the forward splits dy.
// Each output's sum runs over k = 0..80 in order with fmaf; a zero-filled tap
// adds fmaf(a, 0, acc) == acc, so the float32 result does not depend on the
// tiling.  The 103 KB of shared memory per block is dynamic (above the 48 KB
// static limit; two blocks fit on an SM), allowed with cudaFuncSetAttribute
// once a device.
// With HPAD the staged rows move by PRE: df1 reads f2 with H + 2md rows, df2
// reads both g and f1 with H + 2md rows; the output has H rows.

constexpr int kBCC = 16;  // channels per staged chunk
constexpr int kBNC = 2;   // channels per thread
constexpr int kBThreads = kGX * kTY * (kBCC / kBNC);  // one warp per kBNC channels
constexpr int kTile = kTY * kTX;                      // output pixels of a block
constexpr int kRB = kTY + 2 * kMD;                    // staged rows of the haloed map
constexpr int kGS = kS * kS * kTile;                  // floats of the g tile (41.5 KB)
constexpr int kFS = kBCC * kRB * kW2;                 // floats of one staged chunk
constexpr int kBwdSmem = (kGS + 2 * kFS) * (int)sizeof(float);

// The g tile: plane k's kTY x kTX pixels, at the output's place (df1) or at
// q - s_k (df2).  df2's g carries the halo rows under HPAD, df1's does not.
template <typename T, bool DF2, bool HPAD>
__device__ __forceinline__ void stage_g(float* gs, const T* gb, int H, int W, int x0, int y0,
                                        bool vec) {
  constexpr int PRE = (DF2 && HPAD) ? kMD : 0;
  const int Hg = H + 2 * PRE;
  const int64_t plane = (int64_t)Hg * W;
  constexpr int kU = kTX / 4;  // 4-element units of a tile row
  for (int e = threadIdx.x; e < kS * kS * kTY * kU; e += kBThreads) {
    const int q = e / kU, u = e - q * kU;
    const int k = q / kTY, i = q - k * kTY;
    int r = y0 + i, x = x0 + 4 * u;
    bool unit_vec = vec;
    if (DF2) {
      const int dy = k / kS, dx = k - dy * kS;
      r += kMD - dy + PRE;
      x += kMD - dx;
      unit_vec = vec && (dx & 3) == 0;  // the unit stays 4-aligned
    }
    const bool ok = r >= 0 && r < Hg;
    const T* row = gb + (ok ? (int64_t)k * plane + (int64_t)r * W : 0);
    stage_unit<T>(gs + q * kTX + 4 * u, row, x, W, ok, unit_vec);
  }
}

// Channels [c0, c0 + kBCC) of the feature map's tile with its md-pixel halo
// (rows from y0 - md); channels past C are zero.
template <typename T, bool HPAD>
__device__ __forceinline__ void stage_halo(float* fs, const T* fb, int c0, int C, int H, int W,
                                           int x0, int y0, bool vec) {
  constexpr int PRE = HPAD ? kMD : 0;
  const int Hs = H + 2 * PRE;
  const int64_t plane = (int64_t)Hs * W;
  constexpr int kU = kW2 / 4;
  for (int e = threadIdx.x; e < kBCC * kRB * kU; e += kBThreads) {
    const int q = e / kU, u = e - q * kU;
    const int cl = q / kRB, i = q - cl * kRB;
    const int r = y0 - kMD + i + PRE;
    const bool ok = c0 + cl < C && r >= 0 && r < Hs;
    const T* row = fb + (ok ? (int64_t)(c0 + cl) * plane + (int64_t)r * W : 0);
    stage_unit<T>(fs + q * kW2 + 4 * u, row, x0 - kMD + 4 * u, W, ok, vec);
  }
}

// grid (ceil(W / kTX), ceil(H / kTY), B * groups), block kBThreads, kBwdSmem
// bytes of dynamic shared memory.  Group z % groups takes the channel chunks
// [grp * per_group, min(chunks, (grp + 1) * per_group)).  f: f2 (df1) or f1
// (df2).  vec: W % 4 == 0 and g, f, out 16-byte aligned.
template <typename T, bool DF2, bool HPAD>
__device__ __forceinline__ void corr_bwd_body(const T* __restrict__ g, const T* __restrict__ f,
                                              T* __restrict__ out, int C, int H, int W,
                                              int groups, int per_group, float inv_c, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;
  float* fs = smem + kGS;  // two chunks

  constexpr int PRE = HPAD ? kMD : 0;
  const int b = blockIdx.z / groups;
  const int grp = blockIdx.z - b * groups;
  const int chunks = (C + kBCC - 1) / kBCC;
  const int k_lo = grp * per_group;
  const int k_hi = min(chunks, k_lo + per_group);
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int gx = threadIdx.x % kGX;
  const int ty = (threadIdx.x / kGX) % kTY;
  const int cg = threadIdx.x / (kGX * kTY);
  const int Hs = H + 2 * PRE;  // rows of the haloed map
  const int64_t plane = (int64_t)H * W;
  const T* gb = g + (int64_t)b * kS * kS * (DF2 ? Hs : H) * W;
  const T* fb = f + (int64_t)b * C * Hs * W;

  stage_g<T, DF2, HPAD>(gs, gb, H, W, x0, y0, vec);
  stage_halo<T, HPAD>(fs, fb, k_lo * kBCC, C, H, W, x0, y0, vec);
  cp_async_commit();
  const int y = y0 + ty, x = x0 + kPX * gx;
  for (int k = k_lo; k < k_hi; ++k) {
    const float* cur = fs + ((k - k_lo) & 1) * kFS;
    if (k + 1 < k_hi) {
      stage_halo<T, HPAD>(fs + ((k + 1 - k_lo) & 1) * kFS, fb, (k + 1) * kBCC, C, H, W, x0,
                          y0, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float acc[kBNC][kPX];
#pragma unroll
    for (int j = 0; j < kBNC; ++j)
#pragma unroll
      for (int p = 0; p < kPX; ++p) acc[j][p] = 0.f;
    const float* g_base = gs + ty * kTX + kPX * gx;
    const float* f_base = cur + cg * kBNC * kRB * kW2 + kPX * gx;
#pragma unroll 1
    for (int dy = 0; dy < kS; ++dy) {
      float gr[kS][kPX];
#pragma unroll
      for (int dx = 0; dx < kS; ++dx) {
        const float4 v = *reinterpret_cast<const float4*>(g_base + (dy * kS + dx) * kTile);
        gr[dx][0] = v.x;
        gr[dx][1] = v.y;
        gr[dx][2] = v.z;
        gr[dx][3] = v.w;
      }
      const float* row = f_base + (DF2 ? ty + 2 * kMD - dy : ty + dy) * kW2;
#pragma unroll
      for (int j = 0; j < kBNC; ++j) {
        const float* wr = row + j * kRB * kW2;
        const float4 w0 = *reinterpret_cast<const float4*>(wr);
        const float4 w1 = *reinterpret_cast<const float4*>(wr + 4);
        const float4 w2 = *reinterpret_cast<const float4*>(wr + 8);
        const float w[kPX + 2 * kMD] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y,
                                        w1.z, w1.w, w2.x, w2.y, w2.z, w2.w};
#pragma unroll
        for (int p = 0; p < kPX; ++p)
#pragma unroll
          for (int dx = 0; dx < kS; ++dx)
            acc[j][p] = fmaf(gr[dx][p], w[DF2 ? p + 2 * kMD - dx : p + dx], acc[j][p]);
      }
    }
    __syncthreads();  // the buffer is restaged two chunks on
    if (y < H && x < W) {
#pragma unroll
      for (int j = 0; j < kBNC; ++j) {
        const int c = k * kBCC + cg * kBNC + j;
        if (c >= C) break;
        float v[kPX];
#pragma unroll
        for (int p = 0; p < kPX; ++p) v[p] = acc[j][p] * inv_c;
        store4<T>(out + ((int64_t)b * C + c) * plane + (int64_t)y * W + x, v, W - x, vec);
      }
    }
  }
}

template <typename T, bool HPAD>
__global__ void __launch_bounds__(kBThreads)
corr_df1_kernel(const T* __restrict__ g, const T* __restrict__ f2, T* __restrict__ out, int C,
                int H, int W, int groups, int per_group, float inv_c, bool vec) {
  corr_bwd_body<T, false, HPAD>(g, f2, out, C, H, W, groups, per_group, inv_c, vec);
}

template <typename T, bool HPAD>
__global__ void __launch_bounds__(kBThreads)
corr_df2_kernel(const T* __restrict__ g, const T* __restrict__ f1, T* __restrict__ out, int C,
                int H, int W, int groups, int per_group, float inv_c, bool vec) {
  corr_bwd_body<T, true, HPAD>(g, f1, out, C, H, W, groups, per_group, inv_c, vec);
}

// which: 0 = df1 (src = f2), 1 = df2 (src = f1)
template <typename T, bool HPAD>
cudaError_t launch_bwd(int which, const void* g, const void* src, void* out, int B, int C,
                       int H, int W, int md, cudaStream_t stream) {
  if (md != kMD) return cudaErrorInvalidValue;  // the decoder's window (+-4 px)
  const T* gg = static_cast<const T*>(g);
  const T* s = static_cast<const T*>(src);
  T* o = static_cast<T*>(out);
  const bool vec = W % 4 == 0 &&
                   (((uintptr_t)g | (uintptr_t)src | (uintptr_t)out) % 16) == 0;
  // below 2 blocks per SM (the shared memory holds 2), split the channel
  // chunks over the grid's z: B < 2 * kSMs there, so z < 4 * kSMs
  const int tiles = ((W + kTX - 1) / kTX) * ((H + kTY - 1) / kTY);
  const int chunks = (C + kBCC - 1) / kBCC;
  const int64_t blocks = (int64_t)tiles * B;
  int groups = 1;
  if (blocks < 2 * kSMs) groups = std::min(chunks, (int)((2 * kSMs + blocks - 1) / blocks));
  const int per_group = (chunks + groups - 1) / groups;
  groups = (chunks + per_group - 1) / per_group;  // no empty group
  const dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY, B * groups);
  const float inv_c = 1.f / (float)C;
  // above 48 KB of dynamic shared memory a kernel must be allowed it; the
  // attribute is per device, so it is set once a device and kernel (as
  // gather.cu's allow_smem), and a CUDA graph's capture sees launches only
  const auto kernel = which == 0 ? corr_df1_kernel<T, HPAD> : corr_df2_kernel<T, HPAD>;
  static std::atomic<bool> allowed[64][2];  // by device and df1/df2, per <T, HPAD>
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<bool>& done = allowed[dev & 63][which];
  if (!done.load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
    if (err != cudaSuccess) return err;
    done.store(true, std::memory_order_relaxed);
  }
  kernel<<<grid, kBThreads, kBwdSmem, stream>>>(gg, s, o, C, H, W, groups, per_group, inv_c,
                                                vec);
  return cudaGetLastError();
}

template <typename T, int DYB, bool HPAD>
cudaError_t launch_fwd(const T* f1, const T* f2, T* out, int B, int C, int H, int W, float inv_c,
                       bool vec, cudaStream_t stream) {
  const dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY, B * (kS / DYB));
  corr_fwd_kernel<T, DYB, HPAD><<<grid, FwdTile<DYB>::kThreads, 0, stream>>>(
      f1, f2, out, C, H, W, inv_c, vec);
  return cudaGetLastError();
}

template <typename T, bool HPAD>
cudaError_t launch(const void* f1, const void* f2, void* out, int B, int C, int H, int W,
                   int md, cudaStream_t stream) {
  if (md != kMD) return cudaErrorInvalidValue;  // the decoder's window (+-4 px)
  const float inv_c = 1.f / (float)C;
  const T* a = static_cast<const T*>(f1);
  const T* b = static_cast<const T*>(f2);
  T* o = static_cast<T*>(out);
  const bool vec = W % 4 == 0 &&
                   (((uintptr_t)f1 | (uintptr_t)f2 | (uintptr_t)out) % 16) == 0;
  const int64_t blocks = (int64_t)((W + kTX - 1) / kTX) * ((H + kTY - 1) / kTY) * B;
  if (blocks < 2 * kSMs) return launch_fwd<T, 3, HPAD>(a, b, o, B, C, H, W, inv_c, vec, stream);
  return launch_fwd<T, kS, HPAD>(a, b, o, B, C, H, W, inv_c, vec, stream);
}

}  // namespace

// Both entry points launch grids (ceil(W / kTX), ceil(H / kTY), z), with z = B,
// or below 2 blocks per SM (so B < 2 * kSMs) 3B (the forward's dy groups) or
// B * groups < 4 * kSMs (the backward's channel groups): CUDA caps y and z at
// 65535, so H <= 65535 * kTY and B <= 65535 bound them all.
static bool bad_shape(int B, int C, int H, int W, int h_prepad) {
  return B <= 0 || C <= 0 || H <= 0 || W <= 0 || H > 65535 * kTY || B > 65535 ||
         (h_prepad != 0 && h_prepad != 1);
}

// H is the output's rows; h_prepad = 1: f2 carries md halo rows on each side
// (H + 2md rows).  dtype: 0 = float32, 1 = bfloat16.  Returns the launch's
// cudaError_t (0 = success).
extern "C" int corr_fwd(const void* f1, const void* f2, void* out, int B, int C, int H, int W,
                        int md, int h_prepad, int dtype, void* stream) {
  if (bad_shape(B, C, H, W, h_prepad)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 2 + h_prepad) {
    case 0: return (int)launch<float, false>(f1, f2, out, B, C, H, W, md, s);
    case 1: return (int)launch<float, true>(f1, f2, out, B, C, H, W, md, s);
    case 2: return (int)launch<__nv_bfloat16, false>(f1, f2, out, B, C, H, W, md, s);
    case 3: return (int)launch<__nv_bfloat16, true>(f1, f2, out, B, C, H, W, md, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// g: (B, 81, H, W) gradient of the cost volume; src: f2 for which = 0 (df1),
// f1 for which = 1 (df2); out: (B, C, H, W).  h_prepad = 1: df1's f2, and df2's
// g and f1, carry md halo rows on each side (H + 2md rows).  dtype as corr_fwd.
extern "C" int corr_bwd(int which, const void* g, const void* src, void* out, int B, int C,
                        int H, int W, int md, int h_prepad, int dtype, void* stream) {
  if (bad_shape(B, C, H, W, h_prepad) || (which != 0 && which != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 2 + h_prepad) {
    case 0: return (int)launch_bwd<float, false>(which, g, src, out, B, C, H, W, md, s);
    case 1: return (int)launch_bwd<float, true>(which, g, src, out, B, C, H, W, md, s);
    case 2: return (int)launch_bwd<__nv_bfloat16, false>(which, g, src, out, B, C, H, W, md, s);
    case 3: return (int)launch_bwd<__nv_bfloat16, true>(which, g, src, out, B, C, H, W, md, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
