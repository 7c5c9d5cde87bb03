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
// The backward kernels (one thread per output element) are as before.
//
// Halo-prepadded variants (h_prepad = 1).  A row-shard of a height-sharded map
// (parallel/spatial.py) gets its md real neighbour rows above and below from the
// shards next to it (ops/cost_volume_spmd.py), so the operand the window reads
// carries H + 2md rows and output row y finds tap dy at its row y + dy.  They
// replace the same Pallas kernels run with h_prepad=True by
// unopticalflow_tpu/ops/pallas_spmd.py (_fwd_hpad, _df1_hpad, _df2_hpad).  The
// kernels below take it as a template parameter HPAD: the read operand carries
// PRE = HPAD ? MD : 0 rows on each side, and a tap of global row r is read at
// row r + PRE of an operand with H + 2*PRE rows.  One body serves both forms; the
// bounds check covers the image's edges in the first and never fails in the
// second; every H is taken (the TPU kernel's H % 8 tiling does not apply).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int kThreads = 64;  // backward: one thread per output element

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
//   df1[b, c, y, x] = (1/C) * sum_k g[b, k, y, x] * f2[b, c, y + dy - md, x + dx - md]
//   df2[b, c, y, x] = (1/C) * sum_k g[b, k, p] * f1[b, c, p],  p = (y - dy + md, x - dx + md)
//
// with taps outside the map reading zero.  df2 is the gather form of the
// transpose (each output sums the 81 pixels whose window covered it), so no
// atomics are needed and the result is deterministic.
//
// What bounds them: per output element 81 loads of g and 81 of f2 (df1) or f1
// (df2) for 162 flops, so both are load-issue bound like the forward.  Design
// (simple and right first): one thread per output element (b, c, y, x),
// neighbouring threads on neighbouring x so every load is coalesced across the
// warp; the 81 g planes are re-read for every channel and served from L1/L2.
// Unlike the Pallas kernels they take every H and W (no H % 8 condition).
// With HPAD, df1's f2 and both of df2's operands carry their halo rows
// (H + 2md rows; the output has H).

template <typename T, int MD, bool HPAD>
__global__ void __launch_bounds__(kThreads)
corr_df1_kernel(const T* __restrict__ g, const T* __restrict__ f2, T* __restrict__ out,
                int C, int H, int W, float inv_c) {
  constexpr int S = 2 * MD + 1;
  constexpr int PRE = HPAD ? MD : 0;
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z / C;
  const int c = blockIdx.z % C;
  if (x >= W) return;
  const int Hs = H + 2 * PRE;  // rows of f2
  const int64_t plane = (int64_t)H * W;
  const int64_t plane2 = (int64_t)Hs * W;
  const T* pg = g + (int64_t)b * S * S * plane + (int64_t)y * W + x;
  const T* p2 = f2 + ((int64_t)b * C + c) * plane2;
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < S; ++dy) {
    const int yy = y + dy + PRE - MD;
    if ((unsigned)yy >= (unsigned)Hs) continue;
#pragma unroll
    for (int dx = 0; dx < S; ++dx) {
      const int xx = x + dx - MD;
      if ((unsigned)xx >= (unsigned)W) continue;
      acc = fmaf(to_f32(pg[(int64_t)(dy * S + dx) * plane]),
                 to_f32(p2[(int64_t)yy * W + xx]), acc);
    }
  }
  out[((int64_t)b * C + c) * plane + (int64_t)y * W + x] = from_f32<T>(acc * inv_c);
}

template <typename T, int MD, bool HPAD>
__global__ void __launch_bounds__(kThreads)
corr_df2_kernel(const T* __restrict__ g, const T* __restrict__ f1, T* __restrict__ out,
                int C, int H, int W, float inv_c) {
  constexpr int S = 2 * MD + 1;
  constexpr int PRE = HPAD ? MD : 0;
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z / C;
  const int c = blockIdx.z % C;
  if (x >= W) return;
  const int Hs = H + 2 * PRE;  // rows of g and f1
  const int64_t plane = (int64_t)Hs * W;
  const int64_t out_plane = (int64_t)H * W;
  const T* pg = g + (int64_t)b * S * S * plane;
  const T* p1 = f1 + ((int64_t)b * C + c) * plane;
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < S; ++dy) {
    const int py = y - dy + MD + PRE;
    if ((unsigned)py >= (unsigned)Hs) continue;
#pragma unroll
    for (int dx = 0; dx < S; ++dx) {
      const int px = x - dx + MD;
      if ((unsigned)px >= (unsigned)W) continue;
      const int64_t p = (int64_t)py * W + px;
      acc = fmaf(to_f32(pg[(int64_t)(dy * S + dx) * plane + p]), to_f32(p1[p]), acc);
    }
  }
  out[((int64_t)b * C + c) * out_plane + (int64_t)y * W + x] = from_f32<T>(acc * inv_c);
}

// which: 0 = df1 (src = f2), 1 = df2 (src = f1)
template <typename T, bool HPAD>
cudaError_t launch_bwd(int which, const void* g, const void* src, void* out, int B, int C,
                       int H, int W, int md, cudaStream_t stream) {
  if (md != 4) return cudaErrorInvalidValue;  // the decoder's window (+-4 px)
  const dim3 grid((W + kThreads - 1) / kThreads, H, B * C);
  const float inv_c = 1.f / (float)C;
  const T* gg = static_cast<const T*>(g);
  const T* s = static_cast<const T*>(src);
  T* o = static_cast<T*>(out);
  if (which == 0)
    corr_df1_kernel<T, 4, HPAD><<<grid, kThreads, 0, stream>>>(gg, s, o, C, H, W, inv_c);
  else
    corr_df2_kernel<T, 4, HPAD><<<grid, kThreads, 0, stream>>>(gg, s, o, C, H, W, inv_c);
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

// H is the output's rows; h_prepad = 1: f2 carries md halo rows on each side
// (H + 2md rows).  dtype: 0 = float32, 1 = bfloat16.  Returns the launch's
// cudaError_t (0 = success).  The grid's z is B, or 3B below 2 blocks per SM
// (so B < 2 * kSMs): B <= 65535 bounds both.
extern "C" int corr_fwd(const void* f1, const void* f2, void* out, int B, int C, int H, int W,
                        int md, int h_prepad, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || H > 65535 * kTY || B > 65535 ||
      (h_prepad != 0 && h_prepad != 1))
    return (int)cudaErrorInvalidValue;
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
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || H > 65535 || (int64_t)B * C > 65535 ||
      (which != 0 && which != 1) || (h_prepad != 0 && h_prepad != 1))
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
