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
// What bounds it on the card: per output pixel, 2*C*81 flops against C reads of f1,
// 81*C reads of f2 (each f2 value is read by the 81 pixels around it, so after the
// first they are served from L1/L2) and 81 writes.  That is far below the tensor
// cores' rate and the f1/output traffic is small, so the limit is the load/FMA
// issue rate of the f2 window reads.
//
// Design (simple and right first): one thread per output pixel, neighbouring
// threads on neighbouring x so every f2 window read is coalesced across the warp;
// 81 float32 accumulators in registers; a loop over c so f1 is read exactly once;
// bounds checks (a tap outside the map is not read and counts as zero) instead of
// a padded copy of f2, which removes the Pallas version's _halo_pad pass and
// covers every H and W.  Addressing each tap from one base per window row keeps
// ptxas at 183 registers with no spills for md=4 (clamped per-tap addresses took
// 255 and spilled).  At the coarse levels there are few pixels and each thread
// runs C*81 taps in sequence, so the kernel is latency-bound there; splitting a
// pixel's work over threads and shared-memory tiles of the f2 window come next.

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

constexpr int kThreads = 64;

template <typename T, int MD>
__global__ void __launch_bounds__(kThreads)
corr_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2, T* __restrict__ out,
                int C, int H, int W, float inv_c) {
  constexpr int S = 2 * MD + 1;
  constexpr int ND = S * S;
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  if (x >= W) return;

  const int64_t plane = (int64_t)H * W;
  const T* p1 = f1 + (int64_t)b * C * plane + (int64_t)y * W + x;
  const T* p2 = f2 + (int64_t)b * C * plane;
  // offset of the window's top-left tap (y - MD, x - MD) in a channel plane;
  // tap (dy, dx) is at win + dy*W + dx, read only when it lies in the map, so
  // the loads need one base per row and immediate offsets, not 81 addresses
  const int64_t win = (int64_t)(y - MD) * W + (x - MD);

  float acc[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) acc[k] = 0.f;

  for (int c = 0; c < C; ++c) {
    const float a = to_f32(p1[(int64_t)c * plane]);
    const T* q = p2 + (int64_t)c * plane + win;
#pragma unroll
    for (int dy = 0; dy < S; ++dy) {
      const bool row_ok = (unsigned)(y + dy - MD) < (unsigned)H;
      const T* r = q + (int64_t)dy * W;
#pragma unroll
      for (int dx = 0; dx < S; ++dx) {
        const bool ok = row_ok && (unsigned)(x + dx - MD) < (unsigned)W;
        const float v = ok ? to_f32(r[dx]) : 0.f;
        acc[dy * S + dx] = fmaf(a, v, acc[dy * S + dx]);
      }
    }
  }

  T* o = out + (int64_t)b * ND * plane + (int64_t)y * W + x;
#pragma unroll
  for (int k = 0; k < ND; ++k) o[(int64_t)k * plane] = from_f32<T>(acc[k] * inv_c);
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

template <typename T, int MD>
__global__ void __launch_bounds__(kThreads)
corr_df1_kernel(const T* __restrict__ g, const T* __restrict__ f2, T* __restrict__ out,
                int C, int H, int W, float inv_c) {
  constexpr int S = 2 * MD + 1;
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z / C;
  const int c = blockIdx.z % C;
  if (x >= W) return;
  const int64_t plane = (int64_t)H * W;
  const T* pg = g + (int64_t)b * S * S * plane + (int64_t)y * W + x;
  const T* p2 = f2 + ((int64_t)b * C + c) * plane;
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < S; ++dy) {
    const int yy = y + dy - MD;
    if ((unsigned)yy >= (unsigned)H) continue;
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

template <typename T, int MD>
__global__ void __launch_bounds__(kThreads)
corr_df2_kernel(const T* __restrict__ g, const T* __restrict__ f1, T* __restrict__ out,
                int C, int H, int W, float inv_c) {
  constexpr int S = 2 * MD + 1;
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  const int b = blockIdx.z / C;
  const int c = blockIdx.z % C;
  if (x >= W) return;
  const int64_t plane = (int64_t)H * W;
  const T* pg = g + (int64_t)b * S * S * plane;
  const T* p1 = f1 + ((int64_t)b * C + c) * plane;
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < S; ++dy) {
    const int py = y - dy + MD;
    if ((unsigned)py >= (unsigned)H) continue;
#pragma unroll
    for (int dx = 0; dx < S; ++dx) {
      const int px = x - dx + MD;
      if ((unsigned)px >= (unsigned)W) continue;
      const int64_t p = (int64_t)py * W + px;
      acc = fmaf(to_f32(pg[(int64_t)(dy * S + dx) * plane + p]), to_f32(p1[p]), acc);
    }
  }
  out[((int64_t)b * C + c) * plane + (int64_t)y * W + x] = from_f32<T>(acc * inv_c);
}

// which: 0 = df1 (src = f2), 1 = df2 (src = f1)
template <typename T>
cudaError_t launch_bwd(int which, const void* g, const void* src, void* out, int B, int C,
                       int H, int W, int md, cudaStream_t stream) {
  if (md != 4) return cudaErrorInvalidValue;  // the decoder's window (+-4 px)
  const dim3 grid((W + kThreads - 1) / kThreads, H, B * C);
  const float inv_c = 1.f / (float)C;
  const T* gg = static_cast<const T*>(g);
  const T* s = static_cast<const T*>(src);
  T* o = static_cast<T*>(out);
  if (which == 0)
    corr_df1_kernel<T, 4><<<grid, kThreads, 0, stream>>>(gg, s, o, C, H, W, inv_c);
  else
    corr_df2_kernel<T, 4><<<grid, kThreads, 0, stream>>>(gg, s, o, C, H, W, inv_c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* f1, const void* f2, void* out, int B, int C, int H, int W,
                   int md, cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, H, B);
  const float inv_c = 1.f / (float)C;
  const T* a = static_cast<const T*>(f1);
  const T* b = static_cast<const T*>(f2);
  T* o = static_cast<T*>(out);
  if (md != 4) return cudaErrorInvalidValue;  // the decoder's window (+-4 px)
  corr_fwd_kernel<T, 4><<<grid, kThreads, 0, stream>>>(a, b, o, C, H, W, inv_c);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t (0 = success).
extern "C" int corr_fwd(const void* f1, const void* f2, void* out, int B, int C, int H, int W,
                        int md, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(f1, f2, out, B, C, H, W, md, s);
    case 1: return (int)launch<__nv_bfloat16>(f1, f2, out, B, C, H, W, md, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// g: (B, 81, H, W) gradient of the cost volume; src: f2 for which = 0 (df1),
// f1 for which = 1 (df2); out: (B, C, H, W).  dtype as corr_fwd.
extern "C" int corr_bwd(int which, const void* g, const void* src, void* out, int B, int C,
                        int H, int W, int md, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || H > 65535 || (int64_t)B * C > 65535 ||
      (which != 0 && which != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_bwd<float>(which, g, src, out, B, C, H, W, md, s);
    case 1: return (int)launch_bwd<__nv_bfloat16>(which, g, src, out, B, C, H, W, md, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
