// The gathers of the two gather probes, for Hopper (sm_90a).
//
// row_gather_kernel replaces the TPU kernel of benchmarks/gather_probe.py:352
// (kernel3, called by pallas_loop3 at :364): the row gather
//   out[b, r, c] = img[b, idx[b, r], c]      img (B, N, C), idx (B, R) int32, out (B, R, C)
// that jnp.take_along_axis(img, idx[..., None], axis=1) computes.  Every row r < R
// is written: the TPU grid (b, R // 2048) left the rows past the last whole
// 2048-row chunk unwritten, a blocking artefact of that kernel, not part of the
// function.  Indices are in [0, N) by contract; the kernel clamps them into
// that range so that a bad index reads a wrong row and never faults.
// What bounds it on this card: device-memory bytes, with no arithmetic at all
// (the output once, 4 bytes of index per row, and the source rows the indices
// touch; a random 24- or 48-byte row touches one or two 32-byte sectors, so the
// real floor sits above the byte count).  Design: a warp copies 32 consecutive
// rows of one image, the grid is (row blocks, B), so the index arithmetic is
// 32-bit with no division per element.  Each lane loads one row's int32 index
// once and clamps it; the warp's 32 rows form one contiguous run of output
// copy units (16, 8, 4 or 2 bytes: the widest that divides the row and both
// arrays' alignment, 8 for the probe's 24-byte bf16 rows, 16 for its 48-byte
// f32 rows), and lane l copies units l, l + 32, ...: every store instruction
// writes 32 neighbouring units, and the lanes that share a row read its
// neighbouring units, the row's index coming from its lane by a shuffle.  A
// lane steps its (row, unit in row) pair by adding, with no division past
// the first.  On the card this beat one row per thread (its 48-byte f32 rows
// stored 16 bytes per lane 48 bytes apart) in both dtypes.  The row is copied
// as its bits, so the result equals the plain version bit for bit.  (The first
// version ran one thread per element with a 64-bit division and modulo per
// element and re-read the row's index for every element.)
//
// lane_gather_kernel and sublane_gather_kernel replace the TPU kernels of
// benchmarks/pallas_gather_probe.py:42 (lane_kernel) and :50 (sublane_kernel),
// both called through run at :61:
//   lane:    out[s, l] = sum_{k < 64} x[s, (idx[s, l] + k) mod W]     x (S, W)
//   sublane: out[s, l] = sum_{k < 64} x[(idx[s, l] + k) mod S, l]     x (S, L)
// with mod the floor modulo of JAX's %, the sum accumulated in x's dtype in the
// order k = 0, 1, ..., 63, rounding after every add as the JAX kernels'
// acc = acc + g does.  So a bfloat16 sum is rounded to bfloat16 after each add
// (a float32 sum rounded once drifts about 2% from the JAX kernel), and the sum
// is never simplified: the sublane sum visits each value 64 / S times, and
// (64 / S) * sum rounds otherwise; the probe measures the gathers, not adds.
// What bounds them on this card: per element 64 shared-memory reads (33.6 M
// reads for the probe's (4096, 128) lane case), far above the few MB
// of device memory they move, and at the probe's sizes the launch's latency,
// as the TPU probe sat below its dispatch (which is why it loops 64 times).
// Design: the lane kernel stages kLaneRows rows of x in shared memory (coalesced
// loads), then each thread walks one output element's 64 taps in that row;
// the sublane kernel gives each thread one column of a kSubCols-wide strip and
// stages that column's S values in shared memory as s[S][kSubCols], so a warp's
// 32 threads read 32 neighbouring words whatever row each one reads: no bank
// conflicts.  Each thread reads only the column it staged, so it needs no
// barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 256;
constexpr int kRowUnits = 4;  // rows of at most this many units: loads batched before stores
constexpr int kLaneThreads = 256;
constexpr int kLaneRows = 2;   // rows of x staged per block
constexpr int kSubCols = 128;  // columns per block, one thread each
constexpr int kReps = 64;      // taps summed per element: ops/gather.py's REPS

// U: the copy unit (uint4, uint2, uint32_t or uint16_t); a row is `units` of
// them.  grid (ceil(R / kRowThreads), B): each warp copies 32 rows.
template <typename U>
__global__ void __launch_bounds__(kRowThreads)
row_gather_kernel(const U* __restrict__ img, const int* __restrict__ idx, U* __restrict__ out,
                  int N, int R, int units) {
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5)) * 32;
  if (r0 >= R) return;  // the whole warp
  const int b = blockIdx.y;
  const int64_t row0 = (int64_t)b * R + r0;
  int i = 0;  // this lane's row's source index
  if (r0 + lane < R) {
    i = __ldg(idx + row0 + lane);
    i = i < 0 ? 0 : (i >= N ? N - 1 : i);
  }
  const int total = min(32, R - r0) * units;  // the warp's output units
  const U* src = img + (int64_t)b * N * units;
  U* dst = out + row0 * units;
  // unit lane + 32k is unit `off` of row `r` of the warp's rows
  int r = lane / units, off = lane - r * units;
  const int dr = 32 / units, doff = 32 - dr * units;
  if (units <= kRowUnits) {  // every load in flight before the stores
    U v[kRowUnits];
#pragma unroll
    for (int k = 0; k < kRowUnits; ++k) {
      const int s = __shfl_sync(0xffffffffu, i, r & 31);
      if (k < units && lane + 32 * k < total) v[k] = __ldg(src + (int64_t)s * units + off);
      r += dr;
      off += doff;
      if (off >= units) off -= units, ++r;
    }
#pragma unroll
    for (int k = 0; k < kRowUnits; ++k)
      if (k < units && lane + 32 * k < total) dst[lane + 32 * k] = v[k];
    return;
  }
  for (int k = 0; k < units; ++k) {
    const int s = __shfl_sync(0xffffffffu, i, r & 31);
    if (lane + 32 * k < total) dst[lane + 32 * k] = __ldg(src + (int64_t)s * units + off);
    r += dr;
    off += doff;
    if (off >= units) off -= units, ++r;
  }
}

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 zero_of(__nv_bfloat16) { return __float2bfloat16_rn(0.f); }

// one add of the JAX kernels' acc = acc + g, rounded to T
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ __nv_bfloat16 add_rn(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

// floor modulo, as JAX's % and torch.remainder
__device__ __forceinline__ int mod_floor(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

template <typename T>
__device__ __forceinline__ T tap_sum(const T* s, int j, int n, int step) {
  // sum_{k < kReps} s[((j + k) mod n) * step], in the order k = 0, 1, ...
  T acc = zero_of(T());
  for (int k = 0; k < kReps; ++k) {
    acc = add_rn(acc, s[j * step]);
    j = j + 1 == n ? 0 : j + 1;
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kLaneThreads)
lane_gather_kernel(const T* __restrict__ x, const int* __restrict__ idx, T* __restrict__ out,
                   int S, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);  // s[kLaneRows][W]
  const int64_t row0 = (int64_t)blockIdx.x * kLaneRows;
  const int rows = S - row0 < kLaneRows ? (int)(S - row0) : kLaneRows;
  const int n = rows * W;
  const int64_t base = row0 * W;
  for (int e = threadIdx.x; e < n; e += kLaneThreads) s[e] = x[base + e];
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += kLaneThreads) {
    const int r = e / W;
    out[base + e] = tap_sum(s + r * W, mod_floor(idx[base + e], W), W, 1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kSubCols)
sublane_gather_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                      T* __restrict__ out, int S, int64_t L) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem) + threadIdx.x;  // this thread's column of s[S][kSubCols]
  const int64_t l = (int64_t)blockIdx.x * kSubCols + threadIdx.x;
  if (l >= L) return;
  for (int r = 0; r < S; ++r) s[r * kSubCols] = x[r * L + l];
  for (int r = 0; r < S; ++r) {
    out[r * L + l] = tap_sum(s, mod_floor(idx[r * L + l], S), S, kSubCols);
  }
}

template <typename U>
cudaError_t launch_row_units(const void* img, const int* idx, void* out, int B, int N, int R,
                             int row_bytes, cudaStream_t stream) {
  const dim3 grid((R + kRowThreads - 1) / kRowThreads, B);
  row_gather_kernel<U><<<grid, kRowThreads, 0, stream>>>(
      static_cast<const U*>(img), idx, static_cast<U*>(out), N, R, row_bytes / (int)sizeof(U));
  return cudaGetLastError();
}

cudaError_t launch_row(const void* img, const int* idx, void* out, int B, int N, int R,
                       int row_bytes, cudaStream_t stream) {
  // the widest unit that divides the row and both arrays' alignment
  const uintptr_t align = (uintptr_t)row_bytes | (uintptr_t)img | (uintptr_t)out;
  if (align % 16 == 0) return launch_row_units<uint4>(img, idx, out, B, N, R, row_bytes, stream);
  if (align % 8 == 0) return launch_row_units<uint2>(img, idx, out, B, N, R, row_bytes, stream);
  if (align % 4 == 0)
    return launch_row_units<uint32_t>(img, idx, out, B, N, R, row_bytes, stream);
  return launch_row_units<uint16_t>(img, idx, out, B, N, R, row_bytes, stream);
}

template <typename T>
cudaError_t launch_lane(const void* x, const int* idx, void* out, int S, int W,
                        cudaStream_t stream) {
  const int blocks = (S + kLaneRows - 1) / kLaneRows;
  const size_t smem = (size_t)kLaneRows * W * sizeof(T);
  lane_gather_kernel<T><<<blocks, kLaneThreads, smem, stream>>>(
      static_cast<const T*>(x), idx, static_cast<T*>(out), S, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sublane(const void* x, const int* idx, void* out, int S, int L,
                           cudaStream_t stream) {
  const int blocks = (L + kSubCols - 1) / kSubCols;
  const size_t smem = (size_t)S * kSubCols * sizeof(T);
  sublane_gather_kernel<T><<<blocks, kSubCols, smem, stream>>>(
      static_cast<const T*>(x), idx, static_cast<T*>(out), S, L);
  return cudaGetLastError();
}

}  // namespace

// img (B, N, C), idx (B, R) int32, out (B, R, C); dtype 0 = float32, 1 = bfloat16
// (copied as bits).  B at most 65535 (the grid's y), a row at most INT_MAX
// bytes.  B, R or C of 0 launches nothing.  Returns the launch's cudaError_t
// (0 = success).
extern "C" int row_gather(const void* img, const void* idx, void* out, int B, int N, int R,
                          int C, int dtype, void* stream) {
  if (B < 0 || B > 65535 || N <= 0 || R < 0 || C < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * R * C == 0) return (int)cudaSuccess;
  const int64_t row_bytes = (int64_t)C * (dtype == 0 ? 4 : 2);
  if (row_bytes > 0x7fffffff) return (int)cudaErrorInvalidValue;
  return (int)launch_row(img, static_cast<const int*>(idx), out, B, N, R, (int)row_bytes,
                         static_cast<cudaStream_t>(stream));
}

// x, out (S, W) of dtype 0 = float32 / 1 = bfloat16, idx (S, W) int32; W at most
// 4096 (kLaneRows rows of x fit the default 48 KB of shared memory).
extern "C" int lane_gather(const void* x, const void* idx, void* out, int S, int W, int dtype,
                           void* stream) {
  if (S <= 0 || W <= 0 || W > 4096) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  switch (dtype) {
    case 0: return (int)launch_lane<float>(x, ix, out, S, W, s);
    case 1: return (int)launch_lane<__nv_bfloat16>(x, ix, out, S, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x, out (S, L) of dtype 0 = float32 / 1 = bfloat16, idx (S, L) int32; S at most 64.
extern "C" int sublane_gather(const void* x, const void* idx, void* out, int S, int L,
                              int dtype, void* stream) {
  if (S <= 0 || S > 64 || L <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  switch (dtype) {
    case 0: return (int)launch_sublane<float>(x, ix, out, S, L, s);
    case 1: return (int)launch_sublane<__nv_bfloat16>(x, ix, out, S, L, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
