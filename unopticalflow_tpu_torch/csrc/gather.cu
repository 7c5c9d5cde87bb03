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
// real floor sits above the byte count).  Design (simple and right first): one
// thread per output element over a grid-stride loop with 64-bit offsets, so
// every C and every R is taken; neighbouring threads write neighbouring
// elements (coalesced writes), the C threads of a row read its one int32 index
// (4 bytes per row, not torch.gather's int64 per element) and its C neighbouring
// source elements.  The element is copied as its bits (uint32_t for float32,
// uint16_t for bfloat16), so the result equals the plain version bit for bit.
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
constexpr int kRowBlocksPerSM = 16;
constexpr int kSMs = 132;  // H100 SXM; the grid-stride loop takes any size
constexpr int kLaneThreads = 256;
constexpr int kLaneRows = 2;   // rows of x staged per block
constexpr int kSubCols = 128;  // columns per block, one thread each
constexpr int kReps = 64;      // taps summed per element: ops/gather.py's REPS

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
row_gather_kernel(const T* __restrict__ img, const int* __restrict__ idx, T* __restrict__ out,
                  int64_t N, int64_t R, int64_t C, int64_t total) {
  const int64_t stride = (int64_t)gridDim.x * kRowThreads;
  for (int64_t e = (int64_t)blockIdx.x * kRowThreads + threadIdx.x; e < total; e += stride) {
    const int64_t row = e / C;  // b * R + r
    const int64_t c = e - row * C;
    const int64_t b = row / R;
    int64_t i = idx[row];
    i = i < 0 ? 0 : (i >= N ? N - 1 : i);
    out[e] = img[(b * N + i) * C + c];
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

template <typename T>
cudaError_t launch_row(const void* img, const int* idx, void* out, int B, int N, int R, int C,
                       cudaStream_t stream) {
  const int64_t total = (int64_t)B * R * C;
  const int64_t need = (total + kRowThreads - 1) / kRowThreads;
  const int64_t cap = (int64_t)kSMs * kRowBlocksPerSM;
  const int blocks = (int)(need < cap ? need : cap);
  row_gather_kernel<T><<<blocks, kRowThreads, 0, stream>>>(
      static_cast<const T*>(img), idx, static_cast<T*>(out), N, R, C, total);
  return cudaGetLastError();
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
// (copied as uint32_t / uint16_t bits).  B, R or C of 0 launches nothing.
// Returns the launch's cudaError_t (0 = success).
extern "C" int row_gather(const void* img, const void* idx, void* out, int B, int N, int R,
                          int C, int dtype, void* stream) {
  if (B < 0 || N <= 0 || R < 0 || C < 0) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * R * C == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  switch (dtype) {
    case 0: return (int)launch_row<uint32_t>(img, ix, out, B, N, R, C, s);
    case 1: return (int)launch_row<uint16_t>(img, ix, out, B, N, R, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
