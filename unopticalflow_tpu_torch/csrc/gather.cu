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
// lane_gather_kernel, lane_gather_rows_kernel and sublane_gather_kernel replace
// the TPU kernels of benchmarks/pallas_gather_probe.py:42 (lane_kernel) and :50
// (sublane_kernel), both called through run at :61:
//   lane:    out[s, l] = sum_{k < 64} x[s, (idx[s, l] + k) mod W]     x (S, W)
//   sublane: out[s, l] = sum_{k < 64} x[(idx[s, l] + k) mod S, l]     x (S, L)
// with mod the floor modulo of JAX's %, the sum accumulated in x's dtype in the
// order k = 0, 1, ..., 63, rounding after every add as the JAX kernels'
// acc = acc + g does.  So a bfloat16 sum is rounded to bfloat16 after each add
// (a float32 sum rounded once drifts about 2% from the JAX kernel), and the sum
// is never simplified: the sublane sum visits each value 64 / S times, and
// (64 / S) * sum rounds otherwise; the probe measures the gathers, not adds.
// Every tap stays a shared-memory read whose address is set by the element's
// index: j = idx mod n is taken once (a mask where n is a power of two; since
// (idx + k) mod n = (j + k) mod n, JAX's int32 idx + k, which wraps by 2^32,
// gives the same taps at its widths 128 and 8), and each row or column is
// staged followed by its first 63 values, so tap k reads entry j + k: no
// modulo in the tap loop, and the 64 taps unroll with their offsets folded
// into the loads.  A bfloat16 add is one fma.rn.bf16x2 (x * 1 + y rounded once
// to nearest even), which gives the bits of rounding the float32 sum to
// bfloat16: float32 carries more than 2 * 8 + 2 bits, so that double rounding
// is exact.
// What bounds them on this card: shared-memory bandwidth, 128 bytes a clock on
// each SM, far above the few MB of device memory they move: the (4096, 128)
// float32 lane probe reads 33.6 M taps of 4 bytes (4.0 us at 1.98 GHz) against
// a bytes bound of 1.9 us.  Before its first tap a block must have its rows from
// device memory and staged, which no tap can hide; at small sizes the launch's
// latency sets the time.
// Design:
// * lane_gather_kernel (W <= 256, enough rows for half the card's SMs): a
//   1024-thread block owns 32 rows and 128 output columns, 4 a thread; lane l's
//   row lives in bank l (bank[m][32]), so the 32 lanes of a warp, each on its
//   own row, read 32 banks whatever their indices: no bank conflicts (the
//   first design staged a row for all lanes, whose random windows met in a bank
//   ~3.5 times a tap; on the card most of its time was instructions, not the
//   conflicts).  Warp r loads row r of x coalesced, 16 bytes a lane where the
//   rows are whole 16-byte chunks, into a row-major tile whose row stride
//   spreads 32 lanes reading their own rows over all banks, and only then row
//   r of the index tile, which lands while the rows are turned into the banks;
//   the outputs go back the way the indices came.  The thread's 4 sums run
//   side by side.
//   bfloat16 rows are held as two copies packed two values a word, one pairing
//   elements (2p, 2p + 1), one (2p + 1, 2p + 2), so a window that starts at
//   either parity is 32 aligned words: one read serves two taps, and two
//   outputs are summed in the two halves of one bfloat16x2 add.  (Pairs of
//   float32 taps read 8 bytes at a time were no faster: the bytes bound it.)
// * lane_gather_rows_kernel (wider rows, or too few rows): the first design's
//   layout, a block's rows staged row-major for all its threads (bank
//   conflicts left as they fall), with the columns split over the grid until
//   there are two blocks an SM, one output a thread where it can, and each
//   thread's first index loaded while the rows are staged.
// * sublane_gather_kernel: a block owns 32 columns, lane l's column in bank l
//   (no conflicts), one warp an output row, so the probe's (8, 8192) is 256
//   blocks of one output a thread; each value is read once from device memory
//   and stored at every slot m = r (mod S) below S + 63.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int kRowThreads = 256;
constexpr int kRowUnits = 4;  // rows of at most this many units: loads batched before stores
constexpr int kReps = 64;     // taps summed per element: ops/gather.py's REPS
// lane_gather_kernel: 32 rows (one a lane) by 128 output columns a block, 32
// warps of 4 outputs a thread (two bfloat16 pairs)
constexpr int kBankRows = 32;
constexpr int kBankCols = 128;
constexpr int kBankThreads = 1024;
constexpr int kBankWarps = kBankThreads / 32;
constexpr int kBankOuts = kBankCols / kBankWarps;
constexpr int kBankMaxW = 256;
constexpr int kIdxStride = kBankCols + 1;  // odd: the lanes' rows of the tile in 32 banks
// lane_gather_rows_kernel
constexpr int kRowsThreads = 256;
constexpr int kRowsSmem = 48 * 1024;  // the rows a block stages, at most
// sublane_gather_kernel: at most this many warps a block, one output row each
constexpr int kSubWarps = 8;

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

// two bfloat16 sums advanced by one add each: a * 1 + b, rounded once to
// nearest even, which is what rounding their float32 sum to bfloat16 gives
// (float32 carries more than 2 * 8 + 2 bits, so the double rounding is exact)
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(0x3f803f80u), "r"(b));
  return d;
}

// floor modulo, as JAX's % and torch.remainder
__device__ __forceinline__ int mod_floor(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// the first tap's position: idx mod n, a mask where n is a power of two
__device__ __forceinline__ int tap_start(int i, int n) {
  return (n & (n - 1)) == 0 ? (int)((unsigned)i & (unsigned)(n - 1)) : mod_floor(i, n);
}

template <typename T>
struct BitsOf;
template <>
struct BitsOf<float> {
  using type = uint32_t;
};
template <>
struct BitsOf<__nv_bfloat16> {
  using type = uint16_t;
};

// lane_gather_kernel's words a lane holds of its row, in whole 16-byte chunks:
// float32 the row and its first 63 values again; bfloat16 two copies of that,
// packed two values a word, each copy bank_pairs words
__host__ __device__ constexpr int bank_pairs(int W) {
  return ((W - 1) / 2 + kReps / 2 + 3) / 4 * 4;
}
template <typename T>
__host__ __device__ constexpr int bank_words(int W) {
  return sizeof(T) == 4 ? (W + kReps - 1 + 3) / 4 * 4 : 2 * bank_pairs(W);
}
// words of a row of the block's x tile, so that 32 lanes reading their own rows
// at one column hit 32 banks: whole rows of 16-byte chunks (vec) an odd number
// of chunks, read a chunk a lane; otherwise an odd number of words
template <typename T>
__host__ __device__ constexpr int tile_words(int W, bool vec) {
  return vec ? (W * (int)sizeof(T) / 16 % 2 ? W * (int)sizeof(T) / 4 : W * (int)sizeof(T) / 4 + 4)
             : ((W * (int)sizeof(T) + 3) / 4 | 1);
}
template <typename T>
size_t bank_smem(int W) {
  const bool whole = W * (int)sizeof(T) % 16 == 0;  // the kernel may take either layout
  const int tile = std::max(tile_words<T>(W, false), whole ? tile_words<T>(W, true) : 0);
  return (size_t)(bank_words<T>(W) + kIdxStride + tile) * kBankRows * 4;
}

// lane_gather_kernel's taps of columns warp + 32 i (i < 4, below cols) of lane
// l's row: each a read of bank l at the address the index in slot[o] sets, the
// thread's outputs summed side by side (a column past the block's repeats its
// last one, whose owner writes it); the sums replace the indices in slot
template <typename T>
__device__ __forceinline__ void bank_taps(const uint32_t* bank, uint32_t* slot, int lane,
                                          int warp, int cols, int W) {
  int o[kBankOuts];
#pragma unroll
  for (int i = 0; i < kBankOuts; ++i) o[i] = min(warp + kBankWarps * i, cols - 1);
  if constexpr (sizeof(T) == 4) {
    const float* s[kBankOuts];
    float acc[kBankOuts];
#pragma unroll
    for (int i = 0; i < kBankOuts; ++i) {
      s[i] = reinterpret_cast<const float*>(bank) + tap_start((int)slot[o[i]], W) * kBankRows +
             lane;
      acc[i] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < kReps; ++k)
#pragma unroll
      for (int i = 0; i < kBankOuts; ++i) acc[i] = __fadd_rn(acc[i], s[i][k * kBankRows]);
#pragma unroll
    for (int i = 0; i < kBankOuts; ++i)
      if (warp + kBankWarps * i < cols) slot[o[i]] = __float_as_uint(acc[i]);
  } else {
    // outputs 2h and 2h + 1 in the low and high halves of one bfloat16x2 sum;
    // the window at j is words j / 2, j / 2 + 1, ... of the copy of j's parity
    constexpr int kPairs = kBankOuts / 2;
    const int pairs = bank_pairs(W);
    const uint32_t* s[kBankOuts];
    uint32_t acc[kPairs];
#pragma unroll
    for (int i = 0; i < kBankOuts; ++i) {
      const int j = tap_start((int)slot[o[i]], W);
      s[i] = bank + ((j & 1) * pairs + (j >> 1)) * kBankRows + lane;
    }
#pragma unroll
    for (int h = 0; h < kPairs; ++h) acc[h] = 0;  // (+0, +0)
#pragma unroll
    for (int q = 0; q < kReps / 2; ++q)
#pragma unroll
      for (int h = 0; h < kPairs; ++h) {
        const uint32_t w1 = s[2 * h][q * kBankRows], w2 = s[2 * h + 1][q * kBankRows];
        acc[h] = add_bf16x2(acc[h], __byte_perm(w1, w2, 0x5410));  // tap 2q of both
        acc[h] = add_bf16x2(acc[h], __byte_perm(w1, w2, 0x7632));  // tap 2q + 1
      }
#pragma unroll
    for (int i = 0; i < kBankOuts; ++i)
      if (warp + kBankWarps * i < cols)
        slot[o[i]] = i & 1 ? acc[i / 2] >> 16 : acc[i / 2] & 0xffffu;
  }
}

// grid (ceil(S / 32), ceil(W / 128)), kBankThreads threads: the block's rows
// r0 + l (lane l's) and columns c0 + warp + 32 i, i < 4.  Shared memory:
// bank[m][32] (lane l's row in bank l), tile[32][kIdxStride] (the indices, then
// the outputs), xt[32][tile_words] (the rows as loaded).
template <typename T>
__global__ void __launch_bounds__(kBankThreads, 1)
lane_gather_kernel(const T* __restrict__ x, const int* __restrict__ idx, T* __restrict__ out,
                   int S, int W) {
  using Bits = typename BitsOf<T>::type;
  constexpr int kIdxPerLane = kBankCols / 32;
  static_assert(kBankWarps == kBankRows, "a warp a row in the coalesced loads and stores");
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r0 = (int64_t)blockIdx.x * kBankRows;
  const int c0 = blockIdx.y * kBankCols;
  const int rows = (int)min((int64_t)kBankRows, S - r0), cols = min(kBankCols, W - c0);
  // rows of whole 16-byte chunks move a chunk an instruction
  const bool vec = W * (int)sizeof(T) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int tw = tile_words<T>(W, vec);
  uint32_t* bank = reinterpret_cast<uint32_t*>(smem);
  uint32_t* tile = bank + bank_words<T>(W) * kBankRows;
  uint32_t* xt = tile + kBankRows * kIdxStride;
  // 1. warp r loads row r of x, coalesced, every load in flight before the
  // first store (a row is at most 64 chunks: two a lane); the index tile's
  // loads go out once the rows are in, and land during the staging
  const int r = warp;
  if (vec) {
    const int n16 = W * (int)sizeof(T) / 16;
    uint4 v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (r < rows && lane + 32 * e < n16)
        v[e] = __ldg(reinterpret_cast<const uint4*>(x + (r0 + r) * W) + lane + 32 * e);
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (r < rows && lane + 32 * e < n16)
        reinterpret_cast<uint4*>(xt + r * tw)[lane + 32 * e] = v[e];
  } else if (r < rows) {
    Bits* xe = reinterpret_cast<Bits*>(xt) + r * (tw * 4 / (int)sizeof(T));
    const Bits* xb = reinterpret_cast<const Bits*>(x) + (r0 + r) * W;
#pragma unroll 4
    for (int c = lane; c < W; c += 32) xe[c] = __ldg(xb + c);
  }
  __syncthreads();
  int iv[kIdxPerLane];
#pragma unroll
  for (int e = 0; e < kIdxPerLane; ++e) {
    const int o = lane + 32 * e;
    iv[e] = r < rows && o < cols ? __ldg(idx + (r0 + r) * W + c0 + o) : 0;
  }
  // 2. lane l's row into bank l, followed by its first 63 values (mod W)
  if (lane < rows) {
    if (vec) {  // 16-byte chunks of the row, each read once a copy
      const uint4* xr = reinterpret_cast<const uint4*>(xt + lane * tw);
      const int n16 = W * (int)sizeof(T) / 16;
      int q = warp < n16 ? warp : warp % n16;
      if constexpr (sizeof(T) == 4) {
        for (int m = 4 * warp; m < bank_words<T>(W); m += 4 * kBankWarps) {
          const uint4 w = xr[q];
          uint32_t* b = bank + m * kBankRows + lane;
          b[0] = w.x;
          b[kBankRows] = w.y;
          b[2 * kBankRows] = w.z;
          b[3 * kBankRows] = w.w;
          q += kBankWarps;
          while (q >= n16) q -= n16;
        }
      } else {
        // word p of the first copy holds elements 2p, 2p + 1 (the row's word
        // p); of the second 2p + 1, 2p + 2
        const int pairs = bank_pairs(W);
        for (int p = 4 * warp; p < pairs; p += 4 * kBankWarps) {
          const uint4 w = xr[q], n = xr[q + 1 == n16 ? 0 : q + 1];
          uint32_t* a = bank + p * kBankRows + lane;
          uint32_t* b = a + pairs * kBankRows;
          a[0] = w.x;
          a[kBankRows] = w.y;
          a[2 * kBankRows] = w.z;
          a[3 * kBankRows] = w.w;
          b[0] = __byte_perm(w.x, w.y, 0x5432);
          b[kBankRows] = __byte_perm(w.y, w.z, 0x5432);
          b[2 * kBankRows] = __byte_perm(w.z, w.w, 0x5432);
          b[3 * kBankRows] = __byte_perm(w.w, n.x, 0x5432);
          q += kBankWarps;
          while (q >= n16) q -= n16;
        }
      }
    } else {
      const Bits* xr = reinterpret_cast<const Bits*>(xt) + lane * (tw * 4 / (int)sizeof(T));
      if constexpr (sizeof(T) == 4) {
        int c = warp % W;
        for (int m = warp; m < W + kReps - 1; m += kBankWarps) {
          bank[m * kBankRows + lane] = xr[c];
          c += kBankWarps;
          if (c >= W) c = c - W < W ? c - W : c % W;
        }
      } else {
        const int pairs = bank_pairs(W);
        int c = (2 * warp) % W;
        for (int p = warp; p < (W - 1) / 2 + kReps / 2; p += kBankWarps) {
          const int c1 = c + 1 == W ? 0 : c + 1, c2 = c1 + 1 == W ? 0 : c1 + 1;
          const uint32_t e1 = xr[c1];
          bank[p * kBankRows + lane] = (uint32_t)xr[c] | e1 << 16;
          bank[(pairs + p) * kBankRows + lane] = e1 | (uint32_t)xr[c2] << 16;
          c += 2 * kBankWarps;
          if (c >= W) c = c - W < W ? c - W : c % W;
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kIdxPerLane; ++e)
    if (r < rows && lane + 32 * e < cols) tile[r * kIdxStride + lane + 32 * e] = (uint32_t)iv[e];
  __syncthreads();
  // 3. the taps
  if (lane < rows && warp < cols)
    bank_taps<T>(bank, tile + lane * kIdxStride, lane, warp, cols, W);
  __syncthreads();
  // 4. the outputs, coalesced: warp r stores row r
  if (r < rows) {
    Bits* dst = reinterpret_cast<Bits*>(out) + (r0 + r) * W + c0;
#pragma unroll
    for (int e = 0; e < kIdxPerLane; ++e)
      if (lane + 32 * e < cols) dst[lane + 32 * e] = (Bits)tile[r * kIdxStride + lane + 32 * e];
  }
}

// grid (ceil(S / R), ceil(W / C)), kRowsThreads threads: R rows of x staged
// row-major with their first 63 values after them, shared by the block's
// threads; thread t takes the block's outputs t, t + kRowsThreads, ... in
// row-major order.
template <typename T>
__global__ void __launch_bounds__(kRowsThreads)
lane_gather_rows_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                        T* __restrict__ out, int S, int W, int R, int C) {
  using Bits = typename BitsOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  Bits* s = reinterpret_cast<Bits*>(smem);  // s[R][W + 63]
  const Bits* xb = reinterpret_cast<const Bits*>(x);
  const int ws = W + kReps - 1;
  const int64_t r0 = (int64_t)blockIdx.x * R;
  const int c0 = blockIdx.y * C;
  const int rows = (int)min((int64_t)R, S - r0), cols = min(C, W - c0);
  const int n = rows * cols;
  int e = threadIdx.x, r = e / cols, o = e - r * cols;
  int v = e < n ? __ldg(idx + (r0 + r) * W + c0 + o) : 0;  // in flight while the rows load
  for (int m = threadIdx.x; m < rows * ws; m += kRowsThreads) {
    const int mr = m / ws, mc = m - mr * ws;
    s[m] = __ldg(xb + (r0 + mr) * W + (mc < W ? mc : mc % W));
  }
  __syncthreads();
  while (e < n) {
    const int en = e + kRowsThreads;
    int rn = 0, on = 0, vn = 0;
    if (en < n) {  // the next index in flight during these taps
      rn = en / cols;
      on = en - rn * cols;
      vn = __ldg(idx + (r0 + rn) * W + c0 + on);
    }
    const Bits* p = s + r * ws + tap_start(v, W);
    Bits* dst = reinterpret_cast<Bits*>(out) + (r0 + r) * W + c0 + o;
    if constexpr (sizeof(T) == 4) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kReps; ++k) acc = __fadd_rn(acc, __uint_as_float(p[k]));
      *dst = __float_as_uint(acc);
    } else {
      uint32_t acc = 0;  // the sum in the low half
#pragma unroll
      for (int k = 0; k < kReps; ++k) acc = add_bf16x2(acc, p[k]);
      *dst = (Bits)acc;
    }
    e = en;
    r = rn;
    o = on;
    v = vn;
  }
}

// grid ceil(L / 32), 32 * min(S, kSubWarps) threads: the block's columns
// c0 + l (lane l's), its warps' output rows warp, warp + warps, ...; s[m][32]
// holds lane l's column in bank l, a value a word.
template <typename T>
__global__ void __launch_bounds__(kSubWarps * 32)
sublane_gather_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                      T* __restrict__ out, int S, int64_t L) {
  using Bits = typename BitsOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem);
  const Bits* xb = reinterpret_cast<const Bits*>(x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int64_t c = (int64_t)blockIdx.x * 32 + lane;
  const bool live = c < L;
  int v = live ? __ldg(idx + warp * L + c) : 0;  // in flight while the column loads
  if (live) {
    // each value once from device memory, into every slot m = r (mod S), m < S + 63
    for (int r = warp; r < S; r += warps) {
      const uint32_t val = __ldg(xb + r * L + c);
#pragma unroll 4
      for (int m = r; m < S + kReps - 1; m += S) s[m * 32 + lane] = val;
    }
  }
  __syncthreads();
  if (!live) return;
  for (int r = warp; r < S; r += warps) {
    if (r != warp) v = __ldg(idx + r * L + c);
    const uint32_t* p = s + tap_start(v, S) * 32 + lane;
    Bits* dst = reinterpret_cast<Bits*>(out) + r * L + c;
    if constexpr (sizeof(T) == 4) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kReps; ++k) acc = __fadd_rn(acc, __uint_as_float(p[k * 32]));
      *dst = __float_as_uint(acc);
    } else {
      uint32_t acc = 0;  // the sum in the low half
#pragma unroll
      for (int k = 0; k < kReps; ++k) acc = add_bf16x2(acc, p[k * 32]);
      *dst = (Bits)acc;
    }
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


// how a block gather launches: which kernel (0 lane_gather_kernel, 1
// lane_gather_rows_kernel, 2 sublane_gather_kernel), its grid, block and
// dynamic shared memory, and lane_gather_rows_kernel's rows and columns a block
struct Plan {
  int variant;
  dim3 grid;
  int threads;
  size_t smem;
  int rows, cols;
};

// the current device's SMs, read once a device
int sm_count() {
  static std::atomic<int> count[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int n = count[dev & 63].load(std::memory_order_relaxed);
  if (n == 0 && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
    count[dev & 63].store(n, std::memory_order_relaxed);
  return n;
}

template <typename T>
Plan plan_lane(int S, int W) {
  Plan p{};
  const int sms = sm_count();
  const int64_t row_groups = ((int64_t)S + kBankRows - 1) / kBankRows;
  const int col_groups = (W + kBankCols - 1) / kBankCols;
  if (W <= kBankMaxW && 2 * row_groups * col_groups >= sms) {
    p.variant = 0;
    p.grid = dim3((unsigned)row_groups, col_groups);
    p.threads = kBankThreads;
    p.smem = bank_smem<T>(W);
    return p;
  }
  // about one output a thread: as many rows as that takes (one at least,
  // as many as fit), then the columns split until there are two blocks an SM
  const int ws = W + kReps - 1;
  const int rows =
      std::max(1, std::min({S, kRowsThreads / W, kRowsSmem / (ws * (int)sizeof(T))}));
  const int row_blocks = (S + rows - 1) / rows;
  const int splits = std::max(1, std::min((2 * sms + row_blocks - 1) / row_blocks,
                                          (W + kRowsThreads - 1) / kRowsThreads));
  p.variant = 1;
  p.rows = rows;
  p.cols = (W + splits - 1) / splits;
  p.grid = dim3((unsigned)row_blocks, (W + p.cols - 1) / p.cols);
  p.threads = kRowsThreads;
  p.smem = (size_t)rows * ws * sizeof(T);
  return p;
}

template <typename T>
Plan plan_sublane(int S, int L) {
  Plan p{};
  p.variant = 2;
  p.grid = dim3((unsigned)((L + 31) / 32));
  p.threads = 32 * std::min(S, kSubWarps);
  p.smem = (size_t)(S + kReps - 1) * 32 * sizeof(float);
  return p;
}

template <typename T>
const void* kernel_of(int variant) {
  if (variant == 0) return reinterpret_cast<const void*>(lane_gather_kernel<T>);
  if (variant == 1) return reinterpret_cast<const void*>(lane_gather_rows_kernel<T>);
  return reinterpret_cast<const void*>(sublane_gather_kernel<T>);
}

// above the default 48 KB of shared memory a block, the kernel must allow it
// (the attribute is per device; set once for the most a launch has asked)
template <typename T>
cudaError_t allow_smem(const Plan& p) {
  static std::atomic<size_t> allowed[64][3];  // by device and kernel
  if (p.smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaGetDevice(&dev);
  std::atomic<size_t>& a = allowed[dev & 63][p.variant];
  if (p.smem <= a.load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel_of<T>(p.variant), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err == cudaSuccess) a.store(p.smem, std::memory_order_relaxed);
  return err;
}

template <typename T>
cudaError_t launch_block(const Plan& p, const void* x, const int* idx, void* out, int S, int W,
                         cudaStream_t stream) {
  const cudaError_t err = allow_smem<T>(p);
  if (err != cudaSuccess) return err;
  const T* xs = static_cast<const T*>(x);
  T* os = static_cast<T*>(out);
  if (p.variant == 0)
    lane_gather_kernel<T><<<p.grid, p.threads, p.smem, stream>>>(xs, idx, os, S, W);
  else if (p.variant == 1)
    lane_gather_rows_kernel<T><<<p.grid, p.threads, p.smem, stream>>>(xs, idx, os, S, W, p.rows,
                                                                      p.cols);
  else
    sublane_gather_kernel<T><<<p.grid, p.threads, p.smem, stream>>>(xs, idx, os, S, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int kind, const void* x, const int* idx, void* out, int S, int W,
                   cudaStream_t stream) {
  return launch_block<T>(kind == 0 ? plan_lane<T>(S, W) : plan_sublane<T>(S, W), x, idx, out, S,
                         W, stream);
}

// plan[0..7]: variant, threads, dynamic shared bytes, grid x, grid y, blocks an
// SM holds (the occupancy calculator's), registers and local (spill) bytes a thread
template <typename T>
cudaError_t describe(int kind, int S, int W, int* plan) {
  const Plan p = kind == 0 ? plan_lane<T>(S, W) : plan_sublane<T>(S, W);
  cudaError_t err = allow_smem<T>(p);
  int blocks = 0;
  cudaFuncAttributes attr{};
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel_of<T>(p.variant),
                                                        p.threads, p.smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel_of<T>(p.variant));
  const int values[8] = {p.variant, p.threads, (int)p.smem, (int)p.grid.x, (int)p.grid.y,
                         blocks, attr.numRegs, (int)attr.localSizeBytes};
  for (int i = 0; i < 8; ++i) plan[i] = values[i];
  return err;
}

// (S, W) checked as the entries check them; kind 0 = lane, 1 = sublane
bool block_shape_ok(int kind, int S, int W) {
  return S > 0 && W > 0 && (kind == 0 ? W <= 4096 : S <= 64);
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
// 4096 (lane_gather_rows_kernel stages a row and its first 63 values in 48 KB).
extern "C" int lane_gather(const void* x, const void* idx, void* out, int S, int W, int dtype,
                           void* stream) {
  if (!block_shape_ok(0, S, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  switch (dtype) {
    case 0: return (int)launch<float>(0, x, ix, out, S, W, s);
    case 1: return (int)launch<__nv_bfloat16>(0, x, ix, out, S, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x, out (S, L) of dtype 0 = float32 / 1 = bfloat16, idx (S, L) int32; S at most 64.
extern "C" int sublane_gather(const void* x, const void* idx, void* out, int S, int L,
                              int dtype, void* stream) {
  if (!block_shape_ok(1, S, L)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  switch (dtype) {
    case 0: return (int)launch<float>(1, x, ix, out, S, L, s);
    case 1: return (int)launch<__nv_bfloat16>(1, x, ix, out, S, L, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// How lane_gather (kind 0) or sublane_gather (kind 1) launches at (S, W), into
// plan[8]: kernel (0 lane_gather_kernel, 1 lane_gather_rows_kernel, 2
// sublane_gather_kernel), threads a block, dynamic shared memory a block in
// bytes, grid x, grid y, blocks an SM holds, registers a thread, local (spill)
// bytes a thread.  Launches nothing.
extern "C" int block_gather_plan(int kind, int S, int W, int dtype, void* plan) {
  if ((kind != 0 && kind != 1) || !block_shape_ok(kind, S, W)) return (int)cudaErrorInvalidValue;
  int* out = static_cast<int*>(plan);
  switch (dtype) {
    case 0: return (int)describe<float>(kind, S, W, out);
    case 1: return (int)describe<__nv_bfloat16>(kind, S, W, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
