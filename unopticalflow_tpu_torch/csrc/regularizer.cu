// Fused smoothness + consistency regularizer of one loss scale, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of unopticalflow_tpu/ops/pallas_regularizer.py:
// _reg_fwd_kernel (with _smooth_terms, _consis_terms) and _reg_bwd_kernel
// (with _smooth_dflow, _consis_dflow).
//
// Per sample b and packed half d (bwd = flow_b, fwd = flow_f), with
// g = flow * 0.05f on the (B, 2, H, W) float32 flows and the center image
// `img` (B, 3, H, W):
//   wx[i, m]  = exp(-10 mean_c |img[c, i, m+1] - img[c, i, m]|)   (wy along rows)
//   D2x[i, j] = (g[i, j+2] - g[i, j+1]) - (g[i, j+1] - g[i, j])    (D2y along rows)
//   S_sx[d]   = sum_c sum_{i, j <= W-3} wx[i, j+1] |D2x_c[i, j]|
//   S_sy[d]   = sum_c sum_{i <= H-3, j} wy[i+1, j] |D2y_c[i, j]|
//   S_c       = sum_p |n(f_fwd) + n(f_bwd)|_1 (1 - w_fwd),  n(f) = f / (sqrt(f.f + 1e-24) + 1e-12)
// The forward writes the five sums of each sample (S_sx of bwd, of fwd, S_sy
// of bwd, of fwd, S_c): per-block partial sums, added in a fixed order by the
// last block of the sample to finish (no floating-point atomics).  The
// backward gives d(flow_b), d(flow_f) only, in gather form (no atomics):
//   d g = D2^T (cot * w * sign(D2 g)) per axis, d flow = 0.05 d g,
// plus the consistency term to flow_f only (flow_b is detached there):
//   d f = cot * occ * (sgn(r) / (N + e) - f (sgn(r).f) / (N (N + e)^2)),  sign(0) = 0.
//
// Rounding: the second differences of upsampled flows vanish exactly over
// large areas, where sign(0) = 0 and a rounding difference would give +-w.
// So g is the correctly rounded product flow * 0.05f (__fmul_rn: never fused
// into an FMA with the difference that follows) and the differences are taken
// in the plain version's order, which makes D2 bit-identical to
// ops/regularizer.py::regularizer_pack_reference on the same device.  The
// consistency term keeps the plain version's IEEE divisions and square roots,
// whose signs set the gradient's zeros.  The backward's roundings are written
// out (__fmaf_rn, __fmul_rn) as nvcc compiled the first design, one thread a
// position, so d(flow) has that design's bits.
//
// What bounds it on the card: per position 32 bytes read by the forward (4
// flow values, 3 image values, 1 weight) and 16 more written by the backward,
// against about 120 and 200 flops: bound by memory, far from the FP32 rate,
// as long as nothing is computed twice and the loads of a tile are in flight
// together.  Design: a 256-thread block owns a 16 x 32 tile of one sample,
// each thread a chunk of 2 horizontally adjacent positions, both halves in
// one block (the consistency term needs both).  The chunks of the stencils'
// 2-position halo are the tile's own size, so the block stages 1.20x (forward:
// 2 rows below, a chunk right) and 1.41x (backward: 2 rows above and below, a
// chunk on each side) its positions.  A thread issues all its loads of a tile
// at once, the own chunk and its share of the halo's, each one vector load
// (float2, or bf16x2 for the image and weights, where W is even and the
// pointers aligned; else scalar loads), then stores g = flow * 0.05f and the
// image, widened to float32, in shared memory; it keeps its own raw flows and
// weights for the consistency term.  Forward: each position's two stencil
// terms are evaluated once (with the fast exponential: its sums only need
// their tolerance); the five sums are reduced by warp shuffles and one
// barrier, and the last block of each sample (an integer counter) adds the
// tiles' partial sums, so a call is one launch and two calls give the same
// bits.  Backward, in two phases: phase one evaluates every anchor of the
// tile and of its 2-position ring above and to the left once (the edge weight
// and the sign of D2 of the four flow components: 2.19 anchors a position,
// against the first design's 6 edge weights and 12 second differences a
// position) as the signed weights w * sign(D2), exact, which then replace the
// staged inputs in shared memory; phase two gathers each output's 3 + 3
// anchors with the coefficients (+1, -2, +1) in the order t = 0, 1, 2.  The
// consistency term is computed while the tile's loads land.  Shared memory:
// forward 17.3 KB, backward 20.2 KB a block; registers capped for 6 and 5
// blocks of 256 an SM.  Indices are 32-bit (the wrapper bounds B * 3 * H * W
// below 2^31).
//
// Halo-prepadded variants (HPAD = true).  One row-shard of a height-sharded
// model (parallel/spatial.py) computes the sums of the terms it owns.  Its
// flows and image carry one row of halo on each side (operand rows 0 .. H-1,
// the owned rows 1 .. H-2; rows outside the image are zeros), operand row k
// is global row y0 + k, and the image is HS rows tall; w_fwd holds the owned
// rows only.  A term along rows spans three rows and belongs to the shard
// that owns its middle row (the row of its edge weight wy), where its global
// top row lies in [0, HS - 3]; the terms along a row and the consistency
// term belong to the row's shard.  So every term is counted once over the
// shards, and one halo row each side is all a shard reads.  The forward tiles
// the owned rows and stages one row above and one below (the whole map's
// forward stages two below: its y term starts at the position's row, the
// shard's is centred there); the backward tiles every operand row and writes
// d(flow) for all of them, the halo rows' from the owned terms that reach
// them.  HPAD = false is the whole map: lo = 0, hi = H, y0 = 0, HS = H.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <utility>

namespace {

constexpr int TW = 32;           // tile width: 16 chunks of 2 positions
constexpr int TH = 16;           // tile height
constexpr int TC = TW / 2;       // chunks a tile row
constexpr int NT = TC * TH;      // threads: one chunk each
constexpr float kInv20 = 1.0f / 20.0f;  // 0.05f: ops/regularizer.py's INV20
constexpr float kEpsN = 1e-12f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// (g2 - g1) - (g1 - g0), rounded as the plain version rounds
__device__ __forceinline__ float d2(float g0, float g1, float g2) {
  return __fsub_rn(__fsub_rn(g2, g1), __fsub_rn(g1, g0));
}

__device__ __forceinline__ float sgn(float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f); }

// exp(-10 mean_c |b_c - a_c|), the channels added in order 0, 1, 2
__device__ __forceinline__ float edge_w(float a0, float a1, float a2, float b0, float b1,
                                        float b2) {
  const float m = (fabsf(b0 - a0) + fabsf(b1 - a1) + fabsf(b2 - a2)) / 3.f;
  return expf(-10.f * m);
}

// sqrt(u^2 + v^2 + 1e-24) in the plain version's order, no FMA
__device__ __forceinline__ float norm_of(float u, float v) {
  return sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(u, u), __fmul_rn(v, v)), 1e-24f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// p[0], p[1] as float32, p[e] for e >= n as 0.  Where vec, n is 0 or 2 and p
// is aligned to two elements: one 8-byte (float) or 4-byte (bfloat16) load.
__device__ __forceinline__ float2 load2(const float* p, bool vec, int n) {
  if (vec) return n > 0 ? *reinterpret_cast<const float2*>(p) : make_float2(0.f, 0.f);
  return make_float2(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p, bool vec, int n) {
  if (vec) {
    if (n == 0) return make_float2(0.f, 0.f);
    const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(p);
    return make_float2(__low2float(t), __high2float(t));
  }
  return make_float2(n > 0 ? to_f32(p[0]) : 0.f, n > 1 ? to_f32(p[1]) : 0.f);
}

__device__ __forceinline__ void store2(float* p, bool vec, int n, float2 v) {
  if (vec) {
    if (n > 0) *reinterpret_cast<float2*>(p) = v;
    return;
  }
  if (n > 0) p[0] = v.x;
  if (n > 1) p[1] = v.y;
}

__device__ __forceinline__ float2 scale_g(float2 f) {
  return make_float2(__fmul_rn(f.x, kInv20), __fmul_rn(f.y, kInv20));
}

__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The operand rows a kernel owns, [lo, hi), and which terms it counts (see the
// halo-prepadded variants above).
template <bool HPAD>
struct Rows {
  int lo, hi, hs, y0;
  __device__ __forceinline__ Rows(int H, int HS, int Y0)
      : lo(HPAD ? 1 : 0), hi(HPAD ? H - 1 : H), hs(HPAD ? HS : H), y0(HPAD ? Y0 : 0) {}
  __device__ __forceinline__ bool owned(int k) const { return k >= lo && k < hi; }
  // the y term whose window starts at operand row a: its middle row owned, its
  // rows inside the image
  __device__ __forceinline__ bool y_term(int a) const {
    return owned(a + 1) && y0 + a >= 0 && y0 + a <= hs - 3;
  }
};

// Positions of the chunk at (gy, gx .. gx + 1) inside the image.
__device__ __forceinline__ int chunk_len(int gy, int gx, int H, int W) {
  return gy >= 0 && gy < H && gx >= 0 && gx < W ? min(W - gx, 2) : 0;
}

// The staged region of a block: its tile, TOP rows above, BOT below, LEFT
// chunks left and RIGHT right of it, row stride S = 2 * (LEFT + TC + RIGHT)
// floats, one plane P floats; planes 0-3 g of bwd u, v, fwd u, v, planes 4-6
// the image.  Zeros outside the image.
template <int TOP, int BOT, int LEFT, int RIGHT>
struct Stage {
  static constexpr int CW = LEFT + TC + RIGHT;  // chunks a staged row
  static constexpr int S = 2 * CW;
  static constexpr int R = TOP + TH + BOT;
  static constexpr int P = R * S;
  static constexpr int FLOATS = 7 * P;
  static constexpr int RING = (TOP + BOT) * CW + TH * (LEFT + RIGHT);  // chunks off the tile
  static constexpr int PER = (7 * RING + NT - 1) / NT;  // ring (plane, chunk) loads a thread

  // Staged (row, chunk) of the ring's chunk i.
  static __device__ __forceinline__ void ring_pos(int i, int& sr, int& sc) {
    if (i < (TOP + BOT) * CW) {
      const int rr = i / CW;
      sr = rr < TOP ? rr : TH + rr;
      sc = i % CW;
    } else {
      const int k = i - (TOP + BOT) * CW;
      sr = TOP + k / (LEFT + RIGHT);
      const int side = k % (LEFT + RIGHT);
      sc = side < LEFT ? side : TC + side;
    }
  }

  // What a thread loads of one tile: its own chunk (tile row r, chunk c) of
  // the raw flows (bwd u, v, fwd u, v), the image and the weights (where its
  // row is owned: w_fwd holds the owned rows from operand row lo), and its
  // share of the ring's (plane, chunk)s, g already scaled.
  struct Loads {
    float2 f[4], im[3], wf, rv[PER];
    int rdst[PER];  // the ring values' offsets in the staged planes, -1 for none
    int n, p;       // the own chunk's positions in the image and its offset in a plane
  };

  // Issue every load of the tile at (ty0, tx0).
  template <typename T>
  static __device__ __forceinline__ void fetch(Loads& l, const float* fb, const float* ff,
                                               const T* im, const T* wf, int H, int W, int ty0,
                                               int tx0, int r, int c, int tid, bool vec,
                                               int lo, int hi) {
    const int plane = H * W;
    l.n = chunk_len(ty0 + r, tx0 + 2 * c, H, W);
    l.p = l.n > 0 ? (ty0 + r) * W + tx0 + 2 * c : 0;
    l.f[0] = load2(fb + l.p, vec, l.n);
    l.f[1] = load2(fb + plane + l.p, vec, l.n);
    l.f[2] = load2(ff + l.p, vec, l.n);
    l.f[3] = load2(ff + plane + l.p, vec, l.n);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) l.im[ch] = load2(im + ch * plane + l.p, vec, l.n);
    const bool own = ty0 + r >= lo && ty0 + r < hi;
    l.wf = load2(wf + (own ? l.p - lo * W : 0), vec, own ? l.n : 0);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = tid + k * NT;  // plane i / RING, chunk i % RING
      l.rdst[k] = -1;
      if (i >= 7 * RING) continue;
      const int q = i / RING;
      int sr, sc;
      ring_pos(i % RING, sr, sc);
      const int gy = ty0 - TOP + sr, gx = tx0 + 2 * (sc - LEFT);
      const int rn = chunk_len(gy, gx, H, W);
      const int rp = rn > 0 ? gy * W + gx : 0;
      l.rv[k] = q < 4 ? scale_g(load2((q < 2 ? fb : ff) + (q & 1) * plane + rp, vec, rn))
                      : load2(im + (q - 4) * plane + rp, vec, rn);
      l.rdst[k] = q * P + sr * S + 2 * sc;
    }
  }

  // Store the tile's loads into the staged planes.
  static __device__ __forceinline__ void put(float* s, const Loads& l, int r, int c) {
    float* own = s + (TOP + r) * S + 2 * (LEFT + c);
#pragma unroll
    for (int q = 0; q < 4; ++q) *reinterpret_cast<float2*>(own + q * P) = scale_g(l.f[q]);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) *reinterpret_cast<float2*>(own + (4 + ch) * P) = l.im[ch];
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (l.rdst[k] >= 0) *reinterpret_cast<float2*>(s + l.rdst[k]) = l.rv[k];
  }
};

// The mean |difference| over the 3 image planes of the edges a stencil window
// holds: at staged row `k` (a row offset into plane 4), the x edges of
// columns 1..2 and 2..3 of the window (x[0..3]) and the y edges of rows 1..2
// at columns 0, 1; channels added in order 0, 1, 2 as edge_w adds them.
// kx: the x window's row, ky: the y window's first row (the same row in the
// whole map's form).
template <int S, int P>
__device__ __forceinline__ void edge_sums(const float* kx, const float* ky, float (&mx)[2],
                                          float (&my)[2]) {
  mx[0] = mx[1] = my[0] = my[1] = 0.f;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float* sx = kx + (4 + ch) * P;
    const float* sy = ky + (4 + ch) * P;
    const float2 a = lds2(sx), a2 = lds2(sx + 2);
    const float2 y1 = lds2(sy + S), y2 = lds2(sy + 2 * S);
    mx[0] += fabsf(a2.x - a.y);  // the edge from window column 1 to 2
    mx[1] += fabsf(a2.y - a2.x);
    my[0] += fabsf(y2.x - y1.x);
    my[1] += fabsf(y2.y - y1.y);
  }
}

// ---- forward ------------------------------------------------------------------

// The stencils reach 2 positions right and down (the y window from the
// position's row); a shard's y window is centred on the position's row.
template <bool HPAD>
using FwdStage = Stage<HPAD ? 1 : 0, HPAD ? 1 : 2, 0, 1>;

template <typename T, bool HPAD>
__global__ void __launch_bounds__(NT, 6)
reg_fwd_kernel(const float* __restrict__ flow_b, const float* __restrict__ flow_f,
               const T* __restrict__ img, const T* __restrict__ w_fwd,
               float* __restrict__ sums_out, int* __restrict__ counters,
               float* __restrict__ partials, int B, int H, int W, int HS, int Y0, bool vec) {
  using Stg = FwdStage<HPAD>;
  constexpr int S = Stg::S, P = Stg::P, TOP = HPAD ? 1 : 0;
  __shared__ __align__(16) float s[Stg::FLOATS];
  __shared__ float red[NT / 32][5];
  __shared__ int last;
  const Rows<HPAD> span(H, HS, Y0);
  const int b = blockIdx.z;
  const int tx0 = blockIdx.x * TW, ty0 = span.lo + blockIdx.y * TH;
  const int tid = threadIdx.x;
  const int r = tid / TC, c = tid % TC;
  const int plane = H * W;
  float sums[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // sx of half d at d, sy at 2 + d, consis at 4

  typename Stg::Loads l;
  Stg::fetch(l, flow_b + b * 2 * plane, flow_f + b * 2 * plane, img + b * 3 * plane,
             w_fwd + b * (span.hi - span.lo) * W, H, W, ty0, tx0, r, c, tid, vec, span.lo,
             span.hi);
  const int gy = ty0 + r, gx = tx0 + 2 * c;
  const bool own = gy < span.hi;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (e >= l.n || !own) continue;
    const float ub = e ? l.f[0].y : l.f[0].x, vb = e ? l.f[1].y : l.f[1].x;
    const float uf = e ? l.f[2].y : l.f[2].x, vf = e ? l.f[3].y : l.f[3].x;
    const float den_b = norm_of(ub, vb) + kEpsN;
    const float den_f = norm_of(uf, vf) + kEpsN;
    const float ru = uf / den_f + ub / den_b;
    const float rv = vf / den_f + vb / den_b;
    sums[4] += (fabsf(ru) + fabsf(rv)) * (1.f - (e ? l.wf.y : l.wf.x));
  }
  Stg::put(s, l, r, c);
  __syncthreads();

  // the own positions (gy, gx + e) of owned rows: x terms where gx + e <= W -
  // 3, the y term whose window starts TOP rows above where Rows::y_term.
  // Staged row TOP + r holds gy, column 2c + e holds gx + e.  The sums only
  // need their tolerance, so the edge weights here take the fast exponential
  // (the backward's are edge_w's, which its bits rest on).
  const float* sk = s + (TOP + r) * S + 2 * c;  // the x window's row
  const float* sw = s + r * S + 2 * c;          // the y window's first row
  const bool xin = own && l.n > 0, yin = span.y_term(gy - TOP);
  float wx[2], wy[2];
  {
    float mx[2], my[2];
    edge_sums<S, P>(sk, sw, mx, my);
    // wx[i, j+1]: the edge j+1 -> j+2; wy[i+1, j]: the edge i+1 -> i+2
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      wx[e] = __expf(-10.f / 3.f * mx[e]);
      wy[e] = __expf(-10.f / 3.f * my[e]);
    }
  }
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    float ax[2] = {0.f, 0.f}, ay[2] = {0.f, 0.f};
#pragma unroll
    for (int q = 2 * d; q < 2 * d + 2; ++q) {
      const float* sg = sk + q * P;
      const float* sv = sw + q * P;
      const float2 a = lds2(sg), a2 = lds2(sg + 2);
      const float2 y0 = lds2(sv), y1 = lds2(sv + S), y2 = lds2(sv + 2 * S);
      ax[0] += fabsf(d2(a.x, a.y, a2.x));
      ax[1] += fabsf(d2(a.y, a2.x, a2.y));
      ay[0] += fabsf(d2(y0.x, y1.x, y2.x));
      ay[1] += fabsf(d2(y0.y, y1.y, y2.y));
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (xin && gx + e <= W - 3) sums[d] += wx[e] * ax[e];
      if (yin && gx + e < W) sums[2 + d] += wy[e] * ay[e];
    }
  }

  // the five block sums: warp shuffles, one barrier, then one thread per sum
  const int lane = tid & 31, wid = tid >> 5;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float v = warp_sum(sums[k]);
    if (lane == 0) red[wid][k] = v;
  }
  __syncthreads();
  const int tiles = gridDim.x * gridDim.y;
  if (tid < 5) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) t += red[w][tid];
    partials[(tid * B + b) * tiles + blockIdx.y * gridDim.x + blockIdx.x] = t;
    __threadfence();  // the partial is visible before the block is counted
  }
  // the last block of the sample to finish adds its tiles' partial sums, one
  // warp a sum, in an order that does not depend on which block that is
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + b, 1) == tiles - 1;
  __syncthreads();
  if (!last) return;
  for (int k = wid; k < 5; k += NT / 32) {
    const float* src = partials + (k * B + b) * tiles;
    float t = 0.f;
    for (int i = lane; i < tiles; i += 32) t += __ldcg(src + i);
    t = warp_sum(t);
    if (lane == 0) sums_out[k * B + b] = t;
  }
}

// ---- backward -----------------------------------------------------------------

using BwdStage = Stage<2, 2, 1, 1>;  // D2^T reaches 2 positions every way
// Phase one's signed weights w * sign(D2) of component q (bwd u, v, fwd u, v),
// over the staged inputs once those are read: x anchors (i, a) for the tile's
// rows and a in [tx0 - 2, tx0 + TW), at column a - tx0 + 2 of a row of AXS;
// y anchors for i in [ty0 - 2, ty0 + TH) and the tile's columns, at row i - ty0 + 2.
constexpr int AXS = TW + 2;
constexpr int AX = 0, AY = 4 * TH * AXS;
constexpr int ANCHOR_FLOATS = AY + 4 * (TH + 2) * TW;
static_assert(ANCHOR_FLOATS <= BwdStage::FLOATS, "the anchors reuse the staged inputs' memory");
constexpr int XRING = 2 * TH, YRING = 2 * TW;  // anchors of the ring left of and above the tile
constexpr int RPER = (XRING + YRING + NT - 1) / NT;  // ring anchors a thread

// The roundings below are the first design's as nvcc compiled it (its SASS),
// written out so that d(flow) keeps those bits wherever the code sits.
//   consistency: cot * (sgn(r_u) / (N + e) - u_f (sgn(r).f) / (N (N + e)^2)),
//     as cot * fma(su, inv, -(uf * q)), every product rounded
__device__ __forceinline__ void consis_dflow(float ub, float vb, float uf, float vf, float w,
                                             float gc, float& cu, float& cv) {
  const float nf = norm_of(uf, vf);
  const float den_b = norm_of(ub, vb) + kEpsN;
  const float den_f = nf + kEpsN;
  const float su = sgn(uf / den_f + ub / den_b);
  const float sv = sgn(vf / den_f + vb / den_b);
  const float inv = 1.f / den_f;
  const float dot = su * uf + sv * vf;  // exact products: su, sv in {-1, 0, 1}
  const float cot = __fmul_rn(gc, 1.f - w);
  const float q = __fmul_rn(__fmul_rn(dot, inv), inv) / nf;
  cu = __fmul_rn(cot, __fmaf_rn(su, inv, -__fmul_rn(uf, q)));
  cv = __fmul_rn(cot, __fmaf_rn(sv, inv, -__fmul_rn(vf, q)));
}

//   smoothness: a = fma(cx, D2x^T, cy * D2y^T); d flow_b = a * 0.05 and
//     d flow_f = fma(a, 0.05, consistency)
__device__ __forceinline__ float smooth_dflow(float cx, float sx, float cy, float sy, float cons,
                                              bool with_cons) {
  const float a = __fmaf_rn(cx, sx, __fmul_rn(cy, sy));
  return with_cons ? __fmaf_rn(a, kInv20, cons) : __fmul_rn(a, kInv20);
}

// The four signed weights of the x anchor at staged (row sr, column sc), or
// of the y anchor (row sr, column sc) when Y; zeros where `in` is false.
template <bool Y>
__device__ __forceinline__ void anchor(const float* s, int sr, int sc, bool in, float (&out)[4]) {
  constexpr int S = BwdStage::S, P = BwdStage::P;
  constexpr int step = Y ? S : 1;
  const float* a = s + sr * S + sc;
  const float w = edge_w(a[4 * P + step], a[5 * P + step], a[6 * P + step], a[4 * P + 2 * step],
                         a[5 * P + 2 * step], a[6 * P + 2 * step]);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    out[q] = in ? w * sgn(d2(a[q * P], a[q * P + step], a[q * P + 2 * step])) : 0.f;
}

template <typename T, bool HPAD>
__global__ void __launch_bounds__(NT, 5)
reg_bwd_kernel(const float* __restrict__ flow_b, const float* __restrict__ flow_f,
               const T* __restrict__ img, const T* __restrict__ w_fwd,
               const float* __restrict__ g_sx, const float* __restrict__ g_sy,
               const float* __restrict__ g_c, float* __restrict__ dflow_b,
               float* __restrict__ dflow_f, int B, int H, int W, int HS, int Y0, bool vec) {
  constexpr int S = BwdStage::S, P = BwdStage::P;
  __shared__ __align__(16) float s[BwdStage::FLOATS];
  const Rows<HPAD> span(H, HS, Y0);
  const int b = blockIdx.z;
  const int tx0 = blockIdx.x * TW, ty0 = blockIdx.y * TH;
  const int tid = threadIdx.x;
  const int r = tid / TC, c = tid % TC;
  const int plane = H * W;
  const int gy = ty0 + r, gx = tx0 + 2 * c;

  BwdStage::Loads l;
  BwdStage::fetch(l, flow_b + b * 2 * plane, flow_f + b * 2 * plane, img + b * 3 * plane,
                  w_fwd + b * (span.hi - span.lo) * W, H, W, ty0, tx0, r, c, tid, vec, span.lo,
                  span.hi);
  const int n = l.n, p = l.p;
  // the consistency term's part of d(flow_f) at the own positions (owned rows)
  float cu[2] = {0.f, 0.f}, cv[2] = {0.f, 0.f};
  if (span.owned(gy)) {
    const float gc = g_c[b];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float ub = e ? l.f[0].y : l.f[0].x, vb = e ? l.f[1].y : l.f[1].x;
      const float uf = e ? l.f[2].y : l.f[2].x, vf = e ? l.f[3].y : l.f[3].x;
      consis_dflow(ub, vb, uf, vf, e ? l.wf.y : l.wf.x, gc, cu[e], cv[e]);
    }
  }
  BwdStage::put(s, l, r, c);
  __syncthreads();

  // phase one: the own positions' x and y anchors (staged row r + 2, columns
  // 2c + 2 + e; the x stencil reads that row to column 2c + 5, the y stencil
  // rows r + 3 and r + 4), then the ring's anchors
  float ax[2][4], ay[2][4], ring[RPER][4];  // [e][component]
  {
    const float* sk = s + (r + 2) * S + 2 * c + 2;
    float mx[2], my[2];
    edge_sums<S, P>(sk, sk, mx, my);
    float wx[2], wy[2];
    const bool xin = span.owned(gy), yin = span.y_term(gy);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      wx[e] = xin && gx + e <= W - 3 ? expf(-10.f * (mx[e] / 3.f)) : 0.f;
      wy[e] = yin && gx + e < W ? expf(-10.f * (my[e] / 3.f)) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* sg = sk + q * P;
      const float2 a = lds2(sg), a2 = lds2(sg + 2);
      const float2 y1 = lds2(sg + S), y2 = lds2(sg + 2 * S);
      ax[0][q] = wx[0] * sgn(d2(a.x, a.y, a2.x));
      ax[1][q] = wx[1] * sgn(d2(a.y, a2.x, a2.y));
      ay[0][q] = wy[0] * sgn(d2(a.x, y1.x, y2.x));
      ay[1][q] = wy[1] * sgn(d2(a.y, y1.y, y2.y));
    }
  }
#pragma unroll
  for (int k = 0; k < RPER; ++k) {
    const int i = tid + k * NT;
    if (i < XRING) {
      const int rr = i >> 1, a = tx0 - 2 + (i & 1);  // x anchor (ty0 + rr, a)
      anchor<false>(s, rr + 2, i & 1, span.owned(ty0 + rr) && a >= 0 && a <= W - 3, ring[k]);
    } else if (i < XRING + YRING) {
      const int j = i - XRING, a = ty0 - 2 + j / TW;  // y anchor (a, tx0 + j % TW)
      anchor<true>(s, j / TW, j % TW + 2, span.y_term(a) && tx0 + j % TW < W, ring[k]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    *reinterpret_cast<float2*>(s + AX + (q * TH + r) * AXS + 2 * c + 2) =
        make_float2(ax[0][q], ax[1][q]);
    *reinterpret_cast<float2*>(s + AY + (q * (TH + 2) + r + 2) * TW + 2 * c) =
        make_float2(ay[0][q], ay[1][q]);
#pragma unroll
    for (int k = 0; k < RPER; ++k) {
      const int i = tid + k * NT;
      if (i < XRING)
        s[AX + (q * TH + (i >> 1)) * AXS + (i & 1)] = ring[k][q];
      else if (i < XRING + YRING)
        s[AY + (q * (TH + 2) + (i - XRING) / TW) * TW + (i - XRING) % TW] = ring[k][q];
    }
  }
  __syncthreads();

  // phase two: output (gy, gx + e) sees the x anchors at gx + e - 2 + t and
  // the y anchors at gy - 2 + t with the coefficients +1, -2, +1 (t = 0, 1, 2)
  float xs[4][2], ys[4][2];  // [component][e]
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float* sx = s + AX + (q * TH + r) * AXS + 2 * c;
    const float2 a = lds2(sx), a2 = lds2(sx + 2);
    const float x[4] = {a.x, a.y, a2.x, a2.y};
    const float* sy = s + AY + (q * (TH + 2) + r) * TW + 2 * c;
    const float2 y0 = lds2(sy), y1 = lds2(sy + TW), y2 = lds2(sy + 2 * TW);
    const float yt[3][2] = {{y0.x, y0.y}, {y1.x, y1.y}, {y2.x, y2.y}};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float tx = 0.f, ty = 0.f;
      tx += x[e];
      tx = fmaf(-2.f, x[e + 1], tx);
      tx += x[e + 2];
      ty += yt[0][e];
      ty = fmaf(-2.f, yt[1][e], ty);
      ty += yt[2][e];
      xs[q][e] = tx;
      ys[q][e] = ty;
    }
  }

  // d flow = 0.05 (cx D2x^T + cy D2y^T), d flow_f plus the consistency term
  float du[2][2], dv[2][2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const float cx = g_sx[d * B + b], cy = g_sy[d * B + b];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      du[d][e] = smooth_dflow(cx, xs[2 * d][e], cy, ys[2 * d][e], cu[e], d == 1);
      dv[d][e] = smooth_dflow(cx, xs[2 * d + 1][e], cy, ys[2 * d + 1][e], cv[e], d == 1);
    }
  }
  float* ob = dflow_b + b * 2 * plane + p;
  float* of = dflow_f + b * 2 * plane + p;
  store2(ob, vec, n, make_float2(du[0][0], du[0][1]));
  store2(ob + plane, vec, n, make_float2(dv[0][0], dv[0][1]));
  store2(of, vec, n, make_float2(du[1][0], du[1][1]));
  store2(of + plane, vec, n, make_float2(dv[1][0], dv[1][1]));
}

// Whether every chunk can be read and written as one vector: W even (so the
// chunks start at even offsets) and every base pointer aligned to two elements.
bool chunks_align(int W, std::initializer_list<std::pair<const void*, int>> ptrs) {
  if (W % 2 != 0) return false;
  for (const auto& pe : ptrs)
    if (reinterpret_cast<uintptr_t>(pe.first) % (2 * pe.second) != 0) return false;
  return true;
}

dim3 grid_of(int B, int H, int W) { return dim3((W + TW - 1) / TW, (H + TH - 1) / TH, B); }

// work: [5][B] sums (the outputs), [B] int32 counters of finished tiles,
// [5][B][tiles] partial sums.  H: the operand's rows (the owned rows plus 2
// when HPAD), HS: the image's, Y0: the global row of operand row 0.
template <typename T, bool HPAD>
cudaError_t launch_fwd(const float* fb, const float* ff, const void* im, const void* wf,
                       float* work, int B, int H, int W, int HS, int Y0, cudaStream_t stream) {
  const int e = (int)sizeof(T);
  const bool vec = chunks_align(W, {{fb, 4}, {ff, 4}, {im, e}, {wf, e}});
  int* counters = reinterpret_cast<int*>(work + 5 * B);
  const cudaError_t err = cudaMemsetAsync(counters, 0, B * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  reg_fwd_kernel<T, HPAD><<<grid_of(B, HPAD ? H - 2 : H, W), NT, 0, stream>>>(
      fb, ff, static_cast<const T*>(im), static_cast<const T*>(wf), work, counters, work + 6 * B,
      B, H, W, HS, Y0, vec);
  return cudaGetLastError();
}

template <typename T, bool HPAD>
cudaError_t launch_bwd(const float* fb, const float* ff, const void* im, const void* wf,
                       const float* gsx, const float* gsy, const float* gc, float* dfb,
                       float* dff, int B, int H, int W, int HS, int Y0, cudaStream_t stream) {
  const int e = (int)sizeof(T);
  const bool vec = chunks_align(W, {{fb, 4}, {ff, 4}, {im, e}, {wf, e}, {dfb, 4}, {dff, 4}});
  reg_bwd_kernel<T, HPAD><<<grid_of(B, H, W), NT, 0, stream>>>(
      fb, ff, static_cast<const T*>(im), static_cast<const T*>(wf), gsx, gsy, gc, dfb, dff, B,
      H, W, HS, Y0, vec);
  return cudaGetLastError();
}

// The grid's y and z are capped at 65535; every index is 32-bit.
bool bad_shape(int B, int H, int W) {
  return B <= 0 || H <= 0 || W <= 0 || B > 65535 || (H + TH - 1) / TH > 65535 ||
         (int64_t)B * 3 * H * W >= (int64_t(1) << 31);
}

// A halo-prepadded operand of H rows holds at least one owned row.
bool bad_hpad_shape(int B, int H, int W, int HS) {
  return H < 3 || bad_shape(B, H, W) || bad_shape(B, HS, W);
}

template <bool HPAD>
int fwd(const void* flow_b, const void* flow_f, const void* img, const void* w_fwd, void* work,
        int B, int H, int W, int HS, int Y0, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb = static_cast<const float*>(flow_b);
  const float* ff = static_cast<const float*>(flow_f);
  float* w = static_cast<float*>(work);
  switch (dtype) {
    case 0: return (int)launch_fwd<float, HPAD>(fb, ff, img, w_fwd, w, B, H, W, HS, Y0, s);
    case 1:
      return (int)launch_fwd<__nv_bfloat16, HPAD>(fb, ff, img, w_fwd, w, B, H, W, HS, Y0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool HPAD>
int bwd(const void* flow_b, const void* flow_f, const void* img, const void* w_fwd,
        const void* g_sx, const void* g_sy, const void* g_c, void* dflow_b, void* dflow_f, int B,
        int H, int W, int HS, int Y0, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb = static_cast<const float*>(flow_b);
  const float* ff = static_cast<const float*>(flow_f);
  const float* gsx = static_cast<const float*>(g_sx);
  const float* gsy = static_cast<const float*>(g_sy);
  const float* gc = static_cast<const float*>(g_c);
  float* db = static_cast<float*>(dflow_b);
  float* df = static_cast<float*>(dflow_f);
  switch (dtype) {
    case 0:
      return (int)launch_bwd<float, HPAD>(fb, ff, img, w_fwd, gsx, gsy, gc, db, df, B, H, W, HS,
                                          Y0, s);
    case 1:
      return (int)launch_bwd<__nv_bfloat16, HPAD>(fb, ff, img, w_fwd, gsx, gsy, gc, db, df, B, H,
                                                  W, HS, Y0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Flows (B, 2, H, W) f32; image (B, 3, H, W) and w_fwd (B, 1, H, W) of dtype
// 0 = float32 / 1 = bfloat16.  work: a f32 workspace of 6B + 5B *
// ceil(H/16) * ceil(W/32) elements whose first 5B are the outputs: s_sx of
// bwd, of fwd, s_sy of bwd, of fwd, then s_consis, each (B,); the rest is the
// kernel's.  Returns the launch's cudaError_t (0 = success).
extern "C" int reg_fwd(const void* flow_b, const void* flow_f, const void* img,
                       const void* w_fwd, void* work, int B, int H, int W, int dtype,
                       void* stream) {
  if (bad_shape(B, H, W)) return (int)cudaErrorInvalidValue;
  return fwd<false>(flow_b, flow_f, img, w_fwd, work, B, H, W, H, 0, dtype, stream);
}

// g_sx, g_sy: (2B,) f32 gradients of s_sx and s_sy, [bwd; fwd]; g_c: (B,) of
// s_consis.  dflow_b, dflow_f: (B, 2, H, W) f32.
extern "C" int reg_bwd(const void* flow_b, const void* flow_f, const void* img,
                       const void* w_fwd, const void* g_sx, const void* g_sy, const void* g_c,
                       void* dflow_b, void* dflow_f, int B, int H, int W, int dtype,
                       void* stream) {
  if (bad_shape(B, H, W)) return (int)cudaErrorInvalidValue;
  return bwd<false>(flow_b, flow_f, img, w_fwd, g_sx, g_sy, g_c, dflow_b, dflow_f, B, H, W, H, 0,
                    dtype, stream);
}

// One row-shard: flow_b_h, flow_f_h and img_h carry h + 2 = H rows (one halo
// row each side, zeros outside the image), the owned rows being global rows
// row0 .. row0 + h - 1 of an image HS rows tall; w_fwd is (B, 1, h, W).  work:
// 6B + 5B * ceil(h/16) * ceil(W/32) floats, the first 5B the owned terms' sums
// as reg_fwd's.
extern "C" int reg_fwd_hpad(const void* flow_b_h, const void* flow_f_h, const void* img_h,
                            const void* w_fwd, void* work, int B, int HS, int H, int W, int row0,
                            int dtype, void* stream) {
  if (bad_hpad_shape(B, H, W, HS)) return (int)cudaErrorInvalidValue;
  return fwd<true>(flow_b_h, flow_f_h, img_h, w_fwd, work, B, H, W, HS, row0 - 1, dtype, stream);
}

// dflow_b_h, dflow_f_h: (B, 2, H, W) f32, every operand row.
extern "C" int reg_bwd_hpad(const void* flow_b_h, const void* flow_f_h, const void* img_h,
                            const void* w_fwd, const void* g_sx, const void* g_sy,
                            const void* g_c, void* dflow_b_h, void* dflow_f_h, int B, int HS,
                            int H, int W, int row0, int dtype, void* stream) {
  if (bad_hpad_shape(B, H, W, HS)) return (int)cudaErrorInvalidValue;
  return bwd<true>(flow_b_h, flow_f_h, img_h, w_fwd, g_sx, g_sy, g_c, dflow_b_h, dflow_f_h, B, H,
                   W, HS, row0 - 1, dtype, stream);
}
