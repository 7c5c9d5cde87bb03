// Fused photometric loss of one scale, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of unopticalflow_tpu/ops/pallas_photometric.py:
// _fwd_kernel/_fwd_body and _bwd_kernel/_bwd_body (f32 corners), and
// _fwd_kernel_cm/_bwd_kernel_cm (bf16 corners packed as u32 pairs), with the
// math of _blend, _weights_pair, _ssim_terms and _ssim_map.  Here the kernel
// reads the four bilinear corners straight from the image (no corner gather,
// no u32 packing); the bf16 instantiation is the port of the _cm pair.
//
// Per pixel p of the (B, 3, H, W) center image `img`, for both directions
// d = bwd (warp img_l by flow_b) and fwd (warp img_r by flow_f):
//   warped_d  = masked bilinear blend at (x + u, y + v); corners outside the image
//               weigh 0 and the pixel is 0 unless its in-image weight is >= 0.9999
//   valid_d   = warped_d != 0 in some channel
//   diff_d    = mean_c |img - warped_d|
//   w_d       = 2 exp(-((1 - softmax(diff_bwd, diff_fwd)_d) - 0.5)^2 / 0.03) * valid_d
//   S_dw[d]   = sum_p diff_d * w_d;   S_w[d] = sum_p w_d
//   S_cl[d]   = sum_{p,c} clamp((1 - SSIM(img * w_d, warped_d * w_d)) / 2, 0, 1) / 3
// with SSIM from 3x3 zero-padded means (divisor 9).  The forward writes w_d
// (the occlusion weights, in the image dtype) and the sums (per-block partial
// sums added in a fixed order; no floating-point atomics).  The
// backward returns d(flow_b), d(flow_f) only: the images and the weights carry
// no gradient.  Its cotangent inputs are the per-sample gradients of S_dw and
// S_cl; d(clamp) is taken strictly inside (0, 1), and sign(0) = 0.
//
// Positions, corner weights, the blend and everything after it are float32;
// images are float32 or bfloat16 (read and widened to float32, never rounded
// back).  The wrapper bounds B * 3 * H * W below 2^31, so every index is 32-bit.
//
// What bounds it on the card: per pixel a few hundred flops against 3 center
// reads, 2 x 12 scattered corner reads and 4 flow reads, so it is bound by the
// dependent gathers (flow -> corner position -> corners) and the instructions
// around them, far from both the memory rate and the tensor cores, so each
// position's `Pixel` (both blends, diffs, weights) is evaluated once.  Design:
// a 256-thread block owns a 16 x 32 tile of one image; each thread owns two
// horizontally adjacent pixels, so the center image and the flows of its own
// pixels come as one 2-element load (bf16x2 / float2 where W is even and the
// pointers aligned, else two scalar loads).  Pass 1 evaluates the own pixels
// (writing the weights) and then spreads the halo ring over the threads (a
// 1-pixel ring forward, 2 backward: 1.20x and 1.41x the tile's positions).
// x = img * w and y = warped * w go to shared memory (zero outside the image);
// the 3x3 pools are separable: a thread takes a run of rows (forward 2,
// backward cotangents 3) or a pair of columns and forms each 3-element row or
// column sum once, then the 3 sums of each output.  The forward's six sums are
// reduced by warp shuffles and one barrier; the last block of each sample to
// finish (an integer counter) adds the samples' tile sums in a fixed order, so
// a call is one launch and deterministic.  The backward keeps the own pixels'
// warp derivatives and the L1 term's part of d(flow) in registers, then for
// each (direction, channel) forms the SSIM cotangent maps (d/d mu_y, d/d
// pool(y^2), d/d pool(xy); only at positions inside the image, else the border
// rows pick up phantom gradient) on the tile plus 1 pixel and pools them at the
// own pixels (the box filter is self-adjoint).  Shared memory: forward 29.6 KB,
// backward 41.9 KB a block; registers capped for 4 and 3 blocks of 256 a SM
// (ptxas: 64 and 80, a few spilled words).  What shared memory the blocks of an
// SM leave is the L1 cache of the gathers: with the warp derivatives in shared
// memory too (66.5 KB a block) the backward was slower on flows that are random
// pixel by pixel.
//
// Halo-prepadded variants (HPAD = true).  One row-shard of a height-sharded
// model (parallel/spatial.py) computes the pack over the rows it owns.  Its
// center image and flows carry one row of halo on each side (operand rows 0
// .. H-1, the owned rows 1 .. H-2), rows outside the image being zeros; the
// source images img_l and img_r are the whole (B, 3, HS, W) maps at that
// scale, and operand row k is global row y0 + k.  A position is evaluated
// where its global row lies in the image (a halo row there is a real row,
// whose warp and weights the SSIM windows of the owned rows next to it read;
// elsewhere its x and y are SSIM's zero padding); the warp samples the source
// at the global row, and the bounds and validity are the source's.  The
// forward tiles the owned rows only: its sums and the weights it writes are
// the owned rows'.  The backward tiles every operand row and writes d(flow)
// for all of them (zero outside the image): the owned rows' SSIM windows
// reach the halo rows' flows, and autograd carries that to the shards that
// own those rows.  HPAD = false is the whole map: no halo, y0 = 0, HS = H.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <utility>

namespace {

constexpr int TW = 32;  // tile width
constexpr int TH = 16;  // tile height
constexpr int NT = 256;  // threads: two horizontally adjacent pixels each
constexpr float kC1 = 0.01f * 0.01f;
constexpr float kC2 = 0.03f * 0.03f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Two adjacent elements p[0], p[1] as float32 (p[1] only if has2); one vector
// load where the caller knows p is aligned to it.
__device__ __forceinline__ void load2(const float* p, bool vec, bool has2, float& a, float& b) {
  if (vec) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    a = t.x;
    b = t.y;
  } else {
    a = p[0];
    b = has2 ? p[1] : 0.f;
  }
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, bool vec, bool has2, float& a,
                                      float& b) {
  if (vec) {
    const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(p);
    a = __low2float(t);
    b = __high2float(t);
  } else {
    a = __bfloat162float(p[0]);
    b = has2 ? __bfloat162float(p[1]) : 0.f;
  }
}

__device__ __forceinline__ void store2(float* p, bool vec, bool has2, float a, float b) {
  if (vec) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (has2) p[1] = b;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, bool vec, bool has2, float a, float b) {
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16(a);
    if (has2) p[1] = __float2bfloat16(b);
  }
}

struct Warp {
  float v[3];    // warped value per channel
  float ddx[3];  // d warped / d x-fraction
  float ddy[3];  // d warped / d y-fraction
  float valid;
};

// Masked bilinear blend of src (3 planes) at (x + u, y + v): _blend.
template <typename T, bool GRAD>
__device__ __forceinline__ Warp blend(const T* __restrict__ src, int H, int W, int y, int x,
                                      float u, float v) {
  const int plane = H * W;
  const float px = (float)x + u;
  const float py = (float)y + v;
  const float x0 = floorf(px);
  const float y0 = floorf(py);
  const float ax = px - x0;
  const float ay = py - y0;
  const float wm1 = (float)W - 1.f, hm1 = (float)H - 1.f;
  const bool inx0 = x0 >= 0.f && x0 <= wm1;
  const bool inx1 = x0 + 1.f >= 0.f && x0 + 1.f <= wm1;
  const bool iny0 = y0 >= 0.f && y0 <= hm1;
  const bool iny1 = y0 + 1.f >= 0.f && y0 + 1.f <= hm1;
  const float i00 = (iny0 && inx0) ? 1.f : 0.f;
  const float i01 = (iny0 && inx1) ? 1.f : 0.f;
  const float i10 = (iny1 && inx0) ? 1.f : 0.f;
  const float i11 = (iny1 && inx1) ? 1.f : 0.f;
  const float w00 = (1.f - ay) * (1.f - ax) * i00;
  const float w01 = (1.f - ay) * ax * i01;
  const float w10 = ay * (1.f - ax) * i10;
  const float w11 = ay * ax * i11;
  const float mask = (w00 + w01 + w10 + w11) >= 0.9999f ? 1.f : 0.f;
  // integer corners only where in range (x0 may be huge or not finite)
  const int xa = inx0 ? (int)x0 : 0, xb = inx1 ? (int)x0 + 1 : 0;
  const int ya = iny0 ? (int)y0 : 0, yb = iny1 ? (int)y0 + 1 : 0;
  const int o00 = ya * W + xa, o01 = ya * W + xb, o10 = yb * W + xa, o11 = yb * W + xb;
  Warp out;
  bool all_zero = true;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T* s = src + c * plane;
    const float c00 = i00 != 0.f ? to_f32(s[o00]) : 0.f;
    const float c01 = i01 != 0.f ? to_f32(s[o01]) : 0.f;
    const float c10 = i10 != 0.f ? to_f32(s[o10]) : 0.f;
    const float c11 = i11 != 0.f ? to_f32(s[o11]) : 0.f;
    out.v[c] = (w00 * c00 + w01 * c01 + w10 * c10 + w11 * c11) * mask;
    all_zero = all_zero && out.v[c] == 0.f;
    if (GRAD) {
      out.ddx[c] = (-(1.f - ay) * i00 * c00 + (1.f - ay) * i01 * c01 - ay * i10 * c10 +
                    ay * i11 * c11) * mask;
      out.ddy[c] = (-(1.f - ax) * i00 * c00 - ax * i01 * c01 + (1.f - ax) * i10 * c10 +
                    ax * i11 * c11) * mask;
    }
  }
  out.valid = all_zero ? 0.f : 1.f;
  return out;
}

// Both directions' warps, diffs and occlusion weights at one pixel: _weights_pair.
// im: the center image's 3 channels there; (ub, vb), (uf, vf): the two flows.
template <typename T, bool GRAD>
struct Pixel {
  Warp wb, wf;
  float diff_b, diff_f, wgt_b, wgt_f;

  __device__ __forceinline__ Pixel(const T* il, const T* ir, const float* im, float ub,
                                   float vb, float uf, float vf, int H, int W, int y, int x) {
    wb = blend<T, GRAD>(il, H, W, y, x, ub, vb);
    wf = blend<T, GRAD>(ir, H, W, y, x, uf, vf);
    diff_b = (fabsf(im[0] - wb.v[0]) + fabsf(im[1] - wb.v[1]) + fabsf(im[2] - wb.v[2])) / 3.f;
    diff_f = (fabsf(im[0] - wf.v[0]) + fabsf(im[1] - wf.v[1]) + fabsf(im[2] - wf.v[2])) / 3.f;
    const float m = fmaxf(diff_b, diff_f);
    const float eb = expf(diff_b - m);
    const float ef = expf(diff_f - m);
    const float inv = 1.f / (eb + ef);
    const float qb = 1.f - eb * inv - 0.5f;
    const float qf = 1.f - ef * inv - 0.5f;
    wgt_b = 2.f * expf(-(qb * qb) / 0.03f) * wb.valid;
    wgt_f = 2.f * expf(-(qf * qf) / 0.03f) * wf.valid;
  }
};

// x = img * w and y = warped * w of both directions at map index i.
template <typename T, bool GRAD, int N>
__device__ __forceinline__ void put_maps(float (*sx)[3][N], float (*sy)[3][N], int i,
                                         const float* im, const Pixel<T, GRAD>& px) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    sx[0][c][i] = im[c] * px.wgt_b;
    sy[0][c][i] = px.wb.v[c] * px.wgt_b;
    sx[1][c][i] = im[c] * px.wgt_f;
    sy[1][c][i] = px.wf.v[c] * px.wgt_f;
  }
}

template <int N>
__device__ __forceinline__ void zero_maps(float (*sx)[3][N], float (*sy)[3][N], int i) {
#pragma unroll
  for (int c = 0; c < 3; ++c) sx[0][c][i] = sy[0][c][i] = sx[1][c][i] = sy[1][c][i] = 0.f;
}

// The i-th position of the HALO-wide ring around the TH x TW tile, as (row,
// column) of the (TH + 2 HALO) x (TW + 2 HALO) map: the top and bottom HALO
// rows, then the left and right HALO columns of the tile's rows.
template <int HALO>
__device__ __forceinline__ void ring_pos(int i, int& r, int& q) {
  constexpr int MW = TW + 2 * HALO;
  if (i < 2 * HALO * MW) {
    const int rr = i / MW;
    q = i - rr * MW;
    r = rr < HALO ? rr : rr + TH;
  } else {
    const int k = i - 2 * HALO * MW;
    const int cc = k % (2 * HALO);
    r = HALO + k / (2 * HALO);
    q = cc < HALO ? cc : cc + TW;
  }
}

// Row sums of the five SSIM statistics over columns q..q+2 of map row r.
struct Stats {
  float a, b, xx, yy, xy;  // sums of x, y, x^2, y^2, x*y
};

template <int COLS>
__device__ __forceinline__ Stats row_stats(const float* sx, const float* sy, int r, int q) {
  const float* px = sx + r * COLS + q;
  const float* py = sy + r * COLS + q;
  const float x0 = px[0], x1 = px[1], x2 = px[2];
  const float y0 = py[0], y1 = py[1], y2 = py[2];
  return {(x0 + x1) + x2, (y0 + y1) + y2, (x0 * x0 + x1 * x1) + x2 * x2,
          (y0 * y0 + y1 * y1) + y2 * y2, (x0 * y0 + x1 * y1) + x2 * y2};
}

__device__ __forceinline__ Stats add3(const Stats& p, const Stats& q, const Stats& s) {
  return {(p.a + q.a) + s.a, (p.b + q.b) + s.b, (p.xx + q.xx) + s.xx, (p.yy + q.yy) + s.yy,
          (p.xy + q.xy) + s.xy};
}

// SSIM terms of one position from its 3x3 sums (divided by 9 here).
struct Ssim {
  float mu_x, mu_y, px2, py2, pxy, s, inv;  // inv: 1 / SSIM's denominator
};

__device__ __forceinline__ Ssim ssim_of(const Stats& t) {
  const float n = 1.f / 9.f;
  Ssim o;
  o.mu_x = t.a * n;
  o.mu_y = t.b * n;
  o.px2 = t.xx * n;
  o.py2 = t.yy * n;
  o.pxy = t.xy * n;
  const float sigma_x = o.px2 - o.mu_x * o.mu_x;
  const float sigma_y = o.py2 - o.mu_y * o.mu_y;
  const float sigma_xy = o.pxy - o.mu_x * o.mu_y;
  const float num = (2.f * o.mu_x * o.mu_y + kC1) * (2.f * sigma_xy + kC2);
  o.inv = 1.f / ((o.mu_x * o.mu_x + o.mu_y * o.mu_y + kC1) * (sigma_x + sigma_y + kC2));
  o.s = num * o.inv;
  return o;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// ---- forward ------------------------------------------------------------------

constexpr int FH = TH + 2, FW = TW + 2;  // tile + 1-pixel halo
constexpr int FN = FH * FW;
constexpr int FRING = FN - TH * TW;  // the 1-pixel ring's positions

// The operand rows a kernel owns, [lo, hi), the source's rows hs and the
// global row y0 of operand row 0 (see the halo-prepadded variants above).
template <bool HPAD>
struct Rows {
  int lo, hi, hs, y0;
  __device__ __forceinline__ Rows(int H, int HS, int Y0)
      : lo(HPAD ? 1 : 0), hi(HPAD ? H - 1 : H), hs(HPAD ? HS : H), y0(HPAD ? Y0 : 0) {}
  // operand row k lies inside the image (every row of a whole map does)
  __device__ __forceinline__ bool in_image(int k) const {
    return !HPAD || (y0 + k >= 0 && y0 + k < hs);
  }
};

template <typename T, bool HPAD>
__global__ void __launch_bounds__(NT, 4)
photo_fwd_kernel(const T* __restrict__ img_l, const T* __restrict__ img_r,
                 const T* __restrict__ img, const float* __restrict__ flow_b,
                 const float* __restrict__ flow_f, T* __restrict__ weights,
                 float* __restrict__ sums_out, int* __restrict__ counters,
                 float* __restrict__ partials, int B, int H, int W, int HS, int Y0, bool vec) {
  __shared__ float sx[2][3][FN];
  __shared__ float sy[2][3][FN];
  __shared__ float red[NT / 32][6];
  __shared__ int last;
  const Rows<HPAD> span(H, HS, Y0);
  const int b = blockIdx.z;
  const int tx0 = blockIdx.x * TW, ty0 = span.lo + blockIdx.y * TH;
  const int tid = threadIdx.x;
  const int plane = H * W, splane = span.hs * W, oplane = (span.hi - span.lo) * W;
  const T* il = img_l + b * 3 * splane;
  const T* ir = img_r + b * 3 * splane;
  const T* im = img + b * 3 * plane;
  const float* fb = flow_b + b * 2 * plane;
  const float* ff = flow_f + b * 2 * plane;
  float sums[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // s_dw, s_w, s_cl of bwd, then fwd

  // pass 1a: the thread's own two pixels (a halo row below the owned rows
  // is evaluated for the maps only)
  {
    const int pr = tid >> 4, pc = (tid & 15) * 2;
    const int gy = ty0 + pr, gx = tx0 + pc;
    const bool in0 = gy < H && gx < W && span.in_image(gy), in1 = in0 && gx + 1 < W;
    const bool own = gy < span.hi;
    const int i0 = (pr + 1) * FW + pc + 1;
    if (in0) {
      const int p = gy * W + gx;
      float c[2][3], ub[2], vb[2], uf[2], vf[2];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) load2(im + ch * plane + p, vec, in1, c[0][ch], c[1][ch]);
      load2(fb + p, vec, in1, ub[0], ub[1]);
      load2(fb + plane + p, vec, in1, vb[0], vb[1]);
      load2(ff + p, vec, in1, uf[0], uf[1]);
      load2(ff + plane + p, vec, in1, vf[0], vf[1]);
      float wgt[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [direction][pixel]
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k == 1 && !in1) {
          zero_maps<FN>(sx, sy, i0 + 1);
          continue;
        }
        const Pixel<T, false> px(il, ir, c[k], ub[k], vb[k], uf[k], vf[k], span.hs, W,
                                 span.y0 + gy, gx + k);
        put_maps<T, false, FN>(sx, sy, i0 + k, c[k], px);
        if (!own) continue;
        sums[0] += px.diff_b * px.wgt_b;
        sums[1] += px.wgt_b;
        sums[3] += px.diff_f * px.wgt_f;
        sums[4] += px.wgt_f;
        wgt[0][k] = px.wgt_b;
        wgt[1][k] = px.wgt_f;
      }
      if (own) {
        const int o = (gy - span.lo) * W + gx;
        store2(weights + b * oplane + o, vec, in1, wgt[0][0], wgt[0][1]);
        store2(weights + (B + b) * oplane + o, vec, in1, wgt[1][0], wgt[1][1]);
      }
    } else {
      zero_maps<FN>(sx, sy, i0);
      zero_maps<FN>(sx, sy, i0 + 1);
    }
  }
  // pass 1b: the 1-pixel ring
  for (int i = tid; i < FRING; i += NT) {
    int r, q;
    ring_pos<1>(i, r, q);
    const int gy = ty0 - 1 + r, gx = tx0 - 1 + q;
    const int m = r * FW + q;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W && span.in_image(gy)) {
      const int p = gy * W + gx;
      const float c[3] = {to_f32(im[p]), to_f32(im[plane + p]), to_f32(im[2 * plane + p])};
      const Pixel<T, false> px(il, ir, c, fb[p], fb[plane + p], ff[p], ff[plane + p], span.hs,
                               W, span.y0 + gy, gx);
      put_maps<T, false, FN>(sx, sy, m, c, px);
    } else {
      zero_maps<FN>(sx, sy, m);
    }
  }
  __syncthreads();

  // pass 2: SSIM at two vertically adjacent pixels (rows r0, r0 + 1, column q)
  {
    const int q = tid & 31, r0 = (tid >> 5) * 2;
    const int gx = tx0 + q, gy = ty0 + r0;
    const bool in0 = gx < W && gy < span.hi, in1 = in0 && gy + 1 < span.hi;
    if (in0) {
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        float cl0 = 0.f, cl1 = 0.f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const Stats s0 = row_stats<FW>(sx[d][ch], sy[d][ch], r0, q);
          const Stats s1 = row_stats<FW>(sx[d][ch], sy[d][ch], r0 + 1, q);
          const Stats s2 = row_stats<FW>(sx[d][ch], sy[d][ch], r0 + 2, q);
          const Stats s3 = row_stats<FW>(sx[d][ch], sy[d][ch], r0 + 3, q);
          cl0 += fminf(fmaxf((1.f - ssim_of(add3(s0, s1, s2)).s) * 0.5f, 0.f), 1.f);
          cl1 += fminf(fmaxf((1.f - ssim_of(add3(s1, s2, s3)).s) * 0.5f, 0.f), 1.f);
        }
        // the pooled maps have 3 channels
        sums[3 * d + 2] += cl0 / 3.f + (in1 ? cl1 / 3.f : 0.f);
      }
    }
  }

  // the six block sums: warp shuffles, one barrier, then one thread per sum
  const int lane = tid & 31, wid = tid >> 5;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float v = warp_sum(sums[k]);
    if (lane == 0) red[wid][k] = v;
  }
  __syncthreads();
  const int tiles = gridDim.x * gridDim.y;
  if (tid < 6) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) t += red[w][tid];
    const int d = tid / 3, kind = tid % 3;  // kind: 0 s_dw, 1 s_w, 2 s_cl
    partials[((kind * 2 + d) * B + b) * tiles + blockIdx.y * gridDim.x + blockIdx.x] = t;
  }
  // the last block of the sample to finish adds its tiles' partial sums, one
  // warp a sum, in an order that does not depend on which block that is
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + b, 1) == tiles - 1;
  __syncthreads();
  if (last && wid < 6) {
    const int d = wid / 3, kind = wid % 3;
    const float* src = partials + ((kind * 2 + d) * B + b) * tiles;
    float t = 0.f;
    for (int i = lane; i < tiles; i += 32) t += __ldcg(src + i);
    t = warp_sum(t);
    if (lane == 0) sums_out[kind * 2 * B + d * B + b] = t;
  }
}

// ---- backward -----------------------------------------------------------------

constexpr int BH = TH + 4, BW = TW + 4;  // tile + 2-pixel halo: x and y maps
constexpr int BN = BH * BW;
constexpr int BRING = BN - TH * TW;  // the 2-pixel ring's positions
constexpr int QH = TH + 2, QW = TW + 2;  // tile + 1-pixel halo: cotangent maps
constexpr int QN = QH * QW;
constexpr int QRUN = 3;                  // cotangent rows a thread pools at once
static_assert(QH % QRUN == 0 && (QH / QRUN) * QW <= NT, "one cotangent run a thread");

template <typename T, bool HPAD>
__global__ void __launch_bounds__(NT, 3)
photo_bwd_kernel(const T* __restrict__ img_l, const T* __restrict__ img_r,
                 const T* __restrict__ img, const float* __restrict__ flow_b,
                 const float* __restrict__ flow_f, const float* __restrict__ g_dw,
                 const float* __restrict__ g_cl, float* __restrict__ dflow_b,
                 float* __restrict__ dflow_f, int B, int H, int W, int HS, int Y0, bool vec) {
  __shared__ float sx[2][3][BN];
  __shared__ float sy[2][3][BN];
  __shared__ float sq[3][QN];  // [mu_y, pool(y^2), pool(xy)] of one (direction, channel)
  const Rows<HPAD> span(H, HS, Y0);
  const int b = blockIdx.z;
  const int tx0 = blockIdx.x * TW, ty0 = blockIdx.y * TH;
  const int tid = threadIdx.x;
  const int plane = H * W, splane = span.hs * W;
  const T* il = img_l + b * 3 * splane;
  const T* ir = img_r + b * 3 * splane;
  const T* im = img + b * 3 * plane;
  const float* fb = flow_b + b * 2 * plane;
  const float* ff = flow_f + b * 2 * plane;

  // pass 1a: the own two pixels; their warp derivatives, weights and the L1
  // term's part of d(flow) stay in registers.  `out`: the pixels written (zero
  // outside the image), in0: evaluated; the L1 term only on the owned rows.
  const int pr = tid >> 4, pc = (tid & 15) * 2;
  const int gy = ty0 + pr, gx = tx0 + pc;
  const bool out = gy < H && gx < W, out1 = out && gx + 1 < W;
  const bool in0 = out && span.in_image(gy), in1 = in0 && gx + 1 < W;
  float ddx[2][2][3] = {}, ddy[2][2][3] = {};  // [pixel][direction][channel]
  float wgt[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [pixel][direction]
  float du[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float dv[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  {
    const int i0 = (pr + 2) * BW + pc + 2;
    if (in0) {
      const int p = gy * W + gx;
      const bool own = gy >= span.lo && gy < span.hi;
      const float gdw[2] = {own ? g_dw[b] : 0.f, own ? g_dw[B + b] : 0.f};
      float c[2][3], ub[2], vb[2], uf[2], vf[2];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) load2(im + ch * plane + p, vec, in1, c[0][ch], c[1][ch]);
      load2(fb + p, vec, in1, ub[0], ub[1]);
      load2(fb + plane + p, vec, in1, vb[0], vb[1]);
      load2(ff + p, vec, in1, uf[0], uf[1]);
      load2(ff + plane + p, vec, in1, vf[0], vf[1]);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k == 1 && !in1) {
          zero_maps<BN>(sx, sy, i0 + 1);
          continue;
        }
        const Pixel<T, true> px(il, ir, c[k], ub[k], vb[k], uf[k], vf[k], span.hs, W,
                                span.y0 + gy, gx + k);
        put_maps<T, true, BN>(sx, sy, i0 + k, c[k], px);
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const Warp& wp = d == 0 ? px.wb : px.wf;
          const float w = d == 0 ? px.wgt_b : px.wgt_f;
          wgt[k][d] = w;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            ddx[k][d][ch] = wp.ddx[ch];
            ddy[k][d][ch] = wp.ddy[ch];
            const float e = c[k][ch] - wp.v[ch];
            const float sgn = e > 0.f ? 1.f : (e < 0.f ? -1.f : 0.f);
            const float l1 = gdw[d] * w * (-sgn / 3.f);
            du[k][d] += l1 * wp.ddx[ch];
            dv[k][d] += l1 * wp.ddy[ch];
          }
        }
      }
    } else {
      zero_maps<BN>(sx, sy, i0);
      zero_maps<BN>(sx, sy, i0 + 1);
    }
  }
  // pass 1b: the 2-pixel ring
  for (int i = tid; i < BRING; i += NT) {
    int r, q;
    ring_pos<2>(i, r, q);
    const int y = ty0 - 2 + r, x = tx0 - 2 + q;
    const int m = r * BW + q;
    if (y >= 0 && y < H && x >= 0 && x < W && span.in_image(y)) {
      const int p = y * W + x;
      const float c[3] = {to_f32(im[p]), to_f32(im[plane + p]), to_f32(im[2 * plane + p])};
      const Pixel<T, false> px(il, ir, c, fb[p], fb[plane + p], ff[p], ff[plane + p], span.hs,
                               W, span.y0 + y, x);
      put_maps<T, false, BN>(sx, sy, m, c, px);
    } else {
      zero_maps<BN>(sx, sy, m);
    }
  }
  __syncthreads();

  const float n = 1.f / 9.f;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const float gs_in = -0.5f * (g_cl[d * B + b] / 3.f);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      // pass 2: the cotangents of the pooled statistics at the tile + 1 pixel,
      // QRUN vertically adjacent positions a thread (cotangent map rows
      // r0..r0+QRUN-1, column q; x/y map rows r0..r0+QRUN+1, columns q..q+2)
      if (tid < (QH / QRUN) * QW) {
        const int q = tid % QW, r0 = (tid / QW) * QRUN;
        const int x = tx0 - 1 + q;
        Stats rows[QRUN + 2];
#pragma unroll
        for (int j = 0; j < QRUN + 2; ++j) rows[j] = row_stats<BW>(sx[d][ch], sy[d][ch], r0 + j, q);
#pragma unroll
        for (int j = 0; j < QRUN; ++j) {
          const int y = ty0 - 1 + r0 + j;
          float q_mu = 0.f, q_py2 = 0.f, q_pxy = 0.f;
          if (y >= span.lo && y < span.hi && x >= 0 && x < W) {
            const Ssim st = ssim_of(add3(rows[j], rows[j + 1], rows[j + 2]));
            const float s = st.s;
            const float h = (1.f - s) * 0.5f;
            const float gs = (h > 0.f && h < 1.f) ? gs_in : 0.f;
            const float sigma_xy = st.pxy - st.mu_x * st.mu_y;
            const float a1 = 2.f * st.mu_x * st.mu_y + kC1;
            const float a2 = 2.f * sigma_xy + kC2;
            const float b1 = st.mu_x * st.mu_x + st.mu_y * st.mu_y + kC1;
            const float b2 = (st.px2 - st.mu_x * st.mu_x) + (st.py2 - st.mu_y * st.mu_y) + kC2;
            // s = a1 a2 r with r = 1 / (b1 b2); d sigma_xy / d mu_y = -mu_x,
            // d sigma_y / d mu_y = -2 mu_y, d s / d a = s / a, d s / d b = -s / b
            const float r = st.inv, sr = s * r;
            q_mu = gs * (2.f * st.mu_x * (a2 - a1) * r - sr * (2.f * st.mu_y * (b2 - b1)));
            q_py2 = gs * (-sr * b1);
            q_pxy = gs * (2.f * a1 * r);
          }
          const int m = (r0 + j) * QW + q;
          sq[0][m] = q_mu;
          sq[1][m] = q_py2;
          sq[2][m] = q_pxy;
        }
      }
      __syncthreads();

      // pass 3: pool the cotangent maps at the own two pixels (cotangent map
      // row pr + 1, columns pc + 1 + k: column sums at columns pc..pc+3)
      if (in0) {
        float pool[3][2];  // [mu_y, pool(y^2), pool(xy)][pixel]
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const float* m = sq[t] + pr * QW + pc;
          float cs[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) cs[j] = (m[j] + m[QW + j]) + m[2 * QW + j];
          pool[t][0] = (cs[0] + cs[1]) + cs[2];
          pool[t][1] = (cs[1] + cs[2]) + cs[3];
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int i = (pr + 2) * BW + pc + 2 + k;
          const float xv = sx[d][ch][i];
          const float yv = sy[d][ch][i];
          const float dl_dy = pool[0][k] * n + 2.f * yv * (pool[1][k] * n) + xv * (pool[2][k] * n);
          const float g = dl_dy * wgt[k][d];
          du[k][d] += g * ddx[k][d][ch];
          dv[k][d] += g * ddy[k][d][ch];
        }
      }
      __syncthreads();  // the next (direction, channel) overwrites sq
    }
  }

  if (out) {
    const int p = gy * W + gx;
    float* ob = dflow_b + b * 2 * plane + p;
    float* of = dflow_f + b * 2 * plane + p;
    store2(ob, vec, out1, du[0][0], du[1][0]);
    store2(ob + plane, vec, out1, dv[0][0], dv[1][0]);
    store2(of, vec, out1, du[0][1], du[1][1]);
    store2(of + plane, vec, out1, dv[0][1], dv[1][1]);
  }
}

// Whether every pixel pair of the own tiles can be read and written as one
// vector: W even (so the pairs start at even offsets) and every base pointer
// aligned to two elements.
bool pairs_align(int W, std::initializer_list<std::pair<const void*, int>> ptrs) {
  if (W % 2 != 0) return false;
  for (const auto& pe : ptrs)
    if (reinterpret_cast<uintptr_t>(pe.first) % (2 * pe.second) != 0) return false;
  return true;
}

// work: [3][2B] sums (the outputs), [B] int32 counters of finished tiles,
// [3][2][B][tiles] partial sums.  H: the operand's rows (the owned rows plus 2
// when HPAD), HS: the source's, Y0: the global row of operand row 0.
template <typename T, bool HPAD>
cudaError_t launch_fwd(const void* il, const void* ir, const void* im, const float* fb,
                       const float* ff, void* weights, float* work, int B, int H, int W,
                       int HS, int Y0, cudaStream_t stream) {
  const int e = (int)sizeof(T);
  const bool vec = pairs_align(W, {{il, e}, {ir, e}, {im, e}, {weights, e}, {fb, 4}, {ff, 4}});
  int* counters = reinterpret_cast<int*>(work + 6 * B);
  const cudaError_t err = cudaMemsetAsync(counters, 0, B * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const int owned = HPAD ? H - 2 : H;
  const dim3 grid((W + TW - 1) / TW, (owned + TH - 1) / TH, B);
  photo_fwd_kernel<T, HPAD><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(il), static_cast<const T*>(ir), static_cast<const T*>(im), fb, ff,
      static_cast<T*>(weights), work, counters, work + 7 * B, B, H, W, HS, Y0, vec);
  return cudaGetLastError();
}

template <typename T, bool HPAD>
cudaError_t launch_bwd(const void* il, const void* ir, const void* im, const float* fb,
                       const float* ff, const float* g_dw, const float* g_cl, float* dfb,
                       float* dff, int B, int H, int W, int HS, int Y0, cudaStream_t stream) {
  const int e = (int)sizeof(T);
  const bool vec =
      pairs_align(W, {{il, e}, {ir, e}, {im, e}, {fb, 4}, {ff, 4}, {dfb, 4}, {dff, 4}});
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  photo_bwd_kernel<T, HPAD><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(il), static_cast<const T*>(ir), static_cast<const T*>(im), fb, ff,
      g_dw, g_cl, dfb, dff, B, H, W, HS, Y0, vec);
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
int fwd(const void* img_l, const void* img_r, const void* img, const void* flow_b,
        const void* flow_f, void* weights, void* partials, int B, int H, int W, int HS, int Y0,
        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb = static_cast<const float*>(flow_b);
  const float* ff = static_cast<const float*>(flow_f);
  float* part = static_cast<float*>(partials);
  switch (dtype) {
    case 0:
      return (int)launch_fwd<float, HPAD>(img_l, img_r, img, fb, ff, weights, part, B, H, W, HS,
                                          Y0, s);
    case 1:
      return (int)launch_fwd<__nv_bfloat16, HPAD>(img_l, img_r, img, fb, ff, weights, part, B, H,
                                                  W, HS, Y0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool HPAD>
int bwd(const void* img_l, const void* img_r, const void* img, const void* flow_b,
        const void* flow_f, const void* g_dw, const void* g_cl, void* dflow_b, void* dflow_f,
        int B, int H, int W, int HS, int Y0, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb = static_cast<const float*>(flow_b);
  const float* ff = static_cast<const float*>(flow_f);
  const float* gd = static_cast<const float*>(g_dw);
  const float* gc = static_cast<const float*>(g_cl);
  float* db = static_cast<float*>(dflow_b);
  float* df = static_cast<float*>(dflow_f);
  switch (dtype) {
    case 0:
      return (int)launch_bwd<float, HPAD>(img_l, img_r, img, fb, ff, gd, gc, db, df, B, H, W,
                                          HS, Y0, s);
    case 1:
      return (int)launch_bwd<__nv_bfloat16, HPAD>(img_l, img_r, img, fb, ff, gd, gc, db, df, B,
                                                  H, W, HS, Y0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Images (B, 3, H, W) of dtype 0 = float32 / 1 = bfloat16; flows (B, 2, H, W) f32.
// weights: (2B, 1, H, W) in the image dtype, [bwd; fwd].  partials: a f32
// workspace of 7B + 6B * ceil(H/16) * ceil(W/32) elements whose first 6B are
// the outputs s_dw, s_w, s_cl, each (2B,) [bwd; fwd]; the rest is the kernel's.
// Returns the first failing CUDA call's cudaError_t (0 = success).
extern "C" int photo_fwd(const void* img_l, const void* img_r, const void* img,
                         const void* flow_b, const void* flow_f, void* weights, void* partials,
                         int B, int H, int W, int dtype, void* stream) {
  if (bad_shape(B, H, W)) return (int)cudaErrorInvalidValue;
  return fwd<false>(img_l, img_r, img, flow_b, flow_f, weights, partials, B, H, W, H, 0, dtype,
                    stream);
}

// g_dw, g_cl: (2B,) f32 gradients of s_dw and s_cl, [bwd; fwd].
// dflow_b, dflow_f: (B, 2, H, W) f32.
extern "C" int photo_bwd(const void* img_l, const void* img_r, const void* img,
                         const void* flow_b, const void* flow_f, const void* g_dw,
                         const void* g_cl, void* dflow_b, void* dflow_f, int B, int H, int W,
                         int dtype, void* stream) {
  if (bad_shape(B, H, W)) return (int)cudaErrorInvalidValue;
  return bwd<false>(img_l, img_r, img, flow_b, flow_f, g_dw, g_cl, dflow_b, dflow_f, B, H, W, H,
                    0, dtype, stream);
}

// One row-shard: img_h, flow_b_h, flow_f_h carry h + 2 = H rows (one halo row
// each side, zeros outside the image), the owned rows being global rows row0
// .. row0 + h - 1; img_l, img_r are the whole (B, 3, HS, W) maps.  weights:
// (2B, 1, h, W); partials: 7B + 6B * ceil(h/16) * ceil(W/32) floats, the first
// 6B the owned rows' sums as photo_fwd's.
extern "C" int photo_fwd_hpad(const void* img_l, const void* img_r, const void* img_h,
                              const void* flow_b_h, const void* flow_f_h, void* weights,
                              void* partials, int B, int HS, int H, int W, int row0, int dtype,
                              void* stream) {
  if (bad_hpad_shape(B, H, W, HS)) return (int)cudaErrorInvalidValue;
  return fwd<true>(img_l, img_r, img_h, flow_b_h, flow_f_h, weights, partials, B, H, W, HS,
                   row0 - 1, dtype, stream);
}

// dflow_b_h, dflow_f_h: (B, 2, H, W) f32, every operand row.
extern "C" int photo_bwd_hpad(const void* img_l, const void* img_r, const void* img_h,
                              const void* flow_b_h, const void* flow_f_h, const void* g_dw,
                              const void* g_cl, void* dflow_b_h, void* dflow_f_h, int B, int HS,
                              int H, int W, int row0, int dtype, void* stream) {
  if (bad_hpad_shape(B, H, W, HS)) return (int)cudaErrorInvalidValue;
  return bwd<true>(img_l, img_r, img_h, flow_b_h, flow_f_h, g_dw, g_cl, dflow_b_h, dflow_f_h, B,
                   H, W, HS, row0 - 1, dtype, stream);
}
