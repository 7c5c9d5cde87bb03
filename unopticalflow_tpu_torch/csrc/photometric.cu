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
// (the occlusion weights, in the image dtype) and per-block partial sums; the
// caller sums the partials (a deterministic torch reduction, no atomics).  The
// backward returns d(flow_b), d(flow_f) only: the images and the weights carry
// no gradient.  Its cotangent inputs are the per-sample gradients of S_dw and
// S_cl; d(clamp) is taken strictly inside (0, 1), and sign(0) = 0.
//
// Positions, corner weights, the blend and everything after it are float32;
// images are float32 or bfloat16 (read and widened to float32, never rounded
// back).
//
// What bounds it on the card: per pixel a few hundred flops against about
// 3 image reads, 8 corner reads per direction and 2 flow reads, so it is
// bandwidth- and latency-bound, far from the tensor cores.  Design (simple and
// right first): one block per (sample, 8 x 32 tile of pixels), one thread per
// output pixel.  The block computes x = img * w and y = warped * w for the tile
// plus a 1-pixel halo (2 in the backward) into shared memory, then pools from
// there.  In the backward the SSIM cotangent maps (d/d mu_y, d/d pool(y^2),
// d/d pool(xy)) are formed on the tile plus 1 pixel, only at positions inside
// the image (else the border rows would pick up phantom gradient), and pooled
// again (the 3x3 box filter is self-adjoint).  Halo pixels are computed by
// several blocks: recomputing them is cheaper than another pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;  // tile width: one warp per row
constexpr int TY = 8;   // tile height
constexpr int NT = TX * TY;
constexpr float kC1 = 0.01f * 0.01f;
constexpr float kC2 = 0.03f * 0.03f;

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

struct Warp {
  float v[3];    // warped value per channel
  float ddx[3];  // d warped / d x-fraction
  float ddy[3];  // d warped / d y-fraction
  float valid;
};

// Masked bilinear blend of src (3 planes) at (x + u, y + v): _blend.
template <typename T, bool GRAD>
__device__ __forceinline__ Warp blend(const T* __restrict__ src, const float* __restrict__ flow,
                                      int H, int W, int y, int x) {
  const int64_t plane = (int64_t)H * W;
  const int64_t p = (int64_t)y * W + x;
  const float px = (float)x + flow[p];
  const float py = (float)y + flow[plane + p];
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
  Warp out;
  bool all_zero = true;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T* s = src + c * plane;
    const float c00 = i00 != 0.f ? to_f32(s[(int64_t)ya * W + xa]) : 0.f;
    const float c01 = i01 != 0.f ? to_f32(s[(int64_t)ya * W + xb]) : 0.f;
    const float c10 = i10 != 0.f ? to_f32(s[(int64_t)yb * W + xa]) : 0.f;
    const float c11 = i11 != 0.f ? to_f32(s[(int64_t)yb * W + xb]) : 0.f;
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
template <typename T, bool GRAD>
struct Pixel {
  float img[3];
  Warp wb, wf;
  float diff_b, diff_f, wgt_b, wgt_f;

  __device__ __forceinline__ Pixel(const T* img_l, const T* img_r, const T* im,
                                   const float* flow_b, const float* flow_f, int H, int W,
                                   int y, int x) {
    const int64_t plane = (int64_t)H * W;
    const int64_t p = (int64_t)y * W + x;
#pragma unroll
    for (int c = 0; c < 3; ++c) img[c] = to_f32(im[c * plane + p]);
    wb = blend<T, GRAD>(img_l, flow_b, H, W, y, x);
    wf = blend<T, GRAD>(img_r, flow_f, H, W, y, x);
    diff_b = (fabsf(img[0] - wb.v[0]) + fabsf(img[1] - wb.v[1]) + fabsf(img[2] - wb.v[2])) /
             3.f;
    diff_f = (fabsf(img[0] - wf.v[0]) + fabsf(img[1] - wf.v[1]) + fabsf(img[2] - wf.v[2])) /
             3.f;
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

// Pooled SSIM statistics at one position of a (rows x cols) shared-memory map
// pair centred on (r, q): sums over the 3x3 window divided by 9.
struct Stats {
  float mu_x, mu_y, px2, py2, pxy;
};

template <int COLS>
__device__ __forceinline__ Stats pool_stats(const float* sx, const float* sy, int r, int q) {
  float a = 0.f, b = 0.f, xx = 0.f, yy = 0.f, xy = 0.f;
#pragma unroll
  for (int i = -1; i <= 1; ++i) {
#pragma unroll
    for (int j = -1; j <= 1; ++j) {
      const float xv = sx[(r + i) * COLS + q + j];
      const float yv = sy[(r + i) * COLS + q + j];
      a += xv;
      b += yv;
      xx += xv * xv;
      yy += yv * yv;
      xy += xv * yv;
    }
  }
  const float n = 1.f / 9.f;
  return {a * n, b * n, xx * n, yy * n, xy * n};
}

__device__ __forceinline__ float ssim_of(const Stats& s, float* den_out = nullptr) {
  const float sigma_x = s.px2 - s.mu_x * s.mu_x;
  const float sigma_y = s.py2 - s.mu_y * s.mu_y;
  const float sigma_xy = s.pxy - s.mu_x * s.mu_y;
  const float num = (2.f * s.mu_x * s.mu_y + kC1) * (2.f * sigma_xy + kC2);
  const float den = (s.mu_x * s.mu_x + s.mu_y * s.mu_y + kC1) * (sigma_x + sigma_y + kC2);
  if (den_out) *den_out = den;
  return num / den;
}

// Sum of v over the block into out[slot] (thread 0 writes); red holds NT/32 floats.
__device__ __forceinline__ void block_sum(float v, float* red, float* out, int tid) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < NT / 32; ++i) t += red[i];
    *out = t;
  }
}

// ---- forward ------------------------------------------------------------------

constexpr int FH = TY + 2, FW = TX + 2;  // tile + 1-pixel halo

template <typename T>
__global__ void __launch_bounds__(NT)
photo_fwd_kernel(const T* __restrict__ img_l, const T* __restrict__ img_r,
                 const T* __restrict__ img, const float* __restrict__ flow_b,
                 const float* __restrict__ flow_f, T* __restrict__ weights,
                 float* __restrict__ partials, int B, int H, int W) {
  __shared__ float sx[2][3][FH * FW];
  __shared__ float sy[2][3][FH * FW];
  __shared__ float red[NT / 32];
  const int b = blockIdx.z;
  const int tx0 = blockIdx.x * TX, ty0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int64_t plane = (int64_t)H * W;
  const T* il = img_l + (int64_t)b * 3 * plane;
  const T* ir = img_r + (int64_t)b * 3 * plane;
  const T* im = img + (int64_t)b * 3 * plane;
  const float* fb = flow_b + (int64_t)b * 2 * plane;
  const float* ff = flow_f + (int64_t)b * 2 * plane;

  // x = img * w and y = warped * w on the tile + halo; zero outside the image
  for (int i = tid; i < FH * FW; i += NT) {
    const int gy = ty0 - 1 + i / FW, gx = tx0 - 1 + i % FW;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const Pixel<T, false> px(il, ir, im, fb, ff, H, W, gy, gx);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        sx[0][c][i] = px.img[c] * px.wgt_b;
        sy[0][c][i] = px.wb.v[c] * px.wgt_b;
        sx[1][c][i] = px.img[c] * px.wgt_f;
        sy[1][c][i] = px.wf.v[c] * px.wgt_f;
      }
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) sx[0][c][i] = sy[0][c][i] = sx[1][c][i] = sy[1][c][i] = 0.f;
    }
  }
  __syncthreads();

  const int gy = ty0 + threadIdx.y, gx = tx0 + threadIdx.x;
  float sums[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (gy < H && gx < W) {
    const Pixel<T, false> px(il, ir, im, fb, ff, H, W, gy, gx);
    const int r = threadIdx.y + 1, q = threadIdx.x + 1;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      float cl = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float s = ssim_of(pool_stats<FW>(sx[d][c], sy[d][c], r, q));
        cl += fminf(fmaxf((1.f - s) * 0.5f, 0.f), 1.f);
      }
      const float wgt = d == 0 ? px.wgt_b : px.wgt_f;
      const float diff = d == 0 ? px.diff_b : px.diff_f;
      sums[3 * d + 0] = diff * wgt;
      sums[3 * d + 1] = wgt;
      sums[3 * d + 2] = cl / 3.f;  // the pooled maps have 3 channels
    }
    const int64_t p = (int64_t)gy * W + gx;
    weights[(int64_t)b * plane + p] = from_f32<T>(px.wgt_b);
    weights[(int64_t)(B + b) * plane + p] = from_f32<T>(px.wgt_f);
  }
  float* out = partials + ((int64_t)b * gridDim.y * gridDim.x + blockIdx.y * gridDim.x +
                           blockIdx.x) * 6;
#pragma unroll
  for (int k = 0; k < 6; ++k) block_sum(sums[k], red, out + k, tid);
}

// ---- backward -----------------------------------------------------------------

constexpr int BH = TY + 4, BW = TX + 4;  // tile + 2-pixel halo: x and y maps
constexpr int QH = TY + 2, QW = TX + 2;  // tile + 1-pixel halo: cotangent maps

template <typename T>
__global__ void __launch_bounds__(NT)
photo_bwd_kernel(const T* __restrict__ img_l, const T* __restrict__ img_r,
                 const T* __restrict__ img, const float* __restrict__ flow_b,
                 const float* __restrict__ flow_f, const float* __restrict__ g_dw,
                 const float* __restrict__ g_cl, float* __restrict__ dflow_b,
                 float* __restrict__ dflow_f, int B, int H, int W) {
  __shared__ float sx[2][3][BH * BW];
  __shared__ float sy[2][3][BH * BW];
  __shared__ float sq[2][3][3][QH * QW];  // [dir][mu_y, pool(y^2), pool(xy)][channel]
  const int b = blockIdx.z;
  const int tx0 = blockIdx.x * TX, ty0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int64_t plane = (int64_t)H * W;
  const T* il = img_l + (int64_t)b * 3 * plane;
  const T* ir = img_r + (int64_t)b * 3 * plane;
  const T* im = img + (int64_t)b * 3 * plane;
  const float* fb = flow_b + (int64_t)b * 2 * plane;
  const float* ff = flow_f + (int64_t)b * 2 * plane;

  for (int i = tid; i < BH * BW; i += NT) {
    const int gy = ty0 - 2 + i / BW, gx = tx0 - 2 + i % BW;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const Pixel<T, false> px(il, ir, im, fb, ff, H, W, gy, gx);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        sx[0][c][i] = px.img[c] * px.wgt_b;
        sy[0][c][i] = px.wb.v[c] * px.wgt_b;
        sx[1][c][i] = px.img[c] * px.wgt_f;
        sy[1][c][i] = px.wf.v[c] * px.wgt_f;
      }
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) sx[0][c][i] = sy[0][c][i] = sx[1][c][i] = sy[1][c][i] = 0.f;
    }
  }
  __syncthreads();

  // cotangents of the pooled statistics at SSIM positions inside the image
  const float gcl[2] = {g_cl[b], g_cl[B + b]};
  for (int i = tid; i < QH * QW; i += NT) {
    const int ly = i / QW, lx = i % QW;
    const int gy = ty0 - 1 + ly, gx = tx0 - 1 + lx;
    const bool in_image = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float q_mu = 0.f, q_py2 = 0.f, q_pxy = 0.f;
        if (in_image) {
          const Stats st = pool_stats<BW>(sx[d][c], sy[d][c], ly + 1, lx + 1);
          float den;
          const float s = ssim_of(st, &den);
          const float h = (1.f - s) * 0.5f;
          const float gs = (h > 0.f && h < 1.f) ? -0.5f * (gcl[d] / 3.f) : 0.f;
          const float sigma_xy = st.pxy - st.mu_x * st.mu_y;
          const float a1 = 2.f * st.mu_x * st.mu_y + kC1;
          const float a2 = 2.f * sigma_xy + kC2;
          const float b1 = st.mu_x * st.mu_x + st.mu_y * st.mu_y + kC1;
          const float b2 = (st.px2 - st.mu_x * st.mu_x) + (st.py2 - st.mu_y * st.mu_y) + kC2;
          const float inv_d = 1.f / den;
          // s = a1 a2 / (b1 b2); d sigma_xy / d mu_y = -mu_x, d sigma_y / d mu_y = -2 mu_y
          const float ds_dmuy = (2.f * st.mu_x * a2 + a1 * (-2.f * st.mu_x)) * inv_d -
                                (s * inv_d) * (2.f * st.mu_y * b2 + b1 * (-2.f * st.mu_y));
          q_mu = gs * ds_dmuy;
          q_py2 = gs * (-(s * inv_d) * b1);
          q_pxy = gs * (a1 * 2.f * inv_d);
        }
        sq[d][0][c][i] = q_mu;
        sq[d][1][c][i] = q_py2;
        sq[d][2][c][i] = q_pxy;
      }
    }
  }
  __syncthreads();

  const int gy = ty0 + threadIdx.y, gx = tx0 + threadIdx.x;
  if (gy >= H || gx >= W) return;
  const Pixel<T, true> px(il, ir, im, fb, ff, H, W, gy, gx);
  const int r = threadIdx.y + 1, q = threadIdx.x + 1;  // in the cotangent maps
  const int rb = r + 1, qb = q + 1;                     // in the x/y maps
  const float n = 1.f / 9.f;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const Warp& wp = d == 0 ? px.wb : px.wf;
    const float wgt = d == 0 ? px.wgt_b : px.wgt_f;
    const float gdw = g_dw[d * B + b];
    float du = 0.f, dv = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float p_mu = 0.f, p_py2 = 0.f, p_pxy = 0.f;
#pragma unroll
      for (int i = -1; i <= 1; ++i) {
#pragma unroll
        for (int j = -1; j <= 1; ++j) {
          const int k = (r + i) * QW + q + j;
          p_mu += sq[d][0][c][k];
          p_py2 += sq[d][1][c][k];
          p_pxy += sq[d][2][c][k];
        }
      }
      const float xv = sx[d][c][rb * BW + qb];
      const float yv = sy[d][c][rb * BW + qb];
      const float dl_dy = p_mu * n + 2.f * yv * (p_py2 * n) + xv * (p_pxy * n);
      const float e = px.img[c] - wp.v[c];
      const float sgn = e > 0.f ? 1.f : (e < 0.f ? -1.f : 0.f);
      const float dl_dwarped = dl_dy * wgt + gdw * wgt * (-sgn / 3.f);
      du += dl_dwarped * wp.ddx[c];
      dv += dl_dwarped * wp.ddy[c];
    }
    float* out = (d == 0 ? dflow_b : dflow_f) + (int64_t)b * 2 * plane + (int64_t)gy * W + gx;
    out[0] = du;
    out[plane] = dv;
  }
}

template <typename T>
cudaError_t launch_fwd(const void* il, const void* ir, const void* im, const float* fb,
                       const float* ff, void* weights, float* partials, int B, int H, int W,
                       cudaStream_t stream) {
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  photo_fwd_kernel<T><<<grid, dim3(TX, TY), 0, stream>>>(
      static_cast<const T*>(il), static_cast<const T*>(ir), static_cast<const T*>(im), fb, ff,
      static_cast<T*>(weights), partials, B, H, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* il, const void* ir, const void* im, const float* fb,
                       const float* ff, const float* g_dw, const float* g_cl, float* dfb,
                       float* dff, int B, int H, int W, cudaStream_t stream) {
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  photo_bwd_kernel<T><<<grid, dim3(TX, TY), 0, stream>>>(
      static_cast<const T*>(il), static_cast<const T*>(ir), static_cast<const T*>(im), fb, ff,
      g_dw, g_cl, dfb, dff, B, H, W);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int W) {
  return B <= 0 || H <= 0 || W <= 0 || B > 65535 || (H + TY - 1) / TY > 65535;
}

}  // namespace

// Images (B, 3, H, W) of dtype 0 = float32 / 1 = bfloat16; flows (B, 2, H, W) f32.
// weights: (2B, 1, H, W) in the image dtype, [bwd; fwd].  partials:
// (B, ceil(H/8) * ceil(W/32), 6) f32: s_dw, s_w, s_cl of bwd, then of fwd.
// Returns the launch's cudaError_t (0 = success).
extern "C" int photo_fwd(const void* img_l, const void* img_r, const void* img,
                         const void* flow_b, const void* flow_f, void* weights, void* partials,
                         int B, int H, int W, int dtype, void* stream) {
  if (bad_shape(B, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb = static_cast<const float*>(flow_b);
  const float* ff = static_cast<const float*>(flow_f);
  float* part = static_cast<float*>(partials);
  switch (dtype) {
    case 0: return (int)launch_fwd<float>(img_l, img_r, img, fb, ff, weights, part, B, H, W, s);
    case 1:
      return (int)launch_fwd<__nv_bfloat16>(img_l, img_r, img, fb, ff, weights, part, B, H, W,
                                            s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// g_dw, g_cl: (2B,) f32 gradients of s_dw and s_cl, [bwd; fwd].
// dflow_b, dflow_f: (B, 2, H, W) f32.
extern "C" int photo_bwd(const void* img_l, const void* img_r, const void* img,
                         const void* flow_b, const void* flow_f, const void* g_dw,
                         const void* g_cl, void* dflow_b, void* dflow_f, int B, int H, int W,
                         int dtype, void* stream) {
  if (bad_shape(B, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb = static_cast<const float*>(flow_b);
  const float* ff = static_cast<const float*>(flow_f);
  const float* gd = static_cast<const float*>(g_dw);
  const float* gc = static_cast<const float*>(g_cl);
  float* db = static_cast<float*>(dflow_b);
  float* df = static_cast<float*>(dflow_f);
  switch (dtype) {
    case 0:
      return (int)launch_bwd<float>(img_l, img_r, img, fb, ff, gd, gc, db, df, B, H, W, s);
    case 1:
      return (int)launch_bwd<__nv_bfloat16>(img_l, img_r, img, fb, ff, gd, gc, db, df, B, H,
                                            W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
