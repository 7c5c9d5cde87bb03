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
// The forward writes 5 partial sums per block (S_sx of bwd, of fwd, S_sy of
// bwd, of fwd, S_c), each into its own plane of partials; the caller sums
// them over the tiles (a deterministic torch reduction, no atomics).  The
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
// ops/regularizer.py::regularizer_pack_reference on the same device.
//
// What bounds it on the card: per pixel about 60 flops against 32 bytes read
// in the forward (4 flow values, 3 image values, 1 weight) and 16 more written
// in the backward, so it is bound by memory, far from the FP32 rate.  Design
// (simple and right first): one block per (sample, 8 x 32 tile of positions),
// one thread per position, both halves in one block (the consistency term
// needs both).  The block loads the four flow planes and the image tile plus
// a halo into shared memory (the forward's stencil reaches 2 pixels right and
// down, the backward's D2^T 2 pixels left and up as well), so each value is
// read from device memory about once.  Images (and the weights, in the
// image's dtype) are float32 or bfloat16, widened to float32; positions,
// weights and sums stay float32.  Every H and W is taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;  // tile width: one warp per row
constexpr int TY = 8;   // tile height
constexpr int NT = TX * TY;
constexpr float kInv20 = 1.0f / 20.0f;  // 0.05f: ops/regularizer.py's INV20
constexpr float kEpsN = 1e-12f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// (g2 - g1) - (g1 - g0) of g = f * 0.05f, rounded as the plain version rounds
__device__ __forceinline__ float d2(float f0, float f1, float f2) {
  const float g0 = __fmul_rn(f0, kInv20);
  const float g1 = __fmul_rn(f1, kInv20);
  const float g2 = __fmul_rn(f2, kInv20);
  return __fsub_rn(__fsub_rn(g2, g1), __fsub_rn(g1, g0));
}

__device__ __forceinline__ float sgn(float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f); }

// exp(-10 mean_c |img[a] - img[b]|) over the 3 shared-memory image planes
template <int N>
__device__ __forceinline__ float edge_w(const float (*si)[N], int a, int b) {
  const float m = (fabsf(si[0][b] - si[0][a]) + fabsf(si[1][b] - si[1][a]) +
                   fabsf(si[2][b] - si[2][a])) / 3.f;
  return expf(-10.f * m);
}

// sqrt(u^2 + v^2 + 1e-24) in the plain version's order, no FMA
__device__ __forceinline__ float norm_of(float u, float v) {
  return sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(u, u), __fmul_rn(v, v)), 1e-24f));
}

// Sum of v over the block into *out (thread 0 writes); red holds NT/32 floats.
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

// Load the flow planes (bwd u, v, fwd u, v) and the image planes of the tile
// plus a halo, starting at (ty0 - halo, tx0 - halo); zeros outside the image.
template <typename T, int RH, int RW>
__device__ __forceinline__ void load_tile(const float* fb, const float* ff, const T* im,
                                          float (*sf)[RH * RW], float (*si)[RH * RW], int H,
                                          int W, int y0, int x0, int tid) {
  const int64_t plane = (int64_t)H * W;
  for (int i = tid; i < RH * RW; i += NT) {
    const int gy = y0 + i / RW, gx = x0 + i % RW;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const int64_t p = in ? (int64_t)gy * W + gx : 0;
    sf[0][i] = in ? fb[p] : 0.f;
    sf[1][i] = in ? fb[plane + p] : 0.f;
    sf[2][i] = in ? ff[p] : 0.f;
    sf[3][i] = in ? ff[plane + p] : 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) si[c][i] = in ? to_f32(im[c * plane + p]) : 0.f;
  }
}

// ---- forward ------------------------------------------------------------------

constexpr int FH = TY + 2, FW = TX + 2;  // tile + the stencil's 2 pixels right and down

template <typename T>
__global__ void __launch_bounds__(NT)
reg_fwd_kernel(const float* __restrict__ flow_b, const float* __restrict__ flow_f,
               const T* __restrict__ img, const T* __restrict__ w_fwd,
               float* __restrict__ partials, int H, int W) {
  __shared__ float sf[4][FH * FW];
  __shared__ float si[3][FH * FW];
  __shared__ float red[NT / 32];
  const int b = blockIdx.z;
  const int tx0 = blockIdx.x * TX, ty0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int64_t plane = (int64_t)H * W;
  load_tile<T, FH, FW>(flow_b + (int64_t)b * 2 * plane, flow_f + (int64_t)b * 2 * plane,
                       img + (int64_t)b * 3 * plane, sf, si, H, W, ty0, tx0, tid);
  __syncthreads();

  const int gy = ty0 + threadIdx.y, gx = tx0 + threadIdx.x;
  float sums[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // sx of half d at d, sy at 2 + d, consis at 4
  if (gy < H && gx < W) {
    const int k = threadIdx.y * FW + threadIdx.x;  // the anchor (gy, gx) of both stencils
    if (gx <= W - 3) {
      const float wx = edge_w<FH * FW>(si, k + 1, k + 2);  // wx[i, j+1]
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const float* u = sf[2 * d];
        const float* v = sf[2 * d + 1];
        sums[d] = wx * (fabsf(d2(u[k], u[k + 1], u[k + 2])) +
                        fabsf(d2(v[k], v[k + 1], v[k + 2])));
      }
    }
    if (gy <= H - 3) {
      const float wy = edge_w<FH * FW>(si, k + FW, k + 2 * FW);  // wy[i+1, j]
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const float* u = sf[2 * d];
        const float* v = sf[2 * d + 1];
        sums[2 + d] = wy * (fabsf(d2(u[k], u[k + FW], u[k + 2 * FW])) +
                            fabsf(d2(v[k], v[k + FW], v[k + 2 * FW])));
      }
    }
    const float ub = sf[0][k], vb = sf[1][k], uf = sf[2][k], vf = sf[3][k];
    const float den_b = norm_of(ub, vb) + kEpsN;
    const float den_f = norm_of(uf, vf) + kEpsN;
    const float ru = uf / den_f + ub / den_b;
    const float rv = vf / den_f + vb / den_b;
    const float occ = 1.f - to_f32(w_fwd[(int64_t)b * plane + (int64_t)gy * W + gx]);
    sums[4] = (fabsf(ru) + fabsf(rv)) * occ;
  }
  // partials[s][b][tile]: (5, B, tiles)
  const int64_t tiles = (int64_t)gridDim.y * gridDim.x;
  float* out = partials + (int64_t)b * tiles + blockIdx.y * gridDim.x + blockIdx.x;
#pragma unroll
  for (int s = 0; s < 5; ++s) block_sum(sums[s], red, out + s * gridDim.z * tiles, tid);
}

// ---- backward -----------------------------------------------------------------

constexpr int BH = TY + 4, BW = TX + 4;  // tile + 2 pixels on every side

template <typename T>
__global__ void __launch_bounds__(NT)
reg_bwd_kernel(const float* __restrict__ flow_b, const float* __restrict__ flow_f,
               const T* __restrict__ img, const T* __restrict__ w_fwd,
               const float* __restrict__ g_sx, const float* __restrict__ g_sy,
               const float* __restrict__ g_c, float* __restrict__ dflow_b,
               float* __restrict__ dflow_f, int B, int H, int W) {
  __shared__ float sf[4][BH * BW];
  __shared__ float si[3][BH * BW];
  const int b = blockIdx.z;
  const int tx0 = blockIdx.x * TX, ty0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int64_t plane = (int64_t)H * W;
  load_tile<T, BH, BW>(flow_b + (int64_t)b * 2 * plane, flow_f + (int64_t)b * 2 * plane,
                       img + (int64_t)b * 3 * plane, sf, si, H, W, ty0 - 2, tx0 - 2, tid);
  __syncthreads();

  const int gy = ty0 + threadIdx.y, gx = tx0 + threadIdx.x;
  if (gy >= H || gx >= W) return;
  const int k = (threadIdx.y + 2) * BW + threadIdx.x + 2;  // (gy, gx) in the tile
  const int64_t p = (int64_t)gy * W + gx;
  float du[2], dv[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const float* u = sf[2 * d];
    const float* v = sf[2 * d + 1];
    // D2^T: the anchors at offsets -2, -1, 0 see this position with +1, -2, +1
    float xu = 0.f, xv = 0.f, yu = 0.f, yv = 0.f;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const float coef = t == 1 ? -2.f : 1.f;
      const int j = gx - 2 + t;
      if (j >= 0 && j <= W - 3) {
        const int a = k - 2 + t;
        const float w = coef * edge_w<BH * BW>(si, a + 1, a + 2);
        xu += w * sgn(d2(u[a], u[a + 1], u[a + 2]));
        xv += w * sgn(d2(v[a], v[a + 1], v[a + 2]));
      }
      const int i = gy - 2 + t;
      if (i >= 0 && i <= H - 3) {
        const int a = k + (t - 2) * BW;
        const float w = coef * edge_w<BH * BW>(si, a + BW, a + 2 * BW);
        yu += w * sgn(d2(u[a], u[a + BW], u[a + 2 * BW]));
        yv += w * sgn(d2(v[a], v[a + BW], v[a + 2 * BW]));
      }
    }
    const float cx = g_sx[d * B + b], cy = g_sy[d * B + b];
    du[d] = (cx * xu + cy * yu) * kInv20;
    dv[d] = (cx * xv + cy * yv) * kInv20;
  }

  // the consistency term reaches flow_f only
  const float ub = sf[0][k], vb = sf[1][k], uf = sf[2][k], vf = sf[3][k];
  const float nf = norm_of(uf, vf);
  const float den_b = norm_of(ub, vb) + kEpsN;
  const float den_f = nf + kEpsN;
  const float su = sgn(uf / den_f + ub / den_b);
  const float sv = sgn(vf / den_f + vb / den_b);
  const float inv = 1.f / den_f;
  const float dot = su * uf + sv * vf;
  const float occ = 1.f - to_f32(w_fwd[(int64_t)b * plane + p]);
  const float cot = g_c[b] * occ;
  const float q = dot * inv * inv / nf;
  float* ob = dflow_b + (int64_t)b * 2 * plane + p;
  float* of = dflow_f + (int64_t)b * 2 * plane + p;
  ob[0] = du[0];
  ob[plane] = dv[0];
  of[0] = du[1] + cot * (su * inv - uf * q);
  of[plane] = dv[1] + cot * (sv * inv - vf * q);
}

template <typename T>
cudaError_t launch_fwd(const float* fb, const float* ff, const void* im, const void* wf,
                       float* partials, int B, int H, int W, cudaStream_t stream) {
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  reg_fwd_kernel<T><<<grid, dim3(TX, TY), 0, stream>>>(
      fb, ff, static_cast<const T*>(im), static_cast<const T*>(wf), partials, H, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const float* fb, const float* ff, const void* im, const void* wf,
                       const float* gsx, const float* gsy, const float* gc, float* dfb,
                       float* dff, int B, int H, int W, cudaStream_t stream) {
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  reg_bwd_kernel<T><<<grid, dim3(TX, TY), 0, stream>>>(
      fb, ff, static_cast<const T*>(im), static_cast<const T*>(wf), gsx, gsy, gc, dfb, dff, B,
      H, W);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int W) {
  return B <= 0 || H <= 0 || W <= 0 || B > 65535 || (H + TY - 1) / TY > 65535;
}

}  // namespace

// Flows (B, 2, H, W) f32; image (B, 3, H, W) and w_fwd (B, 1, H, W) of dtype
// 0 = float32 / 1 = bfloat16.  partials: (5, B, ceil(H/8) * ceil(W/32)) f32:
// s_sx of bwd, of fwd, s_sy of bwd, of fwd, then s_consis.  Returns the launch's
// cudaError_t (0 = success).
extern "C" int reg_fwd(const void* flow_b, const void* flow_f, const void* img,
                       const void* w_fwd, void* partials, int B, int H, int W, int dtype,
                       void* stream) {
  if (bad_shape(B, H, W)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb = static_cast<const float*>(flow_b);
  const float* ff = static_cast<const float*>(flow_f);
  float* part = static_cast<float*>(partials);
  switch (dtype) {
    case 0: return (int)launch_fwd<float>(fb, ff, img, w_fwd, part, B, H, W, s);
    case 1: return (int)launch_fwd<__nv_bfloat16>(fb, ff, img, w_fwd, part, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// g_sx, g_sy: (2B,) f32 gradients of s_sx and s_sy, [bwd; fwd]; g_c: (B,) of
// s_consis.  dflow_b, dflow_f: (B, 2, H, W) f32.
extern "C" int reg_bwd(const void* flow_b, const void* flow_f, const void* img,
                       const void* w_fwd, const void* g_sx, const void* g_sy, const void* g_c,
                       void* dflow_b, void* dflow_f, int B, int H, int W, int dtype,
                       void* stream) {
  if (bad_shape(B, H, W)) return (int)cudaErrorInvalidValue;
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
      return (int)launch_bwd<float>(fb, ff, img, w_fwd, gsx, gsy, gc, db, df, B, H, W, s);
    case 1:
      return (int)launch_bwd<__nv_bfloat16>(fb, ff, img, w_fwd, gsx, gsy, gc, db, df, B, H,
                                            W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
