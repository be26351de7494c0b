// One reverse step of the 2D Pi-cell adjoints at one cell, from the packed
// parameters: the fully fused step of pg2d_kernel (backward2d.cu), the 1x1
// streaming step of adj2d_kernel and the k x k activation step of
// adj2d_act_kernel (adj2d.cu).  The ensemble's batched kernels
// (batched2d.cu) run the same steps for member m, from row m of the [M, P]
// parameter table and member m's frames, cotangents, adjoints and
// accumulators, so a member's step is the single model's arithmetic.  The
// steps, the layouts and the designs are described in backward2d.cu and
// adj2d.cu.

#pragma once

#include <cuda_runtime.h>

#include "kxk_common.cuh"
#include "pg_common.cuh"

namespace adj2d {

constexpr int kThreads = 256;

__device__ __forceinline__ float lap5(float c, float a1, float a2, float a3, float a4,
                                      float b1, float b2, float b3, float b4, float inv_dx2) {
  return (-5.0f * c + (4.0f / 3.0f) * (a1 + a2 + a3 + a4) -
          (1.0f / 12.0f) * (b1 + b2 + b3 + b4)) *
         inv_dx2;
}

// The fully fused reverse step t (pg2d_kernel) at cell idx of the block:
// g_out = g_t from g_next = g_{t+1}, h = frame t and fbar = the cotangent of
// frame t + 1, and the cell's accumulators acc[q * H W + idx] updated.
template <int NB>
__device__ __forceinline__ void pg2d_step(const float* __restrict__ params, int n_params,
                                          const float2* __restrict__ h,
                                          const float2* __restrict__ fbar,
                                          const float2* __restrict__ g_next,
                                          float2* __restrict__ g_out,
                                          float* __restrict__ acc, int H, int W, int hidden,
                                          float dt, float inv_dx2) {
  extern __shared__ float sp[];
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sp[k] = params[k];
  __syncthreads();

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int cells = H * W;
  if (idx >= cells) return;
  const int i = idx / W;
  const int j = idx - i * W;
  const int im1 = (i + H - 1) % H, ip1 = (i + 1) % H;
  const int im2 = (i + 2 * H - 2) % H, ip2 = (i + 2) % H;
  const int jm1 = (j + W - 1) % W, jp1 = (j + 1) % W;
  const int jm2 = (j + 2 * W - 2) % W, jp2 = (j + 2) % W;
  // centre, the 4 neighbours at distance 1, the 4 at distance 2
  const int nbr[9] = {idx,         ip1 * W + j, im1 * W + j,
                      i * W + jp1, i * W + jm1, ip2 * W + j,
                      im2 * W + j, i * W + jp2, i * W + jm2};

  float2 hs[9], gs[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    hs[k] = h[nbr[k]];
    const float2 a = g_next[nbr[k]], b = fbar[nbr[k]];
    gs[k] = make_float2(a.x + b.x, a.y + b.y);
  }
  const float u = hs[0].x, v = hs[0].y;
  const float lap_hu = lap5(hs[0].x, hs[1].x, hs[2].x, hs[3].x, hs[4].x, hs[5].x,
                            hs[6].x, hs[7].x, hs[8].x, inv_dx2);
  const float lap_hv = lap5(hs[0].y, hs[1].y, hs[2].y, hs[3].y, hs[4].y, hs[5].y,
                            hs[6].y, hs[7].y, hs[8].y, inv_dx2);
  const float lap_gu = lap5(gs[0].x, gs[1].x, gs[2].x, gs[3].x, gs[4].x, gs[5].x,
                            gs[6].x, gs[7].x, gs[8].x, inv_dx2);
  const float lap_gv = lap5(gs[0].y, gs[1].y, gs[2].y, gs[3].y, gs[4].y, gs[5].y,
                            gs[6].y, gs[7].y, gs[8].y, inv_dx2);
  const float gin[2] = {gs[0].x, gs[0].y};

  float du, dv;
  pg_accumulate<NB>(sp, u, v, gin, lap_hu, lap_hv, acc + idx, cells, hidden, du, dv);
  g_out[idx] = make_float2(gin[0] + dt * (sp[0] * lap_gu + du),
                           gin[1] + dt * (sp[1] * lap_gv + dv));
}

// The 1x1 streaming reverse step t (adj2d_kernel) at cell idx of the block:
// g_in_out = g_ins[t] = g_next + fbar and g_out = g_t.
template <int NB>
__device__ __forceinline__ void adj2d_step_1x1(const float* __restrict__ params, int n_params,
                                               const float2* __restrict__ h,
                                               const float2* __restrict__ fbar,
                                               const float2* __restrict__ g_next,
                                               float2* __restrict__ g_out,
                                               float2* __restrict__ g_in_out, int H, int W,
                                               int hidden, float dt, float inv_dx2) {
  extern __shared__ float sp[];
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sp[k] = params[k];
  __syncthreads();

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= H * W) return;
  const int i = idx / W;
  const int j = idx - i * W;
  const int im1 = (i + H - 1) % H, ip1 = (i + 1) % H;
  const int im2 = (i + 2 * H - 2) % H, ip2 = (i + 2) % H;
  const int jm1 = (j + W - 1) % W, jp1 = (j + 1) % W;
  const int jm2 = (j + 2 * W - 2) % W, jp2 = (j + 2) % W;
  // centre, the 4 neighbours at distance 1, the 4 at distance 2
  const int nbr[9] = {idx,         ip1 * W + j, im1 * W + j,
                      i * W + jp1, i * W + jm1, ip2 * W + j,
                      im2 * W + j, i * W + jp2, i * W + jm2};
  float2 gs[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float2 a = g_next[nbr[k]], b = fbar[nbr[k]];
    gs[k] = make_float2(a.x + b.x, a.y + b.y);
  }
  const float lap_gu = lap5(gs[0].x, gs[1].x, gs[2].x, gs[3].x, gs[4].x, gs[5].x,
                            gs[6].x, gs[7].x, gs[8].x, inv_dx2);
  const float lap_gv = lap5(gs[0].y, gs[1].y, gs[2].y, gs[3].y, gs[4].y, gs[5].y,
                            gs[6].y, gs[7].y, gs[8].y, inv_dx2);
  const float gin[2] = {gs[0].x, gs[0].y};
  g_in_out[idx] = gs[0];
  const float2 x = h[idx];
  float du, dv;
  jacobian_t_1x1<NB>(sp, x.x, x.y, gin, hidden, du, dv);
  g_out[idx] = make_float2(gin[0] + dt * (sp[0] * lap_gu + du),
                           gin[1] + dt * (sp[1] * lap_gv + dv));
}

// acc[q] += w[q * hidden] z for the k k 2 taps of one branch's weights.
template <int KS>
__device__ __forceinline__ void accumulate_taps(const float* w, int hidden, float z,
                                                float (&acc)[KS * KS * 2]) {
#pragma unroll
  for (int q = 0; q < KS * KS * 2; ++q) acc[q] = fmaf(w[q * hidden], z, acc[q]);
}

// Form this equation's share of zw[q] = sum_m w[q, m] z[m], the sum over
// its hidden channels and branches, into acc, from the activations that
// y_of(w, i, c) gives (w the branch's weights at hidden channel c).
template <int KS, int NB, class Y>
__device__ __forceinline__ void contract(const float* p, float gin, int hidden, Y y_of,
                                        float (&acc)[KS * KS * 2]) {
  constexpr int kTaps = KS * KS * 2;
  const int wsize = kTaps * hidden;
  const int stride = wsize + hidden;             // per branch: w_i, then b_i
#pragma unroll
  for (int q = 0; q < kTaps; ++q) acc[q] = 0.0f;
  for (int c = 0; c < hidden; ++c) {
    float y[NB], pre[NB + 1], suf[NB + 1];
#pragma unroll
    for (int i = 0; i < NB; ++i) y[i] = y_of(p + i * stride + c, i, c);
    pre[0] = 1.0f;
    suf[NB] = 1.0f;
#pragma unroll
    for (int i = 0; i < NB; ++i) pre[i + 1] = pre[i] * y[i];
#pragma unroll
    for (int i = NB - 1; i >= 0; --i) suf[i] = suf[i + 1] * y[i];
    const float gw = p[NB * stride + c] * gin;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      accumulate_taps<KS>(p + i * stride + c, hidden, gw * (pre[i] * suf[i + 1]), acc);
  }
}

// The two equations' shares meet in shared memory: the o = 1 threads leave
// theirs in xbuf [kTaps][kCells], the o = 0 threads add them and write zw.
// Every thread of the block calls it (it synchronises).
template <int KS>
__device__ __forceinline__ void write_zw(const float (&acc)[KS * KS * 2], float* xbuf, int o,
                                         int cell, bool inside, float* __restrict__ zw,
                                         size_t cells, int idx) {
  constexpr int kTaps = KS * KS * 2;
  if (o == 1) {
#pragma unroll
    for (int q = 0; q < kTaps; ++q) xbuf[q * kxk::kCells + cell] = acc[q];
  }
  __syncthreads();
  if (o == 0 && inside) {
#pragma unroll
    for (int q = 0; q < kTaps; ++q) zw[q * cells + idx] = acc[q] + xbuf[q * kxk::kCells + cell];
  }
}

// Shared memory of the k > 1 first launches: the packed parameters rounded
// up to 4 floats, the staged tile (the activation step from frames only)
// and xbuf.
template <int KS>
int act_smem_bytes(int n_params, bool tile) {
  return static_cast<int>((n_params + 3) / 4 * 4 * sizeof(float) +
                          (tile ? kxk::kTileLen * sizeof(float2) : 0) +
                          KS * KS * 2 * kxk::kCells * sizeof(float));
}

// k > 1, the first launch of a reverse step (adj2d_act_kernel): g_in and zw
// at every cell of the block's 8 x 16 tile (blockIdx.y, blockIdx.x), two
// threads a cell (one per equation, as in adj2d_kxk_kernel), the
// activations recomputed from frame t.
template <int KS, int NB>
__device__ __forceinline__ void adj2d_act(const float* __restrict__ params, int n_params,
                                          const float2* __restrict__ h,
                                          const float2* __restrict__ g_next,
                                          const float2* __restrict__ fbar,
                                          float2* __restrict__ g_in_out,
                                          float* __restrict__ zw, int H, int W, int hidden) {
  extern __shared__ float4 smem[];
  float* sp = reinterpret_cast<float*>(smem);
  float2* tile = reinterpret_cast<float2*>(sp + (n_params + 3) / 4 * 4);
  float* xbuf = reinterpret_cast<float*>(tile + kxk::kTileLen);
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sp[k] = params[k];
  const int i0 = blockIdx.y * kxk::kTileH, j0 = blockIdx.x * kxk::kTileW;
  kxk::stage_tile(tile, h, H, W, i0, j0);
  __syncthreads();

  const int o = threadIdx.x / kxk::kCells;  // the same in every warp
  const int cell = threadIdx.x - o * kxk::kCells;
  const int li = cell / kxk::kTileW, lj = cell - li * kxk::kTileW;
  const int gi = i0 + li, gj = j0 + lj;
  const bool inside = gi < H && gj < W;
  const int idx = gi * W + gj;
  constexpr int kTaps = KS * KS * 2;
  float acc[kTaps];
#pragma unroll
  for (int q = 0; q < kTaps; ++q) acc[q] = 0.0f;
  if (inside) {
    const float gin = reinterpret_cast<const float*>(g_next)[2 * idx + o] +
                      reinterpret_cast<const float*>(fbar)[2 * idx + o];
    reinterpret_cast<float*>(g_in_out)[2 * idx + o] = gin;
    float tap[4 * kxk::Shape<KS>::kQ];
    kxk::gather_taps<KS>(tile, li, lj, tap);
    const float* p = sp + 2 + o * (NB * (kTaps + 1) * hidden + hidden + 1);
    contract<KS, NB>(p, gin, hidden,
                     [&](const float* w, int i, int c) {
                       return kxk::packed_act<KS>(w, hidden, tap);
                     },
                     acc);
  }
  write_zw<KS>(acc, xbuf, o, cell, inside, zw, static_cast<size_t>(H) * W, idx);
}

}  // namespace adj2d
