// One forward-Euler step of the 2D Pi cell from the packed parameters, at one
// cell of an H x W output, and the launch shape of such a step.
// rollout2d_kernel and final2d_kernel (cell2d.cu) run it for one model;
// rollout2d_batched_kernel (batched2d.cu) runs it for member m of an
// ensemble, from row m of the [M, P] parameter table and member m's frames,
// so a member's step is the single model's arithmetic.  The step, the
// packed layout and the design are described in cell2d.cu.
//
// Where a step reads a cell's neighbours is its Grid: Periodic, the whole
// H x W field with no halo, indices wrapped (those three kernels); Haloed,
// one block of a domain-decomposed field with a 2-cell halo,
// [H + 4, W + 4], whose H x W interior is the output, read without a wrap
// (step2d_haloed_kernel, sharded_step2d.cu).  The arithmetic is the same.

#pragma once

#include <cuda_runtime.h>

#include "kxk_common.cuh"

namespace step2d {

constexpr int kThreads = 256;

// The input indices of output cell idx = (i, j) and of its 5-point cross:
// the centre, the four neighbours at distance 1, the four at distance 2.
struct Cross {
  int c, a1, a2, a3, a4, b1, b2, b3, b4;
};

// The whole H x W field, indices wrapped.
struct Periodic {
  int H, W;

  __device__ __forceinline__ Cross cross(int idx, int i, int j) const {
    const int im1 = (i + H - 1) % H, ip1 = (i + 1) % H;
    const int im2 = (i + 2 * H - 2) % H, ip2 = (i + 2) % H;
    const int jm1 = (j + W - 1) % W, jp1 = (j + 1) % W;
    const int jm2 = (j + 2 * W - 2) % W, jp2 = (j + 2) % W;
    return {idx,          ip1 * W + j, im1 * W + j, i * W + jp1, i * W + jm1,
            ip2 * W + j, im2 * W + j, i * W + jp2, i * W + jm2};
  }

  // The k x k steps' tile: rows i0 - 2 .. i0 + kTileH + 1 and columns
  // j0 - 2 .. j0 + kTileW + 1 of the field, wrapped.
  __device__ __forceinline__ void stage(float2* tile, const float2* __restrict__ in, int i0,
                                        int j0) const {
    kxk::stage_tile(tile, in, H, W, i0, j0);
  }
};

// A block with a 2-cell halo, [H + 4, W + 4]; output cell (i, j) is input
// cell (i + 2, j + 2), and every neighbour a step reads lies in the block.
struct Haloed {
  int H, W;

  __device__ __forceinline__ Cross cross(int, int i, int j) const {
    const int ld = W + 2 * kxk::kHalo;
    const int c = (i + kxk::kHalo) * ld + j + kxk::kHalo;
    return {c, c + ld, c - ld, c + 1, c - 1, c + 2 * ld, c - 2 * ld, c + 2, c - 2};
  }

  // The same tile as Periodic's, rows i0 .. i0 + kTileH + 3 and columns
  // j0 .. j0 + kTileW + 3 of the haloed block, zero past its edge (read only
  // by the tile's cells past the output's edge, which write nothing).
  __device__ __forceinline__ void stage(float2* tile, const float2* __restrict__ in, int i0,
                                        int j0) const {
    kxk::stage_tile_haloed(tile, in, H, W, i0, j0);
  }
};

// Pi-block output for one equation; `p` points at that equation's block.
__device__ __forceinline__ float pi_poly(const float* p, float u, float v,
                                         int hidden, int n_branches) {
  const int stride = 3 * hidden;  // w_i [2, C] then b_i [C]
  const float* w_out = p + n_branches * stride;
  float acc = 0.0f;
  for (int c = 0; c < hidden; ++c) {
    float prod = 1.0f;
    for (int i = 0; i < n_branches; ++i) {
      const float* w = p + i * stride;
      const float y = w[c] * u + w[hidden + c] * v + w[2 * hidden + c];
      prod = (i == 0) ? y : prod * y;
    }
    acc += w_out[c] * prod;
  }
  return acc + w_out[hidden];
}

template <class Grid>
__device__ __forceinline__ void euler_step(const float* __restrict__ params,
                                           int n_params,
                                           const float2* __restrict__ in,
                                           float2* __restrict__ out, Grid g,
                                           int hidden, int n_branches,
                                           float dt, float inv_dx2) {
  extern __shared__ float sp[];
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sp[k] = params[k];
  __syncthreads();

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.H * g.W) return;
  const int i = idx / g.W;
  const int j = idx - i * g.W;
  const Cross x = g.cross(idx, i, j);

  const float2 c = in[x.c];
  const float2 a1 = in[x.a1], a2 = in[x.a2];
  const float2 a3 = in[x.a3], a4 = in[x.a4];
  const float2 b1 = in[x.b1], b2 = in[x.b2];
  const float2 b3 = in[x.b3], b4 = in[x.b4];
  const float s1u = a1.x + a2.x + a3.x + a4.x, s1v = a1.y + a2.y + a3.y + a4.y;
  const float s2u = b1.x + b2.x + b3.x + b4.x, s2v = b1.y + b2.y + b3.y + b4.y;
  const float lap_u = (-5.0f * c.x + (4.0f / 3.0f) * s1u - (1.0f / 12.0f) * s2u) * inv_dx2;
  const float lap_v = (-5.0f * c.y + (4.0f / 3.0f) * s1v - (1.0f / 12.0f) * s2v) * inv_dx2;

  const int block = n_branches * 3 * hidden + hidden + 1;
  const float pi_u = pi_poly(sp + 2, c.x, c.y, hidden, n_branches);
  const float pi_v = pi_poly(sp + 2 + block, c.x, c.y, hidden, n_branches);
  out[idx] = make_float2(c.x + dt * (sp[0] * lap_u + pi_u),
                         c.y + dt * (sp[1] * lap_v + pi_v));
}

// One step of a k x k cell (k = 3, 5) at one cell of the block's tile and
// one equation, from the packed parameters: threads [0, kCells) take
// equation 0 and [kCells, 2 kCells) equation 1, so each warp walks one
// equation's weights (the layout of kxk_common.cuh's kernels).  The tile is
// (blockIdx.y, blockIdx.x).
template <int KS, int NB, class Grid>
__device__ __forceinline__ void euler_step_kxk(const float* __restrict__ params,
                                               int n_params,
                                               const float2* __restrict__ in,
                                               float2* __restrict__ out, Grid g,
                                               int hidden, float dt, float inv_dx2) {
  const int H = g.H, W = g.W;
  extern __shared__ float4 smem_kxk[];
  float* sp = reinterpret_cast<float*>(smem_kxk);
  float2* tile = reinterpret_cast<float2*>(sp + (n_params + 3) / 4 * 4);
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sp[k] = params[k];
  const int i0 = blockIdx.y * kxk::kTileH, j0 = blockIdx.x * kxk::kTileW;
  g.stage(tile, in, i0, j0);
  __syncthreads();

  const int o = threadIdx.x / kxk::kCells;  // the same in every warp
  const int cell = threadIdx.x - o * kxk::kCells;
  const int li = cell / kxk::kTileW, lj = cell - li * kxk::kTileW;
  const int gi = i0 + li, gj = j0 + lj;
  if (gi >= H || gj >= W) return;
  constexpr int kTaps = KS * KS * 2;
  float tap[4 * kxk::Shape<KS>::kQ];
  kxk::gather_taps<KS>(tile, li, lj, tap);
  const int stride = (kTaps + 1) * hidden;            // per branch: w_i, then b_i
  const float* p = sp + 2 + o * (NB * stride + hidden + 1);
  float acc = 0.0f;
  for (int c = 0; c < hidden; ++c) {
    float prod = 1.0f;
#pragma unroll
    for (int i = 0; i < NB; ++i) prod *= kxk::packed_act<KS>(p + i * stride + c, hidden, tap);
    acc = fmaf(p[NB * stride + c], prod, acc);
  }
  const float pi = acc + p[NB * stride + hidden];
  const float lap = kxk::tile_lap(tile, li, lj, o, inv_dx2);
  const float ctr = reinterpret_cast<const float*>(tile)[
      ((li + kxk::kHalo) * kxk::kTileRow + lj + kxk::kHalo) * 2 + o];
  reinterpret_cast<float*>(out)[(gi * W + gj) * 2 + o] = ctr + dt * (sp[o] * lap + pi);
}

// KS = 1 takes the branch count at run time (NB = 0); KS = 3, 5 take it as
// NB.  H x W is the output; the Grid says where its neighbours are read.
template <int KS, int NB, class Grid = Periodic>
__device__ __forceinline__ void step(const float* __restrict__ params, int n_params,
                                     const float2* __restrict__ in,
                                     float2* __restrict__ out, int H, int W,
                                     int hidden, int n_branches, float dt,
                                     float inv_dx2) {
  if constexpr (KS == 1)
    euler_step(params, n_params, in, out, Grid{H, W}, hidden, n_branches, dt, inv_dx2);
  else
    euler_step_kxk<KS, NB>(params, n_params, in, out, Grid{H, W}, hidden, dt, inv_dx2);
}

// The launch shape of a step: H*W threads in blocks of kThreads at k = 1;
// one block of kxk::kThreads threads (two a cell) a kTileH x kTileW tile at
// k > 1, with the packed parameters (rounded up to 4 floats) and the tile
// in shared memory.  The grid's unused dimension (y at k = 1, z at k > 1)
// is 1; the batched kernel puts its members there.
struct Launch {
  dim3 grid, block;
  int smem;
};

template <int KS>
Launch launch_shape(int n_params, int H, int W) {
  if constexpr (KS == 1)
    return {dim3((H * W + kThreads - 1) / kThreads), dim3(kThreads),
            static_cast<int>(n_params * sizeof(float))};
  else
    return {dim3((W + kxk::kTileW - 1) / kxk::kTileW, (H + kxk::kTileH - 1) / kxk::kTileH),
            dim3(kxk::kThreads),
            static_cast<int>((n_params + 3) / 4 * 4 * sizeof(float) +
                             kxk::kTileLen * sizeof(float2))};
}

}  // namespace step2d
