// One reverse step of the 2D Pi-cell adjoints at one cell, from the packed
// parameters: the fully fused step of pg2d_kernel (backward2d.cu), the 1x1
// streaming step of adj2d_kernel and the k x k activation step of
// adj2d_act_kernel (adj2d.cu).  The ensemble's batched kernels
// (batched2d.cu) run the same steps for member m, from row m of the [M, P]
// parameter table and member m's frames, cotangents, adjoints and
// accumulators, so a member's step is the single model's arithmetic.  At the
// end, persistent_sweep: the whole 1x1 reverse sweep in one cooperative
// launch, with the parameter gradients accumulated (pg2d_persistent_kernel,
// backward2d.cu) or the adjoint streamed out (adj2d_persistent_kernel,
// adj2d.cu; every member's at once, adj2d_batched_persistent_kernel,
// batched2d.cu), the same code and the same arithmetic.  The steps, the layouts
// and the designs are described in backward2d.cu and adj2d.cu.

#pragma once

#include <cooperative_groups.h>
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

// The whole 1x1 reverse sweep in one cooperative launch (pg2d_persistent_kernel
// with kAcc, adj2d_persistent_kernel without): block b owns the cells
// [first, first + n_own) of the H W field (the balanced split of
// split_evenly in ../cell2d.py) for every step.  With kAcc it keeps their A
// accumulators in its shared memory, plane-major ([A][cap], cap the most
// cells a block owns), from the first step to the last; they reach the
// [A, H, W] planes `acc` once, at the end.  Without it there is no
// accumulator: g_in of every step goes to g_ins[t] and a block needs only the
// packed parameters and 6 + 4 C floats a cell.  A reverse step t, three
// passes with a __syncthreads between them:
//   1. a thread a cell: g_in and h_t at its 9-point cross (g_in formed at
//      each point, g_{t+1} + fbar_{t+1}, as pg2d_step does), the Laplacian of
//      g_in and, with kAcc, of h_t, the diffusion and b_out accumulators
//      (without it h_t at the cell alone, and g_in stored to g_ins[t]), and
//      the cell's u, v, g_in and Lap g_in kept in shared memory;
//   2. a thread a (equation o, hidden channel c, cell) item, the cell index
//      fastest, so a warp's shared-memory traffic is conflict-free: the
//      branch activations, the full and leave-one-out products, with kAcc
//      the w_out, dw and db accumulators of (o, c), each owned by this item
//      alone (no atomics), and the item's share of the Jacobian's transpose;
//   3. a thread a cell: the 2 C shares summed in (o, c) order and g_t
//      written to global memory.
// Then one grid.sync() makes g_t visible to every block's next step; g
// ping-pongs between g0 and scratch, in the order that makes the last step
// (t = 0) write g0.  A thread's first cell is the same at every step: its
// stencil indices are worked out once, and its h_{t-1} and fbar_t are
// loaded before the barrier that ends step t.  Without kAcc the neighbours'
// g_{t+1}, written by other blocks in this launch, are read past the SM's
// L1 (__ldcg).  The step's arithmetic is pg2d_step's and pg_accumulate's,
// expression for expression, except that the Jacobian's sum is taken per
// (o, c) and then over (o, c); passes 2 and 3 are the same code with and
// without kAcc, so the two kernels' g0 agree to the bit.
// With kMembers (an ensemble's M members, without kAcc) the grid is M runs of
// per_member blocks: block (mem, b) = (blockIdx.x / per_member, blockIdx.x %
// per_member) owns split_evenly's share of per_member on member mem's field,
// reads its row of the [M, P] parameter table, its frames and cotangents and
// writes its g0, scratch and g_ins, each at mem times its member stride in
// size_t; one grid.sync() a step serves every member.  A member's block
// owns n_sm // M times the cells of the single model's, so pass 2 takes
// pg2d_batched_persistent_kernel's mapping (batched2d.cu): thread tid keeps
// the (o, c) group tid / L (L = blockDim.x / (2 C) threads a group; the
// last blockDim.x % (2 C) threads idle) and its cells li, li + L, ... (li =
// tid % L) for the whole sweep, its group's 3 NB + 1 weights in registers,
// in place of 3 NB + 1 shared-memory loads and a division an item.  The
// expressions are the same, so a cell's arithmetic does not depend on the
// split or the mapping, and member m's g0 and g_ins equal the single
// model's on member m to the bit.  The flag is a template parameter so that
// the single model's instances keep their machine code.
template <int NB, bool kAcc, bool kMembers = false>
__device__ __forceinline__ void persistent_sweep(const float* __restrict__ params, int n_params,
                                                 const float2* __restrict__ frames,
                                                 const float2* __restrict__ frames_bar,
                                                 float2* g0, float2* scratch,
                                                 float* __restrict__ acc, float2* g_ins,
                                                 int n_steps, int H, int W, int hidden,
                                                 float dt, float inv_dx2, int per_member = 0) {
  static_assert(!(kAcc && kMembers), "the member axis streams the adjoint out");
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int cells = H * W;
  const int mem = kMembers ? static_cast<int>(blockIdx.x) / per_member : 0;
  const int nblk = kMembers ? per_member : static_cast<int>(gridDim.x);
  const int b = kMembers ? static_cast<int>(blockIdx.x) - mem * per_member
                         : static_cast<int>(blockIdx.x);
  if constexpr (kMembers) {
    const size_t frame_stride = (static_cast<size_t>(n_steps) + 1) * cells;
    params += static_cast<size_t>(mem) * n_params;
    frames += mem * frame_stride;
    frames_bar += mem * frame_stride;
    g0 += static_cast<size_t>(mem) * cells;
    scratch += static_cast<size_t>(mem) * cells;
    g_ins += static_cast<size_t>(mem) * n_steps * cells;
  }
  const int q = cells / nblk, m = cells % nblk;
  const int n_own = q + (b < m ? 1 : 0);
  const int first = b * q + (b < m ? b : m);
  const int cap = (cells + nblk - 1) / nblk;
  const int C = hidden, G = 2 * hidden;
  // plane offsets (backward2d.py: _pg_layout)
  const int p_dw = 0;
  const int p_db = 2 * NB * C * 2;
  const int p_wout = p_db + 2 * NB * C;
  const int p_bout = p_wout + 2 * C;
  const int p_diff = p_bout + 2;
  const int n_planes = kAcc ? p_diff + 2 : 0;
  const int stride = 3 * C;               // per branch: w_i[0, :], w_i[1, :], b_i
  const int block = NB * stride + C + 1;  // per equation, then w_out [C], b_out

  extern __shared__ float4 smem_pg[];
  float* sp = reinterpret_cast<float*>(smem_pg);
  float* sacc = sp + (n_params + 3) / 4 * 4;  // [n_planes][cap], with kAcc
  float* st = sacc + n_planes * cap;          // [6][cap]: u, v, g_in (2), Lap g_in (2)
  float* part = st + 6 * cap;                 // [2][G][cap]: the Jacobian's shares
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sp[k] = params[k];
  if constexpr (kAcc) {
    for (int k = threadIdx.x; k < n_planes * cap; k += blockDim.x) sacc[k] = 0.0f;
  }

  // centre, the 4 neighbours at distance 1, the 4 at distance 2 of cell idx
  auto cross = [&](int idx, int (&nbr)[9]) {
    const int i = idx / W;
    const int j = idx - i * W;
    const int im1 = (i + H - 1) % H, ip1 = (i + 1) % H;
    const int im2 = (i + 2 * H - 2) % H, ip2 = (i + 2) % H;
    const int jm1 = (j + W - 1) % W, jp1 = (j + 1) % W;
    const int jm2 = (j + 2 * W - 2) % W, jp2 = (j + 2) % W;
    nbr[0] = idx;
    nbr[1] = ip1 * W + j;
    nbr[2] = im1 * W + j;
    nbr[3] = i * W + jp1;
    nbr[4] = i * W + jm1;
    nbr[5] = ip2 * W + j;
    nbr[6] = im2 * W + j;
    nbr[7] = i * W + jp2;
    nbr[8] = i * W + jm2;
  };
  // g_{t+1} at a cell: with kAcc a plain load, as pg2d_persistent_kernel
  // has always read it; without, past L1
  auto g_at = [&](const float2* p) {
    if constexpr (kAcc) {
      return *p;
    } else {
      return __ldcg(p);
    }
  };
  // A thread's first cell is the same at every step: its cross is worked
  // out once, and its h_t (the centre alone without kAcc) and fbar_{t+1},
  // which do not depend on g, are loaded before the grid barrier that
  // precedes step t.
  const int k0 = threadIdx.x;
  int nbr0[9];
  cross(first + (k0 < n_own ? k0 : 0), nbr0);
  float2 h_next[9], fb_next[9];
  auto prefetch = [&](int t) {
    if (k0 >= n_own || t < 0) return;
    const float2* h = frames + static_cast<size_t>(t) * cells;
    const float2* fbar = frames_bar + static_cast<size_t>(t + 1) * cells;
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      if (kAcc || e == 0) h_next[e] = h[nbr0[e]];
      fb_next[e] = fbar[nbr0[e]];
    }
  };
  prefetch(n_steps - 1);
  __syncthreads();
  // with kMembers, this thread's pass-2 group and its weights for the sweep
  const int L = kMembers ? static_cast<int>(blockDim.x) / G : 1;
  const int grp_m = kMembers ? static_cast<int>(threadIdx.x) / L : 0;
  const int li = static_cast<int>(threadIdx.x) - grp_m * L;
  const int o_m = grp_m / C, c_m = grp_m - o_m * C;
  float wu[NB], wv[NB], wb[NB], wo_m = 0.0f;
  if constexpr (kMembers) {
    if (grp_m < G) {
      const float* p = sp + 2 + o_m * block;
      wo_m = p[NB * stride + c_m];
#pragma unroll
      for (int e = 0; e < NB; ++e) {
        wu[e] = p[e * stride + c_m];
        wv[e] = p[e * stride + C + c_m];
        wb[e] = p[e * stride + 2 * C + c_m];
      }
    }
  }

  for (int s = 0; s < n_steps; ++s) {
    const int t = n_steps - 1 - s;
    float2* dst = (t % 2 == 0) ? g0 : scratch;
    const float2* src = (t % 2 == 0) ? scratch : g0;
    const float2* h = frames + static_cast<size_t>(t) * cells;
    const float2* fbar = frames_bar + static_cast<size_t>(t + 1) * cells;
    for (int k = k0; k < n_own; k += blockDim.x) {
      int nbr[9];
      float2 hs[9], gs[9];
      if (k == k0) {
#pragma unroll
        for (int e = 0; e < 9; ++e) {
          nbr[e] = nbr0[e];
          if (kAcc || e == 0) hs[e] = h_next[e];
          const float2 a = g_at(src + nbr[e]), fb = fb_next[e];
          gs[e] = make_float2(a.x + fb.x, a.y + fb.y);
        }
      } else {
        cross(first + k, nbr);
#pragma unroll
        for (int e = 0; e < 9; ++e) {
          if (kAcc || e == 0) hs[e] = h[nbr[e]];
          const float2 a = g_at(src + nbr[e]), fb = fbar[nbr[e]];
          gs[e] = make_float2(a.x + fb.x, a.y + fb.y);
        }
      }
      float lap_hu = 0.0f, lap_hv = 0.0f;
      if constexpr (kAcc) {
        lap_hu = lap5(hs[0].x, hs[1].x, hs[2].x, hs[3].x, hs[4].x, hs[5].x, hs[6].x, hs[7].x,
                      hs[8].x, inv_dx2);
        lap_hv = lap5(hs[0].y, hs[1].y, hs[2].y, hs[3].y, hs[4].y, hs[5].y, hs[6].y, hs[7].y,
                      hs[8].y, inv_dx2);
      }
      st[k] = hs[0].x;
      st[cap + k] = hs[0].y;
      st[2 * cap + k] = gs[0].x;
      st[3 * cap + k] = gs[0].y;
      st[4 * cap + k] = lap5(gs[0].x, gs[1].x, gs[2].x, gs[3].x, gs[4].x, gs[5].x, gs[6].x,
                             gs[7].x, gs[8].x, inv_dx2);
      st[5 * cap + k] = lap5(gs[0].y, gs[1].y, gs[2].y, gs[3].y, gs[4].y, gs[5].y, gs[6].y,
                             gs[7].y, gs[8].y, inv_dx2);
      if constexpr (kAcc) {
        sacc[p_diff * cap + k] += gs[0].x * lap_hu;
        sacc[(p_diff + 1) * cap + k] += gs[0].y * lap_hv;
        sacc[p_bout * cap + k] += gs[0].x;
        sacc[(p_bout + 1) * cap + k] += gs[0].y;
      } else {
        g_ins[static_cast<size_t>(t) * cells + first + k] = gs[0];
      }
    }
    __syncthreads();
    if constexpr (kMembers) {
      for (int k = li; grp_m < G && k < n_own; k += L) {
        const float u = st[k], v = st[cap + k], g = st[(2 + o_m) * cap + k];
        float y[NB];
#pragma unroll
        for (int e = 0; e < NB; ++e) y[e] = wu[e] * u + wv[e] * v + wb[e];
        float pre[NB + 1], suf[NB + 1];
        pre[0] = 1.0f;
        suf[NB] = 1.0f;
#pragma unroll
        for (int e = 0; e < NB; ++e) pre[e + 1] = pre[e] * y[e];
#pragma unroll
        for (int e = NB - 1; e >= 0; --e) suf[e] = suf[e + 1] * y[e];
        float du = 0.0f, dv = 0.0f;
#pragma unroll
        for (int e = 0; e < NB; ++e) {
          const float zz = g * (pre[e] * suf[e + 1]);
          du += (wu[e] * wo_m) * zz;
          dv += (wv[e] * wo_m) * zz;
        }
        part[grp_m * cap + k] = du;
        part[(G + grp_m) * cap + k] = dv;
      }
    } else {
      for (int it = threadIdx.x; it < G * n_own; it += blockDim.x) {
        const int grp = it / n_own;
        const int k = it - grp * n_own;
        const int o = grp / C, c = grp - o * C;
        const float u = st[k], v = st[cap + k], g = st[(2 + o) * cap + k];
        const float* p = sp + 2 + o * block;
        float y[NB];
#pragma unroll
        for (int e = 0; e < NB; ++e)
          y[e] = p[e * stride + c] * u + p[e * stride + C + c] * v + p[e * stride + 2 * C + c];
        // prod_{j != e} y_j from prefix and suffix products
        float pre[NB + 1], suf[NB + 1];
        pre[0] = 1.0f;
        suf[NB] = 1.0f;
#pragma unroll
        for (int e = 0; e < NB; ++e) pre[e + 1] = pre[e] * y[e];
#pragma unroll
        for (int e = NB - 1; e >= 0; --e) suf[e] = suf[e + 1] * y[e];
        if constexpr (kAcc) sacc[(p_wout + o * C + c) * cap + k] += g * pre[NB];
        const float wo = p[NB * stride + c];
        float du = 0.0f, dv = 0.0f;
#pragma unroll
        for (int e = 0; e < NB; ++e) {
          const float zz = g * (pre[e] * suf[e + 1]);
          if constexpr (kAcc) {
            const int qq = (o * NB + e) * C + c;
            sacc[(p_dw + 2 * qq) * cap + k] += zz * u;
            sacc[(p_dw + 2 * qq + 1) * cap + k] += zz * v;
            sacc[(p_db + qq) * cap + k] += zz;
          }
          du += (p[e * stride + c] * wo) * zz;
          dv += (p[e * stride + C + c] * wo) * zz;
        }
        part[grp * cap + k] = du;
        part[(G + grp) * cap + k] = dv;
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < n_own; k += blockDim.x) {
      float du = 0.0f, dv = 0.0f;
      for (int grp = 0; grp < G; ++grp) {
        du += part[grp * cap + k];
        dv += part[(G + grp) * cap + k];
      }
      dst[first + k] = make_float2(st[2 * cap + k] + dt * (sp[0] * st[4 * cap + k] + du),
                                   st[3 * cap + k] + dt * (sp[1] * st[5 * cap + k] + dv));
    }
    prefetch(t - 1);
    grid.sync();
  }
  if constexpr (kAcc) {
    for (int pl = 0; pl < n_planes; ++pl)
      for (int k = threadIdx.x; k < n_own; k += blockDim.x)
        acc[static_cast<size_t>(pl) * cells + first + k] = sacc[pl * cap + k];
  }
}

// Dynamic shared memory of persistent_sweep on `blocks` blocks: the packed
// parameters rounded up to 4 floats, then [n_planes + 6 + 4 C][cap] floats
// (n_planes the A accumulators with kAcc, else 0; persistent_smem_bytes and
// adj_smem_bytes in ../backward2d.py).
inline size_t persistent_smem(int n_params, int H, int W, int hidden, size_t n_planes,
                              int blocks) {
  const size_t cap = (static_cast<size_t>(H) * W + blocks - 1) / blocks;
  return ((n_params + 3) / 4 * 4 + (n_planes + 6 + 4 * static_cast<size_t>(hidden)) * cap) *
         sizeof(float);
}

}  // namespace adj2d
