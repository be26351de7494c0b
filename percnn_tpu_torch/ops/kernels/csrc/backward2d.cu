// Reverse sweep of the forward-Euler 1x1 Pi-cell rollout (csrc/cell2d.cu)
// with every parameter gradient accumulated in the same pass.
//
// One reverse step t (t = T-1 .. 0), for every cell of the periodic H x W grid:
//   g_in  = g_{t+1} + fbar_{t+1}                     (g_T = 0)
//   acc[diff + o]  += g_in[o] * Lap(h_t)[o]
//   acc[bout + o]  += g_in[o]
//   per equation o, hidden channel c, branch i, y_i = w_i[0,c] u + w_i[1,c] v + b_i[c]:
//     acc[wout + o C + c]          += g * prod_j y_j
//     zz = g * prod_{j != i} y_j
//     acc[dw + ((o nb + i) C + c) 2 + cin] += zz * (u, v)[cin]
//     acc[db + (o nb + i) C + c]            += zz
//   g_t   = g_in + dt (D * Lap(g_in) + sum_{o,c,i} (w_i[0,c], w_i[1,c]) w_out[c] zz)
// with g = g_in[o], (u, v) = h_t at the cell and Lap the 4th-order periodic
// Laplacian of cell2d.cu (symmetric, so it is its own adjoint).  The A
// accumulator planes ([A, H, W] f32, A = 164 for GS2D) are summed over the
// grid after the sweep; dt, the w_out factor of dw and db, and the diffusion
// reparametrisation are applied outside (backward2d.py: _pg_unpack).  The
// packed parameters follow pack_pi_params_2d (cell2d.py).
//
// pg2d_persistent_kernel replaces percnn_tpu/ops/pallas/backward2d.py:
// _phase1_pg_kernel (pallas_call in _fused_phase1_pg) on any field whose
// accumulators fit the co-resident blocks' shared memory (194 x 194 at most
// on 132 SMs; pg_plan in ../backward2d.py); pg2d_kernel replaces it past
// that.  The accumulation at a cell is pg_accumulate's (pg_common.cuh,
// shared with the 3D sweep, backward3d.cu, and kept as it was for
// pg2d_kernel and the ensemble's pg2d_batched_kernel); the persistent
// kernel writes the same expressions per (equation, hidden channel) group.
//
// Bound on an H100 SXM at its 700 W power limit (published peaks: 3.35 TB/s,
// 67 TFLOP/s f32 outside the tensor cores), GS2D training shape 100 x 100,
// T = 800:
//   operations: 848 flops per cell and step that the function needs (48 for
//          each of the 16 equation and hidden-channel pairs: 12 for the
//          activations, 4 multiplies for the full and the three
//          leave-one-out products, 2 for the w_out plane, 10 per branch for
//          zz, dw, db and the Jacobian, whose w_i * w_out depends on the
//          parameters only and is not counted per cell; plus 80 for g_in,
//          four Laplacians, the diffusion and b_out planes and the update;
//          chip_smoke.py counts them), 6.8 GFLOP per backward: 101 us;
//   bytes: h_t and fbar_{t+1} once per step, 2 x 80 KB x 800 = 128 MB, plus
//          6.6 MB of accumulator planes and g0 written once: 40 us.
// So it is bound by operations on paper.  As for the forward, what limits
// a design is the chain of T dependent steps.  pg2d_kernel takes one launch
// a reverse step over H*W threads, one cell a thread, the loop here in C: a
// launch has no grid-wide barrier, so each thread forms g_in itself at its
// 8 stencil neighbours, g ping-pongs between two [H, W, 2] buffers, and each
// thread owns its cell's entry of every accumulator plane, read and written
// every step (13 MB a step for 100 x 100, held in the 50 MB L2; each
// (equation, hidden channel) group of planes is loaded before it is
// stored).  pg2d_persistent_kernel runs the whole sweep in one cooperative
// launch, one block an SM, each block's cells' accumulators in its shared
// memory from the first step to the last, the work of a step spread over
// (equation, hidden channel, cell) items, and one grid barrier a step (the
// design is described at the kernel).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W, per
// T = 800 backward at 100 x 100: pg2d_persistent_kernel 2.931 ms, one
// launch, 3.66 us a step; pg2d_kernel 7.203 ms in the same call (9.0 us a
// step).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "adj2d_step.cuh"

namespace {

namespace cg = cooperative_groups;

using adj2d::kThreads;

// Threads a block of pg2d_persistent_kernel.
constexpr int kPersistentThreads = 512;

// The whole reverse sweep in one cooperative launch: block b owns the cells
// [first, first + n_own) of the H W field (the balanced split of
// split_evenly in ../cell2d.py) for every step, and keeps their A
// accumulators in its shared memory, plane-major ([A][cap], cap the most
// cells a block owns), from the first step to the last; they reach the
// [A, H, W] planes once, at the end.  A reverse step t, three passes with a
// __syncthreads between them:
//   1. a thread a cell: g_in and h_t at its 9-point cross (g_in formed at
//      each point, g_{t+1} + fbar_{t+1}, as pg2d_step does), the two
//      Laplacians of each, the diffusion and b_out accumulators, and the
//      cell's u, v, g_in and Lap g_in kept in shared memory;
//   2. a thread a (equation o, hidden channel c, cell) item, the cell index
//      fastest, so a warp's accumulator traffic is conflict-free: the
//      branch activations, the full and leave-one-out products, the w_out,
//      dw and db accumulators of (o, c), each owned by this item alone (no
//      atomics), and the item's share of the Jacobian's transpose;
//   3. a thread a cell: the 2 C shares summed in (o, c) order and g_t
//      written to global memory.
// Then one grid.sync() makes g_t visible to every block's next step; g
// ping-pongs between g0 and scratch, in the order that makes the last step
// (t = 0) write g0.  A thread's first cell is the same at every step: its
// stencil indices are worked out once, and its h_{t-1} and fbar_t are
// loaded before the barrier that ends step t.  The step's arithmetic is
// pg2d_step's and pg_accumulate's, expression for expression, except that
// the Jacobian's sum is taken per (o, c) and then over (o, c).
template <int NB>
__global__ void __launch_bounds__(kPersistentThreads)
    pg2d_persistent_kernel(const float* __restrict__ params, int n_params,
                           const float2* __restrict__ frames,
                           const float2* __restrict__ frames_bar, float2* g0, float2* scratch,
                           float* __restrict__ acc, int n_steps, int H, int W, int hidden,
                           float dt, float inv_dx2) {
  cg::grid_group grid = cg::this_grid();
  const int cells = H * W;
  const int nblk = gridDim.x, b = blockIdx.x;
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
  const int n_planes = p_diff + 2;
  const int stride = 3 * C;               // per branch: w_i[0, :], w_i[1, :], b_i
  const int block = NB * stride + C + 1;  // per equation, then w_out [C], b_out

  extern __shared__ float4 smem_pg[];
  float* sp = reinterpret_cast<float*>(smem_pg);
  float* sacc = sp + (n_params + 3) / 4 * 4;  // [n_planes][cap]
  float* st = sacc + n_planes * cap;          // [6][cap]: u, v, g_in (2), Lap g_in (2)
  float* part = st + 6 * cap;                 // [2][G][cap]: the Jacobian's shares
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sp[k] = params[k];
  for (int k = threadIdx.x; k < n_planes * cap; k += blockDim.x) sacc[k] = 0.0f;

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
  // A thread's first cell is the same at every step: its cross is worked
  // out once, and its h_t and fbar_{t+1}, which do not depend on g, are
  // loaded before the grid barrier that precedes step t.
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
      h_next[e] = h[nbr0[e]];
      fb_next[e] = fbar[nbr0[e]];
    }
  };
  prefetch(n_steps - 1);
  __syncthreads();

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
          hs[e] = h_next[e];
          const float2 a = src[nbr[e]], fb = fb_next[e];
          gs[e] = make_float2(a.x + fb.x, a.y + fb.y);
        }
      } else {
        cross(first + k, nbr);
#pragma unroll
        for (int e = 0; e < 9; ++e) {
          hs[e] = h[nbr[e]];
          const float2 a = src[nbr[e]], fb = fbar[nbr[e]];
          gs[e] = make_float2(a.x + fb.x, a.y + fb.y);
        }
      }
      const float lap_hu = adj2d::lap5(hs[0].x, hs[1].x, hs[2].x, hs[3].x, hs[4].x, hs[5].x,
                                       hs[6].x, hs[7].x, hs[8].x, inv_dx2);
      const float lap_hv = adj2d::lap5(hs[0].y, hs[1].y, hs[2].y, hs[3].y, hs[4].y, hs[5].y,
                                       hs[6].y, hs[7].y, hs[8].y, inv_dx2);
      st[k] = hs[0].x;
      st[cap + k] = hs[0].y;
      st[2 * cap + k] = gs[0].x;
      st[3 * cap + k] = gs[0].y;
      st[4 * cap + k] = adj2d::lap5(gs[0].x, gs[1].x, gs[2].x, gs[3].x, gs[4].x, gs[5].x,
                                    gs[6].x, gs[7].x, gs[8].x, inv_dx2);
      st[5 * cap + k] = adj2d::lap5(gs[0].y, gs[1].y, gs[2].y, gs[3].y, gs[4].y, gs[5].y,
                                    gs[6].y, gs[7].y, gs[8].y, inv_dx2);
      sacc[p_diff * cap + k] += gs[0].x * lap_hu;
      sacc[(p_diff + 1) * cap + k] += gs[0].y * lap_hv;
      sacc[p_bout * cap + k] += gs[0].x;
      sacc[(p_bout + 1) * cap + k] += gs[0].y;
    }
    __syncthreads();
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
      sacc[(p_wout + o * C + c) * cap + k] += g * pre[NB];
      const float wo = p[NB * stride + c];
      float du = 0.0f, dv = 0.0f;
#pragma unroll
      for (int e = 0; e < NB; ++e) {
        const float zz = g * (pre[e] * suf[e + 1]);
        const int qq = (o * NB + e) * C + c;
        sacc[(p_dw + 2 * qq) * cap + k] += zz * u;
        sacc[(p_dw + 2 * qq + 1) * cap + k] += zz * v;
        sacc[(p_db + qq) * cap + k] += zz;
        du += (p[e * stride + c] * wo) * zz;
        dv += (p[e * stride + C + c] * wo) * zz;
      }
      part[grp * cap + k] = du;
      part[(G + grp) * cap + k] = dv;
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
  for (int pl = 0; pl < n_planes; ++pl)
    for (int k = threadIdx.x; k < n_own; k += blockDim.x)
      acc[static_cast<size_t>(pl) * cells + first + k] = sacc[pl * cap + k];
}

// Dynamic shared memory of pg2d_persistent_kernel on `blocks` blocks: the
// packed parameters rounded up to 4 floats, then [A + 6 + 4 C][cap] floats
// (persistent_smem_bytes in ../backward2d.py).
size_t persistent_smem_bytes(int n_params, int H, int W, int hidden, int n_branches,
                             int blocks) {
  const size_t cap = (static_cast<size_t>(H) * W + blocks - 1) / blocks;
  const size_t planes = 2 * n_branches * hidden * 3 + 2 * hidden + 4;
  return ((n_params + 3) / 4 * 4 + (planes + 6 + 4 * hidden) * cap) * sizeof(float);
}

// How many blocks of pg2d_persistent_kernel<NB> an SM holds at once, its
// shared memory allowed.
template <int NB>
cudaError_t persistent_occupancy(size_t smem, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(pg2d_persistent_kernel<NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, pg2d_persistent_kernel<NB>,
                                                       kPersistentThreads, smem);
}

template <int NB>
cudaError_t persistent_sweep(const float* params, int n_params, const float2* frames,
                             const float2* frames_bar, float2* g0, float2* scratch, float* acc,
                             int n_steps, int H, int W, int hidden, float dt, float inv_dx2,
                             int blocks, cudaStream_t stream, int* per_sm) {
  const size_t smem = persistent_smem_bytes(n_params, H, W, hidden, NB, blocks);
  cudaError_t err = persistent_occupancy<NB>(smem, per_sm);
  if (err != cudaSuccess) return err;
  int device, sms;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // a cooperative grid must be co-resident; one past it would be refused
  if (blocks > *per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&params, &n_params, &frames, &frames_bar, &g0, &scratch, &acc, &n_steps,
                  &H, &W, &hidden, &dt, &inv_dx2};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(pg2d_persistent_kernel<NB>),
                                    dim3(blocks), dim3(kPersistentThreads), args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int NB>
__global__ void pg2d_kernel(const float* __restrict__ params, int n_params,
                            const float2* __restrict__ h,     // frame t
                            const float2* __restrict__ fbar,  // cotangent of frame t + 1
                            const float2* __restrict__ g_next,
                            float2* __restrict__ g_out,
                            float* __restrict__ acc, int H, int W, int hidden,
                            float dt, float inv_dx2) {
  adj2d::pg2d_step<NB>(params, n_params, h, fbar, g_next, g_out, acc, H, W, hidden, dt,
                       inv_dx2);
}

template <int NB>
cudaError_t sweep(const float* params, int n_params, const float2* frames,
                  const float2* frames_bar, float2* g0, float2* scratch,
                  float* acc, int n_steps, int H, int W, int hidden, float dt,
                  float inv_dx2, cudaStream_t stream) {
  const size_t cells = static_cast<size_t>(H) * W;
  const int blocks = static_cast<int>((cells + kThreads - 1) / kThreads);
  // Both g buffers start at zero (the wrapper zeroes them).  Step s reads
  // one and writes the other, in the order that makes the last step (t = 0)
  // write g0.
  for (int s = 0; s < n_steps; ++s) {
    const int t = n_steps - 1 - s;
    float2* dst = (t % 2 == 0) ? g0 : scratch;
    const float2* src = (t % 2 == 0) ? scratch : g0;
    pg2d_kernel<NB><<<blocks, kThreads, n_params * sizeof(float), stream>>>(
        params, n_params, frames + t * cells, frames_bar + (t + 1) * cells,
        src, dst, acc, H, W, hidden, dt, inv_dx2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace

// frames, frames_bar: [n_steps + 1, H, W, 2]; g0, scratch: [H, W, 2], zeroed;
// acc: [A, H, W], zeroed.  On return g0 holds the adjoint at frame 0 (without
// frames_bar[0]) and acc the per-cell gradient sums.
extern "C" int backward2d_pg(const void* params, int n_params, const void* frames,
                             const void* frames_bar, void* g0, void* scratch,
                             void* acc, int n_steps, int H, int W, int hidden,
                             int n_branches, float dt, float inv_dx2,
                             void* stream) {
  const float* p = static_cast<const float*>(params);
  const float2* f = static_cast<const float2*>(frames);
  const float2* fb = static_cast<const float2*>(frames_bar);
  float2* g = static_cast<float2*>(g0);
  float2* s = static_cast<float2*>(scratch);
  float* a = static_cast<float*>(acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_branches) {
    case 1: return sweep<1>(p, n_params, f, fb, g, s, a, n_steps, H, W, hidden, dt, inv_dx2, st);
    case 2: return sweep<2>(p, n_params, f, fb, g, s, a, n_steps, H, W, hidden, dt, inv_dx2, st);
    case 3: return sweep<3>(p, n_params, f, fb, g, s, a, n_steps, H, W, hidden, dt, inv_dx2, st);
    case 4: return sweep<4>(p, n_params, f, fb, g, s, a, n_steps, H, W, hidden, dt, inv_dx2, st);
    default: return cudaErrorInvalidValue;
  }
}

// The same sweep in one cooperative launch of pg2d_persistent_kernel on
// `blocks` blocks (at most the card's co-resident count: else
// cudaErrorCooperativeLaunchTooLarge, before anything is launched); g0 and
// scratch zeroed, acc [A, H, W] written whole.  `per_sm` gets the
// occupancy query's blocks an SM.
extern "C" int backward2d_pg_persistent(const void* params, int n_params, const void* frames,
                                        const void* frames_bar, void* g0, void* scratch,
                                        void* acc, int n_steps, int H, int W, int hidden,
                                        int n_branches, float dt, float inv_dx2, int blocks,
                                        void* stream, int* per_sm) {
  const float* p = static_cast<const float*>(params);
  const float2* f = static_cast<const float2*>(frames);
  const float2* fb = static_cast<const float2*>(frames_bar);
  float2* g = static_cast<float2*>(g0);
  float2* s = static_cast<float2*>(scratch);
  float* a = static_cast<float*>(acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks < 1 || blocks > H * W) return cudaErrorInvalidValue;
#define P(NB) persistent_sweep<NB>(p, n_params, f, fb, g, s, a, n_steps, H, W, hidden, dt, \
                                   inv_dx2, blocks, st, per_sm)
  switch (n_branches) {
    case 1: return P(1);
    case 2: return P(2);
    case 3: return P(3);
    case 4: return P(4);
    default: return cudaErrorInvalidValue;
  }
#undef P
}

extern "C" int backward2d_pg_occupancy(int n_params, int H, int W, int hidden, int n_branches,
                                       int blocks, int* per_sm) {
  const size_t smem = persistent_smem_bytes(n_params, H, W, hidden, n_branches, blocks);
  switch (n_branches) {
    case 1: return persistent_occupancy<1>(smem, per_sm);
    case 2: return persistent_occupancy<2>(smem, per_sm);
    case 3: return persistent_occupancy<3>(smem, per_sm);
    case 4: return persistent_occupancy<4>(smem, per_sm);
    default: return cudaErrorInvalidValue;
  }
}
