// Member-batched forward and reverse sweeps of the 2D Pi-cell rollout: M
// independent models (an ensemble), each with its own row of an [M, P]
// table of packed parameters (pack_pi_params_2d in ../cell2d.py) and its own
// state, advanced together: the fused sweep of the GS2D-sized cells in one
// cooperative launch for all M members, the other kernels here one launch a
// step for all M.  (The forward of the GS2D cell takes one launch a call too:
// rollout2d_cluster_kernel of cell2d.cu, M clusters, one a member.)
//
// Layouts (channels-last, f32, member-major):
//   params     [M, P]
//   frames     [M, T + 1, H, W, 2]   frame 0 of member m is h0[m]
//   frames_bar [M, T + 1, H, W, 2]   the frames' cotangent
//   g_ins      [M, T, H, W, 2]       the streaming sweep's g_in of each step
//   g          [M, H, W, 2]          the adjoint, double-buffered at k = 1
//   zw         [M, k k 2, H, W]      scratch of the k x k sweep
//   acc        [M, A, H, W]          pg2d_batched_kernel's accumulator planes
//   partial    [M, A, B]             pg2d_batched_persistent_kernel's sums, B
//                                    blocks a member
// Member m's share of each starts at m times its member stride, computed in
// size_t (a frames tensor at M = 8, T = 800, 100 x 100 holds 1.28e8 floats).
//
// A member's step is the single model's step, the same code:
//   rollout2d_batched_kernel<KS, NB> replaces
//     percnn_tpu/ops/pallas/batched2d.py:_rollout_kernel_b (pallas_call in
//     _fused_rollout_padded_b): step2d::step of cell2d_step.cuh, the step of
//     rollout2d_kernel (cell2d.cu), any odd k <= 5;
//   adj2d_batched_kernel<NB> (k = 1) and adj2d_batched_act_kernel<KS, NB> +
//     adj2d_batched_gather_kernel<KS> (k = 3, 5) replace _phase1_kernel_b
//     (pallas_call in _fused_phase1_b): the steps of adj2d_kernel and of
//     adj2d_act_kernel + adj2d_gather_kernel (adj2d.cu), writing g_ins and
//     g0 for the parameter gradients outside (chunked_param_grads in
//     ../batched2d.py);
//   pg2d_batched_persistent_kernel<NB> replaces _phase1_pg_kernel_b
//     (pallas_call in _fused_phase1_pg_b) for cells of C <= 8 and 1 to 4
//     branches on any field whose per-step scratch fits a block's shared
//     memory (pg_b_plan in ../batched2d.py: 155 x 155 at M = 8, 223 x 223 at
//     M = 4 on 132 SMs): the whole sweep of every member in one cooperative
//     launch, pg2d_persistent_kernel's three passes a step (backward2d.cu),
//     the gradient sums in registers (the design is described at the
//     kernel); pg2d_batched_kernel<NB> replaces it past that: the step of
//     pg2d_kernel (backward2d.cu), every parameter gradient accumulated in
//     member m's [A, H, W] planes.
// The TPU kernels walk an (M, T) grid, members outer and time inner, with a
// member's state in VMEM scratch; their halo-in-state padding to (8, 128)
// tiles and their SMEM parameter-row adapter are TPU layout, not carried
// over.  The TPU's pg kernel accumulates in VMEM scratch because
// accumulating into a revisited output block gave gradients about 3e-3 off
// on the TPU; here pg2d_batched_kernel's thread owns each (member, cell,
// plane) entry of acc for the whole sweep, and the persistent kernel's
// thread its sums in registers, with no atomics.
//
// Bound on an H100 SXM at its 700 W power limit (published peaks: 3.35 TB/s,
// 67 TFLOP/s f32 outside the tensor cores): M times the single model's, the
// same work per member (chip_smoke.py counts it).  At the ensemble's GS2D
// shape (M = 4, 100 x 100, C = 8, k = 1, T = 800) the forward is about
// 0.14 ms, the streaming sweep 0.26 ms and the fused sweep 0.41 ms, all
// bound by operations; at the 5x5 Burgers cell (M = 2, C = 16, T = 200)
// 0.58 ms forward and 1.2 ms sweep, by operations.  As for every kernel of
// this port, what limits the design is the chain of T dependent steps, one
// launch each (two a step for the k x k sweep).  Measured by chip_smoke.py
// on an NVIDIA H100 80GB HBM3 at 700 W, M = 4, T = 800: 5.1, 4.6 and 12.2 ms
// (6.4, 5.8 and 15.2 us a step), against 17.2, 15.7 and 28.9 ms for four
// runs of the single kernels; the fused sweep at M = 8 took 56 ms, its 52 MB
// of accumulator planes past the 50 MB L2.
// What the per-step design does about it: every launch covers all M
// members, the member in the grid's last dimension (y at k = 1, z at
// k > 1), so an ensemble's step costs one launch and not M, and an M-member
// launch puts M times the blocks of a single model's on the card's 132 SMs
// (160 blocks of 256 at M = 4 and 100 x 100, k = 1).  Each block stages its
// member's parameter row in shared memory, as the single kernels stage
// theirs.  The T-step loops of launches run here in C on the caller's
// stream.
// The fused sweep in one launch: the single model's persistent layout, each
// block's cells' 164 accumulators in shared memory, does not scale to M
// members (32.3 MB at M = 4, against 132 x 227 KB = 30.7 MB of shared
// memory).  pg2d_batched_persistent_kernel instead fixes each thread's
// (member, group, cells) for the whole sweep, so the sums it adds to stay in
// its registers and only a step's 6 + 4 C floats a cell pass through shared
// memory, whatever M is; n_sm // M blocks a member, one an SM, and one grid
// barrier a step for all members.  Measured by chip_smoke.py on an NVIDIA
// H100 80GB HBM3, 700.00 W, T = 800 at 100 x 100, in turns with
// pg2d_batched_kernel in the same call: 3.511 ms at M = 4 (4.39 us a step,
// one launch) against 12.332, and 5.814 ms at M = 8 against 56.340; 128
// registers with 136 bytes spilled (NB = 3).  Holding the group's weights
// in shared memory instead, or also recomputing the first cell's cross
// each step, spilled less or nothing and ran slower (variant builds).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "adj2d_step.cuh"
#include "cell2d_step.cuh"

namespace {

namespace cg = cooperative_groups;

// Row 11: one forward step of every member; `in` is frame t and `out` frame
// t + 1 of member 0, member m's frames `stride` float2 further on.
template <int KS, int NB>
__global__ void rollout2d_batched_kernel(const float* __restrict__ params, int n_params,
                                         const float2* __restrict__ in,
                                         float2* __restrict__ out, size_t stride, int H,
                                         int W, int hidden, int n_branches, float dt,
                                         float inv_dx2) {
  const size_t m = KS == 1 ? blockIdx.y : blockIdx.z;
  step2d::step<KS, NB>(params + m * n_params, n_params, in + m * stride, out + m * stride,
                       H, W, hidden, n_branches, dt, inv_dx2);
}

// Row 12 at k = 1: one reverse step of every member, member in blockIdx.y.
template <int NB>
__global__ void __launch_bounds__(adj2d::kThreads)
    adj2d_batched_kernel(const float* __restrict__ params, int n_params,
                         const float2* __restrict__ h,       // member 0's frame t
                         const float2* __restrict__ fbar,    // its cotangent of frame t + 1
                         const float2* __restrict__ g_next,  // member 0's g_{t+1}
                         float2* __restrict__ g_out,         // member 0's g_t
                         float2* __restrict__ g_in_out,      // member 0's g_ins[t]
                         size_t frame_stride, size_t gins_stride, int H, int W, int hidden,
                         float dt, float inv_dx2) {
  const size_t m = blockIdx.y;
  const size_t cells = static_cast<size_t>(H) * W;
  adj2d::adj2d_step_1x1<NB>(params + m * n_params, n_params, h + m * frame_stride,
                            fbar + m * frame_stride, g_next + m * cells, g_out + m * cells,
                            g_in_out + m * gins_stride, H, W, hidden, dt, inv_dx2);
}

// Row 12 at k > 1, first launch of a reverse step: g_in and zw of every
// member, member in blockIdx.z.
template <int KS, int NB>
__global__ void __launch_bounds__(kxk::kThreads)
    adj2d_batched_act_kernel(const float* __restrict__ params, int n_params,
                             const float2* __restrict__ h, const float2* __restrict__ g,
                             const float2* __restrict__ fbar, float2* __restrict__ g_in_out,
                             float* __restrict__ zw, size_t frame_stride, size_t gins_stride,
                             int H, int W, int hidden) {
  const size_t m = blockIdx.z;
  const size_t cells = static_cast<size_t>(H) * W;
  adj2d::adj2d_act<KS, NB>(params + m * n_params, n_params, h + m * frame_stride, g + m * cells,
                           fbar + m * frame_stride, g_in_out + m * gins_stride,
                           zw + m * (KS * KS * 2) * cells, H, W, hidden);
}

// Row 12 at k > 1, second launch: g of every member in place, member in
// blockIdx.y.
template <int KS>
__global__ void __launch_bounds__(adj2d::kThreads)
    adj2d_batched_gather_kernel(const float* __restrict__ zw, const float2* __restrict__ g_in,
                                const float* __restrict__ params, int n_params,
                                float2* __restrict__ g, size_t gins_stride, int H, int W,
                                float dt, float inv_dx2) {
  const size_t m = blockIdx.y;
  const size_t cells = static_cast<size_t>(H) * W;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < H * W)
    kxk::gather_update<KS>(zw + m * (KS * KS * 2) * cells, g_in + m * gins_stride,
                           params + m * n_params, g + m * cells, H, W, dt, inv_dx2, idx);
}

// Row 13: one fused reverse step of every member, member in blockIdx.y;
// member m's accumulators are the [A, H, W] planes at acc + m acc_stride.
template <int NB>
__global__ void pg2d_batched_kernel(const float* __restrict__ params, int n_params,
                                    const float2* __restrict__ h,
                                    const float2* __restrict__ fbar,
                                    const float2* __restrict__ g_next,
                                    float2* __restrict__ g_out, float* __restrict__ acc,
                                    size_t frame_stride, size_t acc_stride, int H, int W,
                                    int hidden, float dt, float inv_dx2) {
  const size_t m = blockIdx.y;
  const size_t cells = static_cast<size_t>(H) * W;
  adj2d::pg2d_step<NB>(params + m * n_params, n_params, h + m * frame_stride,
                       fbar + m * frame_stride, g_next + m * cells, g_out + m * cells,
                       acc + m * acc_stride, H, W, hidden, dt, inv_dx2);
}

// Threads a block of pg2d_batched_persistent_kernel: 16 warps, over which
// the 2 C (equation, hidden channel) groups of a cell with C <= 8 spread,
// 16 / (2 C) warps a group (pg_b_plan in ../batched2d.py).
constexpr int kPgThreads = 512;
constexpr int kPgWarps = kPgThreads / 32;
constexpr int kPgMaxBranches = 4;
// Floats a warp leaves for the block's reduction at the end: its 4
// diffusion and b_out sums, then its group's w_out, dw (2 NB) and db (NB).
constexpr int kRedStride = 5 + 3 * kPgMaxBranches;

// Row 13: the fused reverse sweep of every member in one cooperative
// launch.  The grid is M runs of per_member blocks, one block an SM; block
// b of run m works on member m alone (its row of the parameter table, its
// frames, cotangents and g), and owns the cells [first, first + n_own) of
// that member's H W field (split_evenly's share of per_member) for every
// step.  Thread tid takes the (equation o, hidden channel c) group
// grp = tid / L, L = blockDim / (2 C) threads a group, and the cells li,
// li + L, ... (li = tid % L) of the block's share in pass 2, and the cells
// tid, tid + blockDim, ... in passes 1 and 3: the same cells at every step.
// So it keeps every parameter-gradient sum it adds to in registers for the
// whole sweep, summed over its cells and the steps: in pass 2 its group's
// 1 + 3 NB (w_out, dw, db), in pass 1 the 4 diffusion and b_out sums; no
// accumulator plane exists.  A reverse step t, as pg2d_persistent_kernel's
// (backward2d.cu), three passes with a __syncthreads between them:
//   1. a thread a cell: g_in and h_t at its 9-point cross, their
//      Laplacians, the diffusion and b_out sums, and the cell's u, v, g_in
//      and Lap g_in kept in shared memory;
//   2. a thread an (o, c, cell) item of its group: the branch activations
//      (its group's weights held in registers), the products, its sums, and
//      the item's share of the Jacobian's transpose in shared memory;
//   3. a thread a cell: the 2 C shares summed in (o, c) order and g_t
//      written to global memory.
// Then one grid.sync(); g ping-pongs between g0 and scratch, ending in g0,
// and a thread's first cell's h_{t-1} and fbar_t are loaded before the
// barrier.  g is read with __ldcg (at L2, past the SM's L1), since other
// blocks wrote it.  At the end each sum is reduced in a fixed order: a
// butterfly of warp shuffles, then the warps of its group (or, for the
// diffusion and b_out sums, all 16 warps) in warp order, and the block
// writes its A partial sums to partial[m][plane][b], no atomics; the
// wrapper sums them over b.  Shared memory holds the parameters, a step's
// 6 + 4 C floats a cell and the reduction's scratch, whatever M is.
template <int NB>
__global__ void __launch_bounds__(kPgThreads)
    pg2d_batched_persistent_kernel(const float* __restrict__ params, int n_params,
                                   const float2* __restrict__ frames,
                                   const float2* __restrict__ frames_bar, float2* g0,
                                   float2* scratch, float* __restrict__ partial, int n_steps,
                                   int H, int W, int hidden, int per_member, float dt,
                                   float inv_dx2) {
  cg::grid_group grid = cg::this_grid();
  const int cells = H * W;
  const int mem = blockIdx.x / per_member, b = blockIdx.x - mem * per_member;
  const int q = cells / per_member, rem = cells % per_member;
  const int n_own = q + (b < rem ? 1 : 0);
  const int first = b * q + (b < rem ? b : rem);
  const int cap = (cells + per_member - 1) / per_member;
  const int C = hidden, G = 2 * hidden;
  const int L = blockDim.x / G;
  const int grp = threadIdx.x / L, li = threadIdx.x - grp * L;
  const int o = grp / C, c = grp - o * C;
  const size_t frame_stride = (static_cast<size_t>(n_steps) + 1) * cells;
  params += static_cast<size_t>(mem) * n_params;
  frames += mem * frame_stride;
  frames_bar += mem * frame_stride;
  g0 += static_cast<size_t>(mem) * cells;
  scratch += static_cast<size_t>(mem) * cells;
  // plane offsets (backward2d.py: _pg_layout)
  const int p_dw = 0;
  const int p_db = 2 * NB * C * 2;
  const int p_wout = p_db + 2 * NB * C;
  const int p_bout = p_wout + 2 * C;
  const int p_diff = p_bout + 2;
  const int n_planes = p_diff + 2;
  const int stride = 3 * C;               // per branch: w_i[0, :], w_i[1, :], b_i
  const int block = NB * stride + C + 1;  // per equation, then w_out [C], b_out

  extern __shared__ float4 smem_pgb[];
  float* sp = reinterpret_cast<float*>(smem_pgb);
  float* st = sp + (n_params + 3) / 4 * 4;  // [6][cap]: u, v, g_in (2), Lap g_in (2)
  float* part = st + 6 * cap;               // [2][G][cap]: the Jacobian's shares
  float* red = part + 2 * G * cap;          // [kPgWarps][kRedStride]
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sp[k] = params[k];

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

  // this thread's group's weights, for the whole sweep
  const float* pe = sp + 2 + o * block;
  const float wo = pe[NB * stride + c];
  float wu[NB], wv[NB], wb[NB];
#pragma unroll
  for (int e = 0; e < NB; ++e) {
    wu[e] = pe[e * stride + c];
    wv[e] = pe[e * stride + C + c];
    wb[e] = pe[e * stride + 2 * C + c];
  }
  // the sums: diffusion (2), b_out (2), then the group's w_out, dw, db
  float s_diff[2] = {0.0f, 0.0f}, s_bout[2] = {0.0f, 0.0f}, s_w = 0.0f;
  float s_dw[NB][2], s_db[NB];
#pragma unroll
  for (int e = 0; e < NB; ++e) s_dw[e][0] = s_dw[e][1] = s_db[e] = 0.0f;

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
          const float2 a = __ldcg(src + nbr[e]), fb = fb_next[e];
          gs[e] = make_float2(a.x + fb.x, a.y + fb.y);
        }
      } else {
        cross(first + k, nbr);
#pragma unroll
        for (int e = 0; e < 9; ++e) {
          hs[e] = h[nbr[e]];
          const float2 a = __ldcg(src + nbr[e]), fb = fbar[nbr[e]];
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
      s_diff[0] += gs[0].x * lap_hu;
      s_diff[1] += gs[0].y * lap_hv;
      s_bout[0] += gs[0].x;
      s_bout[1] += gs[0].y;
    }
    __syncthreads();
    for (int k = li; k < n_own; k += L) {
      const float u = st[k], v = st[cap + k], g = st[(2 + o) * cap + k];
      float y[NB];
#pragma unroll
      for (int e = 0; e < NB; ++e) y[e] = wu[e] * u + wv[e] * v + wb[e];
      // prod_{j != e} y_j from prefix and suffix products
      float pre[NB + 1], suf[NB + 1];
      pre[0] = 1.0f;
      suf[NB] = 1.0f;
#pragma unroll
      for (int e = 0; e < NB; ++e) pre[e + 1] = pre[e] * y[e];
#pragma unroll
      for (int e = NB - 1; e >= 0; --e) suf[e] = suf[e + 1] * y[e];
      s_w += g * pre[NB];
      float du = 0.0f, dv = 0.0f;
#pragma unroll
      for (int e = 0; e < NB; ++e) {
        const float zz = g * (pre[e] * suf[e + 1]);
        s_dw[e][0] += zz * u;
        s_dw[e][1] += zz * v;
        s_db[e] += zz;
        du += (wu[e] * wo) * zz;
        dv += (wv[e] * wo) * zz;
      }
      part[grp * cap + k] = du;
      part[(G + grp) * cap + k] = dv;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < n_own; k += blockDim.x) {
      float du = 0.0f, dv = 0.0f;
      for (int gg = 0; gg < G; ++gg) {
        du += part[gg * cap + k];
        dv += part[(G + gg) * cap + k];
      }
      dst[first + k] = make_float2(st[2 * cap + k] + dt * (sp[0] * st[4 * cap + k] + du),
                                   st[3 * cap + k] + dt * (sp[1] * st[5 * cap + k] + dv));
    }
    prefetch(t - 1);
    grid.sync();
  }

  // the block's reduction, in a fixed order: each sum over the warp by a
  // butterfly of shuffles, then over the warps in warp order
  constexpr int kSums = 5 + 3 * NB;
  float v[kSums];
  v[0] = s_diff[0];
  v[1] = s_diff[1];
  v[2] = s_bout[0];
  v[3] = s_bout[1];
  v[4] = s_w;
#pragma unroll
  for (int e = 0; e < NB; ++e) {
    v[5 + 2 * e] = s_dw[e][0];
    v[6 + 2 * e] = s_dw[e][1];
    v[5 + 2 * NB + e] = s_db[e];
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kSums; ++j) {
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) v[j] += __shfl_xor_sync(0xffffffffu, v[j], d);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kSums; ++j) red[warp * kRedStride + j] = v[j];
  }
  __syncthreads();
  const int warps = blockDim.x / 32, per_group = L / 32;
  float* out = partial + static_cast<size_t>(mem) * n_planes * per_member + b;
  for (int pl = threadIdx.x; pl < n_planes; pl += blockDim.x) {
    int j, w0, nw;
    if (pl >= p_bout) {   // b_out, diffusion: every warp's cells
      j = pl >= p_diff ? pl - p_diff : 2 + (pl - p_bout);
      w0 = 0;
      nw = warps;
    } else {
      int gq, jj;
      if (pl >= p_wout) {
        gq = pl - p_wout;                 // o C + c
        jj = 4;
      } else {
        const int qq = pl >= p_db ? pl - p_db : (pl - p_dw) / 2;   // (o NB + e) C + c
        const int oe = qq / C, e = oe % NB;
        gq = (oe / NB) * C + (qq - oe * C);
        jj = pl >= p_db ? 5 + 2 * NB + e : 5 + 2 * e + (pl - p_dw) % 2;
      }
      j = jj;
      w0 = gq * per_group;
      nw = per_group;
    }
    float sum = 0.0f;
    for (int w = w0; w < w0 + nw; ++w) sum += red[w * kRedStride + j];
    out[static_cast<size_t>(pl) * per_member] = sum;
  }
}

// Dynamic shared memory of pg2d_batched_persistent_kernel with per_member
// blocks a member: the packed parameters rounded up to 4 floats, then
// [6 + 4 C][cap] floats of a step's scratch, then the reduction's
// (pg_b_smem_bytes in ../batched2d.py).
size_t pg_b_smem_bytes(int n_params, int H, int W, int hidden, int per_member) {
  const size_t cap = (static_cast<size_t>(H) * W + per_member - 1) / per_member;
  return ((n_params + 3) / 4 * 4 + (6 + 4 * hidden) * cap + kPgWarps * kRedStride) *
         sizeof(float);
}

// How many blocks of pg2d_batched_persistent_kernel<NB> an SM holds at
// once, its shared memory allowed.
template <int NB>
cudaError_t pg_b_occupancy(size_t smem, int threads, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(pg2d_batched_persistent_kernel<NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, pg2d_batched_persistent_kernel<NB>, threads, smem);
}

template <int NB>
cudaError_t pg_b_persistent(const float* params, int n_params, const float2* frames,
                            const float2* frames_bar, float2* g0, float2* scratch,
                            float* partial, int M, int n_steps, int H, int W, int hidden,
                            float dt, float inv_dx2, int per_member, int threads,
                            cudaStream_t stream, int* per_sm) {
  const size_t smem = pg_b_smem_bytes(n_params, H, W, hidden, per_member);
  cudaError_t err = pg_b_occupancy<NB>(smem, threads, per_sm);
  if (err != cudaSuccess) return err;
  int device, sms;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // a cooperative grid must be co-resident; one past it would be refused
  const int blocks = M * per_member;
  if (blocks > *per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  if (n_steps == 0) {   // no step: every sum is 0, g0 stays as zeroed
    err = cudaMemsetAsync(partial, 0,
                          static_cast<size_t>(M) * (2 * NB * hidden * 3 + 2 * hidden + 4) *
                              per_member * sizeof(float),
                          stream);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  void* args[] = {&params, &n_params, &frames, &frames_bar, &g0, &scratch, &partial,
                  &n_steps, &H, &W, &hidden, &per_member, &dt, &inv_dx2};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(pg2d_batched_persistent_kernel<NB>), dim3(blocks),
      dim3(threads), args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int KS, int NB>
cudaError_t rollout_b(const float* params, int n_params, const float2* h0, float2* f, int M,
                      int n_steps, int H, int W, int hidden, int n_branches, float dt,
                      float inv_dx2, cudaStream_t s) {
  const size_t cells = static_cast<size_t>(H) * W;
  const size_t stride = (static_cast<size_t>(n_steps) + 1) * cells;
  cudaError_t err;
  for (int m = 0; m < M; ++m) {   // frame 0 of every member
    err = cudaMemcpyAsync(f + m * stride, h0 + m * cells, cells * sizeof(float2),
                          cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return err;
  }
  step2d::Launch shape = step2d::launch_shape<KS>(n_params, H, W);
  (KS == 1 ? shape.grid.y : shape.grid.z) = M;
  err = cudaFuncSetAttribute(rollout2d_batched_kernel<KS, NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, shape.smem);
  if (err != cudaSuccess) return err;
  for (int t = 0; t < n_steps; ++t) {
    rollout2d_batched_kernel<KS, NB><<<shape.grid, shape.block, shape.smem, s>>>(
        params, n_params, f + t * cells, f + (t + 1) * cells, stride, H, W, hidden,
        n_branches, dt, inv_dx2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <int NB>
cudaError_t sweep_1x1_b(const float* params, int n_params, const float2* frames,
                        const float2* frames_bar, float2* g0, float2* scratch, float2* g_ins,
                        int M, int n_steps, int H, int W, int hidden, float dt, float inv_dx2,
                        cudaStream_t stream) {
  const size_t cells = static_cast<size_t>(H) * W;
  const size_t frame_stride = (static_cast<size_t>(n_steps) + 1) * cells;
  const size_t gins_stride = static_cast<size_t>(n_steps) * cells;
  const dim3 grid(static_cast<unsigned>((cells + adj2d::kThreads - 1) / adj2d::kThreads), M);
  // Both g buffers start at zero (the wrapper zeroes them).  Step s reads
  // one and writes the other, in the order that makes the last step (t = 0)
  // write g0.
  for (int s = 0; s < n_steps; ++s) {
    const int t = n_steps - 1 - s;
    float2* dst = (t % 2 == 0) ? g0 : scratch;
    const float2* src = (t % 2 == 0) ? scratch : g0;
    adj2d_batched_kernel<NB><<<grid, adj2d::kThreads, n_params * sizeof(float), stream>>>(
        params, n_params, frames + t * cells, frames_bar + (t + 1) * cells, src, dst,
        g_ins + t * cells, frame_stride, gins_stride, H, W, hidden, dt, inv_dx2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <int KS, int NB>
cudaError_t sweep_kxk_b(const float* params, int n_params, const float2* frames,
                        const float2* frames_bar, float2* g, float2* g_ins, float* zw, int M,
                        int n_steps, int H, int W, int hidden, float dt, float inv_dx2,
                        cudaStream_t stream) {
  const size_t cells = static_cast<size_t>(H) * W;
  const size_t frame_stride = (static_cast<size_t>(n_steps) + 1) * cells;
  const size_t gins_stride = static_cast<size_t>(n_steps) * cells;
  const int smem = adj2d::act_smem_bytes<KS>(n_params, true);
  cudaError_t err = cudaFuncSetAttribute(adj2d_batched_act_kernel<KS, NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kxk::kTileW - 1) / kxk::kTileW, (H + kxk::kTileH - 1) / kxk::kTileH, M);
  const dim3 gather_grid(
      static_cast<unsigned>((cells + adj2d::kThreads - 1) / adj2d::kThreads), M);
  // g starts at zero (the wrapper zeroes it) and holds g_t after step t.
  for (int s = 0; s < n_steps; ++s) {
    const int t = n_steps - 1 - s;
    adj2d_batched_act_kernel<KS, NB><<<grid, kxk::kThreads, smem, stream>>>(
        params, n_params, frames + t * cells, g, frames_bar + (t + 1) * cells,
        g_ins + t * cells, zw, frame_stride, gins_stride, H, W, hidden);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    adj2d_batched_gather_kernel<KS><<<gather_grid, adj2d::kThreads, 0, stream>>>(
        zw, g_ins + t * cells, params, n_params, g, gins_stride, H, W, dt, inv_dx2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <int NB>
cudaError_t sweep_pg_b(const float* params, int n_params, const float2* frames,
                       const float2* frames_bar, float2* g0, float2* scratch, float* acc, int M,
                       int n_steps, int H, int W, int hidden, float dt, float inv_dx2,
                       cudaStream_t stream) {
  const size_t cells = static_cast<size_t>(H) * W;
  const size_t frame_stride = (static_cast<size_t>(n_steps) + 1) * cells;
  // the planes of pg_accumulate (pg_common.cuh): dw, db, w_out, b_out, diff
  const size_t planes = static_cast<size_t>(2 * NB * hidden * 2 + 2 * NB * hidden +
                                            2 * hidden + 2 + 2);
  const dim3 grid(static_cast<unsigned>((cells + adj2d::kThreads - 1) / adj2d::kThreads), M);
  // As sweep_1x1_b: the last step (t = 0) writes g0.
  for (int s = 0; s < n_steps; ++s) {
    const int t = n_steps - 1 - s;
    float2* dst = (t % 2 == 0) ? g0 : scratch;
    const float2* src = (t % 2 == 0) ? scratch : g0;
    pg2d_batched_kernel<NB><<<grid, adj2d::kThreads, n_params * sizeof(float), stream>>>(
        params, n_params, frames + t * cells, frames_bar + (t + 1) * cells, src, dst, acc,
        frame_stride, planes * cells, H, W, hidden, dt, inv_dx2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

#define PERCNN_NB_CASES(CALL) \
  case 1: return CALL(1);     \
  case 2: return CALL(2);     \
  case 3: return CALL(3);     \
  case 4: return CALL(4);     \
  default: return cudaErrorInvalidValue;

}  // namespace

// params [M, n_params]; h0 [M, H, W, 2]; frames [M, n_steps + 1, H, W, 2].
// The k x k steps are compiled for 1 to 4 branches; the 1x1 step takes any.
extern "C" int batched2d_rollout(const void* params, int n_params, const void* h0,
                                 void* frames, int M, int n_steps, int H, int W, int hidden,
                                 int n_branches, int kernel_size, float dt, float inv_dx2,
                                 void* stream) {
  const float* p = static_cast<const float*>(params);
  const float2* x = static_cast<const float2*>(h0);
  float2* f = static_cast<float2*>(frames);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define R(KS, NB) \
  rollout_b<KS, NB>(p, n_params, x, f, M, n_steps, H, W, hidden, n_branches, dt, inv_dx2, s)
#define R3(NB) R(3, NB)
#define R5(NB) R(5, NB)
  switch (kernel_size) {
    case 1: return R(1, 0);
    case 3: switch (n_branches) { PERCNN_NB_CASES(R3) }
    case 5: switch (n_branches) { PERCNN_NB_CASES(R5) }
    default: return cudaErrorInvalidValue;
  }
#undef R
#undef R3
#undef R5
}

// frames, frames_bar [M, n_steps + 1, H, W, 2]; g [M, H, W, 2] zeroed, and at
// k = 1 a second zeroed [M, H, W, 2] buffer `scratch` (unused at k > 1);
// g_ins [M, n_steps, H, W, 2]; zw [M, k k 2, H, W] scratch at k > 1 (unused
// at k = 1).  On return g holds each member's adjoint at frame 0 (without
// frames_bar[:, 0]).
extern "C" int batched2d_adj_sweep(const void* params, int n_params, const void* frames,
                                   const void* frames_bar, void* g, void* scratch, void* g_ins,
                                   void* zw, int M, int n_steps, int H, int W, int hidden,
                                   int n_branches, int kernel_size, float dt, float inv_dx2,
                                   void* stream) {
  const float* p = static_cast<const float*>(params);
  const float2* f = static_cast<const float2*>(frames);
  const float2* fb = static_cast<const float2*>(frames_bar);
  float2* gg = static_cast<float2*>(g);
  float2* sc = static_cast<float2*>(scratch);
  float2* gi = static_cast<float2*>(g_ins);
  float* z = static_cast<float*>(zw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ONE(NB) \
  sweep_1x1_b<NB>(p, n_params, f, fb, gg, sc, gi, M, n_steps, H, W, hidden, dt, inv_dx2, s)
#define K3(NB) \
  sweep_kxk_b<3, NB>(p, n_params, f, fb, gg, gi, z, M, n_steps, H, W, hidden, dt, inv_dx2, s)
#define K5(NB) \
  sweep_kxk_b<5, NB>(p, n_params, f, fb, gg, gi, z, M, n_steps, H, W, hidden, dt, inv_dx2, s)
  switch (kernel_size) {
    case 1: switch (n_branches) { PERCNN_NB_CASES(ONE) }
    case 3: switch (n_branches) { PERCNN_NB_CASES(K3) }
    case 5: switch (n_branches) { PERCNN_NB_CASES(K5) }
    default: return cudaErrorInvalidValue;
  }
#undef ONE
#undef K3
#undef K5
}

// frames, frames_bar [M, n_steps + 1, H, W, 2]; g0, scratch [M, H, W, 2],
// zeroed; acc [M, A, H, W], zeroed.  On return g0 holds each member's
// adjoint at frame 0 (without frames_bar[:, 0]) and acc its per-cell
// gradient sums.
extern "C" int batched2d_pg(const void* params, int n_params, const void* frames,
                            const void* frames_bar, void* g0, void* scratch, void* acc, int M,
                            int n_steps, int H, int W, int hidden, int n_branches, float dt,
                            float inv_dx2, void* stream) {
  const float* p = static_cast<const float*>(params);
  const float2* f = static_cast<const float2*>(frames);
  const float2* fb = static_cast<const float2*>(frames_bar);
  float2* g = static_cast<float2*>(g0);
  float2* sc = static_cast<float2*>(scratch);
  float* a = static_cast<float*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PG(NB) sweep_pg_b<NB>(p, n_params, f, fb, g, sc, a, M, n_steps, H, W, hidden, dt, inv_dx2, s)
  switch (n_branches) { PERCNN_NB_CASES(PG) }
#undef PG
}

// The same sweep in one cooperative launch of pg2d_batched_persistent_kernel
// on M x per_member blocks of `threads` (a multiple of 64 hidden, at most
// 512): g0 and scratch [M, H, W, 2] zeroed; partial [M, A, per_member]
// written whole, each member's gradient sums split by block.  A grid the
// card cannot hold at once returns cudaErrorCooperativeLaunchTooLarge before
// anything is launched; at n_steps = 0 nothing is launched and partial is
// zeroed.  `per_sm` gets the occupancy query's blocks an SM.
extern "C" int batched2d_pg_persistent(const void* params, int n_params, const void* frames,
                                       const void* frames_bar, void* g0, void* scratch,
                                       void* partial, int M, int n_steps, int H, int W,
                                       int hidden, int n_branches, float dt, float inv_dx2,
                                       int per_member, int threads, void* stream,
                                       int* per_sm) {
  const int G = 2 * hidden;
  if (M < 1 || per_member < 1 || per_member > H * W || hidden < 1 || threads > kPgThreads ||
      threads % G != 0 || (threads / G) % 32 != 0)
    return cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(params);
  const float2* f = static_cast<const float2*>(frames);
  const float2* fb = static_cast<const float2*>(frames_bar);
  float2* g = static_cast<float2*>(g0);
  float2* sc = static_cast<float2*>(scratch);
  float* a = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PP(NB) pg_b_persistent<NB>(p, n_params, f, fb, g, sc, a, M, n_steps, H, W, hidden, dt, \
                                   inv_dx2, per_member, threads, s, per_sm)
  switch (n_branches) { PERCNN_NB_CASES(PP) }
#undef PP
}

extern "C" int batched2d_pg_occupancy(int n_params, int H, int W, int hidden, int n_branches,
                                      int per_member, int threads, int* per_sm) {
  const size_t smem = pg_b_smem_bytes(n_params, H, W, hidden, per_member);
#define PO(NB) pg_b_occupancy<NB>(smem, threads, per_sm)
  switch (n_branches) { PERCNN_NB_CASES(PO) }
#undef PO
}
