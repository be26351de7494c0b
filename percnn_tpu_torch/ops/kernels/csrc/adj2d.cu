// Reverse sweeps of the forward-Euler 2D Pi-cell rollout that stream the
// adjoint out and leave the parameter gradients to a time-batched pass
// outside (chunked_param_grads or _param_grads_stream in ../backward2d.py).
//
// One reverse step t (t = T-1 .. 0), for every cell x of the periodic H x W
// grid, with m = (o nb + i) C + c and r = k / 2:
//   g_in   = g_{t+1} + fbar_{t+1}                              (g_T = 0)
//   y[m]   = sum_q w_i^o[q, c] im2col(h_t)(x)[q] + b_i^o[c]      (q = (ki k + kj) 2 + cin)
//   z[m]   = w_out_o[c] g_in_o prod_{j != i} y[(o nb + j) C + c]
//   jt_cin = sum_{m, ki, kj} w_i^o[(ki k + kj) 2 + cin, c] z[m](x + (r - ki, r - kj))
//   g_t    = g_in + dt (D Lap(g_in) + jt)
// Outputs: g_ins[t] = g_in [H, W, 2] and, after the sweep, g_0.  The weights
// are the packed vector of pack_pi_params_2d (../cell2d.py) in shared memory.
//
// adj2d_kernel (k = 1) and adj2d_act_kernel + adj2d_gather_kernel (k = 3, 5)
// replace percnn_tpu/ops/pallas/backward2d.py:_phase1_kernel (pallas_call in
// _fused_phase1), which recomputes the Pi Jacobian's transpose from the
// frames; adj2d_ys_act_kernel + adj2d_gather_kernel replace
// _phase1_ys_kernel (pallas_call in _fused_phase1_ys), which reads the
// branch activations y from ys [T, 2 nb C, H, W], precomputed outside the
// sweep by time-batched convolutions (_precompute_ys).
//
// Bounds on an H100 SXM at its 700 W power limit (published peaks: 3.35 TB/s,
// 67 TFLOP/s f32 outside the tensor cores); chip_smoke.py counts them exactly:
//   k = 1, GS2D 100 x 100, C = 8, T = 800: about 600 flops a cell and step,
//          4.8 GFLOP a backward, 72 us; frames, cotangents and g_ins 192 MB,
//          57 us: bound by operations, barely;
//   k = 5, Burgers 100 x 100, C = 16, T = 200: 96 x 51 FMAs for y and 96 x 50
//          for the contraction with the weights, about 20 k flops a cell and
//          step, 39 GFLOP, 0.59 ms, against 48 MB of frames, cotangents and
//          g_ins: bound by operations;
//   ys, the same cell: the contraction alone, about 10 k flops, 0.29 ms,
//          against the 768 MB ys stream read once, 0.23 ms: bound by
//          operations, closely followed by bytes.
// As for every kernel of this port, what limits the design is the chain of
// T dependent steps, one or two launches each.
// What the design does about it: at k = 1 a step is one launch over H*W
// threads, one cell a thread, as pg2d_kernel (backward2d.cu) without its
// accumulators: each thread forms g_in at its 8 stencil neighbours itself
// and g ping-pongs between two buffers, since a neighbour reads the old g.
// At k > 1, z at the neighbours within radius r depends on each neighbour's
// own activations, so a step is two launches, as in adj2d_kxk_kernel
// (backward2d_kxk.cu), with its layout: the activation kernel (8 x 16 tiles
// staged with their halo, two threads a cell, one per equation, each with
// the 50 taps and its equation's 50 partial sums of zw[q] = sum_m w[q, m]
// z[m] in registers, the weights read as shared-memory broadcasts; the two
// equations' sums meet in shared memory) writes g_in and zw [k k 2, H, W];
// the gather kernel (kxk_common.cuh) sums zw over the reversed taps and
// updates g in place.  The ys form reads y instead of the tile and taps, a
// block taking 128 consecutive cells.  The T-step loops of launches run here
// in C on the caller's stream.  The steps of adj2d_kernel and
// adj2d_act_kernel are in adj2d_step.cuh, shared with the ensemble's
// batched2d.cu.
//
// adj2d_ys_persistent_kernel replaces the same TPU kernel as
// adj2d_ys_act_kernel + adj2d_gather_kernel on every field whose block fits
// shared memory (ys_plan in ../backward2d.py; the per-step pair past it):
// the whole sweep in one cooperative launch, one block an SM, one grid
// barrier a step, FFMA in full f32 (the design is described at the kernel).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W, per
// T = 200 at 100 x 100, C = 16: 2.268 ms, one launch, 11.34 us a step;
// adj2d_ys_act_kernel + adj2d_gather_kernel 7.284 ms in the same call, in
// turns.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "adj2d_step.cuh"
#include "kxk_mma.cuh"

namespace {

using adj2d::act_smem_bytes;
using adj2d::kThreads;

// k = 1: one reverse step, one cell a thread.
template <int NB>
__global__ void __launch_bounds__(kThreads)
    adj2d_kernel(const float* __restrict__ params, int n_params,
                 const float2* __restrict__ h,       // frame t
                 const float2* __restrict__ fbar,    // cotangent of frame t + 1
                 const float2* __restrict__ g_next,  // g_{t+1}
                 float2* __restrict__ g_out,         // g_t
                 float2* __restrict__ g_in_out,      // g_ins[t]
                 int H, int W, int hidden, float dt, float inv_dx2) {
  adj2d::adj2d_step_1x1<NB>(params, n_params, h, fbar, g_next, g_out, g_in_out, H, W, hidden,
                            dt, inv_dx2);
}

// k > 1, first launch of a reverse step: g_in and zw at every cell of the
// block's 8 x 16 tile, two threads a cell (one per equation, as in
// adj2d_kxk_kernel), the activations recomputed from frame t.
template <int KS, int NB>
__global__ void __launch_bounds__(kxk::kThreads)
    adj2d_act_kernel(const float* __restrict__ params, int n_params,
                     const float2* __restrict__ h,       // frame t
                     const float2* __restrict__ g_next,  // g_{t+1}
                     const float2* __restrict__ fbar,    // cotangent of frame t + 1
                     float2* __restrict__ g_in_out,      // g_ins[t]
                     float* __restrict__ zw,             // [k k 2][H W]
                     int H, int W, int hidden) {
  adj2d::adj2d_act<KS, NB>(params, n_params, h, g_next, fbar, g_in_out, zw, H, W, hidden);
}

// k > 1, first launch of a reverse step of the ys form: the activations
// read from ys[t], plane (o nb + i) C + c; a block takes 128 consecutive
// cells, two threads a cell.
template <int KS, int NB>
__global__ void __launch_bounds__(kxk::kThreads)
    adj2d_ys_act_kernel(const float* __restrict__ params, int n_params,
                        const float* __restrict__ ys,       // ys[t], [2 nb C][H W]
                        const float2* __restrict__ g_next,  // g_{t+1}
                        const float2* __restrict__ fbar,    // cotangent of frame t + 1
                        float2* __restrict__ g_in_out,      // g_ins[t]
                        float* __restrict__ zw,             // [k k 2][H W]
                        int H, int W, int hidden) {
  extern __shared__ float4 smem[];
  float* sp = reinterpret_cast<float*>(smem);
  float* xbuf = sp + (n_params + 3) / 4 * 4;
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sp[k] = params[k];
  __syncthreads();

  const int o = threadIdx.x / kxk::kCells;  // the same in every warp
  const int cell = threadIdx.x - o * kxk::kCells;
  const int idx = blockIdx.x * kxk::kCells + cell;
  const size_t cells = static_cast<size_t>(H) * W;
  const bool inside = idx < H * W;
  constexpr int kTaps = KS * KS * 2;
  float acc[kTaps];
#pragma unroll
  for (int q = 0; q < kTaps; ++q) acc[q] = 0.0f;
  if (inside) {
    const float gin = reinterpret_cast<const float*>(g_next)[2 * idx + o] +
                      reinterpret_cast<const float*>(fbar)[2 * idx + o];
    reinterpret_cast<float*>(g_in_out)[2 * idx + o] = gin;
    const float* p = sp + 2 + o * (NB * (kTaps + 1) * hidden + hidden + 1);
    const float* yo = ys + static_cast<size_t>(o * NB * hidden) * cells + idx;
    adj2d::contract<KS, NB>(p, gin, hidden,
                            [&](const float*, int i, int c) {
                              return yo[static_cast<size_t>(i * hidden + c) * cells];
                            },
                            acc);
  }
  adj2d::write_zw<KS>(acc, xbuf, o, cell, inside, zw, cells, idx);
}

// k > 1, second launch of a reverse step: jt, Lap(g_in) and g in place.
template <int KS>
__global__ void __launch_bounds__(kThreads)
    adj2d_gather_kernel(const float* __restrict__ zw, const float2* __restrict__ g_in,
                        const float* __restrict__ params, float2* __restrict__ g, int H,
                        int W, float dt, float inv_dx2) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < H * W) kxk::gather_update<KS>(zw, g_in, params, g, H, W, dt, inv_dx2, idx);
}

template <int NB>
cudaError_t sweep_1x1(const float* params, int n_params, const float2* frames,
                      const float2* frames_bar, float2* g0, float2* scratch, float2* g_ins,
                      int n_steps, int H, int W, int hidden, float dt, float inv_dx2,
                      cudaStream_t stream) {
  const size_t cells = static_cast<size_t>(H) * W;
  const int blocks = static_cast<int>((cells + kThreads - 1) / kThreads);
  // Both g buffers start at zero (the wrapper zeroes them).  Step s reads
  // one and writes the other, in the order that makes the last step (t = 0)
  // write g0.
  for (int s = 0; s < n_steps; ++s) {
    const int t = n_steps - 1 - s;
    float2* dst = (t % 2 == 0) ? g0 : scratch;
    const float2* src = (t % 2 == 0) ? scratch : g0;
    adj2d_kernel<NB><<<blocks, kThreads, n_params * sizeof(float), stream>>>(
        params, n_params, frames + t * cells, frames_bar + (t + 1) * cells, src, dst,
        g_ins + t * cells, H, W, hidden, dt, inv_dx2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <int KS, int NB>
cudaError_t sweep_kxk(const float* params, int n_params, const float2* frames,
                      const float2* frames_bar, float2* g, float2* g_ins, float* zw,
                      int n_steps, int H, int W, int hidden, float dt, float inv_dx2,
                      cudaStream_t stream) {
  const size_t cells = static_cast<size_t>(H) * W;
  const int smem = act_smem_bytes<KS>(n_params, true);
  cudaError_t err = cudaFuncSetAttribute(adj2d_act_kernel<KS, NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kxk::kTileW - 1) / kxk::kTileW, (H + kxk::kTileH - 1) / kxk::kTileH);
  const int gather_blocks = static_cast<int>((cells + kThreads - 1) / kThreads);
  // g starts at zero (the wrapper zeroes it) and holds g_t after step t.
  for (int s = 0; s < n_steps; ++s) {
    const int t = n_steps - 1 - s;
    adj2d_act_kernel<KS, NB><<<grid, kxk::kThreads, smem, stream>>>(
        params, n_params, frames + t * cells, g, frames_bar + (t + 1) * cells,
        g_ins + t * cells, zw, H, W, hidden);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    adj2d_gather_kernel<KS><<<gather_blocks, kThreads, 0, stream>>>(
        zw, g_ins + t * cells, params, g, H, W, dt, inv_dx2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <int KS, int NB>
cudaError_t sweep_ys(const float* params, int n_params, const float2* frames_bar,
                     const float* ys, float2* g, float2* g_ins, float* zw, int n_steps,
                     int H, int W, int hidden, float dt, float inv_dx2,
                     cudaStream_t stream) {
  const size_t cells = static_cast<size_t>(H) * W;
  const size_t planes = static_cast<size_t>(2 * NB * hidden);
  const int smem = act_smem_bytes<KS>(n_params, false);
  cudaError_t err = cudaFuncSetAttribute(adj2d_ys_act_kernel<KS, NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int act_blocks = static_cast<int>((cells + kxk::kCells - 1) / kxk::kCells);
  const int blocks = static_cast<int>((cells + kThreads - 1) / kThreads);
  // g starts at zero (the wrapper zeroes it) and holds g_t after step t.
  for (int s = 0; s < n_steps; ++s) {
    const int t = n_steps - 1 - s;
    adj2d_ys_act_kernel<KS, NB><<<act_blocks, kxk::kThreads, smem, stream>>>(
        params, n_params, ys + t * planes * cells, g, frames_bar + (t + 1) * cells,
        g_ins + t * cells, zw, H, W, hidden);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    adj2d_gather_kernel<KS><<<blocks, kThreads, 0, stream>>>(
        zw, g_ins + t * cells, params, g, H, W, dt, inv_dx2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

namespace cg = cooperative_groups;

// adj2d_ys_persistent_kernel's layout: a warp pair (one an equation) for each
// 16-cell tile of a round, at most 8 tiles; lane (tap group q, cell group g)
// of a warp holds kR taps of cells 4 g .. 4 g + 3.
constexpr int kYsTileCells = 16;
constexpr int kYsMaxTiles = 8;
constexpr int kYsMaxThreads = 64 * kYsMaxTiles;  // 512
constexpr int kTapGroups = 8;
constexpr int kYsTail = 36;  // pack_ffma_tail_2d's: D (2), w_out (2 x 16), b_out (2)

template <int KS>
struct YsDims {
  static constexpr int kTaps = KS * KS * 2;
  static constexpr int kR = (kTaps + kTapGroups - 1) / kTapGroups;  // taps a lane: 7 at k = 5
  static constexpr int kHalves = (kR + 3) / 4;                      // float4s of a lane's row
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group of this thread but the last committed has landed
__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The whole ys sweep in one cooperative launch, one block an SM.  Block b
// owns the cells of share_of (kxk_mma.cuh) for every step.  Before the loop
// the block stages the adjoint operand (pack_ffma_adj_2d: the branch
// weights' taps, [M][kHalves][8 tap groups][4], 24.6 KB for the Burgers
// cell) and the tail.  Iteration s covers t = T - 1 - s, the schedule of
// adj2d_kxk_persistent_kernel (backward2d_kxk.cu):
//   A. a thread a (channel, own cell): unless s = 0, step t + 1's gather, jt
//      and Lap(g_in) from zw_{t+1} and g_ins[t + 1] at the neighbours (read
//      from L2 with __ldcg), and g_{t+1} = g_in + dt (D Lap(g_in) + jt); then
//      g_in = g_{t+1} + fbar_{t+1} into shared memory and g_ins[t];
//   B. per round of at most 8 tiles: z[m] = w_out_o[c] g_in_o prod_{j != i}
//      y_j of the round's cells into shared memory, Z [M][cells], from ys[t]
//      staged there; then zw^T = Wtaps^T Z as a register-tiled FFMA product:
//      warp 2 tl + o sums equation o's M / 2 rows for tile tl, lane (q, g)
//      kR taps x 4 cells, one float4 of Z and kHalves float4s of weights a
//      row for 4 kR FMAs; the o = 1 warp's sums meet the o = 0 warp's in
//      shared memory, and the block stores zw_t a plane's run at a time;
// then grid.sync().  zw alternates between two [k k 2][H W] buffers, as in
// the k x k sweep.  The ys stream (768 MB at T = 200 for the Burgers cell)
// does not fit L2: while step t runs, the block's runs of ys[t - 1] (M runs
// of its cells) are copied into a second shared-memory buffer by cp.async,
// so a step reads its activations from shared memory behind the barrier
// instead of waiting for HBM.  After the loop, step 0's gather writes g_0.
template <int KS, int NB>
__global__ void __launch_bounds__(kYsMaxThreads, 1)
    adj2d_ys_persistent_kernel(const float* __restrict__ wa, const float* __restrict__ tail,
                               const float2* __restrict__ frames_bar,
                               const float* __restrict__ ys, float2* g_out, float2* g_ins,
                               float* zw, int n_steps, int H, int W, int hidden, float dt,
                               float inv_dx2) {
  using D = YsDims<KS>;
  constexpr int kTaps = D::kTaps, kR = D::kR, R = KS / 2;
  cg::grid_group grid = cg::this_grid();
  const int cells = H * W;
  const kxk_mma::Share sh = kxk_mma::share_of(cells, W);
  const int cap = (cells + gridDim.x - 1) / gridDim.x;
  const int tiles = blockDim.x >> 6, rc = tiles * kYsTileCells;
  const int nwarps = blockDim.x >> 5;
  const int M = 2 * NB * hidden, Mo = NB * hidden;
  extern __shared__ float4 smem_ys[];
  float4* sw = smem_ys;                                                 // [M][kHalves][8]
  // Z [M][rc], then zw_t [kTaps][rc]
  float* zs = reinterpret_cast<float*>(sw + M * D::kHalves * kTapGroups);
  float* st = zs + max(M, kTaps) * rc;                                  // [kYsTail]
  float* zred = st + kYsTail;                                           // [tiles][4 kR][32]
  float* gin = zred + tiles * 4 * kR * 32;                              // [cap][2]
  float* ybuf = gin + 2 * cap;                                          // [2][M][cap]
  const float4* wa4 = reinterpret_cast<const float4*>(wa);
  for (int e = threadIdx.x; e < M * D::kHalves * kTapGroups; e += blockDim.x) sw[e] = wa4[e];
  for (int e = threadIdx.x; e < kYsTail; e += blockDim.x) st[e] = tail[e];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o = warp & 1, tl = warp >> 1;
  const int tg = lane >> 2, grp = lane & 3;
  const int rounds = (sh.n_own + rc - 1) / rc;

  // the block's runs of ys[t] into buffer b, a warp a plane
  auto prefetch = [&](int t, int b) {
    const float* src = ys + static_cast<size_t>(t) * M * cells + sh.first;
    float* dst = ybuf + static_cast<size_t>(b) * M * cap;
    for (int m = warp; m < M; m += nwarps)
      for (int k = lane; k < sh.n_own; k += 32)
        cp_async4(dst + m * cap + k, src + static_cast<size_t>(m) * cells + k);
  };

  // g_t at own cell k, channel c: g_in_t + dt (D Lap(g_in_t) + jt), from
  // g_ins[t] and zw_t (zsrc) at the neighbours
  auto gather = [&](int t, const float* zsrc, int k, int c) {
    const int idx = sh.first + k;
    const int i = idx / W;
    const int j = idx - i * W;
    int col[KS];
#pragma unroll
    for (int kj = 0; kj < KS; ++kj) col[kj] = kxk_mma::wrap2(j + R - kj, W);
    float jt = 0.0f;
#pragma unroll
    for (int ki = 0; ki < KS; ++ki) {
      const float* zrow = zsrc + static_cast<size_t>(ki * KS * 2 + c) * cells +
                          kxk_mma::wrap2(i + R - ki, H) * W;
#pragma unroll
      for (int kj = 0; kj < KS; ++kj)
        jt += __ldcg(zrow + static_cast<size_t>(kj * 2) * cells + col[kj]);
    }
    const float* gi = reinterpret_cast<const float*>(g_ins + static_cast<size_t>(t) * cells);
    auto at = [&](int di, int dj) {
      return __ldcg(gi + 2 * (kxk_mma::wrap2(i + di, H) * W + kxk_mma::wrap2(j + dj, W)) + c);
    };
    const float s1 = at(1, 0) + at(-1, 0) + at(0, 1) + at(0, -1);
    const float s2 = at(2, 0) + at(-2, 0) + at(0, 2) + at(0, -2);
    const float ctr = gin[2 * k + c];
    const float lap = (-5.0f * ctr + (4.0f / 3.0f) * s1 - (1.0f / 12.0f) * s2) * inv_dx2;
    return ctr + dt * (st[c] * lap + jt);
  };

  if (n_steps > 0) prefetch(n_steps - 1, 0);
  cp_async_commit();
  for (int s = 0; s < n_steps; ++s) {
    const int t = n_steps - 1 - s;
    float* zcur = zw + static_cast<size_t>(s & 1) * kTaps * cells;
    const float* zprev = zw + static_cast<size_t>((s + 1) & 1) * kTaps * cells;
    // A: g_in at the own cells, channel-major so a warp reads a plane's
    // consecutive cells
    const float* fb = reinterpret_cast<const float*>(frames_bar +
                                                     static_cast<size_t>(t + 1) * cells);
    float* gi_out = reinterpret_cast<float*>(g_ins + static_cast<size_t>(t) * cells);
    for (int item = threadIdx.x; item < 2 * sh.n_own; item += blockDim.x) {
      const int c = item >= sh.n_own ? 1 : 0;
      const int k = item - c * sh.n_own;
      const int idx = sh.first + k;
      float v = fb[2 * idx + c];
      if (s > 0) v += gather(t + 1, zprev, k, c);
      gin[2 * k + c] = v;
      gi_out[2 * idx + c] = v;
    }
    // ys[t - 1] into the buffer that step t + 1 read (before the last
    // barrier), issued after the gather's loads so that they do not queue
    // behind it; it lands while phase B and the barrier run
    if (t > 0) prefetch(t - 1, (s + 1) & 1);
    cp_async_commit();
    cp_async_wait_all_but_last();  // this thread's copies of ys[t]
    __syncthreads();
    // B
    const float* yb = ybuf + static_cast<size_t>(s & 1) * M * cap;
    for (int rd = 0; rd < rounds; ++rd) {
      const int base = rd * rc;
      // Z of the round's cells, a warp a (equation, channel) row, zero past
      // the block's cells
      for (int row = warp; row < 2 * hidden; row += nwarps) {
        const int eo = row >= hidden ? 1 : 0;
        const int c = row - eo * hidden;
        const float wo = st[2 + eo * 16 + c];
        for (int kk = lane; kk < rc; kk += 32) {
          const int k = base + kk;
          float z[NB];
          if (k < sh.n_own) {
            float y[NB], pre[NB + 1], suf[NB + 1];
#pragma unroll
            for (int i = 0; i < NB; ++i) y[i] = yb[((eo * NB + i) * hidden + c) * cap + k];
            pre[0] = 1.0f;
            suf[NB] = 1.0f;
#pragma unroll
            for (int i = 0; i < NB; ++i) pre[i + 1] = pre[i] * y[i];
#pragma unroll
            for (int i = NB - 1; i >= 0; --i) suf[i] = suf[i + 1] * y[i];
            const float gw = wo * gin[2 * k + eo];
#pragma unroll
            for (int i = 0; i < NB; ++i) z[i] = gw * (pre[i] * suf[i + 1]);
          } else {
#pragma unroll
            for (int i = 0; i < NB; ++i) z[i] = 0.0f;
          }
#pragma unroll
          for (int i = 0; i < NB; ++i) zs[((eo * NB + i) * hidden + c) * rc + kk] = z[i];
        }
      }
      __syncthreads();
      // zw^T of equation o's rows at tile tl: kR taps x 4 cells a lane
      float acc[kR][4];
#pragma unroll
      for (int j = 0; j < kR; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
      const float4* zl = reinterpret_cast<const float4*>(zs) + tl * 4 + grp;
      const float4* wl = sw + tg;
      const int zstride = rc / 4;
#pragma unroll 4
      for (int m = o * Mo; m < (o + 1) * Mo; ++m) {
        const float4 z = zl[m * zstride];
        float w[4 * D::kHalves];
#pragma unroll
        for (int h = 0; h < D::kHalves; ++h) {
          const float4 v = wl[(m * D::kHalves + h) * kTapGroups];
          w[4 * h] = v.x;
          w[4 * h + 1] = v.y;
          w[4 * h + 2] = v.z;
          w[4 * h + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          acc[j][0] = fmaf(w[j], z.x, acc[j][0]);
          acc[j][1] = fmaf(w[j], z.y, acc[j][1]);
          acc[j][2] = fmaf(w[j], z.z, acc[j][2]);
          acc[j][3] = fmaf(w[j], z.w, acc[j][3]);
        }
      }
      float* zr = zred + tl * 4 * kR * 32 + lane;
      if (o == 1) {
#pragma unroll
        for (int j = 0; j < kR; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) zr[(4 * j + e) * 32] = acc[j][e];
      }
      __syncthreads();
      // the o = 0 warps add the o = 1 warps' sums into [kTaps][rc] in Z's
      // place (read by no warp now), then every thread stores a plane's
      // consecutive cells of zw_t
      if (o == 0) {
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int q = tg * kR + j;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (q < kTaps) zs[q * rc + tl * kYsTileCells + grp * 4 + e] =
                acc[j][e] + zr[(4 * j + e) * 32];
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < kTaps * rc; e += blockDim.x) {
        const int q = e / rc, kk = e - q * rc;
        if (base + kk < sh.n_own)
          zcur[static_cast<size_t>(q) * cells + sh.first + base + kk] = zs[e];
      }
      __syncthreads();  // Z and the exchange free for the next round
    }
    grid.sync();
  }
  if (n_steps > 0) {
    const float* zlast = zw + static_cast<size_t>((n_steps - 1) & 1) * kTaps * cells;
    float* go = reinterpret_cast<float*>(g_out);
    for (int item = threadIdx.x; item < 2 * sh.n_own; item += blockDim.x) {
      const int c = item >= sh.n_own ? 1 : 0;
      const int k = item - c * sh.n_own;
      go[2 * (sh.first + k) + c] = gather(0, zlast, k, c);
    }
  }
}

// Shared memory of adj2d_ys_persistent_kernel<KS, NB> on `blocks` blocks of
// `threads` threads: the operand, Z of a round (or zw_t's, if more rows),
// the tail, the exchange of
// each warp pair, g_in of the most cells a block owns and the two ys buffers
// (ys_smem_bytes in ../backward2d.py computes the same).
template <int KS>
size_t ys_persistent_smem(int H, int W, int hidden, int n_branches, int blocks, int threads) {
  using D = YsDims<KS>;
  const size_t cap = (static_cast<size_t>(H) * W + blocks - 1) / blocks;
  const size_t tiles = threads / 64, rc = tiles * kYsTileCells;
  const size_t M = 2 * static_cast<size_t>(n_branches) * hidden;
  const size_t zrows = M > D::kTaps ? M : D::kTaps;
  return 4 * (M * D::kHalves * kTapGroups * 4 + zrows * rc + kYsTail + tiles * 4 * D::kR * 32 +
              2 * cap + 2 * M * cap);
}

template <int KS, int NB>
cudaError_t ys_persistent_occupancy(size_t smem, int threads, int* per_sm) {
  auto kernel = adj2d_ys_persistent_kernel<KS, NB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
}

template <int KS, int NB>
cudaError_t ys_persistent_sweep(const float* wa, const float* tail, const float2* frames_bar,
                                const float* ys, float2* g, float2* g_ins, float* zw,
                                int n_steps, int H, int W, int hidden, float dt, float inv_dx2,
                                int blocks, int threads, size_t smem, cudaStream_t stream,
                                int* per_sm) {
  if (smem != ys_persistent_smem<KS>(H, W, hidden, NB, blocks, threads))
    return cudaErrorInvalidValue;
  cudaError_t err = ys_persistent_occupancy<KS, NB>(smem, threads, per_sm);
  if (err != cudaSuccess) return err;
  err = kxk_mma::check_coresident(blocks, *per_sm);
  if (err != cudaSuccess || n_steps == 0) return err;
  void* args[] = {&wa, &tail, &frames_bar, &ys, &g, &g_ins, &zw, &n_steps, &H, &W, &hidden,
                  &dt, &inv_dx2};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(adj2d_ys_persistent_kernel<KS, NB>), dim3(blocks),
      dim3(threads), args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// (kernel_size, n_branches) of the caller's scope -> return F<KS, NB>(...),
// or cudaErrorInvalidValue for other widths (k = 3 or 5, 1 to 4 branches).
#define YS_DISPATCH(F, ...)                      \
  switch (kernel_size * 10 + n_branches) {       \
    case 31: return F<3, 1>(__VA_ARGS__);        \
    case 32: return F<3, 2>(__VA_ARGS__);        \
    case 33: return F<3, 3>(__VA_ARGS__);        \
    case 34: return F<3, 4>(__VA_ARGS__);        \
    case 51: return F<5, 1>(__VA_ARGS__);        \
    case 52: return F<5, 2>(__VA_ARGS__);        \
    case 53: return F<5, 3>(__VA_ARGS__);        \
    case 54: return F<5, 4>(__VA_ARGS__);        \
    default: return cudaErrorInvalidValue;       \
  }

#define PERCNN_NB_CASES(CALL) \
  case 1: return CALL(1);     \
  case 2: return CALL(2);     \
  case 3: return CALL(3);     \
  case 4: return CALL(4);     \
  default: return cudaErrorInvalidValue;

}  // namespace

// frames, frames_bar [n_steps + 1, H, W, 2]; g [H, W, 2] zeroed, and at
// k = 1 a second zeroed [H, W, 2] buffer `scratch` (unused at k > 1);
// g_ins [n_steps, H, W, 2]; zw [k k 2, H, W] scratch at k > 1 (unused at
// k = 1).  On return g holds the adjoint at frame 0 (without frames_bar[0]).
extern "C" int adj2d_sweep(const void* params, int n_params, const void* frames,
                           const void* frames_bar, void* g, void* scratch, void* g_ins,
                           void* zw, int n_steps, int H, int W, int hidden, int n_branches,
                           int kernel_size, float dt, float inv_dx2, void* stream) {
  const float* p = static_cast<const float*>(params);
  const float2* f = static_cast<const float2*>(frames);
  const float2* fb = static_cast<const float2*>(frames_bar);
  float2* gg = static_cast<float2*>(g);
  float2* sc = static_cast<float2*>(scratch);
  float2* gi = static_cast<float2*>(g_ins);
  float* z = static_cast<float*>(zw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ONE(NB) sweep_1x1<NB>(p, n_params, f, fb, gg, sc, gi, n_steps, H, W, hidden, dt, inv_dx2, s)
#define K3(NB) sweep_kxk<3, NB>(p, n_params, f, fb, gg, gi, z, n_steps, H, W, hidden, dt, inv_dx2, s)
#define K5(NB) sweep_kxk<5, NB>(p, n_params, f, fb, gg, gi, z, n_steps, H, W, hidden, dt, inv_dx2, s)
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

// frames_bar [n_steps + 1, H, W, 2]; ys [n_steps, 2 nb C, H, W]; g [H, W, 2]
// zeroed; g_ins [n_steps, H, W, 2]; zw [k k 2, H, W] scratch.  On return g
// holds the adjoint at frame 0 (without frames_bar[0]).
extern "C" int adj2d_ys_sweep(const void* params, int n_params, const void* frames_bar,
                              const void* ys, void* g, void* g_ins, void* zw, int n_steps,
                              int H, int W, int hidden, int n_branches, int kernel_size,
                              float dt, float inv_dx2, void* stream) {
  const float* p = static_cast<const float*>(params);
  const float2* fb = static_cast<const float2*>(frames_bar);
  const float* y = static_cast<const float*>(ys);
  float2* gg = static_cast<float2*>(g);
  float2* gi = static_cast<float2*>(g_ins);
  float* z = static_cast<float*>(zw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K3(NB) sweep_ys<3, NB>(p, n_params, fb, y, gg, gi, z, n_steps, H, W, hidden, dt, inv_dx2, s)
#define K5(NB) sweep_ys<5, NB>(p, n_params, fb, y, gg, gi, z, n_steps, H, W, hidden, dt, inv_dx2, s)
  switch (kernel_size) {
    case 3: switch (n_branches) { PERCNN_NB_CASES(K3) }
    case 5: switch (n_branches) { PERCNN_NB_CASES(K5) }
    default: return cudaErrorInvalidValue;
  }
#undef K3
#undef K5
}

// The same sweep in one cooperative launch of adj2d_ys_persistent_kernel on
// `blocks` blocks of `threads` threads with `smem` bytes (ys_plan: at most the
// card's co-resident count, else cudaErrorCooperativeLaunchTooLarge before
// anything is launched; bytes other than the kernel's own, or C over 16,
// cudaErrorInvalidValue).  wa and tail are pack_ffma_adj_2d's and
// pack_ffma_tail_2d's; zw is a [2, k k 2, H, W] scratch; g (zeroed) receives
// g_0 and the other outputs are adj2d_ys_sweep's.  `per_sm` gets the
// occupancy query's blocks an SM.
extern "C" int adj2d_ys_persistent(const void* wa, const void* tail, const void* frames_bar,
                                   const void* ys, void* g, void* g_ins, void* zw, int n_steps,
                                   int H, int W, int hidden, int n_branches, int kernel_size,
                                   float dt, float inv_dx2, int blocks, int threads, int smem,
                                   void* stream, int* per_sm) {
  const float* w = static_cast<const float*>(wa);
  const float* t = static_cast<const float*>(tail);
  const float2* fb = static_cast<const float2*>(frames_bar);
  const float* y = static_cast<const float*>(ys);
  float2* gg = static_cast<float2*>(g);
  float2* gi = static_cast<float2*>(g_ins);
  float* z = static_cast<float*>(zw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks < 1 || blocks > H * W || threads < 64 || threads > kYsMaxThreads ||
      threads % 64 != 0 || hidden < 1 || hidden > 16)
    return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(smem);
  YS_DISPATCH(ys_persistent_sweep, w, t, fb, y, gg, gi, z, n_steps, H, W, hidden, dt, inv_dx2,
              blocks, threads, bytes, s, per_sm)
}

// How many blocks of adj2d_ys_persistent_kernel an SM holds at once,
// `threads` threads and `smem` bytes a block.
extern "C" int adj2d_ys_occupancy(int n_branches, int kernel_size, int threads, int smem,
                                  int* per_sm) {
  const size_t bytes = static_cast<size_t>(smem);
  YS_DISPATCH(ys_persistent_occupancy, bytes, threads, per_sm)
}
