// Member-batched forward and reverse sweeps of the 2D Pi-cell rollout: M
// independent models (an ensemble), each with its own row of an [M, P]
// table of packed parameters (pack_pi_params_2d in ../cell2d.py) and its own
// state, advanced together: the reverse sweeps (fused, and streaming at
// k = 1, 3 and 5) in one cooperative launch for all M members, the per-step
// kernels here, which run past the one-launch kernels' plans, one launch a
// step for all M.  (The forwards take one launch a call too:
// rollout2d_cluster_kernel of cell2d.cu for the GS2D cell, M clusters, one
// a member, and rollout2d_ffma_persistent_kernel of cell2d_ffma.cu with a
// member axis for a k x k cell.)
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
//     _fused_rollout_padded_b) past rollout_b_plan's one-launch forwards
//     (../batched2d.py) and for the widths they are not built for:
//     step2d::step of cell2d_step.cuh, the step of rollout2d_kernel
//     (cell2d.cu), any odd k <= 5;
//   adj2d_batched_kernel<NB> (k = 1) and adj2d_batched_act_kernel<KS, NB> +
//     adj2d_batched_gather_kernel<KS> (k = 3, 5) replace _phase1_kernel_b
//     (pallas_call in _fused_phase1_b): the steps of adj2d_kernel and of
//     adj2d_act_kernel + adj2d_gather_kernel (adj2d.cu), writing g_ins and
//     g0 for the parameter gradients outside (chunked_param_grads in
//     ../batched2d.py); at k = 1 adj2d_batched_persistent_kernel<NB>
//     replaces adj2d_batched_kernel on any field whose block fits shared
//     memory (adj1_b_plan in ../batched2d.py: 224 x 224 at M = 4, 156 x 156
//     at M = 8 for the GS2D cell on 132 SMs): every member's sweep in one
//     cooperative launch, adj2d_persistent_kernel's three passes with a
//     member axis (adj2d_step.cuh); at k = 3, 5
//     adj2d_batched_ffma_persistent_kernel<KS, NB> replaces the pair on any
//     field whose block fits shared memory (adj_b_plan in ../backward2d.py:
//     570 x 570 at M = 2, 300 x 300 at M = 8 for the Burgers cell): every
//     member's sweep in one cooperative launch, FFMA in full f32 (the design
//     is described at the kernel); at M = 1 it is also the single model's
//     k x k streaming sweep (row 4 at k = 3, 5: ../backward2d.py's
//     _phase1_cuda calls it on a one-member batch, 768 x 768 at most);
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
// 0.58 ms forward and 1.2 ms sweep, by operations.  What limits the
// per-step kernels is the chain of T dependent steps, one launch each (two
// a step for the k x k sweep).  Measured by chip_smoke.py
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
// The k x k streaming sweep in one launch: the per-step pair took 46.9 us a
// step at M = 2 for the Burgers cell, the weights read from shared memory
// one scalar an FMA and zw [M, 50, H, W] making a round trip through global
// memory every step.  adj2d_batched_ffma_persistent_kernel keeps a member's
// operands in each of its n_sm // M blocks' shared memory for the whole
// sweep and forms both products as register tiles (kxk_ffma.cuh: the
// forward FFMA kernel's y = Wf im2col + b from frame t, whose lanes then
// hold every branch of their channels and form z themselves, and the ys
// sweep's zw^T = Wtaps^T Z); no activation stream exists.  A block's cells
// go in the fewest rounds of at most 8 tiles of 16, the same number each
// (adj_b_grid), so no round runs its products on tiles it does not own.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W, T = 200
// at 100 x 100, in turns with the per-step pair in the same call: 5.142 ms
// at M = 2 (25.7 us a step, one launch) against 9.432, and 9.428 at M = 4
// against 13.546; 121 registers, no spill (k = 5, 3 branches).
// The 1x1 streaming sweep in one launch: adj2d_batched_kernel took one
// launch a step (5.98 us a step at M = 4).  adj2d_batched_persistent_kernel
// runs the single model's one-launch sweep with n_sm // M blocks a member, a
// member's block owning M times the single model's cells; its pass 2 keeps
// each thread's (equation, hidden channel) group and its weights in
// registers for the whole sweep, as pg2d_batched_persistent_kernel does,
// since the single model's mapping (weights from shared memory, a division
// an item) ran slower than one launch a step in a variant build.  Measured
// by chip_smoke.py as above, T = 800: 3.040 ms at M = 4
// (3.80 us a step) against 4.782 for adj2d_batched_kernel in turns, and
// 5.051 at M = 8 against 5.899; 128 registers, 4 bytes spilled (NB = 3).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "adj2d_step.cuh"
#include "cell2d_step.cuh"
#include "kxk_ffma.cuh"

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

// Threads a block of adj2d_batched_persistent_kernel: adj2d_persistent_kernel's.
constexpr int kAdjThreads = 512;

// Row 12 at k = 1: the streaming sweep of every member in one cooperative
// launch, one block an SM, one grid barrier a step: adj2d::persistent_sweep
// with the member axis (adj2d_step.cuh, where the design is described), the
// grid M runs of per_member blocks, block b of run m on member m's field.
// Each member's g0 and g_ins equal adj2d_persistent_kernel's (adj2d.cu) on
// that member alone to the bit.
template <int NB>
__global__ void __launch_bounds__(kAdjThreads)
    adj2d_batched_persistent_kernel(const float* __restrict__ params, int n_params,
                                    const float2* __restrict__ frames,
                                    const float2* __restrict__ frames_bar, float2* g0,
                                    float2* scratch, float2* g_ins, int n_steps, int H, int W,
                                    int hidden, int per_member, float dt, float inv_dx2) {
  adj2d::persistent_sweep<NB, false, true>(params, n_params, frames, frames_bar, g0, scratch,
                                           nullptr, g_ins, n_steps, H, W, hidden, dt, inv_dx2,
                                           per_member);
}

// Row 12 at k > 1: the streaming sweep of every member in one cooperative
// launch, FFMA in full f32.  The grid is M runs of per_member blocks, one
// block an SM; block b of run m works on member m alone (its operands, its
// frames, cotangents, g_ins, zw and g_0), and owns the cells of
// kxk_mma::share_of_run(per_member, b) of that member's H W field for every
// step.
// Before the loop the block stages its member's forward operand
// (pack_ffma_fwd_2d: the branch weights and biases, 26 KB for the Burgers
// cell), adjoint operand (pack_ffma_adj_2d, 24.6 KB) and tail
// (pack_ffma_tail_2d).  Iteration s covers t = T - 1 - s:
//   A. a thread a (channel, own cell): unless s = 0, step t + 1's gather
//      (kxk_ffma::g_at: jt and Lap(g_in) from zw_{t+1} and g_ins[t + 1] at
//      the neighbours, read past L1), g_{t+1}; then g_in = g_{t+1} +
//      fbar_{t+1} into shared memory and g_ins[t]; and frame t's rows, with
//      the 2-cell wrapped halo, staged into shared memory;
//   B. per round of at most 8 tiles of 16 cells: the im2col stack of the
//      round's cells from the staged rows; y = Wf im2col + b by
//      rollout2d_ffma_persistent_kernel's product (warp 2 tl + o, lane
//      (pair p, group g): channels 2 p, 2 p + 1 of every branch of equation
//      o at 4 cells, in registers), and at once, in the same lane,
//      z = w_out_o[c] g_in_o prod_{j != i} y_j into Z [M rows][cells]; then
//      zw^T = Wtaps^T Z by adj2d_ys_persistent_kernel's product (lane (tap
//      group q, group g): kR taps x 4 cells over equation o's rows), the
//      o = 1 warp's sums meeting the o = 0 warp's in shared memory (in the
//      im2col stack's place), zw_t into Z's place and out a plane's run at
//      a time;
// then grid.sync().  zw alternates between two [k k 2][H W] buffers of the
// member; after the loop step 0's gather writes g_0.  Nothing but the
// frames and cotangents is streamed in: the activations are formed from
// frame t in the block and never leave it.
template <int KS, int NB>
__global__ void __launch_bounds__(kxk_ffma::kMaxThreads, 1)
    adj2d_batched_ffma_persistent_kernel(const float* __restrict__ wf,
                                         const float* __restrict__ wa,
                                         const float* __restrict__ tail,
                                         const float2* __restrict__ frames,
                                         const float2* __restrict__ frames_bar, float2* g_out,
                                         float2* g_ins, float* zw, int n_steps, int H, int W,
                                         int hidden, int per_member, float dt, float inv_dx2) {
  using FD = kxk_ffma::FwdDims<KS, NB>;
  using AD = kxk_ffma::AdjDims<KS>;
  using kxk_ffma::kPairs;
  using kxk_ffma::kTail;
  using kxk_ffma::kTapGroups;
  using kxk_ffma::kTileCells;
  constexpr int kTaps = AD::kTaps, kR = AD::kR;
  cg::grid_group grid = cg::this_grid();
  const int cells = H * W;
  const int mem = blockIdx.x / per_member;
  const kxk_mma::Share sh =
      kxk_mma::share_of_run(cells, W, per_member, blockIdx.x - mem * per_member);
  const int cap = (cells + per_member - 1) / per_member;
  const int tiles = blockDim.x >> 6, rc = tiles * kTileCells;
  const int M = 2 * NB * hidden, Mo = NB * hidden;
  // member mem's operands and state, at offsets in size_t
  const size_t frame_stride = (static_cast<size_t>(n_steps) + 1) * cells;
  wf += static_cast<size_t>(mem) * FD::kOperand;
  wa += static_cast<size_t>(mem) * M * AD::kHalves * kTapGroups * 4;
  tail += static_cast<size_t>(mem) * kTail;
  frames += mem * frame_stride;
  frames_bar += mem * frame_stride;
  g_out += static_cast<size_t>(mem) * cells;
  g_ins += static_cast<size_t>(mem) * n_steps * cells;
  zw += static_cast<size_t>(mem) * 2 * kTaps * cells;

  extern __shared__ float4 smem_bf[];
  float4* swf = smem_bf;                                   // forward operand
  float4* swa = swf + FD::kOperand / 4;                    // [M][kHalves][8] adjoint operand
  float* st = reinterpret_cast<float*>(swa + M * AD::kHalves * kTapGroups);   // [kTail]
  float* xs = st + kTail;  // im2col [kTaps][rc], then the exchange [tiles][4 kR][32]
  float* zs = xs + max(kTaps * rc, tiles * 4 * kR * 32);  // Z [M][rc], then zw_t [kTaps][rc]
  float* gin = zs + max(M, kTaps) * rc;                    // [cap][2]
  float2* tile = reinterpret_cast<float2*>(gin + 2 * cap);   // [rows][W + 4]
  {
    const float4* wf4 = reinterpret_cast<const float4*>(wf);
    for (int e = threadIdx.x; e < FD::kOperand / 4; e += blockDim.x) swf[e] = wf4[e];
    const float4* wa4 = reinterpret_cast<const float4*>(wa);
    for (int e = threadIdx.x; e < M * AD::kHalves * kTapGroups; e += blockDim.x) swa[e] = wa4[e];
    for (int e = threadIdx.x; e < kTail; e += blockDim.x) st[e] = tail[e];
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o = warp & 1, tl = warp >> 1;
  const int pair = lane >> 2, grp = lane & 3;  // the forward's lane; pair is the adjoint's
                                               // tap group
  const int rounds = (sh.n_own + rc - 1) / rc;
  const float* tf = reinterpret_cast<const float*>(tile);
  // the im2col entries a thread builds: cell xc of the round, taps xq0,
  // xq0 + 4, ... (blockDim.x = 4 rc)
  const int xc = threadIdx.x % rc, xq0 = threadIdx.x / rc;
  const float4* wlane = swf + o * FD::kHalves * kPairs + pair;
  const float4* xlane = reinterpret_cast<const float4*>(xs) + tl * 4 + grp;
  const float4* zlane = reinterpret_cast<const float4*>(zs) + tl * 4 + grp;

  // g_t at own cell k, channel c, from g_ins[t] and zw_t (zsrc) at the
  // neighbours
  auto gather = [&](int t, const float* zsrc, int k, int c) {
    return kxk_ffma::g_at<KS>(zsrc, g_ins, t, gin + 2 * k + c, st + c, sh.first + k, c, H, W,
                              dt, inv_dx2);
  };

  for (int s = 0; s < n_steps; ++s) {
    const int t = n_steps - 1 - s;
    float* zcur = zw + static_cast<size_t>(s & 1) * kTaps * cells;
    const float* zprev = zw + static_cast<size_t>((s + 1) & 1) * kTaps * cells;
    // A: g_in at the own cells, channel-major so a warp reads a plane's
    // consecutive cells; frame t's rows
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
    kxk_mma::stage_rows(tile, frames + static_cast<size_t>(t) * cells, H, W, sh);
    // B
    for (int rd = 0; rd < rounds; ++rd) {
      const int base = rd * rc;
      __syncthreads();  // g_in and the rows written, or the last round's reads done
      {
        const int k = min(base + xc, sh.n_own - 1);
        const int tb = kxk_mma::tap_base<KS>(sh.first + k, W, sh.row0);
#pragma unroll
        for (int u = 0; u < (kTaps + 3) / 4; ++u) {
          const int q = xq0 + 4 * u;
          if (q < kTaps) xs[q * rc + xc] = tf[tb + kxk_ffma::tap_offset<KS>(q, W)];
        }
      }
      __syncthreads();
      {
        // y of 2 channels x NB branches (f = cl NB + i) at 4 cells, then z
        // of each into Z, zero past the block's cells
        float acc[2 * NB][4];
        kxk_ffma::fwd_product<KS, NB>(wlane, xlane, rc / 4, acc);
        const int k0 = base + tl * kTileCells + grp * 4;
#pragma unroll
        for (int cl = 0; cl < 2; ++cl) {
          const int c = 2 * pair + cl;
          if (c < hidden) {
            const float wo = st[2 + o * 16 + c];
            float z[NB][4];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              if (k0 + m < sh.n_own) {
                float pre[NB + 1], suf[NB + 1];
                pre[0] = 1.0f;
                suf[NB] = 1.0f;
#pragma unroll
                for (int i = 0; i < NB; ++i) pre[i + 1] = pre[i] * acc[cl * NB + i][m];
#pragma unroll
                for (int i = NB - 1; i >= 0; --i) suf[i] = suf[i + 1] * acc[cl * NB + i][m];
                const float gw = wo * gin[2 * (k0 + m) + o];
#pragma unroll
                for (int i = 0; i < NB; ++i) z[i][m] = gw * (pre[i] * suf[i + 1]);
              } else {
#pragma unroll
                for (int i = 0; i < NB; ++i) z[i][m] = 0.0f;
              }
            }
#pragma unroll
            for (int i = 0; i < NB; ++i)
              *reinterpret_cast<float4*>(zs + ((o * NB + i) * hidden + c) * rc + tl * kTileCells +
                                         grp * 4) = make_float4(z[i][0], z[i][1], z[i][2],
                                                                z[i][3]);
          }
        }
      }
      __syncthreads();
      // zw^T of equation o's rows at tile tl: kR taps x 4 cells a lane
      float acc[kR][4];
      kxk_ffma::adj_product<KS>(zlane, swa + pair, rc / 4, o * Mo, (o + 1) * Mo, acc);
      float* zr = xs + tl * 4 * kR * 32 + lane;
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
          const int q = pair * kR + j;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (q < kTaps) zs[q * rc + tl * kTileCells + grp * 4 + e] =
                acc[j][e] + zr[(4 * j + e) * 32];
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < kTaps * rc; e += blockDim.x) {
        const int q = e / rc, kk = e - q * rc;
        if (base + kk < sh.n_own)
          zcur[static_cast<size_t>(q) * cells + sh.first + base + kk] = zs[e];
      }
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

// Shared memory of adj2d_batched_ffma_persistent_kernel<KS, NB> with
// per_member blocks a member of `threads` threads: both operands, the tail,
// the im2col stack of a round (or the exchange, if larger), Z of a round (or
// zw_t's, if more rows), g_in of the most cells a block owns and its most
// staged rows (adj_b_smem_bytes in ../backward2d.py computes the same).
template <int KS, int NB>
size_t adj_b_smem(int H, int W, int hidden, int per_member, int threads) {
  using FD = kxk_ffma::FwdDims<KS, NB>;
  using AD = kxk_ffma::AdjDims<KS>;
  const size_t cap = (static_cast<size_t>(H) * W + per_member - 1) / per_member;
  const size_t tiles = threads / 64, rc = tiles * kxk_ffma::kTileCells;
  const size_t M = 2 * static_cast<size_t>(NB) * hidden;
  const size_t xsize = AD::kTaps * rc > tiles * 4 * AD::kR * 32 ? AD::kTaps * rc
                                                                 : tiles * 4 * AD::kR * 32;
  const size_t zrows = M > AD::kTaps ? M : AD::kTaps;
  return 4 * (FD::kOperand + M * AD::kHalves * kxk_ffma::kTapGroups * 4 + kxk_ffma::kTail +
              xsize + zrows * rc + 2 * cap) +
         kxk_mma::tile_bytes(H, W, per_member);
}

template <int KS, int NB>
cudaError_t adj_b_occupancy(size_t smem, int threads, int* per_sm) {
  auto kernel = adj2d_batched_ffma_persistent_kernel<KS, NB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
}

template <int KS, int NB>
cudaError_t adj_b_persistent(const float* wf, const float* wa, const float* tail,
                             const float2* frames, const float2* frames_bar, float2* g,
                             float2* g_ins, float* zw, int M, int n_steps, int H, int W,
                             int hidden, float dt, float inv_dx2, int per_member, int threads,
                             size_t smem, cudaStream_t stream, int* per_sm) {
  // the plan's bytes must be the kernel's
  if (smem != adj_b_smem<KS, NB>(H, W, hidden, per_member, threads))
    return cudaErrorInvalidValue;
  cudaError_t err = adj_b_occupancy<KS, NB>(smem, threads, per_sm);
  if (err != cudaSuccess) return err;
  err = kxk_mma::check_coresident(M * per_member, *per_sm);
  if (err != cudaSuccess || n_steps == 0) return err;
  void* args[] = {&wf, &wa, &tail, &frames, &frames_bar, &g, &g_ins, &zw, &n_steps, &H, &W,
                  &hidden, &per_member, &dt, &inv_dx2};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(adj2d_batched_ffma_persistent_kernel<KS, NB>),
      dim3(M * per_member), dim3(threads), args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// How many blocks of adj2d_batched_persistent_kernel<NB> an SM holds at
// once, its shared memory allowed (adj2d::persistent_smem on per_member
// blocks, the single model's bytes for a member's share).
template <int NB>
cudaError_t adj1_b_occupancy(size_t smem, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(adj2d_batched_persistent_kernel<NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, adj2d_batched_persistent_kernel<NB>, kAdjThreads, smem);
}

template <int NB>
cudaError_t adj1_b_persistent(const float* params, int n_params, const float2* frames,
                              const float2* frames_bar, float2* g0, float2* scratch,
                              float2* g_ins, int M, int n_steps, int H, int W, int hidden,
                              float dt, float inv_dx2, int per_member, cudaStream_t stream,
                              int* per_sm) {
  const size_t smem = adj2d::persistent_smem(n_params, H, W, hidden, 0, per_member);
  cudaError_t err = adj1_b_occupancy<NB>(smem, per_sm);
  if (err != cudaSuccess) return err;
  err = kxk_mma::check_coresident(M * per_member, *per_sm);
  if (err != cudaSuccess || n_steps == 0) return err;
  void* args[] = {&params, &n_params, &frames, &frames_bar, &g0, &scratch, &g_ins, &n_steps,
                  &H, &W, &hidden, &per_member, &dt, &inv_dx2};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(adj2d_batched_persistent_kernel<NB>), dim3(M * per_member),
      dim3(kAdjThreads), args, smem, stream);
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

// The k > 1 streaming sweep of every member in one cooperative launch of
// adj2d_batched_ffma_persistent_kernel on M x per_member blocks of `threads`
// threads (a multiple of 64, at most 512) with `smem` bytes (adj_b_plan: at
// most the card's co-resident count, else cudaErrorCooperativeLaunchTooLarge
// before anything is launched; bytes other than the kernel's own, or C over
// 16, cudaErrorInvalidValue; nothing launched at n_steps = 0).  wf, wa and
// tail are [M, ...] stacks of pack_ffma_fwd_2d's, pack_ffma_adj_2d's and
// pack_ffma_tail_2d's operands; frames, frames_bar [M, n_steps + 1, H, W,
// 2]; g [M, H, W, 2] zeroed, receives each member's g_0; g_ins [M, n_steps,
// H, W, 2]; zw [M, 2, k k 2, H, W] scratch.  `per_sm` gets the occupancy
// query's blocks an SM.
extern "C" int batched2d_adj_ffma_persistent(const void* wf, const void* wa, const void* tail,
                                             const void* frames, const void* frames_bar,
                                             void* g, void* g_ins, void* zw, int M, int n_steps,
                                             int H, int W, int hidden, int n_branches,
                                             int kernel_size, float dt, float inv_dx2,
                                             int per_member, int threads, int smem,
                                             void* stream, int* per_sm) {
  if (M < 1 || per_member < 1 || per_member > H * W || threads < 64 ||
      threads > kxk_ffma::kMaxThreads || threads % 64 != 0 || hidden < 1 || hidden > 16)
    return cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(wf);
  const float* a = static_cast<const float*>(wa);
  const float* t = static_cast<const float*>(tail);
  const float2* fr = static_cast<const float2*>(frames);
  const float2* fb = static_cast<const float2*>(frames_bar);
  float2* gg = static_cast<float2*>(g);
  float2* gi = static_cast<float2*>(g_ins);
  float* z = static_cast<float*>(zw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem);
  KXK_FFMA_DISPATCH(adj_b_persistent, f, a, t, fr, fb, gg, gi, z, M, n_steps, H, W, hidden, dt,
                    inv_dx2, per_member, threads, bytes, s, per_sm)
}

// How many blocks of adj2d_batched_ffma_persistent_kernel an SM holds at
// once, `threads` threads and `smem` bytes a block.
extern "C" int batched2d_adj_ffma_occupancy(int n_branches, int kernel_size, int threads,
                                            int smem, int* per_sm) {
  const size_t bytes = static_cast<size_t>(smem);
  KXK_FFMA_DISPATCH(adj_b_occupancy, bytes, threads, per_sm)
}

// The k = 1 sweep of every member in one cooperative launch of
// adj2d_batched_persistent_kernel on M x per_member blocks (adj1_b_plan in
// ../batched2d.py: at most the card's co-resident count, else
// cudaErrorCooperativeLaunchTooLarge before anything is launched; nothing is
// launched at n_steps = 0; C over 256, cudaErrorInvalidValue).  frames,
// frames_bar [M, n_steps + 1, H, W, 2];
// g0 and scratch [M, H, W, 2] zeroed; g_ins [M, n_steps, H, W, 2].  On
// return g0 holds each member's adjoint at frame 0 (without
// frames_bar[:, 0]).  `per_sm` gets the occupancy query's blocks an SM.
extern "C" int batched2d_adj_persistent(const void* params, int n_params, const void* frames,
                                        const void* frames_bar, void* g0, void* scratch,
                                        void* g_ins, int M, int n_steps, int H, int W,
                                        int hidden, int n_branches, float dt, float inv_dx2,
                                        int per_member, void* stream, int* per_sm) {
  if (M < 1 || per_member < 1 || per_member > H * W || hidden < 1 || 2 * hidden > kAdjThreads)
    return cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(params);
  const float2* f = static_cast<const float2*>(frames);
  const float2* fb = static_cast<const float2*>(frames_bar);
  float2* g = static_cast<float2*>(g0);
  float2* sc = static_cast<float2*>(scratch);
  float2* gi = static_cast<float2*>(g_ins);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AP(NB) adj1_b_persistent<NB>(p, n_params, f, fb, g, sc, gi, M, n_steps, H, W, hidden, \
                                     dt, inv_dx2, per_member, s, per_sm)
  switch (n_branches) { PERCNN_NB_CASES(AP) }
#undef AP
}

// How many blocks of adj2d_batched_persistent_kernel an SM holds at once
// with per_member blocks a member, its shared memory allowed.
extern "C" int batched2d_adj_persistent_occupancy(int n_params, int H, int W, int hidden,
                                                  int n_branches, int per_member,
                                                  int* per_sm) {
  const size_t smem = adj2d::persistent_smem(n_params, H, W, hidden, 0, per_member);
#define AO(NB) adj1_b_occupancy<NB>(smem, per_sm)
  switch (n_branches) { PERCNN_NB_CASES(AO) }
#undef AO
}
