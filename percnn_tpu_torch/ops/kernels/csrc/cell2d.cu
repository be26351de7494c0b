// Forward-Euler Pi-cell rollout of a 2D two-channel field, from the packed
// parameters, for kernel_size 1 and for kernel_size 3 or 5.
//
// One time step, for every cell (i, j) of the periodic H x W grid:
//   Lap x = (-5 x + 4/3 s1 - 1/12 s2) / dx^2    (s1, s2: the four neighbours
//           at distance 1 and 2 along both axes, indices wrapped periodically)
//   y_i   = sum_{ki,kj,cin} w_i[ki,kj,cin,c] h(i + ki - r, j + kj - r)[cin] + b_i[c]
//           (r = k / 2; at k = 1, w_i[0,c] u + w_i[1,c] v + b_i[c])
//   Pi_o  = sum_c w_out[c] * prod_i y_i + b_out
//   u'    = u + dt (Du Lap u + Pi_u),   v' = v + dt (Dv Lap v + Pi_v)
// The state is channels-last [H, W, 2] f32, read and written as float2.
// The packed parameters follow pack_pi_params_2d in ../cell2d.py:
// [Du, Dv] then, per output channel, per branch (w_i [k, k, 2, C] row-major,
// b_i [C]), then w_out [C], b_out [1]: 164 floats for the GS2D cell (C = 8,
// 3 branches, k = 1), 4932 for the Burgers cell (C = 16, 3 branches, k = 5).
//
// rollout2d_cluster_kernel replaces percnn_tpu/ops/pallas/cell2d.py:
// _rollout_kernel (pallas_call in _fused_rollout_padded) for the 1x1 GS2D
// cell on any field whose strips fit one cluster's shared memory (448 x 448
// at most; rollout_plan in ../cell2d.py), and in its final-state mode
// _final_kernel (pallas_call in _fused_final_padded) on the same fields
// (final_plan); rollout2d_kernel replaces _rollout_kernel for any other
// field and for k = 3, 5, and final2d_kernel replaces _final_kernel at any
// odd k <= 5 past the one-launch kernels' plans (and with the MXU switch
// off).  With a member axis, M clusters in one launch, one a member,
// rollout2d_cluster_kernel also replaces the ensemble's
// percnn_tpu/ops/pallas/batched2d.py:_rollout_kernel_b (pallas_call in
// _fused_rollout_padded_b) for the GS2D cell (rollout_b_plan in
// ../batched2d.py; rollout2d_batched_kernel of batched2d.cu past it).
// All three run the same step: euler_step at k = 1 (two cells at a time,
// euler_cellsN, in the cluster kernel), euler_step_kxk at k = 3, 5
// (cell2d_step.cuh, shared with the ensemble's batched2d.cu and the
// decomposition's sharded_step2d.cu), so the cluster kernel's frames equal
// rollout2d_kernel's to the bit.
//
// Bound on an H100 SXM at its 700 W power limit (published peaks: 3.35 TB/s,
// 67 TFLOP/s f32 outside the tensor cores), GS2D serving shape 100 x 100,
// T = 2500:
//   bytes: the frames path writes 2501 frames of 80 KB, about 200 MB, which
//          is 60 us; the final-state path moves 160 KB;
//   operations: about 290 flops per cell and step, 2.9 MFLOP per step,
//          7.3 GFLOP per rollout, which is 108 us.
// Neither is what limits these designs: every step depends on the whole
// field of the step before, so a rollout is a chain of T dependent steps.
// With one launch a step (rollout2d_kernel, final2d_kernel: 40 blocks of
// 256 threads for 100 x 100, the T-step loop of launches here in C on the
// caller's stream) each link costs a launch and a round trip of the state
// through global memory.  rollout2d_cluster_kernel runs the whole chain in
// one launch of one 16-CTA cluster, the field in shared memory, the halo
// rows pushed to the neighbouring CTAs through distributed shared memory
// and one cluster barrier a step (the design is described at the kernel).
// Its step is then paced by the step's own instructions on 16 SMs (about
// 300 a cell) and the barrier.  An ensemble's M members are M clusters of
// one launch; no cluster waits on another, so clusters the card cannot hold
// at once (a 16-CTA cluster takes most of a GPC) wait for a free one, and
// past that count rollout_b_plan takes clusters of 8 CTAs.  Measured by
// chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W, T = 800 at
// 100 x 100: M = 4 in one
// launch of 16-CTA clusters 1.758 ms (2.20 us a step) against 5.218 for
// rollout2d_batched_kernel<1>, in turns; M = 8 by 8-CTA clusters 3.390 ms
// against 6.329 (the card holds 7 clusters of 16 CTAs and 15 of 8).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W, per
// 2500-step rollout at 100 x 100: rollout2d_cluster_kernel 5.157 ms, one
// launch, 2.06 us a step; rollout2d_kernel 13.296 ms in the same call (5.3
// us a step).  Its final-state mode 5.074 ms, one launch, 2.03 us a step,
// against 14.012 ms for final2d_kernel, timed in turns in one call.
//
// At k = 5 (the Burgers cell, 100 x 100, C = 16, 3 branches) the step is
// the direct form of the TPU kernel's unrolled VPU FMAs: per cell and
// equation 48 branch activations of 50 taps and a bias, so about 10 k
// flops a cell and step, 0.1 GFLOP a step: 1.5 us at the f32 peak, against
// 24 ns for the 80 KB frame written.  Bound by operations, like
// rollout2d_kxk_kernel (cell2d_kxk.cu), which computes the same step as a
// product with the branch matrix; the two are the two routes of
// ../cell2d.py's MXU_FWD_ENABLED.  What the design does about it: a block of
// 256 threads covers an 8 x 16 tile, two threads a cell, one per equation
// (91 blocks for 100 x 100, the layout of rollout2d_kxk_kernel), stages the
// 19.7 KB of packed parameters and its tile with a 2-cell wrapped halo in
// shared memory (kxk_common.cuh), and each thread holds its cell's 50 taps
// in registers while it walks its equation's weights of each (hidden
// channel, branch) tap by tap: every warp reads the same weight at once, a
// broadcast from shared memory.  The branch count is a template parameter,
// as in the other k x k kernels: a first form that looped over a run-time
// count gave a wrong Pi for the second equation on the card when built at
// -O3, and the right one when built with -G.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cell2d_step.cuh"

namespace {

namespace cg = cooperative_groups;

using step2d::Launch;
using step2d::launch_shape;
using step2d::step;

// The most threads a CTA of rollout2d_cluster_kernel runs (two cells of its
// strip a thread, up to this many): 512 leaves a thread 128 registers.
constexpr int kClusterThreads = 512;
// Cells a thread of rollout2d_cluster_kernel takes at once.
constexpr int kClusterCells = 2;

// Rows [start, start + rows) of the H rows that CTA r of n owns: the
// balanced split, the first H % n CTAs one row more (split_evenly in
// ../cell2d.py, which the CPU tests hold).
__device__ __forceinline__ void strip_of(int r, int n, int H, int& start, int& rows) {
  const int q = H / n, m = H % n;
  rows = q + (r < m ? 1 : 0);
  start = r * q + (r < m ? r : m);
}

// The whole frames rollout of a 1x1 cell in one launch of one cluster of n
// CTAs, every strip at least 2 rows (rollout_plan in ../cell2d.py: n =
// min(16, H / 2)).  CTA r keeps its strip of rows (strip_of) in shared
// memory, in two buffers of [rows_max + 4, W] that the steps ping-pong
// between (the strip, and 2 halo rows above and below), and the packed
// parameters before them.  A step: each thread takes cells of the strip
// (euler_cellsN on the Strip grid, the per-step kernel's arithmetic, from
// the current buffer) and puts the new state into the other buffer, into
// the other buffer's halo of the CTA above (a cell of the strip's first
// two rows) or below (of its last two: periodic in rows, so the first and
// last CTAs are neighbours) through distributed shared memory, and into
// frame t + 1, a coalesced store that no step waits on; then one
// cluster.sync(), whose release/acquire at cluster scope publishes the new
// strips and halos.  With two buffers that one barrier a step is enough:
// step t reads buffer t & 1 and writes buffer (t + 1) & 1 alone, here and
// in the neighbours, so no write of a step can meet a read of the same
// step, and each crosses the barrier before it is read.  The last step's
// writes into a neighbour come before the barrier that ends it, so no CTA
// exits while a peer still writes to it.
// With final_only (the final-state request, in place of _final_kernel) the
// kernel writes no frames: `frames` is the final state [H, W, 2], and each
// thread stores its cells' new state there at the last step alone.  The
// strips and halos ping-pong in shared memory as above, so the barrier and
// its argument are the same, and the arithmetic is the frames path's: the
// final state equals the last frame to the bit.  The flag is an argument,
// not a template parameter, so one compiled kernel serves both requests.
// The hidden width C and the branch count NB are fixed at compile time (the
// GS2D cell: 8, 3), and a thread takes kClusterCells cells at once, k,
// k + blockDim, ..., each weight read once for all of them from 16-byte
// aligned rows (AlignedParams): at one cell a thread, with the widths read
// at run time, the step's weight reads from shared memory were what it
// waited on.  A thread's first cells are the same at every step, so their
// indices are worked out once, before the steps.
// With kMembers, the grid is M clusters and cluster `mem` runs member mem
// of an ensemble: its row of the [M, P] table, its h0 and its output,
// out_stride float2 after the member before.  The flag is a template
// parameter so that the single model's instance keeps the machine code it
// had before the member axis (with the offsets in it, it ran slower).
template <int C, int NB, bool kMembers>
__global__ void __launch_bounds__(kClusterThreads)
    rollout2d_cluster_kernel(const float* __restrict__ params,
                             const float2* __restrict__ h0, float2* __restrict__ frames,
                             size_t out_stride, int n_steps, int final_only, int H, int W,
                             float dt, float inv_dx2) {
  using Params = step2d::AlignedParams<C, NB>;
  constexpr int kCells = kClusterCells;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  if constexpr (kMembers) {
    const int mem = blockIdx.x / n;
    params += mem * (2 + 2 * Params::kBlock);
    h0 += static_cast<size_t>(mem) * H * W;
    frames += mem * out_stride;
  }
  int start, rows, up_start, up_rows;
  strip_of(r, n, H, start, rows);
  strip_of((r + n - 1) % n, n, H, up_start, up_rows);
  (void)up_start;
  const int buf_len = ((H + n - 1) / n + 4) * W;
  extern __shared__ float4 smem_cluster[];
  float* sp = reinterpret_cast<float*>(smem_cluster);
  Params::stage(sp, params);
  float2* bufs = reinterpret_cast<float2*>(sp + Params::kFloats);
  float2* up = cluster.map_shared_rank(bufs, (r + n - 1) % n);
  float2* down = cluster.map_shared_rank(bufs, (r + 1) % n);

  // cell (i, j) of the strip into buffer `off` here, and into the halo of
  // the same buffer of the CTA above (its rows up_rows + 2, up_rows + 3 are
  // this strip's rows 0, 1) or below (its rows 0, 1 are this strip's last
  // two)
  auto put = [&](int off, int i, int j, float2 v) {
    bufs[off + (i + 2) * W + j] = v;
    if (i < 2) up[off + (up_rows + 2 + i) * W + j] = v;
    if (i >= rows - 2) down[off + (i - rows + 2) * W + j] = v;
  };
  const size_t cells = static_cast<size_t>(H) * W;
  const int own = rows * W;
  const size_t first = static_cast<size_t>(start) * W;
  for (int k = threadIdx.x; k < own; k += blockDim.x) {
    const float2 v = h0[first + k];
    const int i = k / W;
    put(0, i, k - i * W, v);
    if (!final_only) frames[first + k] = v;
  }
  const step2d::Strip grid{rows, W};
  // the row, column and cross of cell k of the strip (cell 0 stands in for
  // a cell past the strip, whose result is not stored)
  auto at = [&](int k, int& i, int& j) {
    const int kk = k < own ? k : 0;
    i = kk / W;
    j = kk - i * W;
    return grid.cross(kk, i, j);
  };
  const int B = blockDim.x, k0 = threadIdx.x;
  int i0[kCells], j0[kCells];
  step2d::Cross x0[kCells];
#pragma unroll
  for (int m = 0; m < kCells; ++m) x0[m] = at(k0 + m * B, i0[m], j0[m]);
  cluster.sync();

  for (int t = 0; t < n_steps; ++t) {
    const float2* cur = bufs + (t & 1) * buf_len;
    const int next = ((t + 1) & 1) * buf_len;
    // frame t + 1, or the final state at the last step (no store before it)
    float2* out = frames + (final_only ? 0 : static_cast<size_t>(t + 1) * cells) + first;
    const bool store = !final_only || t == n_steps - 1;
    for (int k = k0; k < own; k += kCells * B) {
      int i[kCells], j[kCells];
      step2d::Cross x[kCells];
#pragma unroll
      for (int m = 0; m < kCells; ++m) {
        if (k == k0) {
          i[m] = i0[m];
          j[m] = j0[m];
          x[m] = x0[m];
        } else {
          x[m] = at(k + m * B, i[m], j[m]);
        }
      }
      float2 v[kCells];
      step2d::euler_cellsN<C, NB, kCells>(sp, cur, x, dt, inv_dx2, v);
#pragma unroll
      for (int m = 0; m < kCells; ++m) {
        if (k + m * B < own) {
          put(next, i[m], j[m], v[m]);
          if (store) out[k + m * B] = v[m];
        }
      }
    }
    cluster.sync();
  }
}

// The cell widths (C, NB) rollout2d_cluster_kernel is compiled for: the
// GS2D cell's (rollout_plan in ../cell2d.py takes no other).
constexpr int kClusterC = 8, kClusterNB = 3;
using ClusterParams = step2d::AlignedParams<kClusterC, kClusterNB>;

// Dynamic shared memory of rollout2d_cluster_kernel: the staged parameters
// (AlignedParams: 172 floats), then two [rows_max + 4, W] float2 buffers
// (cluster_smem_bytes in ../cell2d.py).
size_t cluster_smem_bytes(int H, int W, int n_cta) {
  const size_t rows_max = (H + n_cta - 1) / n_cta;
  return ClusterParams::kFloats * sizeof(float) + 2 * (rows_max + 4) * W * sizeof(float2);
}

using ClusterKernel = void (*)(const float*, const float2*, float2*, size_t, int, int, int, int,
                              float, float);
// one model, and M members in one launch
constexpr ClusterKernel kClusterKernel = rollout2d_cluster_kernel<kClusterC, kClusterNB, false>;
constexpr ClusterKernel kClusterKernelMembers =
    rollout2d_cluster_kernel<kClusterC, kClusterNB, true>;

// The launch configuration of `members` clusters of n_cta CTAs, one a
// member, their shared memory allowed; `attr` must outlive the
// configuration.
cudaError_t cluster_config(ClusterKernel kernel, int H, int W, int n_cta, int threads,
                           int members, cudaStream_t stream, cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* config) {
  const size_t smem = cluster_smem_bytes(H, W, n_cta);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // a cluster of more than 8 CTAs is a non-portable size (16 on an H100)
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             n_cta > 8 ? 1 : 0);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n_cta;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3(n_cta * members);
  config->blockDim = dim3(threads);
  config->dynamicSmemBytes = smem;
  config->stream = stream;
  config->attrs = attr;
  config->numAttrs = 1;
  return cudaSuccess;
}

// One step of the frames path: `in` is frame t and `out` frame t + 1 of the
// output, which thereby holds the state.
template <int KS, int NB>
__global__ void rollout2d_kernel(const float* __restrict__ params, int n_params,
                                 const float2* __restrict__ in,
                                 float2* __restrict__ out, int H, int W,
                                 int hidden, int n_branches, float dt,
                                 float inv_dx2) {
  step<KS, NB>(params, n_params, in, out, H, W, hidden, n_branches, dt, inv_dx2);
}

// One step of the final-state path: `in` and `out` are the two buffers the
// steps ping-pong between.
template <int KS, int NB>
__global__ void final2d_kernel(const float* __restrict__ params, int n_params,
                               const float2* __restrict__ in,
                               float2* __restrict__ out, int H, int W,
                               int hidden, int n_branches, float dt,
                               float inv_dx2) {
  step<KS, NB>(params, n_params, in, out, H, W, hidden, n_branches, dt, inv_dx2);
}

using StepKernel = void (*)(const float*, int, const float2*, float2*, int, int,
                            int, int, float, float);

// Allow the kernel the shared memory of its launch shape (over the default
// 48 KB only at k > 1 with the largest parameter vectors).
cudaError_t allow_smem(StepKernel kernel, const Launch& shape) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shape.smem);
}

cudaError_t launch_step(StepKernel kernel, const Launch& shape, const float* params,
                        int n_params, const float2* in, float2* out, int H, int W,
                        int hidden, int n_branches, float dt, float inv_dx2,
                        cudaStream_t stream) {
  kernel<<<shape.grid, shape.block, shape.smem, stream>>>(
      params, n_params, in, out, H, W, hidden, n_branches, dt, inv_dx2);
  return cudaGetLastError();
}

// frames [n_steps + 1, H, W, 2]: frame 0 is a copy of h0 and step t reads
// frame t and writes frame t + 1, so the output buffer is the state.
template <int KS, int NB>
cudaError_t rollout(const float* params, int n_params, const void* h0, float2* f,
                    int n_steps, int H, int W, int hidden, int n_branches, float dt,
                    float inv_dx2, cudaStream_t s) {
  const size_t cells = static_cast<size_t>(H) * W;
  cudaError_t err = cudaMemcpyAsync(f, h0, cells * sizeof(float2),
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return err;
  const Launch shape = launch_shape<KS>(n_params, H, W);
  err = allow_smem(rollout2d_kernel<KS, NB>, shape);
  if (err != cudaSuccess) return err;
  for (int t = 0; t < n_steps; ++t) {
    err = launch_step(rollout2d_kernel<KS, NB>, shape, params, n_params, f + t * cells,
                      f + (t + 1) * cells, H, W, hidden, n_branches, dt, inv_dx2, s);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// Final state only: the steps ping-pong between `out` and `scratch` (both
// [H, W, 2]), in the order that makes the last step write `out`: step t
// writes `out` when n_steps - 1 - t is even (final_schedule in ../cell2d.py,
// which the CPU tests hold; rollout2d_kxk_persistent_kernel keeps the same
// order).
template <int KS, int NB>
cudaError_t final_state(const float* params, int n_params, const void* h0, void* out,
                        void* scratch, int n_steps, int H, int W, int hidden,
                        int n_branches, float dt, float inv_dx2, cudaStream_t s) {
  const size_t cells = static_cast<size_t>(H) * W;
  if (n_steps == 0) {
    cudaError_t err = cudaMemcpyAsync(out, h0, cells * sizeof(float2),
                                      cudaMemcpyDeviceToDevice, s);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  const Launch shape = launch_shape<KS>(n_params, H, W);
  cudaError_t err = allow_smem(final2d_kernel<KS, NB>, shape);
  if (err != cudaSuccess) return err;
  const float2* src = static_cast<const float2*>(h0);
  for (int t = 0; t < n_steps; ++t) {
    float2* dst = static_cast<float2*>((n_steps - 1 - t) % 2 == 0 ? out : scratch);
    err = launch_step(final2d_kernel<KS, NB>, shape, params, n_params, src, dst, H, W, hidden,
                      n_branches, dt, inv_dx2, s);
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaGetLastError();
}

// How many n_cta-CTA clusters of rollout2d_cluster_kernel the card can hold
// at once (0: none, and the launch would be refused).
cudaError_t cluster_occupancy(ClusterKernel kernel, int H, int W, int n_cta, int threads,
                              int* clusters) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config;
  cudaError_t err = cluster_config(kernel, H, W, n_cta, threads, 1, nullptr, &attr, &config);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &config);
}

#define PERCNN_NB_CASES(CALL) \
  case 1: return CALL(1);     \
  case 2: return CALL(2);     \
  case 3: return CALL(3);     \
  case 4: return CALL(4);     \
  default: return cudaErrorInvalidValue;

}  // namespace

// The k x k steps are compiled for 1 to 4 branches; the 1x1 step takes any.
extern "C" int cell2d_rollout(const void* params, int n_params, const void* h0,
                              void* frames, int n_steps, int H, int W,
                              int hidden, int n_branches, int kernel_size, float dt,
                              float inv_dx2, void* stream) {
  const float* p = static_cast<const float*>(params);
  float2* f = static_cast<float2*>(frames);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define R(KS, NB) rollout<KS, NB>(p, n_params, h0, f, n_steps, H, W, hidden, n_branches, dt, inv_dx2, s)
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

extern "C" int cell2d_final(const void* params, int n_params, const void* h0,
                            void* out, void* scratch, int n_steps, int H, int W,
                            int hidden, int n_branches, int kernel_size, float dt,
                            float inv_dx2, void* stream) {
  const float* p = static_cast<const float*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define F(KS, NB) final_state<KS, NB>(p, n_params, h0, out, scratch, n_steps, H, W, hidden, n_branches, dt, inv_dx2, s)
#define F3(NB) F(3, NB)
#define F5(NB) F(5, NB)
  switch (kernel_size) {
    case 1: return F(1, 0);
    case 3: switch (n_branches) { PERCNN_NB_CASES(F3) }
    case 5: switch (n_branches) { PERCNN_NB_CASES(F5) }
    default: return cudaErrorInvalidValue;
  }
#undef F
#undef F3
#undef F5
}

// The frames rollout of a 1x1 cell in one launch: frames [n_steps + 1, H, W, 2]
// (frame 0 = h0), one cluster of n_cta CTAs of `threads` threads; with
// final_only, `frames` is the final state [H, W, 2] alone, and at n_steps = 0
// h0 is copied there and nothing is launched.  With `members` M > 1 the
// same launch runs M independent models, one cluster each (an ensemble's
// rollout, in place of batched2d.py:_rollout_kernel_b): params [M, P], h0
// [M, H, W, 2] and frames [M, n_steps + 1, H, W, 2] (final_only: [M, H, W,
// 2]); clusters the card cannot hold at once wait for a free GPC, which is
// right because no cluster waits on another.  A card that cannot hold one
// cluster returns cudaErrorLaunchOutOfResources before anything is
// launched; `clusters` gets the occupancy query's count.
extern "C" int cell2d_rollout_cluster(const void* params, int n_params, const void* h0,
                                      void* frames, int n_steps, int final_only, int H, int W,
                                      int hidden, int n_branches, float dt, float inv_dx2,
                                      int n_cta, int threads, int members, void* stream,
                                      int* clusters) {
  if (hidden != kClusterC || n_branches != kClusterNB ||
      n_params != 2 + 2 * ClusterParams::kBlock || n_cta < 1 || 2 * n_cta > H ||
      threads < 32 || threads > kClusterThreads || members < 1)
    return cudaErrorInvalidValue;
  const ClusterKernel kernel = members > 1 ? kClusterKernelMembers : kClusterKernel;
  cudaError_t err = cluster_occupancy(kernel, H, W, n_cta, threads, clusters);
  if (err != cudaSuccess) return err;
  if (*clusters < 1) return cudaErrorLaunchOutOfResources;
  const size_t cells = static_cast<size_t>(H) * W;
  if (final_only && n_steps == 0) {
    err = cudaMemcpyAsync(frames, h0, members * cells * sizeof(float2),
                          cudaMemcpyDeviceToDevice, static_cast<cudaStream_t>(stream));
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config;
  err = cluster_config(kernel, H, W, n_cta, threads, members, static_cast<cudaStream_t>(stream),
                       &attr, &config);
  if (err != cudaSuccess) return err;
  const size_t out_stride = final_only ? cells : (static_cast<size_t>(n_steps) + 1) * cells;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const float*>(params),
                           static_cast<const float2*>(h0), static_cast<float2*>(frames),
                           out_stride, n_steps, final_only ? 1 : 0, H, W, dt, inv_dx2);
  return err != cudaSuccess ? err : cudaGetLastError();
}

extern "C" int cell2d_cluster_occupancy(int H, int W, int n_cta, int threads, int* clusters) {
  return cluster_occupancy(kClusterKernel, H, W, n_cta, threads, clusters);
}
