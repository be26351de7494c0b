// Member-batched forward and reverse sweeps of the 2D Pi-cell rollout: M
// independent models (an ensemble), each with its own row of an [M, P]
// table of packed parameters (pack_pi_params_2d in ../cell2d.py) and its own
// state, advanced together, one launch a step for all M members.
//
// Layouts (channels-last, f32, member-major):
//   params     [M, P]
//   frames     [M, T + 1, H, W, 2]   frame 0 of member m is h0[m]
//   frames_bar [M, T + 1, H, W, 2]   the frames' cotangent
//   g_ins      [M, T, H, W, 2]       the streaming sweep's g_in of each step
//   g          [M, H, W, 2]          the adjoint, double-buffered at k = 1
//   zw         [M, k k 2, H, W]      scratch of the k x k sweep
//   acc        [M, A, H, W]          the fused sweep's accumulator planes
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
//   pg2d_batched_kernel<NB> replaces _phase1_pg_kernel_b (pallas_call in
//     _fused_phase1_pg_b): the step of pg2d_kernel (backward2d.cu), every
//     parameter gradient accumulated in member m's [A, H, W] planes.
// The TPU kernels walk an (M, T) grid, members outer and time inner, with a
// member's state in VMEM scratch; their halo-in-state padding to (8, 128)
// tiles and their SMEM parameter-row adapter are TPU layout, not carried
// over.  The TPU's pg kernel accumulates in VMEM scratch because
// accumulating into a revisited output block gave gradients about 3e-3 off
// on the TPU; here one thread owns each (member, cell, plane) entry of acc
// for the whole sweep, with no atomics and no sum across blocks.
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
// What the design does about it: every launch covers all M members, the
// member in the grid's last dimension (y at k = 1, z at k > 1), so an
// ensemble's step costs one launch and not M, and an M-member launch puts
// M times the blocks of a single model's on the card's 132 SMs (160 blocks
// of 256 at M = 4 and 100 x 100, k = 1).  Each block stages its member's
// parameter row in shared memory, as the single kernels stage theirs.  The
// T-step loops of launches run here in C on the caller's stream.

#include <cuda_runtime.h>

#include "adj2d_step.cuh"
#include "cell2d_step.cuh"

namespace {

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
