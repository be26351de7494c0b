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
// rollout2d_kernel replaces percnn_tpu/ops/pallas/cell2d.py:_rollout_kernel
// (pallas_call in _fused_rollout_padded) and final2d_kernel replaces
// _final_kernel (pallas_call in _fused_final_padded), both at any odd
// k <= 5.  Both run the same step: euler_step at k = 1, euler_step_kxk at
// k = 3, 5 (cell2d_step.cuh, shared with the ensemble's batched2d.cu).
//
// Bound on an H100 SXM at its 700 W power limit (published peaks: 3.35 TB/s,
// 67 TFLOP/s f32 outside the tensor cores), GS2D serving shape 100 x 100,
// T = 2500:
//   bytes: the frames path writes 2501 frames of 80 KB, about 200 MB, which
//          is 60 us; the final-state path moves 160 KB;
//   operations: about 290 flops per cell and step, 2.9 MFLOP per step,
//          7.3 GFLOP per rollout, which is 108 us.
// Neither is what limits this design: every step depends on the whole field
// of the step before, so a rollout is a chain of T dependent steps, and with
// one launch per step each link costs at least one kernel launch.  Measured
// by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 13.4 ms per
// rollout, 5.3 us per step, for either kernel.
// What the design does about it: each step is one launch over H*W threads
// (40 blocks of 256 for 100 x 100), the packed parameters sit in shared
// memory, and the whole T-step loop of launches runs here in C on the
// caller's stream, so a rollout is one call from Python and not T.  There is
// no halo in the state: the kernel wraps its indices.  Cutting the launches
// (a persistent kernel, clusters with DSMEM halos) is later work.
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

#include <cuda_runtime.h>

#include "cell2d_step.cuh"

namespace {

using step2d::Launch;
using step2d::launch_shape;
using step2d::step;

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
// [H, W, 2]), in the order that makes the last step write `out`.
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
