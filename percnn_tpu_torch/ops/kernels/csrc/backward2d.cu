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
// design is described at adj2d::persistent_sweep in adj2d_step.cuh, whose
// code without the accumulators is adj2d.cu's adj2d_persistent_kernel, the
// streaming sweep in one launch).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W, per
// T = 800 backward at 100 x 100: pg2d_persistent_kernel 2.931 ms, one
// launch, 3.66 us a step; pg2d_kernel 7.203 ms in the same call (9.0 us a
// step).

#include <cuda_runtime.h>

#include "adj2d_step.cuh"

namespace {

using adj2d::kThreads;

// Threads a block of pg2d_persistent_kernel.
constexpr int kPersistentThreads = 512;

// The whole reverse sweep in one cooperative launch, one block an SM, each
// block's cells' A accumulators in its shared memory for the whole sweep,
// one grid barrier a step: adj2d::persistent_sweep with kAcc
// (adj2d_step.cuh, where the design is described; adj2d.cu's
// adj2d_persistent_kernel is the same sweep without the accumulators).
template <int NB>
__global__ void __launch_bounds__(kPersistentThreads)
    pg2d_persistent_kernel(const float* __restrict__ params, int n_params,
                           const float2* __restrict__ frames,
                           const float2* __restrict__ frames_bar, float2* g0, float2* scratch,
                           float* __restrict__ acc, int n_steps, int H, int W, int hidden,
                           float dt, float inv_dx2) {
  adj2d::persistent_sweep<NB, true>(params, n_params, frames, frames_bar, g0, scratch, acc,
                                    nullptr, n_steps, H, W, hidden, dt, inv_dx2);
}

// Dynamic shared memory of pg2d_persistent_kernel on `blocks` blocks: the
// packed parameters, then [A + 6 + 4 C][cap] floats (adj2d::persistent_smem).
size_t persistent_smem_bytes(int n_params, int H, int W, int hidden, int n_branches,
                             int blocks) {
  const size_t planes = 2 * n_branches * hidden * 3 + 2 * hidden + 4;
  return adj2d::persistent_smem(n_params, H, W, hidden, planes, blocks);
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
