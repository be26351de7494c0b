// Reverse sweep of the forward-Euler 3D 1x1 Pi-cell rollout (csrc/cell3d.cu)
// with every parameter gradient accumulated in the same pass.
//
// One reverse step t (t = T-1 .. 0), for every cell of the periodic
// D x H x W grid:
//   g_in = g_{t+1} + fbar_{t+1}                     (g_T = 0)
//   the A accumulator planes take this cell's share of every parameter
//          gradient (pg_accumulate in pg_common.cuh, shared with pg2d_kernel)
//   g_t  = g_in + dt (D * Lap(g_in) + sum_{o,c,i} (w_i[0,c], w_i[1,c]) w_out[c] zz)
// with Lap the 4th-order 13-point periodic Laplacian
//   Lap x = (-15/2 x + 4/3 s1 - 1/12 s2) / dx^2    (s1, s2: the six neighbours
//           at distance 1 and 2 along the three axes)
// which is symmetric, so it is its own adjoint.  The planes ([A, D, H, W] f32,
// A = 44 for the GS3D cell: hidden 2, 3 branches) are summed over the grid
// after the sweep; dt, the w_out factor of dw and db, and the diffusion
// reparametrisation are applied outside (backward2d.py: _pg_unpack).  The
// packed parameters are the literal form, pack_pi_params_3d (cell3d.py);
// the forward ran the expanded form of the same cell.
//
// pg3d_kernel replaces percnn_tpu/ops/pallas/backward3d.py:_phase1_pg_kernel3d
// (pallas_call in _fused_phase1_pg_3d).  adj3d_kernel, at the end, replaces
// _phase1_kernel3d (pallas_call in _fused_phase1_3d): the same sweep without
// the accumulators, streaming g_ins[t] = g_in [D, H, W, 2] out for the
// time-batched parameter gradients (chunked_param_grads, ../backward3d.py).
//
// Bound on an H100 SXM at its 700 W power limit (published peaks: 3.35 TB/s,
// 67 TFLOP/s f32 outside the tensor cores), GS3D training shape 48^3,
// T = 300, reckoned as in backward2d.cu:
//   operations: 296 flops per cell and step that the function needs (48 for
//          each of the 4 equation and hidden-channel pairs; plus 26 for g_in
//          at 13 points, four 3D Laplacians of 16, 6 for the diffusion and
//          b_out planes and 8 for the update; chip_smoke.py counts them),
//          9.8 GFLOP per backward: 147 us;
//   bytes: h_t and fbar_{t+1} once per step, 2 x 885 KB x 300 = 531 MB, plus
//          19.5 MB of accumulator planes and g0 written once: 165 us.
// So it is bound by bytes on paper, closely followed by operations.  What
// limits this design is, as in 2D, the chain of T dependent steps, one launch
// each, and each step's read-modify-write of the 44 accumulator planes
// (19.5 MB read and written a step at 48^3, held in the 50 MB L2).
// What the design does about it: each reverse step is one launch over
// D*H*W threads (432 blocks of 256 at 48^3), one cell per thread; the loop
// runs here in C on the caller's stream.  With no grid-wide barrier inside a
// launch, each thread forms g_in itself at its 12 stencil neighbours and g
// ping-pongs between two [D, H, W, 2] buffers.  Each thread owns its cell's
// entry of every plane, plane-major: no atomics, a deterministic result,
// coalesced plane accesses; each (equation, hidden channel) group of planes
// is loaded before it is stored (pg_common.cuh).  The packed parameters sit
// in shared memory.  Cutting the launches is later work, as for the others.

#include <cuda_runtime.h>

#include "pg_common.cuh"
#include "stencil3d.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float lap13(const float x[kPoints], float inv_dx2) {
  const float s1 = x[1] + x[2] + x[3] + x[4] + x[5] + x[6];
  const float s2 = x[7] + x[8] + x[9] + x[10] + x[11] + x[12];
  return (-7.5f * x[0] + (4.0f / 3.0f) * s1 - (1.0f / 12.0f) * s2) * inv_dx2;
}

// At most 64 registers a thread, so that four blocks of 256 fit an SM's 64K
// registers: left to itself nvcc takes more here, fewer blocks fit, and the
// sweep is slower (chip_smoke.py's build phase prints ptxas's counts).
template <int NB>
__global__ void __launch_bounds__(kThreads, 4) pg3d_kernel(const float* __restrict__ params, int n_params,
                            const float2* __restrict__ h,     // frame t
                            const float2* __restrict__ fbar,  // cotangent of frame t + 1
                            const float2* __restrict__ g_next,
                            float2* __restrict__ g_out,
                            float* __restrict__ acc, int D, int H, int W,
                            int hidden, float dt, float inv_dx2) {
  extern __shared__ float sp[];
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sp[k] = params[k];
  __syncthreads();

  const int cells = D * H * W;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= cells) return;
  int nbr[kPoints];
  stencil13(idx, D, H, W, nbr);

  float hu[kPoints], hv[kPoints], gu[kPoints], gv[kPoints];
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const float2 x = h[nbr[k]];
    const float2 a = g_next[nbr[k]], b = fbar[nbr[k]];
    hu[k] = x.x;
    hv[k] = x.y;
    gu[k] = a.x + b.x;
    gv[k] = a.y + b.y;
  }
  const float lap_hu = lap13(hu, inv_dx2), lap_hv = lap13(hv, inv_dx2);
  const float lap_gu = lap13(gu, inv_dx2), lap_gv = lap13(gv, inv_dx2);
  const float gin[2] = {gu[0], gv[0]};

  float du, dv;
  pg_accumulate<NB>(sp, hu[0], hv[0], gin, lap_hu, lap_hv, acc + idx, cells, hidden,
                    du, dv);
  g_out[idx] = make_float2(gin[0] + dt * (sp[0] * lap_gu + du),
                           gin[1] + dt * (sp[1] * lap_gv + dv));
}

template <int NB>
cudaError_t sweep(const float* params, int n_params, const float2* frames,
                  const float2* frames_bar, float2* g0, float2* scratch,
                  float* acc, int n_steps, int D, int H, int W, int hidden,
                  float dt, float inv_dx2, cudaStream_t stream) {
  const size_t cells = static_cast<size_t>(D) * H * W;
  const int blocks = static_cast<int>((cells + kThreads - 1) / kThreads);
  // Both g buffers start at zero (the wrapper zeroes them).  Step s reads
  // one and writes the other, in the order that makes the last step (t = 0)
  // write g0.
  for (int s = 0; s < n_steps; ++s) {
    const int t = n_steps - 1 - s;
    float2* dst = (t % 2 == 0) ? g0 : scratch;
    const float2* src = (t % 2 == 0) ? scratch : g0;
    pg3d_kernel<NB><<<blocks, kThreads, n_params * sizeof(float), stream>>>(
        params, n_params, frames + t * cells, frames_bar + (t + 1) * cells,
        src, dst, acc, D, H, W, hidden, dt, inv_dx2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// The streaming sweep: one reverse step of pg3d_kernel's arithmetic without
// the accumulators, g_in written to g_ins[t].
//
// Bound on the same card, GS3D 48^3, T = 300: per cell and step 2 adds a
// stencil point for g_in (26), two Laplacians (32), the Jacobian's
// transpose (per equation and hidden channel 12 for the activations, 4 for
// the leave-one-out products, 5 a branch: 124 at C = 2) and 8 for the
// update, about 190 flops, 6.3 GFLOP, 94 us; h_t and fbar_{t+1} read and
// g_ins written once, 3 x 885 KB x 300 = 797 MB, 238 us: bound by bytes.
// The design is pg3d_kernel's, with the same __launch_bounds__(256, 4).
template <int NB>
__global__ void __launch_bounds__(kThreads, 4) adj3d_kernel(const float* __restrict__ params, int n_params,
                            const float2* __restrict__ h,     // frame t
                            const float2* __restrict__ fbar,  // cotangent of frame t + 1
                            const float2* __restrict__ g_next,
                            float2* __restrict__ g_out,
                            float2* __restrict__ g_in_out,    // g_ins[t]
                            int D, int H, int W, int hidden, float dt, float inv_dx2) {
  extern __shared__ float sp[];
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sp[k] = params[k];
  __syncthreads();

  const int cells = D * H * W;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= cells) return;
  int nbr[kPoints];
  stencil13(idx, D, H, W, nbr);
  float gu[kPoints], gv[kPoints];
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const float2 a = g_next[nbr[k]], b = fbar[nbr[k]];
    gu[k] = a.x + b.x;
    gv[k] = a.y + b.y;
  }
  const float lap_gu = lap13(gu, inv_dx2), lap_gv = lap13(gv, inv_dx2);
  const float gin[2] = {gu[0], gv[0]};
  g_in_out[idx] = make_float2(gin[0], gin[1]);
  const float2 x = h[idx];
  float du, dv;
  jacobian_t_1x1<NB>(sp, x.x, x.y, gin, hidden, du, dv);
  g_out[idx] = make_float2(gin[0] + dt * (sp[0] * lap_gu + du),
                           gin[1] + dt * (sp[1] * lap_gv + dv));
}

template <int NB>
cudaError_t adj_sweep(const float* params, int n_params, const float2* frames,
                      const float2* frames_bar, float2* g0, float2* scratch, float2* g_ins,
                      int n_steps, int D, int H, int W, int hidden, float dt, float inv_dx2,
                      cudaStream_t stream) {
  const size_t cells = static_cast<size_t>(D) * H * W;
  const int blocks = static_cast<int>((cells + kThreads - 1) / kThreads);
  // as in sweep: both g buffers start at zero and the last step writes g0
  for (int s = 0; s < n_steps; ++s) {
    const int t = n_steps - 1 - s;
    float2* dst = (t % 2 == 0) ? g0 : scratch;
    const float2* src = (t % 2 == 0) ? scratch : g0;
    adj3d_kernel<NB><<<blocks, kThreads, n_params * sizeof(float), stream>>>(
        params, n_params, frames + t * cells, frames_bar + (t + 1) * cells, src, dst,
        g_ins + t * cells, D, H, W, hidden, dt, inv_dx2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace

// frames, frames_bar: [n_steps + 1, D, H, W, 2]; g0, scratch: [D, H, W, 2],
// zeroed; acc: [A, D, H, W], zeroed.  On return g0 holds the adjoint at
// frame 0 (without frames_bar[0]) and acc the per-cell gradient sums.
extern "C" int backward3d_pg(const void* params, int n_params, const void* frames,
                             const void* frames_bar, void* g0, void* scratch,
                             void* acc, int n_steps, int D, int H, int W,
                             int hidden, int n_branches, float dt, float inv_dx2,
                             void* stream) {
  const float* p = static_cast<const float*>(params);
  const float2* f = static_cast<const float2*>(frames);
  const float2* fb = static_cast<const float2*>(frames_bar);
  float2* g = static_cast<float2*>(g0);
  float2* s = static_cast<float2*>(scratch);
  float* a = static_cast<float*>(acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The forward's expanded cubic is for three branches (cell3d.cu).
  if (n_branches != 3) return cudaErrorInvalidValue;
  return sweep<3>(p, n_params, f, fb, g, s, a, n_steps, D, H, W, hidden, dt, inv_dx2, st);
}

// frames, frames_bar: [n_steps + 1, D, H, W, 2]; g0, scratch: [D, H, W, 2],
// zeroed; g_ins: [n_steps, D, H, W, 2].  On return g0 holds the adjoint at
// frame 0 (without frames_bar[0]).
extern "C" int backward3d_adj(const void* params, int n_params, const void* frames,
                              const void* frames_bar, void* g0, void* scratch, void* g_ins,
                              int n_steps, int D, int H, int W, int hidden, int n_branches,
                              float dt, float inv_dx2, void* stream) {
  if (n_branches != 3) return cudaErrorInvalidValue;
  return adj_sweep<3>(static_cast<const float*>(params), n_params,
                      static_cast<const float2*>(frames), static_cast<const float2*>(frames_bar),
                      static_cast<float2*>(g0), static_cast<float2*>(scratch),
                      static_cast<float2*>(g_ins), n_steps, D, H, W, hidden, dt, inv_dx2,
                      static_cast<cudaStream_t>(stream));
}
