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

#include <cuda_runtime.h>

#include "adj2d_step.cuh"

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
