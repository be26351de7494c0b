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
// k = 3, 5.
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

#include "kxk_common.cuh"

namespace {

constexpr int kThreads = 256;

// Pi-block output for one equation; `p` points at that equation's block.
__device__ __forceinline__ float pi_poly(const float* p, float u, float v,
                                         int hidden, int n_branches) {
  const int stride = 3 * hidden;  // w_i [2, C] then b_i [C]
  const float* w_out = p + n_branches * stride;
  float acc = 0.0f;
  for (int c = 0; c < hidden; ++c) {
    float prod = 1.0f;
    for (int i = 0; i < n_branches; ++i) {
      const float* w = p + i * stride;
      const float y = w[c] * u + w[hidden + c] * v + w[2 * hidden + c];
      prod = (i == 0) ? y : prod * y;
    }
    acc += w_out[c] * prod;
  }
  return acc + w_out[hidden];
}

__device__ __forceinline__ void euler_step(const float* __restrict__ params,
                                           int n_params,
                                           const float2* __restrict__ in,
                                           float2* __restrict__ out, int H,
                                           int W, int hidden, int n_branches,
                                           float dt, float inv_dx2) {
  extern __shared__ float sp[];
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sp[k] = params[k];
  __syncthreads();

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= H * W) return;
  const int i = idx / W;
  const int j = idx - i * W;
  const int im1 = (i + H - 1) % H, ip1 = (i + 1) % H;
  const int im2 = (i + 2 * H - 2) % H, ip2 = (i + 2) % H;
  const int jm1 = (j + W - 1) % W, jp1 = (j + 1) % W;
  const int jm2 = (j + 2 * W - 2) % W, jp2 = (j + 2) % W;

  const float2 c = in[idx];
  const float2 a1 = in[ip1 * W + j], a2 = in[im1 * W + j];
  const float2 a3 = in[i * W + jp1], a4 = in[i * W + jm1];
  const float2 b1 = in[ip2 * W + j], b2 = in[im2 * W + j];
  const float2 b3 = in[i * W + jp2], b4 = in[i * W + jm2];
  const float s1u = a1.x + a2.x + a3.x + a4.x, s1v = a1.y + a2.y + a3.y + a4.y;
  const float s2u = b1.x + b2.x + b3.x + b4.x, s2v = b1.y + b2.y + b3.y + b4.y;
  const float lap_u = (-5.0f * c.x + (4.0f / 3.0f) * s1u - (1.0f / 12.0f) * s2u) * inv_dx2;
  const float lap_v = (-5.0f * c.y + (4.0f / 3.0f) * s1v - (1.0f / 12.0f) * s2v) * inv_dx2;

  const int block = n_branches * 3 * hidden + hidden + 1;
  const float pi_u = pi_poly(sp + 2, c.x, c.y, hidden, n_branches);
  const float pi_v = pi_poly(sp + 2 + block, c.x, c.y, hidden, n_branches);
  out[idx] = make_float2(c.x + dt * (sp[0] * lap_u + pi_u),
                         c.y + dt * (sp[1] * lap_v + pi_v));
}

// One step of a k x k cell (k = 3, 5) at one cell of the block's tile and
// one equation, from the packed parameters: threads [0, kCells) take
// equation 0 and [kCells, 2 kCells) equation 1, so each warp walks one
// equation's weights (the layout of kxk_common.cuh's kernels).
template <int KS, int NB>
__device__ __forceinline__ void euler_step_kxk(const float* __restrict__ params,
                                               int n_params,
                                               const float2* __restrict__ in,
                                               float2* __restrict__ out, int H,
                                               int W, int hidden, float dt,
                                               float inv_dx2) {
  extern __shared__ float4 smem_kxk[];
  float* sp = reinterpret_cast<float*>(smem_kxk);
  float2* tile = reinterpret_cast<float2*>(sp + (n_params + 3) / 4 * 4);
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sp[k] = params[k];
  const int i0 = blockIdx.y * kxk::kTileH, j0 = blockIdx.x * kxk::kTileW;
  kxk::stage_tile(tile, in, H, W, i0, j0);
  __syncthreads();

  const int o = threadIdx.x / kxk::kCells;  // the same in every warp
  const int cell = threadIdx.x - o * kxk::kCells;
  const int li = cell / kxk::kTileW, lj = cell - li * kxk::kTileW;
  const int gi = i0 + li, gj = j0 + lj;
  if (gi >= H || gj >= W) return;
  constexpr int kTaps = KS * KS * 2;
  float tap[4 * kxk::Shape<KS>::kQ];
  kxk::gather_taps<KS>(tile, li, lj, tap);
  const int stride = (kTaps + 1) * hidden;            // per branch: w_i, then b_i
  const float* p = sp + 2 + o * (NB * stride + hidden + 1);
  float acc = 0.0f;
  for (int c = 0; c < hidden; ++c) {
    float prod = 1.0f;
#pragma unroll
    for (int i = 0; i < NB; ++i) prod *= kxk::packed_act<KS>(p + i * stride + c, hidden, tap);
    acc = fmaf(p[NB * stride + c], prod, acc);
  }
  const float pi = acc + p[NB * stride + hidden];
  const float lap = kxk::tile_lap(tile, li, lj, o, inv_dx2);
  const float ctr = reinterpret_cast<const float*>(tile)[
      ((li + kxk::kHalo) * kxk::kTileRow + lj + kxk::kHalo) * 2 + o];
  reinterpret_cast<float*>(out)[(gi * W + gj) * 2 + o] = ctr + dt * (sp[o] * lap + pi);
}

// KS = 1 takes the branch count at run time (NB = 0); KS = 3, 5 take it as
// NB.
template <int KS, int NB>
__device__ __forceinline__ void step(const float* __restrict__ params, int n_params,
                                     const float2* __restrict__ in,
                                     float2* __restrict__ out, int H, int W,
                                     int hidden, int n_branches, float dt,
                                     float inv_dx2) {
  if constexpr (KS == 1)
    euler_step(params, n_params, in, out, H, W, hidden, n_branches, dt, inv_dx2);
  else
    euler_step_kxk<KS, NB>(params, n_params, in, out, H, W, hidden, dt, inv_dx2);
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

// The launch shape of a step: H*W threads in blocks of kThreads at k = 1;
// one block of kxk::kThreads threads (two a cell) a kTileH x kTileW tile at
// k > 1, with the packed parameters (rounded up to 4 floats) and the tile
// in shared memory.
struct Launch {
  dim3 grid, block;
  int smem;
};

template <int KS>
Launch launch_shape(int n_params, int H, int W) {
  if constexpr (KS == 1)
    return {dim3((H * W + kThreads - 1) / kThreads), dim3(kThreads),
            static_cast<int>(n_params * sizeof(float))};
  else
    return {dim3((W + kxk::kTileW - 1) / kxk::kTileW, (H + kxk::kTileH - 1) / kxk::kTileH),
            dim3(kxk::kThreads),
            static_cast<int>((n_params + 3) / 4 * 4 * sizeof(float) +
                             kxk::kTileLen * sizeof(float2))};
}

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
