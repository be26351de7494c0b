// Forward-Euler Pi-cell rollout of a 2D two-channel field, kernel_size 1.
//
// One time step, for every cell (i, j) of the periodic H x W grid:
//   Lap x = (-5 x + 4/3 s1 - 1/12 s2) / dx^2    (s1, s2: the four neighbours
//           at distance 1 and 2 along both axes, indices wrapped periodically)
//   Pi_o  = sum_c w_out[c] * prod_i (w_i[0,c] u + w_i[1,c] v + b_i[c]) + b_out
//   u'    = u + dt (Du Lap u + Pi_u),   v' = v + dt (Dv Lap v + Pi_v)
// The state is channels-last [H, W, 2] f32, read and written as float2.
// The packed parameters follow pack_pi_params_2d in ../cell2d.py:
// [Du, Dv] then, per output channel, per branch (w_i [2, C] row-major, b_i [C]),
// then w_out [C], b_out [1]: 164 floats for the GS2D cell (C = 8, 3 branches).
//
// rollout2d_kernel replaces percnn_tpu/ops/pallas/cell2d.py:_rollout_kernel
// (pallas_call in _fused_rollout_padded) and final2d_kernel replaces
// _final_kernel (pallas_call in _fused_final_padded).  Both run the same
// step, euler_step below.
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

#include <cuda_runtime.h>

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

// One step of the frames path: `in` is frame t and `out` frame t + 1 of the
// output, which thereby holds the state.
__global__ void rollout2d_kernel(const float* __restrict__ params, int n_params,
                                 const float2* __restrict__ in,
                                 float2* __restrict__ out, int H, int W,
                                 int hidden, int n_branches, float dt,
                                 float inv_dx2) {
  euler_step(params, n_params, in, out, H, W, hidden, n_branches, dt, inv_dx2);
}

// One step of the final-state path: `in` and `out` are the two buffers the
// steps ping-pong between.
__global__ void final2d_kernel(const float* __restrict__ params, int n_params,
                               const float2* __restrict__ in,
                               float2* __restrict__ out, int H, int W,
                               int hidden, int n_branches, float dt,
                               float inv_dx2) {
  euler_step(params, n_params, in, out, H, W, hidden, n_branches, dt, inv_dx2);
}

using StepKernel = void (*)(const float*, int, const float2*, float2*, int, int,
                            int, int, float, float);

cudaError_t launch_step(StepKernel kernel, const float* params, int n_params,
                        const float2* in, float2* out, int H, int W, int hidden,
                        int n_branches, float dt, float inv_dx2,
                        cudaStream_t stream) {
  const int blocks = (H * W + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, n_params * sizeof(float), stream>>>(
      params, n_params, in, out, H, W, hidden, n_branches, dt, inv_dx2);
  return cudaGetLastError();
}

}  // namespace

// frames [n_steps + 1, H, W, 2]: frame 0 is a copy of h0 and step t reads
// frame t and writes frame t + 1, so the output buffer is the state.
extern "C" int cell2d_rollout(const void* params, int n_params, const void* h0,
                              void* frames, int n_steps, int H, int W,
                              int hidden, int n_branches, float dt,
                              float inv_dx2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* f = static_cast<float2*>(frames);
  const size_t cells = static_cast<size_t>(H) * W;
  cudaError_t err = cudaMemcpyAsync(f, h0, cells * sizeof(float2),
                                    cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return err;
  for (int t = 0; t < n_steps; ++t) {
    err = launch_step(rollout2d_kernel, static_cast<const float*>(params), n_params,
                      f + t * cells, f + (t + 1) * cells, H, W, hidden,
                      n_branches, dt, inv_dx2, s);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// Final state only: the steps ping-pong between `out` and `scratch` (both
// [H, W, 2]), in the order that makes the last step write `out`.
extern "C" int cell2d_final(const void* params, int n_params, const void* h0,
                            void* out, void* scratch, int n_steps, int H, int W,
                            int hidden, int n_branches, float dt, float inv_dx2,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t cells = static_cast<size_t>(H) * W;
  if (n_steps == 0) {
    cudaError_t err = cudaMemcpyAsync(out, h0, cells * sizeof(float2),
                                      cudaMemcpyDeviceToDevice, s);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  const float2* src = static_cast<const float2*>(h0);
  for (int t = 0; t < n_steps; ++t) {
    float2* dst = static_cast<float2*>((n_steps - 1 - t) % 2 == 0 ? out : scratch);
    cudaError_t err = launch_step(final2d_kernel, static_cast<const float*>(params),
                                  n_params, src, dst, H, W, hidden, n_branches, dt,
                                  inv_dx2, s);
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaGetLastError();
}
