// Forward-Euler Pi-cell rollout of a 3D two-channel field, kernel_size 1,
// with the Pi block in its expanded-cubic form.
//
// One time step, for every cell (d, h, w) of the periodic D x H x W grid:
//   s1, s2 = the sums of the six neighbours at distance 1 and at distance 2
//            along the three axes (indices wrapped periodically)
//   u' = u + k1_u s1u + k2_u s2u + P_u(u, v),   v' = v + k1_v s1v + k2_v s2v + P_v(u, v)
//   P_eq = c0 + c1 u + c2 v + c3 u^2 + c4 uv + c5 v^2 + c6 u^3 + c7 u^2 v
//          + c8 u v^2 + c9 v^3
// which is x + dt (nu Lap x + Pi(u, v)) with the 4th-order 13-point
// Laplacian: k1 = dt nu / dx^2 * 4/3, k2 = -dt nu / dx^2 / 12, the centre tap
// -15/2 dt nu / dx^2 folded into the linear coefficient of the equation's own
// field, and the product of the three affine branches summed over the hidden
// channels expanded into the cubic's 10 coefficients, all dt-scaled
// (expand_packed_3d in ../cell3d.py, 12 floats per equation).  The state is
// channels-last [D, H, W, 2] f32, read and written as float2.
//
// rollout3d_kernel replaces percnn_tpu/ops/pallas/cell3d.py:_rollout3d_kernel
// (pallas_call in _fused_rollout3d_flat), both its frames and its final-only
// form.  The TPU kernel's width-wrap lane masks (_shift_w, _width_masks) are
// an artefact of its flat [D, H*W] layout; here each thread wraps its indices.
//
// Bound on an H100 SXM at its 700 W power limit (published peaks: 3.35 TB/s,
// 67 TFLOP/s f32 outside the tensor cores), GS3D shape 48^3, T = 1000:
//   operations: 73 flops per cell and step (20 adds for the four neighbour
//          sums, 7 multiplies for the shared monomials, 23 per equation for
//          the update), 8.1 GFLOP per rollout: 120 us;
//   bytes: the frames path writes 1001 frames of 885 KB, 886 MB: 264 us; the
//          final-state path moves 1.8 MB.
// So the frames path is bound by bytes and the final-state path by
// operations on paper.  As in 2D, what limits this design is the chain of T
// dependent steps, one launch each: the 885 KB state is far larger than one
// block's 227 KB of shared memory, so every step needs a device-wide sync,
// which here is the end of a launch.
// What the design does about it: each step is one launch over D*H*W threads
// (432 blocks of 256 at 48^3), one cell per thread, reading its 13 stencil
// points (neighbouring threads read neighbouring cells, and the +-1, +-2
// planes are shared through L1 and L2); the 24 coefficients sit in shared
// memory; the state ping-pongs between two buffers (for the frames path the
// output frames are the buffers); the whole T-step loop of launches runs
// here in C on the caller's stream.  Cutting the launches (a persistent
// kernel with a grid barrier, or clusters with DSMEM halos) is later work.

#include <cuda_runtime.h>

#include "stencil3d.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRow = 12;   // coefficients per equation

__global__ void rollout3d_kernel(const float* __restrict__ coef,
                                 const float2* __restrict__ in,
                                 float2* __restrict__ out, int D, int H,
                                 int W) {
  __shared__ float e[2 * kRow];
  if (threadIdx.x < 2 * kRow) e[threadIdx.x] = coef[threadIdx.x];
  __syncthreads();

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= D * H * W) return;
  int nbr[kPoints];
  stencil13(idx, D, H, W, nbr);
  float2 x[kPoints];
#pragma unroll
  for (int k = 0; k < kPoints; ++k) x[k] = in[nbr[k]];
  const float s1u = x[1].x + x[2].x + x[3].x + x[4].x + x[5].x + x[6].x;
  const float s1v = x[1].y + x[2].y + x[3].y + x[4].y + x[5].y + x[6].y;
  const float s2u = x[7].x + x[8].x + x[9].x + x[10].x + x[11].x + x[12].x;
  const float s2v = x[7].y + x[8].y + x[9].y + x[10].y + x[11].y + x[12].y;

  const float2 c = x[0];
  const float u = c.x, v = c.y;
  const float u2 = u * u, uv = u * v, v2 = v * v;
  const float u3 = u2 * u, u2v = u2 * v, uv2 = u * v2, v3 = v2 * v;
  const float* eu = e;
  const float* ev = e + kRow;
  const float un = u + eu[0] * s1u + eu[1] * s2u + eu[2] + eu[3] * u + eu[4] * v +
                   eu[5] * u2 + eu[6] * uv + eu[7] * v2 + eu[8] * u3 +
                   eu[9] * u2v + eu[10] * uv2 + eu[11] * v3;
  const float vn = v + ev[0] * s1v + ev[1] * s2v + ev[2] + ev[3] * u + ev[4] * v +
                   ev[5] * u2 + ev[6] * uv + ev[7] * v2 + ev[8] * u3 +
                   ev[9] * u2v + ev[10] * uv2 + ev[11] * v3;
  out[idx] = make_float2(un, vn);
}

cudaError_t launch_step(const float* coef, const float2* in, float2* out, int D,
                        int H, int W, cudaStream_t stream) {
  const long long cells = static_cast<long long>(D) * H * W;
  const int blocks = static_cast<int>((cells + kThreads - 1) / kThreads);
  rollout3d_kernel<<<blocks, kThreads, 0, stream>>>(coef, in, out, D, H, W);
  return cudaGetLastError();
}

}  // namespace

// coef: [24] (expand_packed_3d); h0: [D, H, W, 2].
// final_only = 0: out is [n_steps + 1, D, H, W, 2]; frame 0 is a copy of h0
//   and step t reads frame t and writes frame t + 1; scratch is null.
// final_only = 1: out and scratch are [D, H, W, 2]; the steps ping-pong
//   between them in the order that makes the last step write out.
extern "C" int cell3d_rollout(const void* coef, const void* h0, void* out,
                              void* scratch, int n_steps, int D, int H, int W,
                              int final_only, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* e = static_cast<const float*>(coef);
  const size_t cells = static_cast<size_t>(D) * H * W;
  cudaError_t err;
  if (!final_only) {
    float2* f = static_cast<float2*>(out);
    err = cudaMemcpyAsync(f, h0, cells * sizeof(float2), cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return err;
    for (int t = 0; t < n_steps; ++t) {
      err = launch_step(e, f + t * cells, f + (t + 1) * cells, D, H, W, s);
      if (err != cudaSuccess) return err;
    }
    return cudaGetLastError();
  }
  if (n_steps == 0) {
    err = cudaMemcpyAsync(out, h0, cells * sizeof(float2), cudaMemcpyDeviceToDevice, s);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  const float2* src = static_cast<const float2*>(h0);
  for (int t = 0; t < n_steps; ++t) {
    float2* dst = static_cast<float2*>((n_steps - 1 - t) % 2 == 0 ? out : scratch);
    err = launch_step(e, src, dst, D, H, W, s);
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaGetLastError();
}
