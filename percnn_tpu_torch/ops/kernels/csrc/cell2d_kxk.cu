// Forward-Euler rollout of a 2D two-channel Pi cell with k x k branches
// (k = 3 or 5: the Burgers and lambda-omega Stage-1 cells, 5 x 5, C = 16,
// 3 branches).  One time step, for every cell x of the periodic H x W grid:
//   y[m]  = sum_{ki,kj,cin} Wm[m, (ki k + kj) 2 + cin] h(x + (ki - r, kj - r))[cin]
//           + Wm[m, 2 k k]                      (r = k / 2; m = (o nb + i) C + c)
//   Pi_o  = sum_c w_out_o[c] prod_i y[(o nb + i) C + c] + b_out_o
//   h'_o  = h_o + dt (D_o Lap h_o + Pi_o)
// with Lap the 4th-order 5-point cross of cell2d.cu.  The state is
// channels-last [H, W, 2] f32; Wm and the tail follow pack_pi_matrix_2d and
// pi_tail_2d (../cell2d.py); what is staged where is in kxk_common.cuh.
//
// rollout2d_kxk_kernel replaces
// percnn_tpu/ops/pallas/cell2d.py:_rollout_kernel_mxu (pallas_call in
// _fused_rollout_padded_mxu), which forms the im2col stack of the whole
// field and runs the M x K x (H W) product on the TPU's matrix unit.  Here
// the product is FFMA in full f32 (no tensor cores: TF32 fails the f32
// bars), one im2col column a thread, never stored.
//
// Bound on an H100 SXM at its 700 W power limit (published peaks: 3.35 TB/s,
// 67 TFLOP/s f32 outside the tensor cores), Burgers 100 x 100, C = 16, k = 5:
//   operations: 96 x 51 FMAs for y, 2 x 16 x 3 for the products and the
//          aggregation, 32 for the Laplacians and the update: about 10 k
//          flops a cell and step, 0.1 GFLOP a step, 1.5 us a step
//          (chip_smoke.py counts them);
//   bytes: a frame of 80 KB written a step, 24 ns.
// So it is bound by operations, unlike the 1x1 kernels.
// What the design does about it: each step is one launch of (W / 16) x
// (H / 8) blocks of 256 threads, 91 blocks for 100 x 100, so most SMs get
// one; a thread takes one cell and one equation, so the two equations'
// 48 rows run side by side, and its im2col column (52 floats) sits in
// registers while it walks its rows of Wm in shared memory, read as float4
// broadcasts.  Each row's dot product keeps four partial sums and the
// branch loop is unrolled, so 12 FMA chains are in flight a thread.  The
// T-step loop of launches runs here in C on the caller's stream.  Cutting
// the launches (a persistent kernel) and the tensor cores (3xTF32) are
// later work.

#include <cuda_runtime.h>

#include "kxk_common.cuh"

namespace {

using namespace kxk;

template <int KS, int NB>
__global__ void __launch_bounds__(kThreads)
    rollout2d_kxk_kernel(const float* __restrict__ wm, const float* __restrict__ tail,
                         const float2* __restrict__ in, float2* __restrict__ out, int H,
                         int W, int hidden, float dt, float inv_dx2) {
  extern __shared__ float4 smem[];
  const int i0 = blockIdx.y * kTileH, j0 = blockIdx.x * kTileW;
  const Staged s = stage<KS>(smem, wm, tail, in, H, W, hidden, NB, i0, j0);
  __syncthreads();

  const int o = threadIdx.x / kCells;  // the same in every warp
  const int cell = threadIdx.x - o * kCells;
  const int li = cell / kTileW, lj = cell - li * kTileW;
  const int gi = i0 + li, gj = j0 + lj;
  if (gi >= H || gj >= W) return;

  float tap[4 * Shape<KS>::kQ];
  gather_taps<KS>(s.tile, li, lj, tap);
  constexpr int kRow4 = Shape<KS>::kRow / 4;
  float acc = 0.0f;
  for (int c = 0; c < hidden; ++c) {
    float prod = 1.0f;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float y = row_dot<KS>(s.wm + ((o * NB + i) * hidden + c) * kRow4, tap);
      prod = (i == 0) ? y : prod * y;
    }
    acc = fmaf(s.tail[2 + o * hidden + c], prod, acc);
  }
  const float pi = acc + s.tail[2 + 2 * hidden + o];
  const float lap = tile_lap(s.tile, li, lj, o, inv_dx2);
  const float ctr = reinterpret_cast<const float*>(s.tile)[
      ((li + kHalo) * kTileRow + lj + kHalo) * 2 + o];
  reinterpret_cast<float*>(out)[(gi * W + gj) * 2 + o] = ctr + dt * (s.tail[o] * lap + pi);
}

template <int KS, int NB>
cudaError_t rollout(const float* wm, const float* tail, const float2* h0, float2* frames,
                    int n_steps, int H, int W, int hidden, float dt, float inv_dx2,
                    cudaStream_t stream) {
  const size_t cells = static_cast<size_t>(H) * W;
  cudaError_t err = cudaMemcpyAsync(frames, h0, cells * sizeof(float2),
                                    cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return err;
  const int smem = staged_bytes<KS>(hidden, NB);
  err = cudaFuncSetAttribute(rollout2d_kxk_kernel<KS, NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  for (int t = 0; t < n_steps; ++t) {
    rollout2d_kxk_kernel<KS, NB><<<grid, kThreads, smem, stream>>>(
        wm, tail, frames + t * cells, frames + (t + 1) * cells, H, W, hidden, dt, inv_dx2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <int KS>
cudaError_t rollout_nb(const float* wm, const float* tail, const float2* h0, float2* f,
                       int n_steps, int H, int W, int hidden, int n_branches, float dt,
                       float inv_dx2, cudaStream_t s) {
  switch (n_branches) {
    case 1: return rollout<KS, 1>(wm, tail, h0, f, n_steps, H, W, hidden, dt, inv_dx2, s);
    case 2: return rollout<KS, 2>(wm, tail, h0, f, n_steps, H, W, hidden, dt, inv_dx2, s);
    case 3: return rollout<KS, 3>(wm, tail, h0, f, n_steps, H, W, hidden, dt, inv_dx2, s);
    case 4: return rollout<KS, 4>(wm, tail, h0, f, n_steps, H, W, hidden, dt, inv_dx2, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// frames [n_steps + 1, H, W, 2]: frame 0 is a copy of h0 and step t reads
// frame t and writes frame t + 1.  wm [2 nb C, kRow], tail [2 C + 4].
extern "C" int cell2d_kxk_rollout(const void* wm, const void* tail, const void* h0,
                                  void* frames, int n_steps, int H, int W, int hidden,
                                  int n_branches, int kernel_size, float dt, float inv_dx2,
                                  void* stream) {
  const float* w = static_cast<const float*>(wm);
  const float* t = static_cast<const float*>(tail);
  const float2* h = static_cast<const float2*>(h0);
  float2* f = static_cast<float2*>(frames);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kernel_size) {
    case 3: return rollout_nb<3>(w, t, h, f, n_steps, H, W, hidden, n_branches, dt, inv_dx2, s);
    case 5: return rollout_nb<5>(w, t, h, f, n_steps, H, W, hidden, n_branches, dt, inv_dx2, s);
    default: return cudaErrorInvalidValue;
  }
}
