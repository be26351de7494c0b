// Reverse sweep of the forward-Euler k x k Pi-cell rollout (cell2d_kxk.cu).
//
// One reverse step t (t = T-1 .. 0), for every cell x of the periodic H x W
// grid, with m = (o nb + i) C + c and r = k / 2:
//   g_in   = g_{t+1} + fbar_{t+1}                              (g_T = 0)
//   y[m]   = Wm[m, :] . im2col(h_t)(x)                         (as the forward)
//   z[m]   = w_out_o[c] g_in_o prod_{j != i} y[(o nb + j) C + c]
//   zw[q]  = sum_m Wm[m, q] z[m]         for the k k 2 tap columns q = (ki k + kj) 2 + cin
//   jt_cin = sum_{ki,kj} zw[(ki k + kj) 2 + cin](x + (r - ki, r - kj))
//   g_t    = g_in + dt (D Lap(g_in) + jt)
// Outputs: g_ins[t] = g_in [H, W, 2], ys[t] = y [M, H, W] (for the parameter
// gradients, _param_grads_stream in ../backward2d.py) and, after the sweep,
// g_0.  Wm, the tail and the staging are those of the forward
// (kxk_common.cuh).
//
// adj2d_kxk_kernel replaces percnn_tpu/ops/pallas/backward2d.py:
// _phase1_mxu_kernel (pallas_call in _fused_phase1_mxu), which runs both
// contractions on the TPU's matrix unit over the whole field in VMEM.  A
// block here holds a tile, and jt at a cell needs zw at every neighbour
// within radius r, which depends on the neighbour's own y and z: so a step
// is two launches, the activation kernel (y, ys, z and zw into a [k k 2,
// H, W] scratch, g_in into g_ins[t]) and the gather kernel (jt, Lap(g_in)
// and the update of g, in place: a launch boundary separates its reads of
// g from the activation kernel's).  FFMA in full f32, no tensor cores.
//
// Bound on an H100 SXM at its 700 W power limit (published peaks: 3.35 TB/s,
// 67 TFLOP/s f32 outside the tensor cores), Burgers 100 x 100, C = 16, k = 5,
// T = 200:
//   operations: 96 x 51 FMAs for y and 96 x 50 for zw, the products and z,
//          the 50-point gather, a Laplacian and the update: about 20 k flops
//          a cell and step, 39 GFLOP a backward, 0.59 ms (chip_smoke.py
//          counts them);
//   bytes: ys 768 MB written, g_ins 16 MB, frames and cotangents read once,
//          about 0.24 ms.
// So it is bound by operations.
// What the design does about it: the activation kernel has the forward's
// layout (two threads a cell, one per equation, 91 blocks of 256 threads
// for 100 x 100); a thread keeps its im2col column and its 50 partial sums
// of zw in registers while it walks its 48 rows of Wm in shared memory
// (float4 broadcasts), writes each y as it forms it (a warp writes 32
// consecutive cells of one plane), and the two equations' partial sums
// meet in shared memory.  The gather kernel is one thread a cell.  The
// T-step loop of launches runs here in C on the caller's stream.

#include <cuda_runtime.h>

#include "kxk_common.cuh"

namespace {

using namespace kxk;

constexpr int kGatherThreads = 256;

// acc[q] += row[q] z for the k k 2 tap columns of one row of Wm.
template <int KS>
__device__ __forceinline__ void accumulate_row(const float4* row, float z,
                                               float (&acc)[Shape<KS>::kTaps]) {
  constexpr int kTaps = Shape<KS>::kTaps;
#pragma unroll
  for (int q = 0; q < kTaps / 4; ++q) {
    const float4 w = row[q];
    acc[4 * q] = fmaf(w.x, z, acc[4 * q]);
    acc[4 * q + 1] = fmaf(w.y, z, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(w.z, z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(w.w, z, acc[4 * q + 3]);
  }
  static_assert(kTaps % 4 == 2, "k k 2 taps leave two columns after the float4s");
  const float4 w = row[kTaps / 4];
  acc[kTaps - 2] = fmaf(w.x, z, acc[kTaps - 2]);
  acc[kTaps - 1] = fmaf(w.y, z, acc[kTaps - 1]);
}

template <int KS, int NB>
__global__ void __launch_bounds__(kThreads)
    adj2d_kxk_act_kernel(const float* __restrict__ wm, const float* __restrict__ tail,
                         const float2* __restrict__ h,       // frame t
                         const float2* __restrict__ g_next,  // g_{t+1}
                         const float2* __restrict__ fbar,    // cotangent of frame t + 1
                         float2* __restrict__ g_in_out,      // g_ins[t]
                         float* __restrict__ ys,             // ys[t], [M][H W]
                         float* __restrict__ zw,             // [k k 2][H W]
                         int H, int W, int hidden) {
  extern __shared__ float4 smem[];
  constexpr int kTaps = Shape<KS>::kTaps;
  constexpr int kRow4 = Shape<KS>::kRow / 4;
  const int i0 = blockIdx.y * kTileH, j0 = blockIdx.x * kTileW;
  const Staged s = stage<KS>(smem, wm, tail, h, H, W, hidden, NB, i0, j0);
  // the o = 1 threads' partial sums of zw, [kTaps][kCells]
  float* xbuf = reinterpret_cast<float*>(smem) + staged_bytes<KS>(hidden, NB) / 4;
  __syncthreads();

  const int o = threadIdx.x / kCells;  // the same in every warp
  const int cell = threadIdx.x - o * kCells;
  const int li = cell / kTileW, lj = cell - li * kTileW;
  const int gi = i0 + li, gj = j0 + lj;
  const bool inside = gi < H && gj < W;
  const size_t cells = static_cast<size_t>(H) * W;
  const int idx = gi * W + gj;

  float acc[kTaps];
#pragma unroll
  for (int q = 0; q < kTaps; ++q) acc[q] = 0.0f;
  if (inside) {
    const float gin = reinterpret_cast<const float*>(g_next)[2 * idx + o] +
                      reinterpret_cast<const float*>(fbar)[2 * idx + o];
    reinterpret_cast<float*>(g_in_out)[2 * idx + o] = gin;
    float tap[4 * Shape<KS>::kQ];
    gather_taps<KS>(s.tile, li, lj, tap);
    for (int c = 0; c < hidden; ++c) {
      const float4* rows[NB];
      float y[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int m = (o * NB + i) * hidden + c;
        rows[i] = s.wm + m * kRow4;
        y[i] = row_dot<KS>(rows[i], tap);
        ys[m * cells + idx] = y[i];
      }
      // prod_{j != i} y_j from prefix and suffix products
      float pre[NB + 1], suf[NB + 1];
      pre[0] = 1.0f;
      suf[NB] = 1.0f;
#pragma unroll
      for (int i = 0; i < NB; ++i) pre[i + 1] = pre[i] * y[i];
#pragma unroll
      for (int i = NB - 1; i >= 0; --i) suf[i] = suf[i + 1] * y[i];
      const float gw = s.tail[2 + o * hidden + c] * gin;
#pragma unroll
      for (int i = 0; i < NB; ++i) accumulate_row<KS>(rows[i], gw * (pre[i] * suf[i + 1]), acc);
    }
  }
  if (o == 1) {
#pragma unroll
    for (int q = 0; q < kTaps; ++q) xbuf[q * kCells + cell] = acc[q];
  }
  __syncthreads();
  if (o == 0 && inside) {
#pragma unroll
    for (int q = 0; q < kTaps; ++q) zw[q * cells + idx] = acc[q] + xbuf[q * kCells + cell];
  }
}

template <int KS>
__global__ void __launch_bounds__(kGatherThreads)
    adj2d_kxk_gather_kernel(const float* __restrict__ zw, const float2* __restrict__ g_in,
                            const float* __restrict__ tail, float2* __restrict__ g, int H,
                            int W, float dt, float inv_dx2) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < H * W) gather_update<KS>(zw, g_in, tail, g, H, W, dt, inv_dx2, idx);
}

template <int KS, int NB>
cudaError_t sweep(const float* wm, const float* tail, const float2* frames,
                  const float2* frames_bar, float2* g, float2* g_ins, float* ys, float* zw,
                  int n_steps, int H, int W, int hidden, float dt, float inv_dx2,
                  cudaStream_t stream) {
  const size_t cells = static_cast<size_t>(H) * W;
  const size_t m_rows = 2 * NB * hidden;
  const int smem = staged_bytes<KS>(hidden, NB) + 4 * Shape<KS>::kTaps * kCells;
  cudaError_t err = cudaFuncSetAttribute(adj2d_kxk_act_kernel<KS, NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  const int gather_blocks = static_cast<int>((cells + kGatherThreads - 1) / kGatherThreads);
  // g starts at zero (the wrapper zeroes it) and holds g_t after step t.
  for (int s = 0; s < n_steps; ++s) {
    const int t = n_steps - 1 - s;
    adj2d_kxk_act_kernel<KS, NB><<<grid, kThreads, smem, stream>>>(
        wm, tail, frames + t * cells, g, frames_bar + (t + 1) * cells, g_ins + t * cells,
        ys + t * m_rows * cells, zw, H, W, hidden);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    adj2d_kxk_gather_kernel<KS><<<gather_blocks, kGatherThreads, 0, stream>>>(
        zw, g_ins + t * cells, tail, g, H, W, dt, inv_dx2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <int KS>
cudaError_t sweep_nb(const float* wm, const float* tail, const float2* f, const float2* fb,
                     float2* g, float2* gi, float* ys, float* zw, int n_steps, int H, int W,
                     int hidden, int n_branches, float dt, float inv_dx2, cudaStream_t s) {
  switch (n_branches) {
    case 1: return sweep<KS, 1>(wm, tail, f, fb, g, gi, ys, zw, n_steps, H, W, hidden, dt, inv_dx2, s);
    case 2: return sweep<KS, 2>(wm, tail, f, fb, g, gi, ys, zw, n_steps, H, W, hidden, dt, inv_dx2, s);
    case 3: return sweep<KS, 3>(wm, tail, f, fb, g, gi, ys, zw, n_steps, H, W, hidden, dt, inv_dx2, s);
    case 4: return sweep<KS, 4>(wm, tail, f, fb, g, gi, ys, zw, n_steps, H, W, hidden, dt, inv_dx2, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// frames, frames_bar [n_steps + 1, H, W, 2]; g [H, W, 2], zeroed; g_ins
// [n_steps, H, W, 2]; ys [n_steps, 2 nb C, H, W]; zw [k k 2, H, W] scratch.
// On return g holds the adjoint at frame 0 (without frames_bar[0]).
extern "C" int backward2d_kxk(const void* wm, const void* tail, const void* frames,
                              const void* frames_bar, void* g, void* g_ins, void* ys, void* zw,
                              int n_steps, int H, int W, int hidden, int n_branches,
                              int kernel_size, float dt, float inv_dx2, void* stream) {
  const float* w = static_cast<const float*>(wm);
  const float* t = static_cast<const float*>(tail);
  const float2* f = static_cast<const float2*>(frames);
  const float2* fb = static_cast<const float2*>(frames_bar);
  float2* gg = static_cast<float2*>(g);
  float2* gi = static_cast<float2*>(g_ins);
  float* y = static_cast<float*>(ys);
  float* z = static_cast<float*>(zw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kernel_size) {
    case 3: return sweep_nb<3>(w, t, f, fb, gg, gi, y, z, n_steps, H, W, hidden, n_branches, dt, inv_dx2, s);
    case 5: return sweep_nb<5>(w, t, f, fb, gg, gi, y, z, n_steps, H, W, hidden, n_branches, dt, inv_dx2, s);
    default: return cudaErrorInvalidValue;
  }
}
