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
// pg3d_persistent_kernel replaces percnn_tpu/ops/pallas/backward3d.py:
// _phase1_pg_kernel3d (pallas_call in _fused_phase1_pg_3d) on any field whose
// accumulators fit the co-resident blocks' shared memory, two cells a
// thread at most (51^3 at most on 132 SMs; pg3d_plan in ../backward3d.py);
// pg3d_kernel replaces it past that.  adj3d_persistent_kernel replaces
// _phase1_kernel3d (pallas_call in _fused_phase1_3d) for the same widths on
// the same fields (adj3d_plan in ../backward3d.py: 51^3 at most on 132 SMs),
// adj3d_kernel, at the end, past that and for other widths: the same sweep
// without the accumulators, streaming g_ins[t] = g_in [D, H, W, 2] out for
// the time-batched parameter gradients (chunked_param_grads,
// ../backward3d.py).
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
// limits a design is, as in 2D, the chain of T dependent steps.
// pg3d_kernel takes one launch a reverse step over D*H*W threads (432 blocks
// of 256 at 48^3), one cell a thread, the loop here in C on the caller's
// stream.  With no grid-wide barrier inside a launch, each thread forms g_in
// itself at its 12 stencil neighbours and g ping-pongs between two
// [D, H, W, 2] buffers.  Each thread owns its cell's entry of every plane,
// plane-major: no atomics, a deterministic result, coalesced plane
// accesses; each (equation, hidden channel) group of planes is loaded
// before it is stored (pg_common.cuh).  The packed parameters sit in shared
// memory.  That design reads and writes all 44 planes every step (19.5 MB
// each way a step at 48^3, held in the 50 MB L2).
// pg3d_persistent_kernel runs the whole sweep in one cooperative launch,
// one block an SM, each block's cells' accumulators in its shared memory
// from the first step to the last (written to the planes once, at the end),
// and one grid barrier a step: pg2d_persistent_kernel's design
// (backward2d.cu) with the 13-point stencil (described at persistent_sweep3d).
// adj3d_persistent_kernel is the same body without the accumulators (a
// template flag): a block needs the packed parameters and g's window alone,
// 8 416 bytes at 48^3 against 155 904, and its g0 is pg3d_persistent_kernel's
// to the bit.  adj3d_kernel took one launch a reverse step, 6.16 us a step
// at 48^3; the one-launch sweep's bound is adj3d_kernel's below (0.238 ms
// per T = 300, bytes).  Measured by chip_smoke.py on an NVIDIA H100 80GB
// HBM3, 700.00 W, per T = 300 at 48^3, in turns: 1.431 ms (4.77 us a step,
// one launch) against 1.848 for adj3d_kernel; 128 registers, no spill.  A
// build for two blocks an SM (__launch_bounds__(512, 2): 64 registers, 264
// bytes spilled) on 264 blocks took 2.047 ms against 1.435 in turns, so
// the plan keeps one block an SM.

#include <cooperative_groups.h>
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

namespace cg = cooperative_groups;

// Threads a block of pg3d_persistent_kernel, and the staging loads a
// thread has in flight at once.
constexpr int kPersistentThreads = 512;
constexpr int kBatch = 4;

// The whole reverse sweep in one cooperative launch (pg3d_persistent_kernel
// with kAcc, adj3d_persistent_kernel without): block b owns the cells
// [first, first + n_own) of the flat D H W field (split_evenly in
// ../cell2d.py) for every step, a thread cells k0 = threadIdx.x and, where
// the block owns more than blockDim.x, k1 = k0 + blockDim.x (the plans keep
// a block within 2 blockDim.x cells).  With kAcc the block keeps its cells'
// A accumulators in its shared memory, plane-major ([A][cap], cap the most
// cells a block owns), from the first step to the last; they reach the
// [A, D, H, W] planes once, at the end.  Without it there is no
// accumulator: g_in of every step goes to g_ins[t], and a block needs only
// the packed parameters and g's window.  A reverse step t:
//   - g_{t+1}'s window that the block's stencils read along height and width
//     (the owned run with two rows of W cells on each side) is staged into
//     shared memory with __ldcg (L2, not the SM's L1, which may hold a stale
//     line of a buffer written during the launch) and coalesced, as
//     rollout3d_persistent_kernel stages its state;
//   - each thread takes its cells one after the other, each as pg3d_kernel
//     takes its cell: g_in = g_{t+1} + fbar_{t+1} and the Laplacians, then
//     pg_accumulate (pg_common.cuh) on the cell's column of the shared
//     planes (without kAcc the same function with the planes compiled out,
//     and g_in stored to g_ins[t]), then g_t written to global memory.  The
//     depth neighbours of g_{t+1}, and a height neighbour that wraps around
//     its plane, come from L2 (staging them as well, in 27 KB more a block
//     at 48^3, made no difference on the card).
// Then one grid.sync() makes g_t visible to every block's next step; g
// ping-pongs between g0 and scratch, in the order that makes the last step
// (t = 0) write g0.  h_t and fbar_{t+1} do not depend on g, so a cell's 13
// points of each (of h the centre alone without kAcc) are loaded ahead,
// into registers: k0's after step t + 1, in flight across the barrier;
// k1's while k0's accumulation runs.  Each is reduced to the centre values
// and the Laplacians of h and fbar as it is used: Lap is linear, so
// Lap g_in = Lap g_{t+1} + Lap fbar_{t+1}, which rounds otherwise than
// pg3d_kernel's and adj3d_kernel's Lap(g_{t+1} + fbar_{t+1}).  All else is
// pg3d_kernel's arithmetic, expression for expression, and (du, dv) come
// from the same code with and without kAcc, so the two kernels' g0 agree to
// the bit.  The body is compiled for the GS3D cell's widths, NB = 3
// branches and C = 2 hidden channels (pg_accumulate's channel loop then
// unrolls: about 9% of the sweep's time at 48^3 on the card); other cells
// take pg3d_kernel and adj3d_kernel.  The flag is a template parameter so
// that pg3d_persistent_kernel keeps its machine code.
template <int NB, int C, bool kAcc>
__device__ __forceinline__ void persistent_sweep3d(const float* __restrict__ params, int n_params,
                                                   const float2* __restrict__ frames,
                                                   const float2* __restrict__ frames_bar,
                                                   float2* g0, float2* scratch,
                                                   float* __restrict__ acc, float2* g_ins,
                                                   int n_steps, int D, int H, int W, float dt,
                                                   float inv_dx2) {
  cg::grid_group grid = cg::this_grid();
  const int HW = H * W, cells = D * HW;
  const int nblk = gridDim.x, b = blockIdx.x;
  const int q = cells / nblk, m = cells % nblk;
  const int n_own = q + (b < m ? 1 : 0);
  const int first = b * q + (b < m ? b : m);
  const int cap = (cells + nblk - 1) / nblk;
  const int halo = 2 * W, n_mid = n_own + 2 * halo;
  // A (backward2d.py: _pg_layout) with kAcc, else none
  const int n_planes = kAcc ? 2 * NB * C * 3 + 2 * C + 4 : 0;

  extern __shared__ float4 smem_pg3[];
  float* sp = reinterpret_cast<float*>(smem_pg3);
  float* sacc = sp + (n_params + 3) / 4 * 4;                         // [n_planes][cap]
  float2* gmid = reinterpret_cast<float2*>(sacc + n_planes * cap);  // [cap + 4 W]
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sp[k] = params[k];
  for (int k = threadIdx.x; k < n_planes * cap; k += blockDim.x) sacc[k] = 0.0f;

  // h_t and fbar_{t+1} at the 13 stencil points of own cell k (of h the
  // centre alone without kAcc), loaded into hx, fx, then reduced to r: u, v,
  // Lap h (u, v; without kAcc unused), fbar (u, v), Lap fbar (u, v)
  float2 hx[kPoints], fx[kPoints];
  auto prefetch = [&](int t, int k) {
    int nbr[kPoints];
    stencil13(first + k, D, H, W, nbr);
    const float2* h = frames + static_cast<size_t>(t) * cells;
    const float2* fbar = frames_bar + static_cast<size_t>(t + 1) * cells;
#pragma unroll
    for (int e = 0; e < kPoints; ++e) {
      if constexpr (kAcc) {
        hx[e] = h[nbr[e]];
      } else {
        if (e == 0) hx[e] = h[nbr[e]];
      }
      fx[e] = fbar[nbr[e]];
    }
  };
  auto reduce = [&](float (&r)[8]) {
    float hu[kPoints], hv[kPoints], fu[kPoints], fv[kPoints];
#pragma unroll
    for (int e = 0; e < kPoints; ++e) {
      hu[e] = hx[e].x;
      hv[e] = hx[e].y;
      fu[e] = fx[e].x;
      fv[e] = fx[e].y;
    }
    r[0] = hu[0];
    r[1] = hv[0];
    r[2] = lap13(hu, inv_dx2);
    r[3] = lap13(hv, inv_dx2);
    r[4] = fu[0];
    r[5] = fv[0];
    r[6] = lap13(fu, inv_dx2);
    r[7] = lap13(fv, inv_dx2);
  };
  // g_in and Lap g_in of own cell k from g_{t+1} in src: the centre and the
  // height and width neighbours from gmid, the rest from L2
  auto gather = [&](const float2* src, int k, const float (&r)[8], float (&gin)[2],
                    float& lap_gu, float& lap_gv) {
    const int idx = first + k;
    const int d = idx / HW;
    const int rr = idx - d * HW;
    const int i = rr / W;
    const int j = rr - i * W;
    const int c = k + halo;
    auto plane = [&](int shift) {
      const int g = idx + shift;
      return __ldcg(src + (g < 0 ? g + cells : (g >= cells ? g - cells : g)));
    };
    float2 x[kPoints];
    x[0] = gmid[c];
    x[1] = plane(HW);
    x[2] = plane(-HW);
    x[3] = i + 1 < H ? gmid[c + W] : __ldcg(src + idx + W - HW);
    x[4] = i >= 1 ? gmid[c - W] : __ldcg(src + idx - W + HW);
    x[5] = gmid[c + (j + 1 < W ? 1 : 1 - W)];
    x[6] = gmid[c + (j >= 1 ? -1 : W - 1)];
    x[7] = plane(2 * HW);
    x[8] = plane(-2 * HW);
    x[9] = i + 2 < H ? gmid[c + 2 * W] : __ldcg(src + idx + 2 * W - HW);
    x[10] = i >= 2 ? gmid[c - 2 * W] : __ldcg(src + idx - 2 * W + HW);
    x[11] = gmid[c + (j + 2 < W ? 2 : 2 - W)];
    x[12] = gmid[c + (j >= 2 ? -2 : W - 2)];
    float gu[kPoints], gv[kPoints];
#pragma unroll
    for (int e = 0; e < kPoints; ++e) {
      gu[e] = x[e].x;
      gv[e] = x[e].y;
    }
    gin[0] = gu[0] + r[4];
    gin[1] = gv[0] + r[5];
    lap_gu = lap13(gu, inv_dx2) + r[6];
    lap_gv = lap13(gv, inv_dx2) + r[7];
  };
  auto finish = [&](float2* dst, int k, const float (&r)[8], const float (&gin)[2],
                    float lap_gu, float lap_gv) {
    float du, dv;
    if constexpr (kAcc) {
      pg_accumulate<NB>(sp, r[0], r[1], gin, r[2], r[3], sacc + k, cap, C, du, dv);
    } else {
      jacobian_t_1x1<NB>(sp, r[0], r[1], gin, C, du, dv);
    }
    dst[first + k] = make_float2(gin[0] + dt * (sp[0] * lap_gu + du),
                                 gin[1] + dt * (sp[1] * lap_gv + dv));
  };

  const int k0 = threadIdx.x, k1 = k0 + blockDim.x;
  if (k0 < n_own) prefetch(n_steps - 1, k0);
  __syncthreads();

  for (int s = 0; s < n_steps; ++s) {
    const int t = n_steps - 1 - s;
    float2* dst = (t % 2 == 0) ? g0 : scratch;
    const float2* src = (t % 2 == 0) ? scratch : g0;
    // g_{t+1}'s window into gmid, kBatch loads in flight a thread
    for (int base = threadIdx.x; base < n_mid; base += kBatch * blockDim.x) {
      float2 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * blockDim.x;
        int g = first - halo + i;
        g = g < 0 ? g + cells : (g >= cells ? g - cells : g);
        if (i < n_mid) v[u] = __ldcg(src + g);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * blockDim.x;
        if (i < n_mid) gmid[i] = v[u];
      }
    }
    float r0[8];
    if (k0 < n_own) reduce(r0);
    __syncthreads();
    if (k0 < n_own) {
      float gin[2], lap_gu, lap_gv;
      gather(src, k0, r0, gin, lap_gu, lap_gv);
      if (k1 < n_own) prefetch(t, k1);
      finish(dst, k0, r0, gin, lap_gu, lap_gv);
      if constexpr (!kAcc) {
        g_ins[static_cast<size_t>(t) * cells + first + k0] = make_float2(gin[0], gin[1]);
      }
    }
    if (k1 < n_own) {
      float r1[8], gin[2], lap_gu, lap_gv;
      reduce(r1);
      gather(src, k1, r1, gin, lap_gu, lap_gv);
      finish(dst, k1, r1, gin, lap_gu, lap_gv);
      if constexpr (!kAcc) {
        g_ins[static_cast<size_t>(t) * cells + first + k1] = make_float2(gin[0], gin[1]);
      }
    }
    if (k0 < n_own && t > 0) prefetch(t - 1, k0);
    if (s + 1 < n_steps) grid.sync();
  }
  for (int pl = 0; pl < n_planes; ++pl)
    for (int k = threadIdx.x; k < n_own; k += blockDim.x)
      acc[static_cast<size_t>(pl) * cells + first + k] = sacc[pl * cap + k];
}

// Row 10: the fused sweep in one cooperative launch (persistent_sweep3d
// with the accumulators).
template <int NB, int C>
__global__ void __launch_bounds__(kPersistentThreads)
    pg3d_persistent_kernel(const float* __restrict__ params, int n_params,
                           const float2* __restrict__ frames,
                           const float2* __restrict__ frames_bar, float2* g0, float2* scratch,
                           float* __restrict__ acc, int n_steps, int D, int H, int W,
                           float dt, float inv_dx2) {
  persistent_sweep3d<NB, C, true>(params, n_params, frames, frames_bar, g0, scratch, acc,
                                  nullptr, n_steps, D, H, W, dt, inv_dx2);
}

// Row 9: the streaming sweep in one cooperative launch (persistent_sweep3d
// without the accumulators): g_ins[t] = g_in [D, H, W, 2] streamed out for
// the time-batched parameter gradients, g0 pg3d_persistent_kernel's to the
// bit.
template <int NB, int C>
__global__ void __launch_bounds__(kPersistentThreads)
    adj3d_persistent_kernel(const float* __restrict__ params, int n_params,
                            const float2* __restrict__ frames,
                            const float2* __restrict__ frames_bar, float2* g0, float2* scratch,
                            float2* g_ins, int n_steps, int D, int H, int W, float dt,
                            float inv_dx2) {
  persistent_sweep3d<NB, C, false>(params, n_params, frames, frames_bar, g0, scratch, nullptr,
                                   g_ins, n_steps, D, H, W, dt, inv_dx2);
}

// Dynamic shared memory of persistent_sweep3d on `blocks` blocks: the
// packed parameters rounded up to 4 floats, then [n_planes][cap] floats
// (the A accumulators of pg3d_persistent_kernel, none for
// adj3d_persistent_kernel), then g's window, cap + 4 W float2
// (pg3d_smem_bytes and adj3d_smem_bytes in ../backward3d.py).
size_t persistent_smem_bytes(int n_params, int D, int H, int W, size_t n_planes, int blocks) {
  const size_t cap = (static_cast<size_t>(D) * H * W + blocks - 1) / blocks;
  return ((n_params + 3) / 4 * 4 + n_planes * cap) * sizeof(float) +
         (cap + 4 * static_cast<size_t>(W)) * sizeof(float2);
}

// The widths the one-launch sweeps are compiled for, and pg3d_persistent_kernel's A.
constexpr int kPersistentBranches = 3, kPersistentHidden = 2;
constexpr size_t kPersistentPlanes =
    2 * kPersistentBranches * kPersistentHidden * 3 + 2 * kPersistentHidden + 4;
const auto pg3d_persistent = pg3d_persistent_kernel<kPersistentBranches, kPersistentHidden>;
const auto adj3d_persistent = adj3d_persistent_kernel<kPersistentBranches, kPersistentHidden>;

// How many blocks of a one-launch sweep kernel an SM holds at once, its
// shared memory allowed.
template <typename Kernel>
cudaError_t persistent_occupancy(Kernel kernel, size_t smem, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kPersistentThreads, smem);
}

// One cooperative launch of `kernel` on `blocks` blocks with the arguments
// `args`, after the occupancy query: a cooperative grid must be
// co-resident, and one past it would be refused.
template <typename Kernel>
cudaError_t launch_persistent(Kernel kernel, void** args, size_t smem, int blocks,
                              cudaStream_t stream, int* per_sm) {
  cudaError_t err = persistent_occupancy(kernel, smem, per_sm);
  if (err != cudaSuccess) return err;
  int device, sms;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (blocks > *per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                    dim3(kPersistentThreads), args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t persistent_sweep(const float* params, int n_params, const float2* frames,
                             const float2* frames_bar, float2* g0, float2* scratch, float* acc,
                             int n_steps, int D, int H, int W, float dt, float inv_dx2,
                             int blocks, cudaStream_t stream, int* per_sm) {
  const size_t smem = persistent_smem_bytes(n_params, D, H, W, kPersistentPlanes, blocks);
  void* args[] = {&params, &n_params, &frames, &frames_bar, &g0, &scratch, &acc, &n_steps,
                  &D, &H, &W, &dt, &inv_dx2};
  return launch_persistent(pg3d_persistent, args, smem, blocks, stream, per_sm);
}

cudaError_t adj_persistent_sweep(const float* params, int n_params, const float2* frames,
                                 const float2* frames_bar, float2* g0, float2* scratch,
                                 float2* g_ins, int n_steps, int D, int H, int W, float dt,
                                 float inv_dx2, int blocks, cudaStream_t stream, int* per_sm) {
  const size_t smem = persistent_smem_bytes(n_params, D, H, W, 0, blocks);
  cudaError_t err = persistent_occupancy(adj3d_persistent, smem, per_sm);
  if (err != cudaSuccess || n_steps == 0) return err;   // no step: g0 stays as zeroed
  void* args[] = {&params, &n_params, &frames, &frames_bar, &g0, &scratch, &g_ins, &n_steps,
                  &D, &H, &W, &dt, &inv_dx2};
  return launch_persistent(adj3d_persistent, args, smem, blocks, stream, per_sm);
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

// The fused sweep in one cooperative launch of pg3d_persistent_kernel on
// `blocks` blocks (at most the card's co-resident count: else
// cudaErrorCooperativeLaunchTooLarge, before anything is launched); g0 and
// scratch zeroed, acc [A, D, H, W] written whole.  `per_sm` gets the
// occupancy query's blocks an SM.
extern "C" int backward3d_pg_persistent(const void* params, int n_params, const void* frames,
                                        const void* frames_bar, void* g0, void* scratch,
                                        void* acc, int n_steps, int D, int H, int W, int hidden,
                                        int n_branches, float dt, float inv_dx2, int blocks,
                                        void* stream, int* per_sm) {
  const long long cells = 1LL * D * H * W;
  if (n_branches != kPersistentBranches || hidden != kPersistentHidden || blocks < 1 ||
      blocks > cells || (cells + blocks - 1) / blocks > 2 * kPersistentThreads)
    return cudaErrorInvalidValue;
  return persistent_sweep(static_cast<const float*>(params), n_params,
                          static_cast<const float2*>(frames),
                          static_cast<const float2*>(frames_bar), static_cast<float2*>(g0),
                          static_cast<float2*>(scratch), static_cast<float*>(acc), n_steps, D,
                          H, W, dt, inv_dx2, blocks, static_cast<cudaStream_t>(stream), per_sm);
}

// How many blocks of pg3d_persistent_kernel an SM holds at once, on
// `blocks` blocks.
extern "C" int backward3d_pg_occupancy(int n_params, int D, int H, int W, int hidden,
                                       int n_branches, int blocks, int* per_sm) {
  if (n_branches != kPersistentBranches || hidden != kPersistentHidden || blocks < 1)
    return cudaErrorInvalidValue;
  return persistent_occupancy(
      pg3d_persistent, persistent_smem_bytes(n_params, D, H, W, kPersistentPlanes, blocks),
      per_sm);
}

// The streaming sweep in one cooperative launch of adj3d_persistent_kernel
// on `blocks` blocks (adj3d_plan in ../backward3d.py: at most the card's
// co-resident count, else cudaErrorCooperativeLaunchTooLarge, before
// anything is launched; nothing is launched at n_steps = 0); frames,
// frames_bar [n_steps + 1, D, H, W, 2]; g0 and scratch [D, H, W, 2]
// zeroed; g_ins [n_steps, D, H, W, 2].  On return g0 holds the adjoint at
// frame 0 (without frames_bar[0]).  `per_sm` gets the occupancy query's
// blocks an SM.
extern "C" int backward3d_adj_persistent(const void* params, int n_params, const void* frames,
                                         const void* frames_bar, void* g0, void* scratch,
                                         void* g_ins, int n_steps, int D, int H, int W,
                                         int hidden, int n_branches, float dt, float inv_dx2,
                                         int blocks, void* stream, int* per_sm) {
  const long long cells = 1LL * D * H * W;
  if (n_branches != kPersistentBranches || hidden != kPersistentHidden || blocks < 1 ||
      blocks > cells || (cells + blocks - 1) / blocks > 2 * kPersistentThreads)
    return cudaErrorInvalidValue;
  return adj_persistent_sweep(static_cast<const float*>(params), n_params,
                              static_cast<const float2*>(frames),
                              static_cast<const float2*>(frames_bar), static_cast<float2*>(g0),
                              static_cast<float2*>(scratch), static_cast<float2*>(g_ins),
                              n_steps, D, H, W, dt, inv_dx2, blocks,
                              static_cast<cudaStream_t>(stream), per_sm);
}

// How many blocks of adj3d_persistent_kernel an SM holds at once, on
// `blocks` blocks.
extern "C" int backward3d_adj_occupancy(int n_params, int D, int H, int W, int hidden,
                                        int n_branches, int blocks, int* per_sm) {
  if (n_branches != kPersistentBranches || hidden != kPersistentHidden || blocks < 1)
    return cudaErrorInvalidValue;
  return persistent_occupancy(adj3d_persistent,
                              persistent_smem_bytes(n_params, D, H, W, 0, blocks), per_sm);
}
