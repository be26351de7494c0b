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
//
// adj2d_kxk_persistent_kernel replaces the same TPU kernel on every field
// that fits a block's shared memory (kxk_adj_plan in ../backward2d.py; the
// per-step kernels above run past it): the whole sweep in one cooperative
// launch, one block an SM, one grid barrier a step, both products on the
// tensor cores in 3xTF32 (kxk_mma.cuh).  Bound on the same card with the
// products at the tensor cores' 495 TFLOP/s dense TF32 (three passes) and
// the rest at the f32 peak: the 768 MB ys write sets it, about 0.24 ms per
// T = 200 (chip_smoke.py counts both bounds).  Measured by chip_smoke.py on
// an NVIDIA H100 80GB HBM3, 700.00 W, per T = 200 at 100 x 100: 2.133 ms,
// one launch, 10.66 us a step; adj2d_kxk_kernel 4.825 ms in the same call.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "kxk_common.cuh"
#include "kxk_mma.cuh"

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

namespace cg = cooperative_groups;

// The whole reverse sweep in one cooperative launch.  Block b owns the cells
// of share_of (kxk_mma.cuh) for every step; warp w takes equation o = w % 2
// of the 16-cell tiles of round r: r pairs + w / 2.  Before the loop the
// block stages both operands (pack_mma_fwd_2d, pack_mma_adj_2d, split into
// hi and lo) and the tail.  The only neighbourhood dependency of a reverse
// step, jt and Lap(g_in), reads what the previous step wrote, so one
// grid.sync() a step suffices: iteration s (t = T - 1 - s)
//   A. frame t's rows staged; a thread a (channel, own cell): unless s = 0,
//      step t + 1's gather, jt and Lap(g_in) from zw_{t+1} and g_ins[t + 1]
//      at the neighbours, and g_{t+1} = g_in + dt (D Lap(g_in) + jt); then
//      g_in = g_{t+1} + fbar_{t+1} (fbar_T alone at s = 0) into shared
//      memory and g_ins[t];
//   B. per tile and equation, y^T by the 3xTF32 branch product (streamed
//      to ys[t]), z in registers, zw^T = z^T Wm_taps by the second product;
//      the o = 1 warp's share of zw meets the o = 0 warp's in shared
//      memory, which writes zw_t;
// then grid.sync().  zw alternates between two [k k 2][H W] buffers, so a
// block writing zw_t never races a slower block still gathering zw_{t+1}.
// After the loop, step 0's gather writes g_0.
template <int KS, int NB, int CH>
__global__ void __launch_bounds__(kxk_mma::kMaxThreads, 1)
    adj2d_kxk_persistent_kernel(const float* __restrict__ bfwd, const float* __restrict__ badj,
                                const float* __restrict__ tail,
                                const float2* __restrict__ frames,
                                const float2* __restrict__ frames_bar, float2* g_out,
                                float2* g_ins, float* __restrict__ ys, float* zw, int n_steps,
                                int H, int W, int hidden, float dt, float inv_dx2) {
  using namespace kxk_mma;
  using D = Dims<KS, NB, CH>;
  constexpr int kTaps = D::kTaps;
  constexpr int R = KS / 2;
  cg::grid_group grid = cg::this_grid();
  const int cells = H * W;
  const Share sh = share_of(cells, W);
  const int cap = (cells + gridDim.x - 1) / gridDim.x;
  const int pairs = blockDim.x >> 6;
  extern __shared__ uint4 smem_adj[];
  uint4* sbf = smem_adj;                                 // [K8][2 NT][32]
  uint4* sba = sbf + D::kK8 * 2 * D::kNT * 32;           // [2 NT][QT][32]
  float* st = reinterpret_cast<float*>(sba + 2 * D::kNT * D::kQT * 32);  // [kTail]
  float* gin = st + D::kTail;                            // [cap][2]: g_in of the own cells
  float* zred = gin + 2 * cap;                           // [pairs][QT][4][32]
  float2* tile = reinterpret_cast<float2*>(zred + pairs * D::kQT * 4 * 32);
  stage_fragments(sbf, bfwd, D::kK8 * 2 * D::kNT * 32);
  stage_fragments(sba, badj, 2 * D::kNT * D::kQT * 32);
  stage_tail<D::kC8>(st, tail, hidden);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o = warp & 1, pair = warp >> 1;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_tiles = (sh.n_own + kTile - 1) / kTile;
  const int rounds = (n_tiles + pairs - 1) / pairs;
  const int M = 2 * NB * hidden;
  int off[D::kK8][2];
  tap_offsets<KS>(W, t4, off);
  const float* tf = reinterpret_cast<const float*>(tile);

  // g_t at own cell k, channel c: g_in_t + dt (D Lap(g_in_t) + jt), from
  // g_ins[t] and zw_t (zsrc) at the neighbours
  auto gather = [&](int t, const float* zsrc, int k, int c) {
    const int idx = sh.first + k;
    const int i = idx / W;
    const int j = idx - i * W;
    int col[KS];
#pragma unroll
    for (int kj = 0; kj < KS; ++kj) col[kj] = wrap2(j + R - kj, W);
    float jt = 0.0f;
#pragma unroll
    for (int ki = 0; ki < KS; ++ki) {
      const float* zrow = zsrc + static_cast<size_t>(ki * KS * 2 + c) * cells +
                          wrap2(i + R - ki, H) * W;
#pragma unroll
      for (int kj = 0; kj < KS; ++kj) jt += __ldcg(zrow + static_cast<size_t>(kj * 2) * cells + col[kj]);
    }
    const float* gi = reinterpret_cast<const float*>(g_ins + static_cast<size_t>(t) * cells);
    auto at = [&](int di, int dj) {
      return __ldcg(gi + 2 * (wrap2(i + di, H) * W + wrap2(j + dj, W)) + c);
    };
    const float s1 = at(1, 0) + at(-1, 0) + at(0, 1) + at(0, -1);
    const float s2 = at(2, 0) + at(-2, 0) + at(0, 2) + at(0, -2);
    const float ctr = gin[2 * k + c];
    const float lap = (-5.0f * ctr + (4.0f / 3.0f) * s1 - (1.0f / 12.0f) * s2) * inv_dx2;
    return ctr + dt * (st[c] * lap + jt);
  };

  for (int s = 0; s < n_steps; ++s) {
    const int t = n_steps - 1 - s;
    float* zcur = zw + static_cast<size_t>(s & 1) * kTaps * cells;
    const float* zprev = zw + static_cast<size_t>((s + 1) & 1) * kTaps * cells;
    // A: g_in at the own cells, channel-major so a warp reads a plane's
    // consecutive cells
    stage_rows(tile, frames + static_cast<size_t>(t) * cells, H, W, sh);
    const float* fb = reinterpret_cast<const float*>(frames_bar +
                                                     static_cast<size_t>(t + 1) * cells);
    float* gi_out = reinterpret_cast<float*>(g_ins + static_cast<size_t>(t) * cells);
    for (int item = threadIdx.x; item < 2 * sh.n_own; item += blockDim.x) {
      const int c = item >= sh.n_own ? 1 : 0;
      const int k = item - c * sh.n_own;
      const int idx = sh.first + k;
      float v = fb[2 * idx + c];
      if (s > 0) v += gather(t + 1, zprev, k, c);
      gin[2 * k + c] = v;
      gi_out[2 * idx + c] = v;
    }
    __syncthreads();
    // B
    float* ys_t = ys + static_cast<size_t>(t) * M * cells;
    for (int rd = 0; rd < rounds; ++rd) {
      const int tl = rd * pairs + pair;
      const int r0 = tl * kTile + g, r1 = r0 + 8;
      const int k0 = min(r0, sh.n_own - 1), k1 = min(r1, sh.n_own - 1);
      float zacc[D::kQT][4];
      if (tl < n_tiles) {
        float acc[D::kNT][4];
        branch_product<KS, NB, CH>(sbf, tf, tap_base<KS>(sh.first + k0, W, sh.row0),
                                   tap_base<KS>(sh.first + k1, W, sh.row0), off, o, lane, acc);
        const float gw0 = gin[2 * k0 + o], gw1 = gin[2 * k1 + o];
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * ch + 2 * t4 + (e & 1);
            const int r = e < 2 ? r0 : r1;
            if (c < hidden && r < sh.n_own) {
#pragma unroll
              for (int i = 0; i < NB; ++i)
                __stcs(ys_t + static_cast<size_t>((o * NB + i) * hidden + c) * cells +
                           sh.first + r,
                       acc[i * CH + ch][e]);
            }
            // z_i = w_out[c] g_in prod_{j != i} y_j, from prefix and suffix products
            float pre[NB + 1], suf[NB + 1];
            pre[0] = 1.0f;
            suf[NB] = 1.0f;
#pragma unroll
            for (int i = 0; i < NB; ++i) pre[i + 1] = pre[i] * acc[i * CH + ch][e];
#pragma unroll
            for (int i = NB - 1; i >= 0; --i) suf[i] = suf[i + 1] * acc[i * CH + ch][e];
            const float gw = st[2 + o * D::kC8 + c] * (e < 2 ? gw0 : gw1);
#pragma unroll
            for (int i = 0; i < NB; ++i) acc[i * CH + ch][e] = gw * (pre[i] * suf[i + 1]);
          }
        }
        // zw^T += z^T Wm_taps: A's columns t, t + 4 are accumulator columns 2 t, 2 t + 1
#pragma unroll
        for (int q = 0; q < D::kQT; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) zacc[q][e] = 0.0f;
#pragma unroll
        for (int n = 0; n < D::kNT; ++n) {
          const float a[4] = {acc[n][0], acc[n][2], acc[n][1], acc[n][3]};
          uint32_t hi[4], lo[4];
          split4(a, hi, lo);
          const uint4* row = sba + ((o * D::kNT + n) * D::kQT) * 32 + lane;
#pragma unroll
          for (int q = 0; q < D::kQT; ++q) mma3(zacc[q], hi, lo, row[q * 32]);
        }
        if (o == 1) {
#pragma unroll
          for (int q = 0; q < D::kQT; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) zred[((pair * D::kQT + q) * 4 + e) * 32 + lane] = zacc[q][e];
        }
      }
      __syncthreads();
      if (tl < n_tiles && o == 0) {
#pragma unroll
        for (int q = 0; q < D::kQT; ++q) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * q + 2 * t4 + (e & 1);
            const int r = e < 2 ? r0 : r1;
            if (col < kTaps && r < sh.n_own)
              zcur[static_cast<size_t>(col) * cells + sh.first + r] =
                  zacc[q][e] + zred[((pair * D::kQT + q) * 4 + e) * 32 + lane];
          }
        }
      }
      __syncthreads();
    }
    grid.sync();
  }
  if (n_steps > 0) {
    const float* zlast = zw + static_cast<size_t>((n_steps - 1) & 1) * kTaps * cells;
    float* go = reinterpret_cast<float*>(g_out);
    for (int item = threadIdx.x; item < 2 * sh.n_own; item += blockDim.x) {
      const int c = item >= sh.n_own ? 1 : 0;
      const int k = item - c * sh.n_own;
      go[2 * (sh.first + k) + c] = gather(0, zlast, k, c);
    }
  }
}

// Shared memory of adj2d_kxk_persistent_kernel<KS, NB, CH> on `blocks`
// blocks of `threads` threads: both split operands, the tail, g_in of the
// most cells a block owns, the zw exchange of each warp pair and the most
// staged rows of a block (kxk_adj_plan in ../backward2d.py computes the same).
template <int KS, int NB, int CH>
size_t persistent_smem(int H, int W, int blocks, int threads) {
  using D = kxk_mma::Dims<KS, NB, CH>;
  const size_t cap = (static_cast<size_t>(H) * W + blocks - 1) / blocks;
  return 16 * (D::kK8 + D::kQT) * 2 * D::kNT * 32 + 4 * D::kTail + 8 * cap +
         4 * static_cast<size_t>(threads / 64) * D::kQT * 4 * 32 +
         kxk_mma::tile_bytes(H, W, blocks);
}

template <int KS, int NB, int CH>
cudaError_t persistent_occupancy(size_t smem, int threads, int* per_sm) {
  auto kernel = adj2d_kxk_persistent_kernel<KS, NB, CH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
}

template <int KS, int NB, int CH>
cudaError_t persistent_sweep(const float* bfwd, const float* badj, const float* tail,
                             const float2* frames, const float2* frames_bar, float2* g,
                             float2* g_ins, float* ys, float* zw, int n_steps, int H, int W,
                             int hidden, float dt, float inv_dx2, int blocks, int threads,
                             size_t smem, cudaStream_t stream, int* per_sm) {
  if (smem != persistent_smem<KS, NB, CH>(H, W, blocks, threads)) return cudaErrorInvalidValue;
  cudaError_t err = persistent_occupancy<KS, NB, CH>(smem, threads, per_sm);
  if (err != cudaSuccess) return err;
  err = kxk_mma::check_coresident(blocks, *per_sm);
  if (err != cudaSuccess || n_steps == 0) return err;
  void* args[] = {&bfwd, &badj, &tail, &frames, &frames_bar, &g, &g_ins, &ys, &zw, &n_steps,
                  &H, &W, &hidden, &dt, &inv_dx2};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(adj2d_kxk_persistent_kernel<KS, NB, CH>), dim3(blocks),
      dim3(threads), args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
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

// The same sweep in one cooperative launch of adj2d_kxk_persistent_kernel on
// `blocks` blocks of `threads` threads with `smem` bytes (kxk_adj_plan; the
// checks of cell2d_kxk_rollout_persistent).  bfwd and badj are
// pack_mma_fwd_2d's and pack_mma_adj_2d's operands, ch = ceil(C / 8), 1 or
// 2; zw is a [2, k k 2, H, W] scratch.  g (zeroed) receives g_0 and the
// outputs are those of backward2d_kxk.  `per_sm` gets the occupancy query's
// blocks an SM.
extern "C" int backward2d_kxk_persistent(const void* bfwd, const void* badj, const void* tail,
                                         const void* frames, const void* frames_bar, void* g,
                                         void* g_ins, void* ys, void* zw, int n_steps, int H,
                                         int W, int hidden, int n_branches, int kernel_size,
                                         int ch, float dt, float inv_dx2, int blocks,
                                         int threads, int smem, void* stream, int* per_sm) {
  const float* bf = static_cast<const float*>(bfwd);
  const float* ba = static_cast<const float*>(badj);
  const float* t = static_cast<const float*>(tail);
  const float2* f = static_cast<const float2*>(frames);
  const float2* fb = static_cast<const float2*>(frames_bar);
  float2* gg = static_cast<float2*>(g);
  float2* gi = static_cast<float2*>(g_ins);
  float* y = static_cast<float*>(ys);
  float* z = static_cast<float*>(zw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!kxk_mma::valid_grid(blocks, threads, H * W)) return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(smem);
  KXK_MMA_DISPATCH(persistent_sweep, bf, ba, t, f, fb, gg, gi, y, z, n_steps, H, W, hidden, dt,
                   inv_dx2, blocks, threads, bytes, s, per_sm)
}

// How many blocks of adj2d_kxk_persistent_kernel an SM holds at once,
// `threads` threads and `smem` bytes a block.
extern "C" int backward2d_kxk_occupancy(int n_branches, int kernel_size, int ch, int threads,
                                        int smem, int* per_sm) {
  const size_t bytes = static_cast<size_t>(smem);
  KXK_MMA_DISPATCH(persistent_occupancy, bytes, threads, per_sm)
}
