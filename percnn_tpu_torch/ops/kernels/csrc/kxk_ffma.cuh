// What the one-launch FFMA kernels of a k x k Pi cell share (k = 3 or 5,
// 1 to 4 branches, C <= 16, full f32, no tensor cores):
// rollout2d_ffma_persistent_kernel (cell2d_ffma.cu), adj2d_ys_persistent_kernel
// (adj2d.cu) and the ensemble's adj2d_batched_ffma_persistent_kernel
// (batched2d.cu).  Their block works on rounds of at most 8 tiles of 16
// cells, warp 2 tl + o taking equation o of tile tl, and forms two small
// register-tiled products from operands packed on the host in lane order:
//   the forward's   y [2 nb C rows] = Wf . im2col [k k 2 taps x cells] + b
//     (fwd_product: lane (pair p, group g) holds channels 2 p, 2 p + 1 of
//     every branch at cells 4 g .. 4 g + 3; pack_ffma_fwd_2d), and
//   the adjoint's   zw^T [k k 2 taps x cells] = Wtaps^T . Z [rows x cells]
//     (adj_product: lane (tap group q, group g) holds kR taps of cells
//     4 g .. 4 g + 3 over equation o's rows; pack_ffma_adj_2d).
// g_at is the adjoint's gather: g_t at one cell and channel from zw_t and
// g_ins[t] at its neighbours, read past L1 (other blocks wrote them in the
// same launch).  The designs are described at the kernels.

#pragma once

#include <cuda_runtime.h>

#include "kxk_mma.cuh"

namespace kxk_ffma {

constexpr int kTileCells = 16;               // cells of a warp's tile
constexpr int kMaxTiles = 8;                 // tiles a round: one warp pair each
constexpr int kMaxThreads = 64 * kMaxTiles;  // 512
constexpr int kPairs = 8;                    // the forward's channel pairs: C <= 16
constexpr int kTapGroups = 8;                // the adjoint's tap groups
constexpr int kTail = 36;                    // D (2), w_out (2 x 16), b_out (2)

template <int KS, int NB>
struct FwdDims {
  static constexpr int kTaps = KS * KS * 2;
  static constexpr int kW = (2 * NB + 3) / 4 * 4;  // floats of a (tap, equation, pair)
  static constexpr int kHalves = kW / 4;
  // the forward operand [kTaps + 1][2][kHalves][kPairs][4], row kTaps the biases
  static constexpr int kOperand = (kTaps + 1) * 2 * kW * kPairs;
};

template <int KS>
struct AdjDims {
  static constexpr int kTaps = KS * KS * 2;
  static constexpr int kR = (kTaps + kTapGroups - 1) / kTapGroups;  // taps a lane: 7 at k = 5
  static constexpr int kHalves = (kR + 3) / 4;                      // float4s of a lane's row
};

// Float offset of tap q = (ki k + kj) 2 + cin in the staged rows, from the
// cell's first tap (kxk_mma::tap_base).
template <int KS>
__device__ __forceinline__ int tap_offset(int q, int W) {
  const int tap = q >> 1;
  const int ki = tap / KS;
  return (ki * (W + 2 * kxk::kHalo) + tap - ki * KS) * 2 + (q & 1);
}

// y of this lane's 2 channels x NB branches (f = cl NB + i) at its 4 cells:
// the biases, then one FFMA chain a row over the taps.  wlane is the
// lane's operand float4 at tap 0 (stride 2 kHalves kPairs a tap), xlane its
// im2col float4 at tap 0 (stride xstride a tap).
template <int KS, int NB>
__device__ __forceinline__ void fwd_product(const float4* wlane, const float4* xlane,
                                            int xstride, float (&acc)[2 * NB][4]) {
  using D = FwdDims<KS, NB>;
  constexpr int kRowF4 = 2 * D::kHalves * kPairs;
  {
    float w[4 * D::kHalves];
#pragma unroll
    for (int h = 0; h < D::kHalves; ++h) {
      const float4 v = wlane[D::kTaps * kRowF4 + h * kPairs];
      w[4 * h] = v.x;
      w[4 * h + 1] = v.y;
      w[4 * h + 2] = v.z;
      w[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int f = 0; f < 2 * NB; ++f)
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[f][m] = w[f];
  }
#pragma unroll
  for (int q = 0; q < D::kTaps; ++q) {
    const float4 x = xlane[q * xstride];
    float w[4 * D::kHalves];
#pragma unroll
    for (int h = 0; h < D::kHalves; ++h) {
      const float4 v = wlane[q * kRowF4 + h * kPairs];
      w[4 * h] = v.x;
      w[4 * h + 1] = v.y;
      w[4 * h + 2] = v.z;
      w[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int f = 0; f < 2 * NB; ++f) {
      acc[f][0] = fmaf(w[f], x.x, acc[f][0]);
      acc[f][1] = fmaf(w[f], x.y, acc[f][1]);
      acc[f][2] = fmaf(w[f], x.z, acc[f][2]);
      acc[f][3] = fmaf(w[f], x.w, acc[f][3]);
    }
  }
}

// zw^T of rows [m0, m1) at this lane's kR taps x 4 cells: zl is the lane's
// float4 of Z at row 0 (stride zstride a row), wl its operand float4 at row
// 0 (kHalves float4s a row, the 8 tap groups' interleaved).
template <int KS>
__device__ __forceinline__ void adj_product(const float4* zl, const float4* wl, int zstride,
                                            int m0, int m1, float (&acc)[AdjDims<KS>::kR][4]) {
  using D = AdjDims<KS>;
#pragma unroll
  for (int j = 0; j < D::kR; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll 4
  for (int m = m0; m < m1; ++m) {
    const float4 z = zl[m * zstride];
    float w[4 * D::kHalves];
#pragma unroll
    for (int h = 0; h < D::kHalves; ++h) {
      const float4 v = wl[(m * D::kHalves + h) * kTapGroups];
      w[4 * h] = v.x;
      w[4 * h + 1] = v.y;
      w[4 * h + 2] = v.z;
      w[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < D::kR; ++j) {
      acc[j][0] = fmaf(w[j], z.x, acc[j][0]);
      acc[j][1] = fmaf(w[j], z.y, acc[j][1]);
      acc[j][2] = fmaf(w[j], z.z, acc[j][2]);
      acc[j][3] = fmaf(w[j], z.w, acc[j][3]);
    }
  }
}

// g_t at cell idx, channel c: ctr + dt (diff Lap(g_in_t) + jt), *ctr = g_in_t
// at the cell and *diff = D_c (both in shared memory, read last), jt the sum
// of zw_t (zsrc, [k k 2][H W]) over the reversed taps at the neighbours and
// the Laplacian over g_ins[t] ([H W][2]), both read from L2 with __ldcg.
template <int KS>
__device__ __forceinline__ float g_at(const float* zsrc, const float2* g_ins, int t,
                                      const float* ctr_at, const float* diff_at, int idx, int c,
                                      int H, int W, float dt, float inv_dx2) {
  constexpr int R = KS / 2;
  const int cells = H * W;
  const int i = idx / W;
  const int j = idx - i * W;
  int col[KS];
#pragma unroll
  for (int kj = 0; kj < KS; ++kj) col[kj] = kxk_mma::wrap2(j + R - kj, W);
  float jt = 0.0f;
#pragma unroll
  for (int ki = 0; ki < KS; ++ki) {
    const float* zrow = zsrc + static_cast<size_t>(ki * KS * 2 + c) * cells +
                        kxk_mma::wrap2(i + R - ki, H) * W;
#pragma unroll
    for (int kj = 0; kj < KS; ++kj)
      jt += __ldcg(zrow + static_cast<size_t>(kj * 2) * cells + col[kj]);
  }
  const float* gi = reinterpret_cast<const float*>(g_ins + static_cast<size_t>(t) * cells);
  auto at = [&](int di, int dj) {
    return __ldcg(gi + 2 * (kxk_mma::wrap2(i + di, H) * W + kxk_mma::wrap2(j + dj, W)) + c);
  };
  const float s1 = at(1, 0) + at(-1, 0) + at(0, 1) + at(0, -1);
  const float s2 = at(2, 0) + at(-2, 0) + at(0, 2) + at(0, -2);
  const float ctr = *ctr_at;
  const float lap = (-5.0f * ctr + (4.0f / 3.0f) * s1 - (1.0f / 12.0f) * s2) * inv_dx2;
  return ctr + dt * (*diff_at * lap + jt);
}

}  // namespace kxk_ffma

// (kernel_size, n_branches) of the caller's scope -> return F<KS, NB>(...),
// or cudaErrorInvalidValue for widths the FFMA kernels are not built for
// (k = 3 or 5, 1 to 4 branches; C up to 16 is the operands' padding).
#define KXK_FFMA_DISPATCH(F, ...)                 \
  switch (kernel_size * 10 + n_branches) {        \
    case 31: return F<3, 1>(__VA_ARGS__);         \
    case 32: return F<3, 2>(__VA_ARGS__);         \
    case 33: return F<3, 3>(__VA_ARGS__);         \
    case 34: return F<3, 4>(__VA_ARGS__);         \
    case 51: return F<5, 1>(__VA_ARGS__);         \
    case 52: return F<5, 2>(__VA_ARGS__);         \
    case 53: return F<5, 3>(__VA_ARGS__);         \
    case 54: return F<5, 4>(__VA_ARGS__);         \
    default: return cudaErrorInvalidValue;        \
  }
