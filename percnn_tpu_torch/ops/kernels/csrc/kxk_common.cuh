// What the k x k Pi-cell kernels share: rollout2d_kxk_kernel (cell2d_kxk.cu)
// and adj2d_kxk_act_kernel (backward2d_kxk.cu) both form, at every cell of a
// block's tile, the branch activations y = Wm . im2col(h) of the 5x5 (or 3x3)
// neighbourhood, with Wm the [M, kRow] matrix of pack_pi_matrix_2d
// (../cell2d.py): row (o nb + i) C + c, columns (ki k + kj) 2 + cin, then the
// bias column (the ones entry of the im2col stack), then zeros to kRow.
// The tap-by-tap kernels of the packed parameters (rollout2d_kernel and
// final2d_kernel at k > 1 in cell2d.cu, adj2d_act_kernel in adj2d.cu) take
// the tile staging (stage_tile), gather_taps, packed_act, tile_lap and, for
// the adjoints, the gather step (gather_update) from here too.
//
// A block covers a kTileH x kTileW tile of the periodic H x W grid with two
// threads a cell, one per equation o: threads [0, kCells) take o = 0 and
// [kCells, 2 kCells) o = 1, so every warp reads one row of Wm at a time, a
// broadcast from shared memory.  The block stages in shared memory:
//   Wm [M][kRow] f32, float4-aligned;
//   the tail [Du, Dv, w_out (2 x C), b_out (2)], rounded up to 4 floats
//   (pi_tail_2d in ../cell2d.py);
//   the state tile with a 2-cell periodic halo, [kTileH + 4][kTileW + 4]
//   float2 (u, v), indices wrapped as it is loaded: the port's state has no
//   halo, and the Laplacian and any k <= 5 read at most 2 cells away.

#pragma once

#include <cuda_runtime.h>

namespace kxk {

constexpr int kHalo = 2;
constexpr int kTileH = 8;
constexpr int kTileW = 16;
constexpr int kCells = kTileH * kTileW;               // 128 cells a block
constexpr int kThreads = 2 * kCells;                  // one thread a cell and equation
constexpr int kTileRow = kTileW + 2 * kHalo;          // 20
constexpr int kTileLen = (kTileH + 2 * kHalo) * kTileRow;

template <int KS>
struct Shape {
  static constexpr int kTaps = KS * KS * 2;           // conv taps x channels
  static constexpr int kQ = (kTaps + 1 + 3) / 4;      // float4s holding taps + bias
  static constexpr int kRow = (kTaps + 1 + 7) / 8 * 8;  // row length of Wm
};

__host__ __device__ constexpr int tail_floats(int hidden) {
  return (2 * hidden + 4 + 3) / 4 * 4;
}

// Shared-memory bytes of the staged matrix, tail and state tile.
template <int KS>
__host__ __device__ constexpr int staged_bytes(int hidden, int n_branches) {
  return 4 * (2 * n_branches * hidden * Shape<KS>::kRow + tail_floats(hidden)) +
         8 * kTileLen;
}

// Stage the block's state tile, rows i0 - 2 .. i0 + kTileH + 1 and columns
// j0 - 2 .. j0 + kTileW + 1 of the periodic grid, wrapped.  The caller
// synchronises.
__device__ __forceinline__ void stage_tile(float2* tile, const float2* __restrict__ state,
                                           int H, int W, int i0, int j0) {
  for (int k = threadIdx.x; k < kTileLen; k += blockDim.x) {
    const int ti = k / kTileRow;
    int gi = (i0 + ti - kHalo) % H;
    int gj = (j0 + k - ti * kTileRow - kHalo) % W;
    gi += gi < 0 ? H : 0;
    gj += gj < 0 ? W : 0;
    tile[k] = state[gi * W + gj];
  }
}

// The same tile from a block with a 2-cell halo, [H + 4, W + 4] (H x W its
// interior): tile cell (ti, tj) is block cell (i0 + ti, j0 + tj), no wrap,
// and zero past the block's edge.  The caller synchronises.
__device__ __forceinline__ void stage_tile_haloed(float2* tile, const float2* __restrict__ xp,
                                                  int H, int W, int i0, int j0) {
  const int ld = W + 2 * kHalo;
  for (int k = threadIdx.x; k < kTileLen; k += blockDim.x) {
    const int ti = k / kTileRow;
    const int bi = i0 + ti, bj = j0 + k - ti * kTileRow;
    tile[k] = (bi < H + 2 * kHalo && bj < ld) ? xp[bi * ld + bj] : make_float2(0.0f, 0.0f);
  }
}

struct Staged {
  const float4* wm;  // [M][kRow / 4]
  const float* tail;
  const float2* tile;
};

// Stage Wm, the tail and the block's state tile (rows i0 - 2 .. i0 + kTileH + 1,
// columns j0 - 2 .. j0 + kTileW + 1, wrapped).  The caller synchronises.
template <int KS>
__device__ __forceinline__ Staged stage(float4* smem, const float* __restrict__ wm,
                                        const float* __restrict__ tail,
                                        const float2* __restrict__ state, int H, int W,
                                        int hidden, int n_branches, int i0, int j0) {
  const int n4 = 2 * n_branches * hidden * Shape<KS>::kRow / 4;
  float4* sw = smem;
  float* st = reinterpret_cast<float*>(sw + n4);
  float2* tile = reinterpret_cast<float2*>(st + tail_floats(hidden));
  const float4* wm4 = reinterpret_cast<const float4*>(wm);
  for (int k = threadIdx.x; k < n4; k += blockDim.x) sw[k] = wm4[k];
  for (int k = threadIdx.x; k < 2 * hidden + 4; k += blockDim.x) st[k] = tail[k];
  stage_tile(tile, state, H, W, i0, j0);
  return {sw, st, tile};
}

// The im2col column of tile cell (li, lj): taps (ki, kj, cin), then 1, then 0.
template <int KS>
__device__ __forceinline__ void gather_taps(const float2* tile, int li, int lj,
                                            float (&tap)[4 * Shape<KS>::kQ]) {
  constexpr int r = KS / 2;
#pragma unroll
  for (int ki = 0; ki < KS; ++ki) {
#pragma unroll
    for (int kj = 0; kj < KS; ++kj) {
      const float2 v = tile[(li + kHalo + ki - r) * kTileRow + lj + kHalo + kj - r];
      tap[(ki * KS + kj) * 2] = v.x;
      tap[(ki * KS + kj) * 2 + 1] = v.y;
    }
  }
  tap[Shape<KS>::kTaps] = 1.0f;
#pragma unroll
  for (int q = Shape<KS>::kTaps + 1; q < 4 * Shape<KS>::kQ; ++q) tap[q] = 0.0f;
}

// One activation: row . column, in four interleaved partial sums.
template <int KS>
__device__ __forceinline__ float row_dot(const float4* row,
                                         const float (&tap)[4 * Shape<KS>::kQ]) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
  for (int q = 0; q < Shape<KS>::kQ; ++q) {
    const float4 w = row[q];
    a0 = fmaf(w.x, tap[4 * q], a0);
    a1 = fmaf(w.y, tap[4 * q + 1], a1);
    a2 = fmaf(w.z, tap[4 * q + 2], a2);
    a3 = fmaf(w.w, tap[4 * q + 3], a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// One branch activation from the packed layout (pack_pi_params_2d in
// ../cell2d.py): w points at branch i's weight of hidden channel c, so
// w_i[q, c] is w[q * hidden] and the bias b_i[c] is w[k k 2 * hidden]; the
// taps in two interleaved partial sums.
template <int KS>
__device__ __forceinline__ float packed_act(const float* w, int hidden,
                                           const float (&tap)[4 * Shape<KS>::kQ]) {
  constexpr int kTaps = Shape<KS>::kTaps;
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int q = 0; q < kTaps; q += 2) {
    a0 = fmaf(w[q * hidden], tap[q], a0);
    a1 = fmaf(w[(q + 1) * hidden], tap[q + 1], a1);
  }
  return (a0 + a1) + w[kTaps * hidden];
}

// The 4th-order Laplacian's 5-point cross of channel o at tile cell (li, lj).
__device__ __forceinline__ float tile_lap(const float2* tile, int li, int lj, int o,
                                          float inv_dx2) {
  const float* t = reinterpret_cast<const float*>(tile);
  auto at = [&](int di, int dj) {
    return t[((li + kHalo + di) * kTileRow + lj + kHalo + dj) * 2 + o];
  };
  const float s1 = at(1, 0) + at(-1, 0) + at(0, 1) + at(0, -1);
  const float s2 = at(2, 0) + at(-2, 0) + at(0, 2) + at(0, -2);
  return (-5.0f * at(0, 0) + (4.0f / 3.0f) * s1 - (1.0f / 12.0f) * s2) * inv_dx2;
}

// The second launch of a k x k adjoint step at cell idx = (i, j), the update
// of g in place from the first launch's outputs:
//   jt_cin = sum_{ki,kj} zw[(ki k + kj) 2 + cin](x + (r - ki, r - kj))
//   g      = g_in + dt (D Lap(g_in) + jt)
// zw [k k 2][H W] and g_in [H, W, 2]; `diff` points at [Du, Dv] (the head of
// both the tail of pi_tail_2d and the packed vector of pack_pi_params_2d).
template <int KS>
__device__ __forceinline__ void gather_update(const float* __restrict__ zw,
                                              const float2* __restrict__ g_in,
                                              const float* __restrict__ diff,
                                              float2* __restrict__ g, int H, int W, float dt,
                                              float inv_dx2, int idx) {
  const int cells = H * W;
  const int i = idx / W;
  const int j = idx - i * W;
  auto wrap = [](int x, int n) { x %= n; return x < 0 ? x + n : x; };
  constexpr int r = KS / 2;
  float ju = 0.0f, jv = 0.0f;
#pragma unroll
  for (int ki = 0; ki < KS; ++ki) {
    const int row = wrap(i + r - ki, H) * W;
#pragma unroll
    for (int kj = 0; kj < KS; ++kj) {
      const int n = row + wrap(j + r - kj, W);
      const int tap = ki * KS + kj;
      ju += zw[(2 * tap) * cells + n];
      jv += zw[(2 * tap + 1) * cells + n];
    }
  }
  const float2 c = g_in[idx];
  const float2 a1 = g_in[wrap(i + 1, H) * W + j], a2 = g_in[wrap(i - 1, H) * W + j];
  const float2 a3 = g_in[i * W + wrap(j + 1, W)], a4 = g_in[i * W + wrap(j - 1, W)];
  const float2 b1 = g_in[wrap(i + 2, H) * W + j], b2 = g_in[wrap(i - 2, H) * W + j];
  const float2 b3 = g_in[i * W + wrap(j + 2, W)], b4 = g_in[i * W + wrap(j - 2, W)];
  const float lap_u = (-5.0f * c.x + (4.0f / 3.0f) * (a1.x + a2.x + a3.x + a4.x) -
                       (1.0f / 12.0f) * (b1.x + b2.x + b3.x + b4.x)) * inv_dx2;
  const float lap_v = (-5.0f * c.y + (4.0f / 3.0f) * (a1.y + a2.y + a3.y + a4.y) -
                       (1.0f / 12.0f) * (b1.y + b2.y + b3.y + b4.y)) * inv_dx2;
  g[idx] = make_float2(c.x + dt * (diff[0] * lap_u + ju), c.y + dt * (diff[1] * lap_v + jv));
}

}  // namespace kxk
