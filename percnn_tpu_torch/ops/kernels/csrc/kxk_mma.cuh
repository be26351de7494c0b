// What the one-launch k x k Pi-cell kernels share: rollout2d_kxk_persistent_kernel
// (cell2d_kxk.cu) and adj2d_kxk_persistent_kernel (backward2d_kxk.cu) run a
// whole rollout or reverse sweep in one cooperative launch, one block an SM,
// and form the branch activations on the tensor cores.
//
// Precision: 3xTF32.  Each f32 operand a is split into hi = tf32(a) (round to
// nearest, ties away: cvt.rna) and lo = tf32(a - hi); a product is
// lo_a hi_b + hi_a lo_b, then hi_a hi_b, accumulated in f32 by
// mma.sync.aligned.m16n8k8 (lo_a lo_b, about 2^-22 of the product, is
// dropped).  One TF32 pass alone keeps 11 bits and fails the f32 bars.
//
// The mapping puts the cells on the M side.  A warp takes a tile of 16 cells
// (rows g and g + 8 of the m16n8k8 fragments, g = lane / 4) and one equation o:
//   y^T [16 cells x 8 nb CH] = im2col^T [16 x K] . Wm^T [K x 8 nb CH]
// with K the forward's kRow (taps, the ones column, zeros) and C padded to
// 8 CH (the padded rows of Wm and entries of w_out are zero).  Accumulator
// element e of n-tile n = i CH + ch holds y of cell g + 8 (e / 2) at hidden
// channel c = 8 ch + 2 t + (e % 2) (t = lane % 4), for branch i: every
// branch of (o, c) lies in one thread, so the branch product and the w_out
// sum stay in registers, the sum over c ending in two shfl_xor over the 4
// lanes of a group.  The adjoint's second product
//   zw^T [16 x Q] = z^T [16 x 8 nb CH] . Wm_taps [8 nb CH x Q]
// (Q the k k 2 tap columns padded to 8) takes z^T as its A operand straight
// from the accumulator: A's column t of a k-step is accumulator column 2 t
// and column t + 4 is 2 t + 1, so the B operand's rows are permuted within
// each group of 8 (pack_mma_adj_2d in ../cell2d.py).  The B operands come
// packed in fragment order (pack_mma_fwd_2d, pack_mma_adj_2d): [steps][n-tiles]
// [32 lanes][b0, b1] f32, split into hi and lo once, at staging, into
// [steps][n-tiles][32] uint4 {hi b0, hi b1, lo b0, lo b1} in shared memory.
//
// Block b owns the cells [first, first + n_own) of the row-major H x W field
// (split_evenly in ../cell2d.py) for the whole call.  A step stages the rows
// its cells touch, with 2 rows and 2 columns of periodic halo, from the
// current frame in global memory (L2-resident) into shared memory:
// [rows][W + 4] float2.  Data written by other blocks during the launch is
// read with __ldcg (L2, not the SM's L1) after the grid barrier.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "kxk_common.cuh"

namespace kxk_mma {

using kxk::kHalo;
using kxk::Shape;

// warp pairs (one per equation) a block: 384 threads leave a thread 170
// registers, so the sweep's accumulators do not spill
constexpr int kMaxPairs = 6;
constexpr int kMaxThreads = 64 * kMaxPairs;  // 384
constexpr int kTile = 16;                    // cells of one m16 tile

template <int KS, int NB, int CH>
struct Dims {
  static constexpr int kTaps = KS * KS * 2;
  static constexpr int kK8 = Shape<KS>::kRow / 8;  // k-steps of the branch product
  static constexpr int kC8 = 8 * CH;               // hidden channels, padded
  static constexpr int kNT = NB * CH;              // n-tiles of one equation
  static constexpr int kQT = (kTaps + 7) / 8;      // n-tiles of the adjoint product
  static constexpr int kTail = (4 + 2 * kC8 + 3) / 4 * 4;  // D, w_out (2 x C8), b_out
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a . b on one m16n8k8 tile, TF32 in, f32 out.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: d += a_lo b_hi + a_hi b_lo, then a_hi b_hi; b = {hi b0, hi b1, lo b0, lo b1}.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4], uint4 b) {
  mma(d, lo, b.x, b.y);
  mma(d, hi, b.z, b.w);
  mma(d, hi, b.x, b.y);
}

// The A fragment of four f32 values, split.
__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(a[e], hi[e], lo[e]);
}

// B operands from fragment order in global memory into shared memory, split.
__device__ __forceinline__ void stage_fragments(uint4* dst, const float* __restrict__ src,
                                                int n) {
  const float2* s2 = reinterpret_cast<const float2*>(src);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float2 b = s2[e];
    uint32_t h0, l0, h1, l1;
    split(b.x, h0, l0);
    split(b.y, h1, l1);
    dst[e] = make_uint4(h0, h1, l0, l1);
  }
}

// [Du, Dv], w_out of both equations padded to C8 with zeros, b_out: from the
// tail of pi_tail_2d ([Du, Dv], w_out (2 x C), b_out (2)).
template <int C8>
__device__ __forceinline__ void stage_tail(float* st, const float* __restrict__ tail,
                                           int hidden) {
  for (int e = threadIdx.x; e < 4 + 2 * C8; e += blockDim.x) {
    float v;
    if (e < 2) {
      v = tail[e];
    } else if (e < 2 + 2 * C8) {
      const int o = (e - 2) / C8, c = e - 2 - o * C8;
      v = c < hidden ? tail[2 + o * hidden + c] : 0.0f;
    } else {
      v = tail[2 + 2 * hidden + (e - 2 - 2 * C8)];
    }
    st[e] = v;
  }
}

// x mod n for -2 <= x < n + 2 (a cell index and an offset of at most 2),
// without a division.
__device__ __forceinline__ int wrap2(int x, int n) {
  x += x < 0 ? n : 0;
  x += x < 0 ? n : 0;
  x -= x >= n ? n : 0;
  x -= x >= n ? n : 0;
  return x;
}

// Block b's cells, [first, first + n_own), and the rows it stages: rows
// row0 - 2 .. row0 + rows - 3 of the field (mod H), rows = the rows its
// cells span + 4.
struct Share {
  int first, n_own, row0, rows;
};

__device__ __forceinline__ Share share_of(int cells, int W) {
  const int nblk = gridDim.x, b = blockIdx.x;
  const int q = cells / nblk, m = cells % nblk;
  Share s;
  s.n_own = q + (b < m ? 1 : 0);
  s.first = b * q + (b < m ? b : m);
  s.row0 = s.first / W;
  s.rows = (s.first + s.n_own - 1) / W - s.row0 + 1 + 2 * kHalo;
  return s;
}

// The same share for block b of a run of nblk blocks (the ensemble's
// kernels split the grid into runs, one a member).  share_of keeps its own
// body: written as a call of this one, it changed the machine code of every
// kernel that calls it.
__device__ __forceinline__ Share share_of_run(int cells, int W, int nblk, int b) {
  const int q = cells / nblk, m = cells % nblk;
  Share s;
  s.n_own = q + (b < m ? 1 : 0);
  s.first = b * q + (b < m ? b : m);
  s.row0 = s.first / W;
  s.rows = (s.first + s.n_own - 1) / W - s.row0 + 1 + 2 * kHalo;
  return s;
}

// The staged rows of `frame` ([H, W] float2) into tile [s.rows][W + 4],
// wrapped (rows row0 - 2 .. at most H + 1, columns -2 .. W + 1).  The
// caller synchronises.
__device__ __forceinline__ void stage_rows(float2* tile, const float2* frame, int H, int W,
                                           const Share& s) {
  const int tw = W + 2 * kHalo;
  const int n = s.rows * tw;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / tw;
    const int c = e - r * tw;
    tile[e] = __ldcg(frame + wrap2(s.row0 - kHalo + r, H) * W + wrap2(c - kHalo, W));
  }
}

// Float offset in the staged tile of cell idx's first tap (ki = kj = 0,
// cin = 0), and of its centre.
template <int KS>
__device__ __forceinline__ int tap_base(int idx, int W, int row0) {
  constexpr int r = KS / 2;
  const int i = idx / W;
  const int j = idx - i * W;
  return ((i - row0 + kHalo - r) * (W + 2 * kHalo) + j + kHalo - r) * 2;
}

__device__ __forceinline__ int centre(int idx, int W, int row0) {
  const int i = idx / W;
  const int j = idx - i * W;
  return ((i - row0 + kHalo) * (W + 2 * kHalo) + j + kHalo) * 2;
}

// This lane's im2col columns of each k-step: column q = 8 ks + t + 4 h, as a
// float offset from tap_base, or -1 for the ones column and -2 past it.
template <int KS>
__device__ __forceinline__ void tap_offsets(int W, int t, int (&off)[Shape<KS>::kRow / 8][2]) {
  constexpr int kTaps = KS * KS * 2;
  const int tw = W + 2 * kHalo;
#pragma unroll
  for (int ks = 0; ks < Shape<KS>::kRow / 8; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 8 * ks + t + 4 * h;
      const int tap = q >> 1;
      const int ki = tap / KS;
      off[ks][h] = q < kTaps ? (ki * tw + tap - ki * KS) * 2 + (q & 1) : (q == kTaps ? -1 : -2);
    }
  }
}

template <int KS>
__device__ __forceinline__ float im2col_at(const float* tile, int base, int off, bool past_taps) {
  if (!past_taps) return tile[base + off];
  return off >= 0 ? tile[base + off] : (off == -1 ? 1.0f : 0.0f);
}

// y^T of one tile and equation o: acc[n][e] for n-tile n = i CH + ch, cells
// at tap_base base0 (row g) and base1 (row g + 8).
template <int KS, int NB, int CH>
__device__ __forceinline__ void branch_product(const uint4* sb, const float* tile, int base0,
                                               int base1,
                                               const int (&off)[Shape<KS>::kRow / 8][2],
                                               int o, int lane,
                                               float (&acc)[NB * CH][4]) {
  using D = Dims<KS, NB, CH>;
#pragma unroll
  for (int n = 0; n < D::kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < D::kK8; ++ks) {
    const bool past = 8 * ks + 7 >= D::kTaps;
    const float a[4] = {im2col_at<KS>(tile, base0, off[ks][0], past),
                        im2col_at<KS>(tile, base1, off[ks][0], past),
                        im2col_at<KS>(tile, base0, off[ks][1], past),
                        im2col_at<KS>(tile, base1, off[ks][1], past)};
    uint32_t hi[4], lo[4];
    split4(a, hi, lo);
    const uint4* row = sb + (ks * 2 * D::kNT + o * D::kNT) * 32 + lane;
#pragma unroll
    for (int n = 0; n < D::kNT; ++n) mma3(acc[n], hi, lo, row[n * 32]);
  }
}

// The 4th-order Laplacian's 5-point cross at float offset ctr of the tile
// (one channel), in the order of kxk::tile_lap.
__device__ __forceinline__ float lap_at(const float* t, int ctr, int W, float inv_dx2) {
  const int row = 2 * (W + 2 * kHalo);
  const float s1 = t[ctr + row] + t[ctr - row] + t[ctr + 2] + t[ctr - 2];
  const float s2 = t[ctr + 2 * row] + t[ctr - 2 * row] + t[ctr + 4] + t[ctr - 4];
  return (-5.0f * t[ctr] + (4.0f / 3.0f) * s1 - (1.0f / 12.0f) * s2) * inv_dx2;
}

// Bytes of the most staged rows of a block on `blocks` blocks: a run of cap
// cells spans at most (cap + W - 2) / W + 1 rows, plus 2 halo rows above
// and below, each W + 4 float2.
inline size_t tile_bytes(int H, int W, int blocks) {
  const int cells = H * W;
  const int cap = (cells + blocks - 1) / blocks;
  const int rows = (cap + W - 2) / W + 1 + 2 * kHalo;
  return 8 * static_cast<size_t>(rows) * (W + 2 * kHalo);
}

inline bool valid_grid(int blocks, int threads, int cells) {
  return blocks >= 1 && blocks <= cells && threads >= 64 && threads <= kMaxThreads &&
         threads % 64 == 0;
}

// A cooperative grid must be co-resident; one past it would be refused.
inline cudaError_t check_coresident(int blocks, int per_sm) {
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  return blocks > per_sm * sms ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

}  // namespace kxk_mma

// (kernel_size, n_branches, ch) of the caller's scope -> return F<KS, NB, CH>(...),
// or cudaErrorInvalidValue for widths the one-launch kernels are not built
// for (k = 3 or 5, 1 to 4 branches, C up to 16: ch = ceil(C / 8) = 1 or 2).
#define KXK_MMA_DISPATCH(F, ...)                  \
  switch (kernel_size * 100 + n_branches * 10 + ch) { \
    case 311: return F<3, 1, 1>(__VA_ARGS__);     \
    case 312: return F<3, 1, 2>(__VA_ARGS__);     \
    case 321: return F<3, 2, 1>(__VA_ARGS__);     \
    case 322: return F<3, 2, 2>(__VA_ARGS__);     \
    case 331: return F<3, 3, 1>(__VA_ARGS__);     \
    case 332: return F<3, 3, 2>(__VA_ARGS__);     \
    case 341: return F<3, 4, 1>(__VA_ARGS__);     \
    case 342: return F<3, 4, 2>(__VA_ARGS__);     \
    case 511: return F<5, 1, 1>(__VA_ARGS__);     \
    case 512: return F<5, 1, 2>(__VA_ARGS__);     \
    case 521: return F<5, 2, 1>(__VA_ARGS__);     \
    case 522: return F<5, 2, 2>(__VA_ARGS__);     \
    case 531: return F<5, 3, 1>(__VA_ARGS__);     \
    case 532: return F<5, 3, 2>(__VA_ARGS__);     \
    case 541: return F<5, 4, 1>(__VA_ARGS__);     \
    case 542: return F<5, 4, 2>(__VA_ARGS__);     \
    default: return cudaErrorInvalidValue;        \
  }
