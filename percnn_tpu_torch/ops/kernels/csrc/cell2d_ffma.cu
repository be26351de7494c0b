// The whole frames rollout of a k x k Pi cell (k = 3 or 5: the Burgers and
// lambda-omega Stage-1 cells, 5 x 5, C = 16, 3 branches) in one cooperative
// launch, the branch convs tap by tap in FFMA (no tensor cores): the route
// of ../cell2d.py's MXU_FWD_ENABLED off.  The step is cell2d.cu's (the
// Laplacian, the branch activations, the Pi block, the Euler update); the
// state is channels-last [H, W, 2] f32.
//
// rollout2d_ffma_persistent_kernel replaces percnn_tpu/ops/pallas/cell2d.py:
// _rollout_kernel (pallas_call in _fused_rollout_padded) in its k x k form on
// every field whose block fits shared memory (ffma_plan in ../cell2d.py;
// rollout2d_kernel<k>, one launch a step, past it), and in its final-state
// mode _final_kernel (pallas_call in _fused_final_padded) on the same fields
// with the MXU switch off (final_plan; final2d_kernel<k> past it).
//
// Bound on an H100 SXM at its 700 W power limit (published peaks: 3.35 TB/s,
// 67 TFLOP/s f32 outside the tensor cores), Burgers 100 x 100, T = 200: 96
// activations of 51 FMAs a cell and step, about 10 k flops, 0.1 GFLOP a step,
// 1.46 us a step at the f32 peak, against 24 ns for the 80 KB frame written:
// bound by operations (chip_smoke.py counts them).
//
// What the design does about it.  A block's work a step is a small product,
//   y [96 rows (o, c, i)] x [cells] = Wf [96 x 50 taps] . im2col [50 x cells] + b,
// about 372 k FMAs for a block's 76 cells at 100 x 100 on 132 SMs, 1.6 us at
// one SM's FFMA rate, beside the 1.1 us grid barrier.  rollout2d_kernel<5>
// gives a thread one (cell, equation) and reads each weight from shared
// memory as it uses it, one load an FMA; here a thread owns a register tile
// of 4 cells x (2 hidden channels x NB branches) of one equation: a step of
// the product is one float4 of the im2col stack (4 cells) and NB / 2 (rounded
// up) float4s of weights for 8 NB FMAs: 3 loads for 24 FMAs at NB = 3.  A
// warp takes one equation of a 16-cell tile: lane (pair p, group g) holds
// channels 2 p, 2 p + 1 (8 pairs: C <= 16, zero padded) of cells 4 g .. 4 g
// + 3, so the 4 lanes of a pair read one weight float4 (a broadcast) and the
// 8 pairs read 128 consecutive bytes, and the 8 lanes of a group one im2col
// float4.  The branch product and the w_out sum of the lane's 2 channels stay
// in registers, and the sum over the 8 pairs ends in three shfl_xor.
//
// The schedule is rollout2d_kxk_persistent_kernel's (cell2d_kxk.cu): block b
// owns the cells of share_of (kxk_mma.cuh) for every step, warp 2 t + o takes
// equation o of tile t of a round (rounds of at most 8 tiles, 128 cells), and
// a step stages the rows its cells touch, with the 2-cell wrapped halo, from
// L2 with __ldcg, builds the round's im2col stack [taps][cells] in shared
// memory from them, runs the product and writes frame t + 1; one grid.sync()
// a step makes it visible.  Before the loop the block stages the forward
// operand (pack_ffma_fwd_2d: the packed parameters' branch weights and biases
// in the lane order above, 26 KB for the Burgers cell) and the tail
// (pack_ffma_tail_2d).  The sum over taps runs in one chain a row from the
// bias and the sum over channels as a tree, so the frames are not bitwise
// rollout2d_kernel<k>'s, which sums taps in two interleaved chains and
// channels in one; both are held to the plain version at the forward bars.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3, 700.00 W, per
// T = 200 at 100 x 100: 1.107 ms, one launch, 5.53 us a step (a grid barrier
// alone is 1.12 us); rollout2d_kernel<5, 3> 3.867 ms in the same call, in
// turns.  The final-state mode over 1200 steps: 6.256 ms against 23.133 for
// final2d_kernel<5, 3>.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "kxk_common.cuh"
#include "kxk_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using kxk::kHalo;

constexpr int kTileCells = 16;               // cells of a warp's tile
constexpr int kMaxTiles = 8;                 // tiles a round: one warp pair each
constexpr int kMaxThreads = 64 * kMaxTiles;  // 512
constexpr int kPairs = 8;                    // channel pairs: C <= 16
constexpr int kTail = 36;                    // D (2), w_out (2 x 16), b_out (2)

template <int KS, int NB>
struct Dims {
  static constexpr int kTaps = KS * KS * 2;
  static constexpr int kW = (2 * NB + 3) / 4 * 4;  // floats of a (tap, equation, pair)
  static constexpr int kHalves = kW / 4;
  // the forward operand [kTaps + 1][2][kHalves][kPairs][4], row kTaps the biases
  static constexpr int kOperand = (kTaps + 1) * 2 * kW * kPairs;
};

// Float offset of tap q = (ki k + kj) 2 + cin in the staged rows, from the
// cell's first tap (kxk_mma::tap_base).
template <int KS>
__device__ __forceinline__ int tap_offset(int q, int W) {
  const int tap = q >> 1;
  const int ki = tap / KS;
  return (ki * (W + 2 * kHalo) + tap - ki * KS) * 2 + (q & 1);
}

// The whole rollout in one cooperative launch (the design above).  `wf` is
// pack_ffma_fwd_2d's operand, `tail` pack_ffma_tail_2d's.  With final_only
// (the final-state request) no frame is stored: `out` is the final state
// [H, W, 2], and the steps ping-pong between it and `scratch` in
// final_schedule's order (rollout2d_kxk_persistent_kernel's argument holds:
// step s writes only the buffer step s - 1 read, every block staged step
// s - 1's rows before the barrier that ended it, the rows are loaded with
// __ldcg and the buffers take no const __restrict__).  The arithmetic is the
// frames path's, so the final state equals the last frame to the bit.
template <int KS, int NB>
__global__ void __launch_bounds__(kMaxThreads, 1)
    rollout2d_ffma_persistent_kernel(const float* __restrict__ wf,
                                     const float* __restrict__ tail, const float2* h0,
                                     float2* out, float2* scratch, int n_steps, int final_only,
                                     int H, int W, float dt, float inv_dx2) {
  using D = Dims<KS, NB>;
  cg::grid_group grid = cg::this_grid();
  const int cells = H * W;
  const kxk_mma::Share sh = kxk_mma::share_of(cells, W);
  const int tiles = blockDim.x >> 6;
  const int rc = tiles * kTileCells;  // cells of a round
  extern __shared__ float4 smem_ffma[];
  float4* sw = smem_ffma;                                          // the operand
  float* st = reinterpret_cast<float*>(sw + D::kOperand / 4);      // [kTail]
  float* xs = st + kTail;                                          // im2col [kTaps][rc]
  float2* tile = reinterpret_cast<float2*>(xs + D::kTaps * rc);    // [rows][W + 4]
  const float4* wf4 = reinterpret_cast<const float4*>(wf);
  for (int e = threadIdx.x; e < D::kOperand / 4; e += blockDim.x) sw[e] = wf4[e];
  for (int e = threadIdx.x; e < kTail; e += blockDim.x) st[e] = tail[e];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o = warp & 1, tl = warp >> 1;
  const int pair = lane >> 2, grp = lane & 3;
  const int rounds = (sh.n_own + rc - 1) / rc;
  const float* tf = reinterpret_cast<const float*>(tile);
  // the im2col entries a thread builds: cell xc of the round, taps xq0,
  // xq0 + 4, ... (blockDim.x = 4 rc)
  const int xc = threadIdx.x % rc, xq0 = threadIdx.x / rc;
  // this lane's operand float4s at tap 0 (stride kRowF4 a tap) and im2col
  // float4 at tap 0 (stride rc / 4)
  constexpr int kRowF4 = 2 * D::kHalves * kPairs;
  const float4* wlane = sw + o * D::kHalves * kPairs + pair;
  const float4* xlane = reinterpret_cast<const float4*>(xs) + tl * 4 + grp;
  const int xstride = rc / 4;

  for (int s = 0; s < n_steps; ++s) {
    const float2* src;
    float2* dst;
    if (final_only) {
      src = s == 0 ? h0 : ((n_steps - s) % 2 == 0 ? out : scratch);
      dst = (n_steps - 1 - s) % 2 == 0 ? out : scratch;
    } else {
      src = out + static_cast<size_t>(s) * cells;
      dst = out + static_cast<size_t>(s + 1) * cells;
    }
    kxk_mma::stage_rows(tile, src, H, W, sh);
    float* next = reinterpret_cast<float*>(dst);
    for (int rd = 0; rd < rounds; ++rd) {
      const int base = rd * rc;
      __syncthreads();  // the rows staged, or the last round's reads of xs done
      {
        const int k = min(base + xc, sh.n_own - 1);
        const int tb = kxk_mma::tap_base<KS>(sh.first + k, W, sh.row0);
#pragma unroll
        for (int u = 0; u < (D::kTaps + 3) / 4; ++u) {
          const int q = xq0 + 4 * u;
          if (q < D::kTaps) xs[q * rc + xc] = tf[tb + tap_offset<KS>(q, W)];
        }
      }
      __syncthreads();
      // y of 2 channels x NB branches (f = cl NB + i) at 4 cells, from the biases
      float acc[2 * NB][4];
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
      // Pi_o less b_out at the 4 cells: this lane's 2 channels, then the 8 pairs
      const float w0 = st[2 + o * 16 + 2 * pair], w1 = st[3 + o * 16 + 2 * pair];
      float p[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float prod0 = acc[0][m], prod1 = acc[NB][m];
#pragma unroll
        for (int i = 1; i < NB; ++i) {
          prod0 *= acc[i][m];
          prod1 *= acc[NB + i][m];
        }
        p[m] = fmaf(w1, prod1, w0 * prod0);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        p[m] += __shfl_xor_sync(0xffffffffu, p[m], 4);
        p[m] += __shfl_xor_sync(0xffffffffu, p[m], 8);
        p[m] += __shfl_xor_sync(0xffffffffu, p[m], 16);
      }
      // pairs 0 .. 3 of each group write equation o of the group's 4 cells
      const int k = base + tl * kTileCells + grp * 4 + pair;
      if (pair < 4 && k < sh.n_own) {
        const float pm = pair == 0 ? p[0] : (pair == 1 ? p[1] : (pair == 2 ? p[2] : p[3]));
        const int idx = sh.first + k;
        const int ctr = kxk_mma::centre(idx, W, sh.row0) + o;
        const float pi = pm + st[34 + o];
        next[idx * 2 + o] = tf[ctr] + dt * (st[o] * kxk_mma::lap_at(tf, ctr, W, inv_dx2) + pi);
      }
    }
    grid.sync();
  }
}

// Shared memory of rollout2d_ffma_persistent_kernel<KS, NB> on `blocks`
// blocks of `threads` threads: the operand, the tail, the im2col stack of a
// round and the most staged rows of a block (ffma_smem_bytes in
// ../cell2d.py computes the same).
template <int KS, int NB>
size_t persistent_smem(int H, int W, int blocks, int threads) {
  using D = Dims<KS, NB>;
  const size_t rc = static_cast<size_t>(threads / 64) * kTileCells;
  return 4 * (D::kOperand + kTail + D::kTaps * rc) + kxk_mma::tile_bytes(H, W, blocks);
}

template <int KS, int NB>
cudaError_t persistent_occupancy(size_t smem, int threads, int* per_sm) {
  auto kernel = rollout2d_ffma_persistent_kernel<KS, NB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
}

template <int KS, int NB>
cudaError_t persistent_rollout(const float* wf, const float* tail, const float2* h0, float2* out,
                               float2* scratch, int n_steps, int final_only, int H, int W,
                               float dt, float inv_dx2, int blocks, int threads, size_t smem,
                               cudaStream_t stream, int* per_sm) {
  // the plan's bytes must be the kernel's
  if (smem != persistent_smem<KS, NB>(H, W, blocks, threads)) return cudaErrorInvalidValue;
  if (final_only && scratch == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = persistent_occupancy<KS, NB>(smem, threads, per_sm);
  if (err != cudaSuccess) return err;
  err = kxk_mma::check_coresident(blocks, *per_sm);
  if (err != cudaSuccess) return err;
  // frame 0 of the frames, or the final state of no steps: a copy of h0
  if (!final_only || n_steps == 0) {
    const size_t cells = static_cast<size_t>(H) * W;
    err = cudaMemcpyAsync(out, h0, cells * sizeof(float2), cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess || n_steps == 0) return err;
  }
  final_only = final_only ? 1 : 0;
  void* args[] = {&wf, &tail, &h0, &out, &scratch, &n_steps, &final_only, &H, &W, &dt, &inv_dx2};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(rollout2d_ffma_persistent_kernel<KS, NB>), dim3(blocks),
      dim3(threads), args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

inline bool valid_grid(int blocks, int threads, int cells) {
  return blocks >= 1 && blocks <= cells && threads >= 64 && threads <= kMaxThreads &&
         threads % 64 == 0;
}

}  // namespace

// (kernel_size, n_branches) of the caller's scope -> return F<KS, NB>(...), or
// cudaErrorInvalidValue for widths the kernel is not built for (k = 3 or 5,
// 1 to 4 branches; C up to 16 is the operand's padding).
#define FFMA_DISPATCH(F, ...)                     \
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

// The rollout in one cooperative launch of rollout2d_ffma_persistent_kernel on
// `blocks` blocks of `threads` threads with `smem` bytes (ffma_plan: at most
// the card's co-resident count, else cudaErrorCooperativeLaunchTooLarge
// before anything is launched; bytes other than the kernel's own,
// cudaErrorInvalidValue).  wf and tail are pack_ffma_fwd_2d's and
// pack_ffma_tail_2d's.  `out` is frames [n_steps + 1, H, W, 2] (frame 0 =
// h0; `scratch` unused), or with final_only the final state [H, W, 2],
// `scratch` a second [H, W, 2] buffer (h0 copied to `out`, and nothing
// launched, at n_steps = 0).  `per_sm` gets the occupancy query's blocks an
// SM.
extern "C" int cell2d_ffma_rollout_persistent(const void* wf, const void* tail, const void* h0,
                                              void* out, void* scratch, int n_steps,
                                              int final_only, int H, int W, int n_branches,
                                              int kernel_size, float dt, float inv_dx2, int blocks,
                                              int threads, int smem, void* stream, int* per_sm) {
  const float* w = static_cast<const float*>(wf);
  const float* t = static_cast<const float*>(tail);
  const float2* h = static_cast<const float2*>(h0);
  float2* f = static_cast<float2*>(out);
  float2* sc = static_cast<float2*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid_grid(blocks, threads, H * W)) return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(smem);
  FFMA_DISPATCH(persistent_rollout, w, t, h, f, sc, n_steps, final_only, H, W, dt, inv_dx2,
                blocks, threads, bytes, s, per_sm)
}

// How many blocks of rollout2d_ffma_persistent_kernel an SM holds at once,
// `threads` threads and `smem` bytes a block.
extern "C" int cell2d_ffma_occupancy(int n_branches, int kernel_size, int threads, int smem,
                                     int* per_sm) {
  const size_t bytes = static_cast<size_t>(smem);
  FFMA_DISPATCH(persistent_occupancy, bytes, threads, per_sm)
}
