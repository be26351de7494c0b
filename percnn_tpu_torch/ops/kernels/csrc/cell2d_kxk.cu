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
// T-step loop of launches runs here in C on the caller's stream.
//
// rollout2d_kxk_persistent_kernel replaces the same TPU kernel on every
// field whose staged rows fit a block's shared memory (kxk_plan in
// ../cell2d.py; the per-step kernel above runs past it), and in its
// final-state mode percnn_tpu/ops/pallas/cell2d.py:_final_kernel on the
// same fields (final_plan; final2d_kernel in cell2d.cu past it and with the
// MXU switch off): the whole rollout in one cooperative launch, one block
// an SM, each block owning a fixed run of cells for every step, the branch
// product on the tensor cores in 3xTF32 (kxk_mma.cuh).  Bound on the same
// card with the product at the tensor cores' 495 TFLOP/s dense TF32 (three
// passes) and the rest at the f32 peak: about 0.6 us a step at 100 x 100,
// C = 16 (chip_smoke.py counts both bounds).  Measured by chip_smoke.py on
// an NVIDIA H100 80GB HBM3, 700.00 W, per T = 200 at 100 x 100: 0.848 ms,
// one launch, 4.24 us a step (a grid barrier alone is 1.12 us);
// rollout2d_kxk_kernel 2.264 ms in the same call.  The final-state mode
// over Burgers' 1200-step serving horizon: 5.068 ms, one launch, 4.22 us a
// step, against 23.002 ms for final2d_kernel<5, 3> (one launch a step,
// FFMA) in the same call.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "kxk_common.cuh"
#include "kxk_mma.cuh"

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

namespace cg = cooperative_groups;

// The whole rollout in one cooperative launch.  Block b owns the cells of
// share_of (kxk_mma.cuh) for every step; warp w takes equation o = w % 2 of
// the 16-cell tiles w / 2, w / 2 + pairs, ...  Before the loop the block
// stages the forward operand (pack_mma_fwd_2d, split into hi and lo) and the
// tail.  A step t: stage frame t's rows that the block's cells touch, then
// per tile and equation the 3xTF32 branch product into registers, the
// branch product and the w_out sum in registers (two shfl_xor), and lanes
// t = 0 and 1 of each group write equation o of frame t + 1 at cells g and
// g + 8.  One grid.sync() a step makes frame t + 1 visible.
//
// With final_only (the final-state request, in place of _final_kernel) no
// frame is stored: `out` is the final state [H, W, 2], and the steps
// ping-pong between it and `scratch` ([H, W, 2]): step s reads h0 (s = 0)
// or what step s - 1 wrote, and writes `out` when n_steps - 1 - s is even,
// else `scratch` (final_schedule in ../cell2d.py; final_state in cell2d.cu
// keeps the same order), so the last step writes `out`.  The arithmetic is
// the frames path's, so the final state equals the last frame to the bit.
// The buffers are rewritten, every other step, at the addresses that step
// s - 2 read (the frames path never reuses an address); one grid.sync() a
// step is still enough: step s writes only the buffer that step s - 1
// read, and every block staged step s - 1's rows (stage_rows, then
// __syncthreads) before the barrier that ended step s - 1, which step s's
// writes come after.  The rows are loaded with __ldcg, through L2, and the
// buffers take no const __restrict__, so no load can be served from a
// stale line of an SM's L1.  The flag is an argument, not a template
// parameter, so one compiled kernel serves both requests.
template <int KS, int NB, int CH>
__global__ void __launch_bounds__(kxk_mma::kMaxThreads, 1)
    rollout2d_kxk_persistent_kernel(const float* __restrict__ bfrag,
                                    const float* __restrict__ tail, const float2* h0,
                                    float2* out, float2* scratch, int n_steps, int final_only,
                                    int H, int W, int hidden, float dt, float inv_dx2) {
  using namespace kxk_mma;
  using D = Dims<KS, NB, CH>;
  cg::grid_group grid = cg::this_grid();
  const int cells = H * W;
  const Share sh = share_of(cells, W);
  extern __shared__ uint4 smem_fwd[];
  uint4* sb = smem_fwd;                                                // [K8][2 NT][32]
  float* st = reinterpret_cast<float*>(sb + D::kK8 * 2 * D::kNT * 32);  // [kTail]
  float2* tile = reinterpret_cast<float2*>(st + D::kTail);             // [rows][W + 4]
  stage_fragments(sb, bfrag, D::kK8 * 2 * D::kNT * 32);
  stage_tail<D::kC8>(st, tail, hidden);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o = warp & 1, pair = warp >> 1, pairs = blockDim.x >> 6;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_tiles = (sh.n_own + kTile - 1) / kTile;
  int off[D::kK8][2];
  tap_offsets<KS>(W, t4, off);
  const float* tf = reinterpret_cast<const float*>(tile);

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
    stage_rows(tile, src, H, W, sh);
    __syncthreads();
    float* next = reinterpret_cast<float*>(dst);
    for (int tl = pair; tl < n_tiles; tl += pairs) {
      const int r0 = tl * kTile + g, r1 = r0 + 8;
      const int idx0 = sh.first + min(r0, sh.n_own - 1);
      const int idx1 = sh.first + min(r1, sh.n_own - 1);
      float acc[D::kNT][4];
      branch_product<KS, NB, CH>(sb, tf, tap_base<KS>(idx0, W, sh.row0),
                                 tap_base<KS>(idx1, W, sh.row0), off, o, lane, acc);
      // Pi_o = sum_c w_out[c] prod_i y_i + b_out: this lane's 2 CH channels
      // of cells g (p0) and g + 8 (p1), then the 4 lanes of the group
      float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float prod = acc[ch][e];
#pragma unroll
          for (int i = 1; i < NB; ++i) prod *= acc[i * CH + ch][e];
          const float w = st[2 + o * D::kC8 + 8 * ch + 2 * t4 + (e & 1)];
          if (e < 2) p0 = fmaf(w, prod, p0);
          else p1 = fmaf(w, prod, p1);
        }
      }
      p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
      p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
      p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
      p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
      const int r = t4 == 0 ? r0 : r1;
      if (t4 < 2 && r < sh.n_own) {
        const int idx = sh.first + r;
        const int ctr = centre(idx, W, sh.row0) + o;
        const float pi = (t4 == 0 ? p0 : p1) + st[2 + 2 * D::kC8 + o];
        next[idx * 2 + o] = tf[ctr] + dt * (st[o] * lap_at(tf, ctr, W, inv_dx2) + pi);
      }
    }
    grid.sync();
  }
}

// Shared memory of rollout2d_kxk_persistent_kernel<KS, NB, CH> on `blocks`
// blocks: the split operand, the tail and the most staged rows of a block
// (kxk_plan in ../cell2d.py computes the same).
template <int KS, int NB, int CH>
size_t persistent_smem(int H, int W, int blocks) {
  using D = kxk_mma::Dims<KS, NB, CH>;
  return 16 * D::kK8 * 2 * D::kNT * 32 + 4 * D::kTail + kxk_mma::tile_bytes(H, W, blocks);
}

template <int KS, int NB, int CH>
cudaError_t persistent_occupancy(size_t smem, int threads, int* per_sm) {
  auto kernel = rollout2d_kxk_persistent_kernel<KS, NB, CH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
}

template <int KS, int NB, int CH>
cudaError_t persistent_rollout(const float* bfrag, const float* tail, const float2* h0,
                               float2* out, float2* scratch, int n_steps, int final_only, int H,
                               int W, int hidden, float dt, float inv_dx2, int blocks,
                               int threads, size_t smem, cudaStream_t stream, int* per_sm) {
  // the plan's bytes must be the kernel's
  if (smem != persistent_smem<KS, NB, CH>(H, W, blocks)) return cudaErrorInvalidValue;
  if (final_only && scratch == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = persistent_occupancy<KS, NB, CH>(smem, threads, per_sm);
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
  void* args[] = {&bfrag, &tail, &h0, &out, &scratch, &n_steps, &final_only, &H, &W, &hidden,
                  &dt, &inv_dx2};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(rollout2d_kxk_persistent_kernel<KS, NB, CH>),
      dim3(blocks), dim3(threads), args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
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

// The same rollout in one cooperative launch of rollout2d_kxk_persistent_kernel
// on `blocks` blocks of `threads` threads with `smem` bytes (kxk_plan: at
// most the card's co-resident count, else cudaErrorCooperativeLaunchTooLarge
// before anything is launched; bytes other than the kernel's own,
// cudaErrorInvalidValue).  bfrag is pack_mma_fwd_2d's [kRow / 8, 2 nb ch, 32,
// 2] operand, ch = ceil(C / 8), 1 or 2.  `out` is frames [n_steps + 1, H, W,
// 2] (frame 0 = h0; `scratch` unused), or with final_only the final state
// [H, W, 2], `scratch` a second [H, W, 2] buffer (h0 copied to `out`, and
// nothing launched, at n_steps = 0).  `per_sm` gets the occupancy query's
// blocks an SM.
extern "C" int cell2d_kxk_rollout_persistent(const void* bfrag, const void* tail,
                                             const void* h0, void* out, void* scratch,
                                             int n_steps, int final_only, int H, int W,
                                             int hidden, int n_branches, int kernel_size, int ch,
                                             float dt, float inv_dx2, int blocks, int threads,
                                             int smem, void* stream, int* per_sm) {
  const float* b = static_cast<const float*>(bfrag);
  const float* t = static_cast<const float*>(tail);
  const float2* h = static_cast<const float2*>(h0);
  float2* f = static_cast<float2*>(out);
  float2* sc = static_cast<float2*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!kxk_mma::valid_grid(blocks, threads, H * W)) return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(smem);
  KXK_MMA_DISPATCH(persistent_rollout, b, t, h, f, sc, n_steps, final_only, H, W, hidden, dt,
                   inv_dx2, blocks, threads, bytes, s, per_sm)
}

// How many blocks of rollout2d_kxk_persistent_kernel an SM holds at once,
// `threads` threads and `smem` bytes a block.
extern "C" int cell2d_kxk_occupancy(int n_branches, int kernel_size, int ch, int threads,
                                    int smem, int* per_sm) {
  const size_t bytes = static_cast<size_t>(smem);
  KXK_MMA_DISPATCH(persistent_occupancy, bytes, threads, per_sm)
}

namespace {

// A measurement kernel, on no path: n grid.sync()s of an empty cooperative
// grid, the barrier a step of the one-launch kernels alone.
__global__ void grid_barrier_kernel(int n) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int s = 0; s < n; ++s) grid.sync();
}

}  // namespace

// n grid barriers of `blocks` blocks of `threads` threads in one cooperative launch.
extern "C" int kxk_grid_barrier(int n, int blocks, int threads, void* stream) {
  void* args[] = {&n};
  cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(grid_barrier_kernel),
                                                dim3(blocks), dim3(threads), args, 0,
                                                static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}
