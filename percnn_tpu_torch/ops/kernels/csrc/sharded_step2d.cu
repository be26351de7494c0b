// One forward-Euler step of a 2D two-channel Pi cell (any odd k <= 5) on the
// blocks of a domain-decomposed periodic field, out = x + dt (D * Lap4(x) +
// Pi(x)) on each block's cells, with the 4th-order 5-point Laplacian and the
// Pi block of cell2d.cu; the packed parameters follow pack_pi_params_2d in
// ../cell2d.py (164 floats for the GS2D cell, 4932 for the Burgers cell).
// All three kernels replace percnn_tpu/ops/pallas/sharded_step2d.py:
// _step_kernel (pallas_call in _pallas_step); the TPU kernel's
// channel-first [2, Hp, Wp] layout and its (8, 128) padding are not carried
// over: blocks stay channels-last, read as float2.  Each runs
// cell2d_step.cuh's step, the one rollout2d_kernel, final2d_kernel and
// rollout2d_batched_kernel run, on another Grid: one thread a cell at k = 1;
// at k = 3, 5 a block of 256 threads an 8 x 16 tile, two threads a cell, the
// tile staged with its halo (zero past the block's edge, read only by the
// tile's masked cells, so a block narrower than a tile is right).
//
// step2d_haloed_kernel (the Haloed grid), one block already extended by the
// exchange (../../../parallel/halo.py), xp [h + 4, w + 4, 2] -> out [h, w, 2],
// read without a wrap.  At k = 5 the branch convs read the halo's corners,
// which hold the diagonal neighbours' cells because the exchange goes one
// axis after the other.  One launch a block and step: the one-block
// counterpart of pallas_step_haloed (step_haloed_2d in ../sharded_step2d.py).
//
// step2d_blocks_kernel (the Blocks grid), every block of one device in one
// launch (blockIdx.z the block): a table gives each block where the nine
// regions of its haloed block lie, so it reads a neighbour on the same
// device in place, and one on another device from the 2-cell edge rows,
// columns and 2 x 2 corners the wrapper copied into a strips buffer before
// the launch; nothing copies a whole block.  The state is [nb, h, w, 2],
// the device's blocks in mesh order.  The halo cells, corners included,
// are those the axis-by-axis exchange puts there, so each output is the
// Haloed step's to the bit.  At k = 1 a CUDA block takes one row segment of
// a block (up to 256 cells) and stages the 5 rows around it in shared
// memory; at k > 1 the tile is staged through the table.  One launch a
// device and step.
//
// rollout2d_blocks_kernel, every block on one device through all n_steps
// in one cooperative launch, one grid barrier a step: step t reads frame t
// of the assembled frames [n_steps + 1, H, W, 2] and writes frame t + 1 (the
// table points into a frame), so the frames are the double buffer and
// nothing is stacked or joined.  Occupancy is checked before the launch.
//
// Bound on an H100 SXM at its 700 W power limit (published peaks: 3.35 TB/s,
// 67 TFLOP/s f32 outside the tensor cores), the rollout's work counted once
// as row 1's is: GS2D 100 x 100 (2 x 2 blocks of 50 x 50), T = 200,
//   operations: about 290 flops a cell and step, 0.58 GFLOP, 8.7 us;
//   bytes: h0 and the parameters in, 201 frames of 80 KB out, 16 MB, 4.8 us.
// step2d_haloed_kernel's rollout was paced by neither: one launch a block and
// step, and the host's exchange around it (two slices, two copies and a cat
// a block and axis).  The one-launch route pays one grid barrier a step
// (about 1.1 us on 132 SMs) and a block's staging; the per-step route, one
// launch and one strips gather a device and step.  chip_smoke.py times all
// three.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cell2d_step.cuh"

namespace {

namespace cg = cooperative_groups;

using step2d::Blocks;
using step2d::Haloed;
using step2d::kRegions;
using step2d::Launch;
using step2d::launch_shape;
using step2d::step;

template <int KS, int NB>
__global__ void step2d_haloed_kernel(const float* __restrict__ params, int n_params,
                                     const float2* __restrict__ xp, float2* __restrict__ out,
                                     int H, int W, int hidden, int n_branches, float dt,
                                     float inv_dx2) {
  step<KS, NB, Haloed>(params, n_params, xp, out, H, W, hidden, n_branches, dt, inv_dx2);
}

template <int KS, int NB>
cudaError_t haloed_step(const float* params, int n_params, const float2* xp, float2* out,
                        int H, int W, int hidden, int n_branches, float dt, float inv_dx2,
                        cudaStream_t s) {
  const Launch shape = launch_shape<KS>(n_params, H, W);
  cudaError_t err = cudaFuncSetAttribute(step2d_haloed_kernel<KS, NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         shape.smem);
  if (err != cudaSuccess) return err;
  step2d_haloed_kernel<KS, NB><<<shape.grid, shape.block, shape.smem, s>>>(
      params, n_params, xp, out, H, W, hidden, n_branches, dt, inv_dx2);
  return cudaGetLastError();
}

// One step of block blockIdx.z of the launch from `table` (kRegions int4s a
// block, Blocks's): src holds the state (or a frame), strips the cells
// copied from other devices, out the output buffer.  k = 1: euler_step on
// the row segment (blockIdx.y, blockIdx.x * blockDim.x ..), its 5 rows
// staged after the parameters in shared memory; k > 1: euler_step_kxk on
// the block, tile (blockIdx.y, blockIdx.x).
template <int KS, int NB>
__device__ __forceinline__ void blocks_step(const float* __restrict__ params, int n_params,
                                            const float2* src, const float2* strips,
                                            float2* out, const int4* __restrict__ table,
                                            int h, int w, int hidden, int n_branches,
                                            float dt, float inv_dx2) {
  const int4* region = table + blockIdx.z * kRegions;
  const int4 o = __ldg(region + kRegions - 1);
  if constexpr (KS == 1) {
    extern __shared__ float4 smem_blocks[];
    float2* tile =
        reinterpret_cast<float2*>(reinterpret_cast<float*>(smem_blocks) + (n_params + 3) / 4 * 4);
    const Blocks g{1, w, h, w, o.z, region, src, strips, static_cast<int>(blockIdx.y),
                   static_cast<int>(blockIdx.x * blockDim.x)};
    g.stage_rows(tile);
    step2d::euler_step(params, n_params, tile, out + o.y + g.row * o.z, g, hidden, n_branches,
                       dt, inv_dx2);
  } else {
    const Blocks g{h, w, h, w, o.z, region, src, strips, 0, 0};
    step2d::euler_step_kxk<KS, NB>(params, n_params, src, out + o.y, g, hidden, dt, inv_dx2);
  }
}

template <int KS, int NB>
__global__ void step2d_blocks_kernel(const float* __restrict__ params, int n_params,
                                     const float2* src, const float2* strips, float2* out,
                                     const int4* __restrict__ table, int h, int w, int hidden,
                                     int n_branches, float dt, float inv_dx2) {
  blocks_step<KS, NB>(params, n_params, src, strips, out, table, h, w, hidden, n_branches, dt,
                      inv_dx2);
}

// n_steps of every block, frame t -> frame t + 1 of `frames`, one grid
// barrier between steps; frame 0 is written before the launch.
template <int KS, int NB>
__global__ void rollout2d_blocks_kernel(const float* __restrict__ params, int n_params,
                                        float2* frames, const int4* __restrict__ table,
                                        long long frame_cells, int n_steps, int h, int w,
                                        int hidden, int n_branches, float dt, float inv_dx2) {
  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < n_steps; ++t) {
    blocks_step<KS, NB>(params, n_params, frames + t * frame_cells, nullptr,
                        frames + (t + 1) * frame_cells, table, h, w, hidden, n_branches, dt,
                        inv_dx2);
    if (t + 1 < n_steps) grid.sync();
  }
}

// The launch of a blocks step (either kernel): at k = 1 one CUDA block of
// min(256, w rounded up to 32) threads a row segment, (segments, h, nb), with
// the parameters (rounded up to 4 floats) and 5 staged rows of threads + 4
// float2 in shared memory; at k > 1 launch_shape's tiles of the block, nb of
// them in z.  blocks_shape in ../sharded_step2d.py is its copy.
template <int KS>
Launch blocks_shape(int n_params, int n_blocks, int h, int w) {
  if constexpr (KS == 1) {
    const int threads = w < step2d::kThreads ? (w + 31) / 32 * 32 : step2d::kThreads;
    return {dim3((w + threads - 1) / threads, h, n_blocks), dim3(threads),
            static_cast<int>((n_params + 3) / 4 * 4 * sizeof(float) +
                             (2 * kxk::kHalo + 1) * (threads + 2 * kxk::kHalo) * sizeof(float2))};
  } else {
    Launch shape = launch_shape<KS>(n_params, h, w);
    shape.grid.z = n_blocks;
    return shape;
  }
}

template <int KS, int NB>
cudaError_t blocks_step_launch(const float* params, int n_params, const float2* src,
                               const float2* strips, float2* out, const int4* table,
                               int n_blocks, int h, int w, int hidden, int n_branches, float dt,
                               float inv_dx2, cudaStream_t s) {
  const Launch shape = blocks_shape<KS>(n_params, n_blocks, h, w);
  cudaError_t err = cudaFuncSetAttribute(step2d_blocks_kernel<KS, NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         shape.smem);
  if (err != cudaSuccess) return err;
  step2d_blocks_kernel<KS, NB><<<shape.grid, shape.block, shape.smem, s>>>(
      params, n_params, src, strips, out, table, h, w, hidden, n_branches, dt, inv_dx2);
  return cudaGetLastError();
}

// How many CTAs of rollout2d_blocks_kernel an SM holds (per_sm), and
// whether the whole grid fits on the card at once: cudaSuccess, or
// cudaErrorCooperativeLaunchTooLarge for a grid past it.
template <int KS, int NB>
cudaError_t blocks_rollout_fits(int n_params, int n_blocks, int h, int w, int* per_sm) {
  const Launch shape = blocks_shape<KS>(n_params, n_blocks, h, w);
  cudaError_t err = cudaFuncSetAttribute(rollout2d_blocks_kernel<KS, NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         shape.smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, rollout2d_blocks_kernel<KS, NB>,
                                                      shape.block.x, shape.smem);
  if (err != cudaSuccess) return err;
  int device, sms;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long ctas = static_cast<long long>(shape.grid.x) * shape.grid.y * shape.grid.z;
  return ctas <= static_cast<long long>(*per_sm) * sms ? cudaSuccess
                                                        : cudaErrorCooperativeLaunchTooLarge;
}

template <int KS, int NB>
cudaError_t blocks_rollout_launch(const float* params, int n_params, float2* frames,
                                  const int4* table, int n_blocks, int h, int w,
                                  long long frame_cells, int n_steps, int hidden, int n_branches,
                                  float dt, float inv_dx2, cudaStream_t s, int* per_sm) {
  // a cooperative grid must be co-resident; one past it would be refused
  cudaError_t err = blocks_rollout_fits<KS, NB>(n_params, n_blocks, h, w, per_sm);
  if (err != cudaSuccess || n_steps == 0) return err;
  const Launch shape = blocks_shape<KS>(n_params, n_blocks, h, w);
  void* args[] = {&params, &n_params, &frames, &table, &frame_cells, &n_steps, &h, &w,
                  &hidden, &n_branches, &dt, &inv_dx2};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(rollout2d_blocks_kernel<KS, NB>),
                                    shape.grid, shape.block, args, shape.smem, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

#define PERCNN_NB_CASES(CALL) \
  case 1: return CALL(1);     \
  case 2: return CALL(2);     \
  case 3: return CALL(3);     \
  case 4: return CALL(4);     \
  default: return cudaErrorInvalidValue;

}  // namespace

// One step: xp [H + 4, W + 4, 2] -> out [H, W, 2].  The k x k steps are
// compiled for 1 to 4 branches; the 1x1 step takes any.
extern "C" int sharded_step2d(const void* params, int n_params, const void* xp, void* out,
                              int H, int W, int hidden, int n_branches, int kernel_size,
                              float dt, float inv_dx2, void* stream) {
  const float* p = static_cast<const float*>(params);
  const float2* x = static_cast<const float2*>(xp);
  float2* o = static_cast<float2*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define S(KS, NB) haloed_step<KS, NB>(p, n_params, x, o, H, W, hidden, n_branches, dt, inv_dx2, s)
#define S3(NB) S(3, NB)
#define S5(NB) S(5, NB)
  switch (kernel_size) {
    case 1: return S(1, 0);
    case 3: switch (n_branches) { PERCNN_NB_CASES(S3) }
    case 5: switch (n_branches) { PERCNN_NB_CASES(S5) }
    default: return cudaErrorInvalidValue;
  }
#undef S
#undef S3
#undef S5
}

// One step of the nb blocks of one device: src [nb, h, w, 2] (or any buffer
// the table points into), strips [*, 2] (null where no region lies there),
// out as the table's output entries say, table [nb, kRegions] int4.
extern "C" int sharded_blocks_step(const void* params, int n_params, const void* src,
                                   const void* strips, void* out, const void* table,
                                   int n_blocks, int h, int w, int hidden, int n_branches,
                                   int kernel_size, float dt, float inv_dx2, void* stream) {
  const float* p = static_cast<const float*>(params);
  const float2* x = static_cast<const float2*>(src);
  const float2* st = static_cast<const float2*>(strips);
  float2* o = static_cast<float2*>(out);
  const int4* tb = static_cast<const int4*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define S(KS, NB) \
  blocks_step_launch<KS, NB>(p, n_params, x, st, o, tb, n_blocks, h, w, hidden, n_branches, dt, \
                             inv_dx2, s)
#define S3(NB) S(3, NB)
#define S5(NB) S(5, NB)
  switch (kernel_size) {
    case 1: return S(1, 0);
    case 3: switch (n_branches) { PERCNN_NB_CASES(S3) }
    case 5: switch (n_branches) { PERCNN_NB_CASES(S5) }
    default: return cudaErrorInvalidValue;
  }
#undef S
#undef S3
#undef S5
}

// n_steps of the nb blocks of one device in one cooperative launch of
// rollout2d_blocks_kernel: frames [n_steps + 1, frame_cells, 2] with frame 0
// written, the table pointing into a frame.  The occupancy query's CTAs an
// SM go to per_sm; a grid the card cannot hold at once returns
// cudaErrorCooperativeLaunchTooLarge and launches nothing, as n_steps = 0
// does.
extern "C" int sharded_blocks_rollout(const void* params, int n_params, void* frames,
                                      const void* table, int n_blocks, int h, int w,
                                      long long frame_cells, int n_steps, int hidden,
                                      int n_branches, int kernel_size, float dt, float inv_dx2,
                                      void* stream, int* per_sm) {
  const float* p = static_cast<const float*>(params);
  float2* f = static_cast<float2*>(frames);
  const int4* tb = static_cast<const int4*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define S(KS, NB) \
  blocks_rollout_launch<KS, NB>(p, n_params, f, tb, n_blocks, h, w, frame_cells, n_steps, hidden, \
                                n_branches, dt, inv_dx2, s, per_sm)
#define S3(NB) S(3, NB)
#define S5(NB) S(5, NB)
  switch (kernel_size) {
    case 1: return S(1, 0);
    case 3: switch (n_branches) { PERCNN_NB_CASES(S3) }
    case 5: switch (n_branches) { PERCNN_NB_CASES(S5) }
    default: return cudaErrorInvalidValue;
  }
#undef S
#undef S3
#undef S5
}

// The CTAs of rollout2d_blocks_kernel an SM holds at this shape (per_sm),
// and cudaErrorCooperativeLaunchTooLarge where the card cannot hold the
// whole grid.
extern "C" int sharded_blocks_occupancy(int n_params, int n_blocks, int h, int w, int n_branches,
                                        int kernel_size, int* per_sm) {
#define S(KS, NB) blocks_rollout_fits<KS, NB>(n_params, n_blocks, h, w, per_sm)
#define S3(NB) S(3, NB)
#define S5(NB) S(5, NB)
  switch (kernel_size) {
    case 1: return S(1, 0);
    case 3: switch (n_branches) { PERCNN_NB_CASES(S3) }
    case 5: switch (n_branches) { PERCNN_NB_CASES(S5) }
    default: return cudaErrorInvalidValue;
  }
#undef S
#undef S3
#undef S5
}
