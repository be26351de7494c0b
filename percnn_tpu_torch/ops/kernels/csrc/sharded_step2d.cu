// One forward-Euler step of a 2D two-channel Pi cell (any odd k <= 5) on one
// block of a domain-decomposed field: the block arrives with a 2-cell halo
// that the exchange (../../../parallel/halo.py) filled from its neighbours,
//   xp [h + 4, w + 4, 2] f32  ->  out [h, w, 2] f32,
//   out = xp_int + dt (D * Lap4(xp) + Pi(xp))
// with the 4th-order 5-point Laplacian and the Pi block of cell2d.cu, read
// straight from the halo: nothing wraps.  At k = 5 the branch convs read
// the halo's corners, which hold the diagonal neighbours' cells because the
// exchange goes one axis after the other.  The packed parameters follow
// pack_pi_params_2d in ../cell2d.py (164 floats for the GS2D cell, 4932 for
// the Burgers cell).
//
// step2d_haloed_kernel replaces
// percnn_tpu/ops/pallas/sharded_step2d.py:_step_kernel (pallas_call in
// _pallas_step).  The TPU kernel's channel-first [2, Hp, Wp] layout and its
// (8, 128) padding are not carried over: the block stays channels-last,
// read as float2.
//
// The step is cell2d_step.cuh's, the one rollout2d_kernel, final2d_kernel
// and rollout2d_batched_kernel run, with the Haloed grid in place of the
// Periodic one: one thread a cell at k = 1; at k = 3, 5 a block of 256
// threads an 8 x 16 tile, two threads a cell, the tile staged with its
// halo from the block (zero past the block's edge, read only by the
// tile's masked cells, so a block narrower than a tile is right).
//
// Bound on an H100 SXM at its 700 W power limit (published peaks: 3.35 TB/s,
// 67 TFLOP/s f32 outside the tensor cores), GS2D 100 x 100 on a 2 x 2 mesh,
// four 50 x 50 blocks a step:
//   bytes: 4 x 54^2 cells in and 4 x 50^2 out at 8 bytes, 173 KB, 52 ns;
//   operations: about 290 flops a cell, 2.9 MFLOP, 43 ns.
// What bounds it is neither: one launch a block and step, each a few
// microseconds of launch and the host's exchange around it (two slices, two
// copies and a cat per block and axis).  chip_smoke.py measures both.
// Cutting them (the exchange and the step in one launch over all blocks,
// or a persistent kernel) is later work.

#include <cuda_runtime.h>

#include "cell2d_step.cuh"

namespace {

using step2d::Haloed;
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
