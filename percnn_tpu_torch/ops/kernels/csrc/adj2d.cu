// Reverse sweeps of the forward-Euler 2D Pi-cell rollout that stream the
// adjoint out and leave the parameter gradients to a time-batched pass
// outside (chunked_param_grads or _param_grads_stream in ../backward2d.py).
//
// One reverse step t (t = T-1 .. 0), for every cell x of the periodic H x W
// grid, with m = (o nb + i) C + c and r = k / 2:
//   g_in   = g_{t+1} + fbar_{t+1}                              (g_T = 0)
//   y[m]   = sum_q w_i^o[q, c] im2col(h_t)(x)[q] + b_i^o[c]      (q = (ki k + kj) 2 + cin)
//   z[m]   = w_out_o[c] g_in_o prod_{j != i} y[(o nb + j) C + c]
//   jt_cin = sum_{m, ki, kj} w_i^o[(ki k + kj) 2 + cin, c] z[m](x + (r - ki, r - kj))
//   g_t    = g_in + dt (D Lap(g_in) + jt)
// Outputs: g_ins[t] = g_in [H, W, 2] and, after the sweep, g_0.  The weights
// are the packed vector of pack_pi_params_2d (../cell2d.py) in shared memory.
//
// adj2d_kernel (k = 1) and adj2d_act_kernel + adj2d_gather_kernel (k = 3, 5)
// replace percnn_tpu/ops/pallas/backward2d.py:_phase1_kernel (pallas_call in
// _fused_phase1), which recomputes the Pi Jacobian's transpose from the
// frames; adj2d_ys_act_kernel + adj2d_gather_kernel replace
// _phase1_ys_kernel (pallas_call in _fused_phase1_ys), which reads the
// branch activations y from ys [T, 2 nb C, H, W], precomputed outside the
// sweep by time-batched convolutions (_precompute_ys).
//
// Bounds on an H100 SXM at its 700 W power limit (published peaks: 3.35 TB/s,
// 67 TFLOP/s f32 outside the tensor cores); chip_smoke.py counts them exactly:
//   k = 1, GS2D 100 x 100, C = 8, T = 800: about 600 flops a cell and step,
//          4.8 GFLOP a backward, 72 us; frames, cotangents and g_ins 192 MB,
//          57 us: bound by operations, barely;
//   k = 5, Burgers 100 x 100, C = 16, T = 200: 96 x 51 FMAs for y and 96 x 50
//          for the contraction with the weights, about 20 k flops a cell and
//          step, 39 GFLOP, 0.59 ms, against 48 MB of frames, cotangents and
//          g_ins: bound by operations;
//   ys, the same cell: the contraction alone, about 10 k flops, 0.29 ms,
//          against the 768 MB ys stream read once, 0.23 ms: bound by
//          operations, closely followed by bytes.
// As for every kernel of this port, what limits the design is the chain of
// T dependent steps, one or two launches each.
// What the design does about it: at k = 1 a step is one launch over H*W
// threads, one cell a thread, as pg2d_kernel (backward2d.cu) without its
// accumulators: each thread forms g_in at its 8 stencil neighbours itself
// and g ping-pongs between two buffers, since a neighbour reads the old g.
// At k > 1, z at the neighbours within radius r depends on each neighbour's
// own activations, so a step is two launches, as in adj2d_kxk_kernel
// (backward2d_kxk.cu), with its layout: the activation kernel (8 x 16 tiles
// staged with their halo, two threads a cell, one per equation, each with
// the 50 taps and its equation's 50 partial sums of zw[q] = sum_m w[q, m]
// z[m] in registers, the weights read as shared-memory broadcasts; the two
// equations' sums meet in shared memory) writes g_in and zw [k k 2, H, W];
// the gather kernel (kxk_common.cuh) sums zw over the reversed taps and
// updates g in place.  The ys form reads y instead of the tile and taps, a
// block taking 128 consecutive cells.  The T-step loops of launches run here
// in C on the caller's stream.

#include <cuda_runtime.h>

#include "kxk_common.cuh"
#include "pg_common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float lap5(float c, float a1, float a2, float a3, float a4,
                                      float b1, float b2, float b3, float b4, float inv_dx2) {
  return (-5.0f * c + (4.0f / 3.0f) * (a1 + a2 + a3 + a4) -
          (1.0f / 12.0f) * (b1 + b2 + b3 + b4)) *
         inv_dx2;
}

// k = 1: one reverse step, one cell a thread.
template <int NB>
__global__ void __launch_bounds__(kThreads)
    adj2d_kernel(const float* __restrict__ params, int n_params,
                 const float2* __restrict__ h,       // frame t
                 const float2* __restrict__ fbar,    // cotangent of frame t + 1
                 const float2* __restrict__ g_next,  // g_{t+1}
                 float2* __restrict__ g_out,         // g_t
                 float2* __restrict__ g_in_out,      // g_ins[t]
                 int H, int W, int hidden, float dt, float inv_dx2) {
  extern __shared__ float sp[];
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sp[k] = params[k];
  __syncthreads();

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= H * W) return;
  const int i = idx / W;
  const int j = idx - i * W;
  const int im1 = (i + H - 1) % H, ip1 = (i + 1) % H;
  const int im2 = (i + 2 * H - 2) % H, ip2 = (i + 2) % H;
  const int jm1 = (j + W - 1) % W, jp1 = (j + 1) % W;
  const int jm2 = (j + 2 * W - 2) % W, jp2 = (j + 2) % W;
  // centre, the 4 neighbours at distance 1, the 4 at distance 2
  const int nbr[9] = {idx,         ip1 * W + j, im1 * W + j,
                      i * W + jp1, i * W + jm1, ip2 * W + j,
                      im2 * W + j, i * W + jp2, i * W + jm2};
  float2 gs[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float2 a = g_next[nbr[k]], b = fbar[nbr[k]];
    gs[k] = make_float2(a.x + b.x, a.y + b.y);
  }
  const float lap_gu = lap5(gs[0].x, gs[1].x, gs[2].x, gs[3].x, gs[4].x, gs[5].x,
                            gs[6].x, gs[7].x, gs[8].x, inv_dx2);
  const float lap_gv = lap5(gs[0].y, gs[1].y, gs[2].y, gs[3].y, gs[4].y, gs[5].y,
                            gs[6].y, gs[7].y, gs[8].y, inv_dx2);
  const float gin[2] = {gs[0].x, gs[0].y};
  g_in_out[idx] = gs[0];
  const float2 x = h[idx];
  float du, dv;
  jacobian_t_1x1<NB>(sp, x.x, x.y, gin, hidden, du, dv);
  g_out[idx] = make_float2(gin[0] + dt * (sp[0] * lap_gu + du),
                           gin[1] + dt * (sp[1] * lap_gv + dv));
}

// acc[q] += w[q * hidden] z for the k k 2 taps of one branch's weights.
template <int KS>
__device__ __forceinline__ void accumulate_taps(const float* w, int hidden, float z,
                                                float (&acc)[KS * KS * 2]) {
#pragma unroll
  for (int q = 0; q < KS * KS * 2; ++q) acc[q] = fmaf(w[q * hidden], z, acc[q]);
}

// Form this equation's share of zw[q] = sum_m w[q, m] z[m], the sum over
// its hidden channels and branches, into acc, from the activations that
// y_of(w, i, c) gives (w the branch's weights at hidden channel c).
template <int KS, int NB, class Y>
__device__ __forceinline__ void contract(const float* p, float gin, int hidden, Y y_of,
                                        float (&acc)[KS * KS * 2]) {
  constexpr int kTaps = KS * KS * 2;
  const int wsize = kTaps * hidden;
  const int stride = wsize + hidden;             // per branch: w_i, then b_i
#pragma unroll
  for (int q = 0; q < kTaps; ++q) acc[q] = 0.0f;
  for (int c = 0; c < hidden; ++c) {
    float y[NB], pre[NB + 1], suf[NB + 1];
#pragma unroll
    for (int i = 0; i < NB; ++i) y[i] = y_of(p + i * stride + c, i, c);
    pre[0] = 1.0f;
    suf[NB] = 1.0f;
#pragma unroll
    for (int i = 0; i < NB; ++i) pre[i + 1] = pre[i] * y[i];
#pragma unroll
    for (int i = NB - 1; i >= 0; --i) suf[i] = suf[i + 1] * y[i];
    const float gw = p[NB * stride + c] * gin;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      accumulate_taps<KS>(p + i * stride + c, hidden, gw * (pre[i] * suf[i + 1]), acc);
  }
}

// The two equations' shares meet in shared memory: the o = 1 threads leave
// theirs in xbuf [kTaps][kCells], the o = 0 threads add them and write zw.
// Every thread of the block calls it (it synchronises).
template <int KS>
__device__ __forceinline__ void write_zw(const float (&acc)[KS * KS * 2], float* xbuf, int o,
                                         int cell, bool inside, float* __restrict__ zw,
                                         size_t cells, int idx) {
  constexpr int kTaps = KS * KS * 2;
  if (o == 1) {
#pragma unroll
    for (int q = 0; q < kTaps; ++q) xbuf[q * kxk::kCells + cell] = acc[q];
  }
  __syncthreads();
  if (o == 0 && inside) {
#pragma unroll
    for (int q = 0; q < kTaps; ++q) zw[q * cells + idx] = acc[q] + xbuf[q * kxk::kCells + cell];
  }
}

// Shared memory of the k > 1 first launches: the packed parameters rounded
// up to 4 floats, the staged tile (adj2d_act_kernel only) and xbuf.
template <int KS>
int act_smem_bytes(int n_params, bool tile) {
  return static_cast<int>((n_params + 3) / 4 * 4 * sizeof(float) +
                          (tile ? kxk::kTileLen * sizeof(float2) : 0) +
                          KS * KS * 2 * kxk::kCells * sizeof(float));
}

// k > 1, first launch of a reverse step: g_in and zw at every cell of the
// block's 8 x 16 tile, two threads a cell (one per equation, as in
// adj2d_kxk_kernel), the activations recomputed from frame t.
template <int KS, int NB>
__global__ void __launch_bounds__(kxk::kThreads)
    adj2d_act_kernel(const float* __restrict__ params, int n_params,
                     const float2* __restrict__ h,       // frame t
                     const float2* __restrict__ g_next,  // g_{t+1}
                     const float2* __restrict__ fbar,    // cotangent of frame t + 1
                     float2* __restrict__ g_in_out,      // g_ins[t]
                     float* __restrict__ zw,             // [k k 2][H W]
                     int H, int W, int hidden) {
  extern __shared__ float4 smem[];
  float* sp = reinterpret_cast<float*>(smem);
  float2* tile = reinterpret_cast<float2*>(sp + (n_params + 3) / 4 * 4);
  float* xbuf = reinterpret_cast<float*>(tile + kxk::kTileLen);
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sp[k] = params[k];
  const int i0 = blockIdx.y * kxk::kTileH, j0 = blockIdx.x * kxk::kTileW;
  kxk::stage_tile(tile, h, H, W, i0, j0);
  __syncthreads();

  const int o = threadIdx.x / kxk::kCells;  // the same in every warp
  const int cell = threadIdx.x - o * kxk::kCells;
  const int li = cell / kxk::kTileW, lj = cell - li * kxk::kTileW;
  const int gi = i0 + li, gj = j0 + lj;
  const bool inside = gi < H && gj < W;
  const int idx = gi * W + gj;
  constexpr int kTaps = KS * KS * 2;
  float acc[kTaps];
#pragma unroll
  for (int q = 0; q < kTaps; ++q) acc[q] = 0.0f;
  if (inside) {
    const float gin = reinterpret_cast<const float*>(g_next)[2 * idx + o] +
                      reinterpret_cast<const float*>(fbar)[2 * idx + o];
    reinterpret_cast<float*>(g_in_out)[2 * idx + o] = gin;
    float tap[4 * kxk::Shape<KS>::kQ];
    kxk::gather_taps<KS>(tile, li, lj, tap);
    const float* p = sp + 2 + o * (NB * (kTaps + 1) * hidden + hidden + 1);
    contract<KS, NB>(p, gin, hidden,
                     [&](const float* w, int i, int c) {
                       return kxk::packed_act<KS>(w, hidden, tap);
                     },
                     acc);
  }
  write_zw<KS>(acc, xbuf, o, cell, inside, zw, static_cast<size_t>(H) * W, idx);
}

// k > 1, first launch of a reverse step of the ys form: the activations
// read from ys[t], plane (o nb + i) C + c; a block takes 128 consecutive
// cells, two threads a cell.
template <int KS, int NB>
__global__ void __launch_bounds__(kxk::kThreads)
    adj2d_ys_act_kernel(const float* __restrict__ params, int n_params,
                        const float* __restrict__ ys,       // ys[t], [2 nb C][H W]
                        const float2* __restrict__ g_next,  // g_{t+1}
                        const float2* __restrict__ fbar,    // cotangent of frame t + 1
                        float2* __restrict__ g_in_out,      // g_ins[t]
                        float* __restrict__ zw,             // [k k 2][H W]
                        int H, int W, int hidden) {
  extern __shared__ float4 smem[];
  float* sp = reinterpret_cast<float*>(smem);
  float* xbuf = sp + (n_params + 3) / 4 * 4;
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sp[k] = params[k];
  __syncthreads();

  const int o = threadIdx.x / kxk::kCells;  // the same in every warp
  const int cell = threadIdx.x - o * kxk::kCells;
  const int idx = blockIdx.x * kxk::kCells + cell;
  const size_t cells = static_cast<size_t>(H) * W;
  const bool inside = idx < H * W;
  constexpr int kTaps = KS * KS * 2;
  float acc[kTaps];
#pragma unroll
  for (int q = 0; q < kTaps; ++q) acc[q] = 0.0f;
  if (inside) {
    const float gin = reinterpret_cast<const float*>(g_next)[2 * idx + o] +
                      reinterpret_cast<const float*>(fbar)[2 * idx + o];
    reinterpret_cast<float*>(g_in_out)[2 * idx + o] = gin;
    const float* p = sp + 2 + o * (NB * (kTaps + 1) * hidden + hidden + 1);
    const float* yo = ys + static_cast<size_t>(o * NB * hidden) * cells + idx;
    contract<KS, NB>(p, gin, hidden,
                     [&](const float*, int i, int c) {
                       return yo[static_cast<size_t>(i * hidden + c) * cells];
                     },
                     acc);
  }
  write_zw<KS>(acc, xbuf, o, cell, inside, zw, cells, idx);
}

// k > 1, second launch of a reverse step: jt, Lap(g_in) and g in place.
template <int KS>
__global__ void __launch_bounds__(kThreads)
    adj2d_gather_kernel(const float* __restrict__ zw, const float2* __restrict__ g_in,
                        const float* __restrict__ params, float2* __restrict__ g, int H,
                        int W, float dt, float inv_dx2) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < H * W) kxk::gather_update<KS>(zw, g_in, params, g, H, W, dt, inv_dx2, idx);
}

template <int NB>
cudaError_t sweep_1x1(const float* params, int n_params, const float2* frames,
                      const float2* frames_bar, float2* g0, float2* scratch, float2* g_ins,
                      int n_steps, int H, int W, int hidden, float dt, float inv_dx2,
                      cudaStream_t stream) {
  const size_t cells = static_cast<size_t>(H) * W;
  const int blocks = static_cast<int>((cells + kThreads - 1) / kThreads);
  // Both g buffers start at zero (the wrapper zeroes them).  Step s reads
  // one and writes the other, in the order that makes the last step (t = 0)
  // write g0.
  for (int s = 0; s < n_steps; ++s) {
    const int t = n_steps - 1 - s;
    float2* dst = (t % 2 == 0) ? g0 : scratch;
    const float2* src = (t % 2 == 0) ? scratch : g0;
    adj2d_kernel<NB><<<blocks, kThreads, n_params * sizeof(float), stream>>>(
        params, n_params, frames + t * cells, frames_bar + (t + 1) * cells, src, dst,
        g_ins + t * cells, H, W, hidden, dt, inv_dx2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <int KS, int NB>
cudaError_t sweep_kxk(const float* params, int n_params, const float2* frames,
                      const float2* frames_bar, float2* g, float2* g_ins, float* zw,
                      int n_steps, int H, int W, int hidden, float dt, float inv_dx2,
                      cudaStream_t stream) {
  const size_t cells = static_cast<size_t>(H) * W;
  const int smem = act_smem_bytes<KS>(n_params, true);
  cudaError_t err = cudaFuncSetAttribute(adj2d_act_kernel<KS, NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kxk::kTileW - 1) / kxk::kTileW, (H + kxk::kTileH - 1) / kxk::kTileH);
  const int gather_blocks = static_cast<int>((cells + kThreads - 1) / kThreads);
  // g starts at zero (the wrapper zeroes it) and holds g_t after step t.
  for (int s = 0; s < n_steps; ++s) {
    const int t = n_steps - 1 - s;
    adj2d_act_kernel<KS, NB><<<grid, kxk::kThreads, smem, stream>>>(
        params, n_params, frames + t * cells, g, frames_bar + (t + 1) * cells,
        g_ins + t * cells, zw, H, W, hidden);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    adj2d_gather_kernel<KS><<<gather_blocks, kThreads, 0, stream>>>(
        zw, g_ins + t * cells, params, g, H, W, dt, inv_dx2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <int KS, int NB>
cudaError_t sweep_ys(const float* params, int n_params, const float2* frames_bar,
                     const float* ys, float2* g, float2* g_ins, float* zw, int n_steps,
                     int H, int W, int hidden, float dt, float inv_dx2,
                     cudaStream_t stream) {
  const size_t cells = static_cast<size_t>(H) * W;
  const size_t planes = static_cast<size_t>(2 * NB * hidden);
  const int smem = act_smem_bytes<KS>(n_params, false);
  cudaError_t err = cudaFuncSetAttribute(adj2d_ys_act_kernel<KS, NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int act_blocks = static_cast<int>((cells + kxk::kCells - 1) / kxk::kCells);
  const int blocks = static_cast<int>((cells + kThreads - 1) / kThreads);
  // g starts at zero (the wrapper zeroes it) and holds g_t after step t.
  for (int s = 0; s < n_steps; ++s) {
    const int t = n_steps - 1 - s;
    adj2d_ys_act_kernel<KS, NB><<<act_blocks, kxk::kThreads, smem, stream>>>(
        params, n_params, ys + t * planes * cells, g, frames_bar + (t + 1) * cells,
        g_ins + t * cells, zw, H, W, hidden);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    adj2d_gather_kernel<KS><<<blocks, kThreads, 0, stream>>>(
        zw, g_ins + t * cells, params, g, H, W, dt, inv_dx2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

#define PERCNN_NB_CASES(CALL) \
  case 1: return CALL(1);     \
  case 2: return CALL(2);     \
  case 3: return CALL(3);     \
  case 4: return CALL(4);     \
  default: return cudaErrorInvalidValue;

}  // namespace

// frames, frames_bar [n_steps + 1, H, W, 2]; g [H, W, 2] zeroed, and at
// k = 1 a second zeroed [H, W, 2] buffer `scratch` (unused at k > 1);
// g_ins [n_steps, H, W, 2]; zw [k k 2, H, W] scratch at k > 1 (unused at
// k = 1).  On return g holds the adjoint at frame 0 (without frames_bar[0]).
extern "C" int adj2d_sweep(const void* params, int n_params, const void* frames,
                           const void* frames_bar, void* g, void* scratch, void* g_ins,
                           void* zw, int n_steps, int H, int W, int hidden, int n_branches,
                           int kernel_size, float dt, float inv_dx2, void* stream) {
  const float* p = static_cast<const float*>(params);
  const float2* f = static_cast<const float2*>(frames);
  const float2* fb = static_cast<const float2*>(frames_bar);
  float2* gg = static_cast<float2*>(g);
  float2* sc = static_cast<float2*>(scratch);
  float2* gi = static_cast<float2*>(g_ins);
  float* z = static_cast<float*>(zw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ONE(NB) sweep_1x1<NB>(p, n_params, f, fb, gg, sc, gi, n_steps, H, W, hidden, dt, inv_dx2, s)
#define K3(NB) sweep_kxk<3, NB>(p, n_params, f, fb, gg, gi, z, n_steps, H, W, hidden, dt, inv_dx2, s)
#define K5(NB) sweep_kxk<5, NB>(p, n_params, f, fb, gg, gi, z, n_steps, H, W, hidden, dt, inv_dx2, s)
  switch (kernel_size) {
    case 1: switch (n_branches) { PERCNN_NB_CASES(ONE) }
    case 3: switch (n_branches) { PERCNN_NB_CASES(K3) }
    case 5: switch (n_branches) { PERCNN_NB_CASES(K5) }
    default: return cudaErrorInvalidValue;
  }
#undef ONE
#undef K3
#undef K5
}

// frames_bar [n_steps + 1, H, W, 2]; ys [n_steps, 2 nb C, H, W]; g [H, W, 2]
// zeroed; g_ins [n_steps, H, W, 2]; zw [k k 2, H, W] scratch.  On return g
// holds the adjoint at frame 0 (without frames_bar[0]).
extern "C" int adj2d_ys_sweep(const void* params, int n_params, const void* frames_bar,
                              const void* ys, void* g, void* g_ins, void* zw, int n_steps,
                              int H, int W, int hidden, int n_branches, int kernel_size,
                              float dt, float inv_dx2, void* stream) {
  const float* p = static_cast<const float*>(params);
  const float2* fb = static_cast<const float2*>(frames_bar);
  const float* y = static_cast<const float*>(ys);
  float2* gg = static_cast<float2*>(g);
  float2* gi = static_cast<float2*>(g_ins);
  float* z = static_cast<float*>(zw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K3(NB) sweep_ys<3, NB>(p, n_params, fb, y, gg, gi, z, n_steps, H, W, hidden, dt, inv_dx2, s)
#define K5(NB) sweep_ys<5, NB>(p, n_params, fb, y, gg, gi, z, n_steps, H, W, hidden, dt, inv_dx2, s)
  switch (kernel_size) {
    case 3: switch (n_branches) { PERCNN_NB_CASES(K3) }
    case 5: switch (n_branches) { PERCNN_NB_CASES(K5) }
    default: return cudaErrorInvalidValue;
  }
#undef K3
#undef K5
}
