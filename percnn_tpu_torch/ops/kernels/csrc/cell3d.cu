// Forward-Euler Pi-cell rollout of a 3D two-channel field, kernel_size 1,
// with the Pi block in its expanded-cubic form.
//
// One time step, for every cell (d, h, w) of the periodic D x H x W grid:
//   s1, s2 = the sums of the six neighbours at distance 1 and at distance 2
//            along the three axes (indices wrapped periodically)
//   u' = u + k1_u s1u + k2_u s2u + P_u(u, v),   v' = v + k1_v s1v + k2_v s2v + P_v(u, v)
//   P_eq = c0 + c1 u + c2 v + c3 u^2 + c4 uv + c5 v^2 + c6 u^3 + c7 u^2 v
//          + c8 u v^2 + c9 v^3
// which is x + dt (nu Lap x + Pi(u, v)) with the 4th-order 13-point
// Laplacian: k1 = dt nu / dx^2 * 4/3, k2 = -dt nu / dx^2 / 12, the centre tap
// -15/2 dt nu / dx^2 folded into the linear coefficient of the equation's own
// field, and the product of the three affine branches summed over the hidden
// channels expanded into the cubic's 10 coefficients, all dt-scaled
// (expand_packed_3d in ../cell3d.py, 12 floats per equation).  The state is
// channels-last [D, H, W, 2] f32, read and written as float2.
//
// rollout3d_persistent_kernel and rollout3d_kernel replace
// percnn_tpu/ops/pallas/cell3d.py:_rollout3d_kernel (pallas_call in
// _fused_rollout3d_flat), both its frames and its final-only form: the
// persistent kernel on any field whose staged planes fit a block's shared
// memory (91^3 at most on 132 SMs; rollout3d_plan in ../cell3d.py), the
// per-step kernel past that.  The TPU kernel's width-wrap lane masks
// (_shift_w, _width_masks) are an artefact of its flat [D, H*W] layout;
// here each thread wraps its indices.  Both kernels take a cell's step from
// euler_step3d, so their frames agree to the bit.
//
// Bound on an H100 SXM at its 700 W power limit (published peaks: 3.35 TB/s,
// 67 TFLOP/s f32 outside the tensor cores), GS3D shape 48^3, T = 1000:
//   operations: 73 flops per cell and step (20 adds for the four neighbour
//          sums, 7 multiplies for the shared monomials, 23 per equation for
//          the update), 8.1 GFLOP per rollout: 120 us;
//   bytes: the frames path writes 1001 frames of 885 KB, 886 MB: 264 us; the
//          final-state path moves 1.8 MB.
// So the frames path is bound by bytes and the final-state path by
// operations on paper.  What limits a design is the chain of T dependent
// steps: the 885 KB state is far larger than one block's 227 KB of shared
// memory, so every step needs a device-wide sync.
// rollout3d_kernel makes that sync the end of a launch: one launch a step
// over D*H*W threads (432 blocks of 256 at 48^3), one cell a thread, reading
// its 13 stencil points (neighbouring threads read neighbouring cells, and
// the +-1, +-2 planes are shared through L1 and L2), the whole T-step loop
// of launches here in C on the caller's stream.
// rollout3d_persistent_kernel runs the whole rollout in one cooperative
// launch with one grid barrier a step (the design is described at the
// kernel).  Either way the state ping-pongs between two buffers, and for
// the frames path the output frames are the buffers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "stencil3d.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kRow = 12;   // coefficients per equation
// Threads a block of rollout3d_persistent_kernel, at most, and the staging
// loads a thread has in flight at once.
constexpr int kMaxPersistentThreads = 896;
constexpr int kBatch = 6;

// One Euler step at a cell from its 13 stencil points x (stencil13's order)
// and the 2 kRow expanded coefficients e.
__device__ __forceinline__ float2 euler_step3d(const float* e, const float2 (&x)[kPoints]) {
  const float s1u = x[1].x + x[2].x + x[3].x + x[4].x + x[5].x + x[6].x;
  const float s1v = x[1].y + x[2].y + x[3].y + x[4].y + x[5].y + x[6].y;
  const float s2u = x[7].x + x[8].x + x[9].x + x[10].x + x[11].x + x[12].x;
  const float s2v = x[7].y + x[8].y + x[9].y + x[10].y + x[11].y + x[12].y;

  const float2 c = x[0];
  const float u = c.x, v = c.y;
  const float u2 = u * u, uv = u * v, v2 = v * v;
  const float u3 = u2 * u, u2v = u2 * v, uv2 = u * v2, v3 = v2 * v;
  const float* eu = e;
  const float* ev = e + kRow;
  const float un = u + eu[0] * s1u + eu[1] * s2u + eu[2] + eu[3] * u + eu[4] * v +
                   eu[5] * u2 + eu[6] * uv + eu[7] * v2 + eu[8] * u3 +
                   eu[9] * u2v + eu[10] * uv2 + eu[11] * v3;
  const float vn = v + ev[0] * s1v + ev[1] * s2v + ev[2] + ev[3] * u + ev[4] * v +
                   ev[5] * u2 + ev[6] * uv + ev[7] * v2 + ev[8] * u3 +
                   ev[9] * u2v + ev[10] * uv2 + ev[11] * v3;
  return make_float2(un, vn);
}

__global__ void rollout3d_kernel(const float* __restrict__ coef,
                                 const float2* __restrict__ in,
                                 float2* __restrict__ out, int D, int H,
                                 int W) {
  __shared__ float e[2 * kRow];
  if (threadIdx.x < 2 * kRow) e[threadIdx.x] = coef[threadIdx.x];
  __syncthreads();

  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= D * H * W) return;
  int nbr[kPoints];
  stencil13(idx, D, H, W, nbr);
  float2 x[kPoints];
#pragma unroll
  for (int k = 0; k < kPoints; ++k) x[k] = in[nbr[k]];
  out[idx] = euler_step3d(e, x);
}

cudaError_t launch_step(const float* coef, const float2* in, float2* out, int D,
                        int H, int W, cudaStream_t stream) {
  const long long cells = static_cast<long long>(D) * H * W;
  const int blocks = static_cast<int>((cells + kThreads - 1) / kThreads);
  rollout3d_kernel<<<blocks, kThreads, 0, stream>>>(coef, in, out, D, H, W);
  return cudaGetLastError();
}

// The whole rollout in one cooperative launch.  Block b owns the cells
// [first, first + n_own) of the flat D H W field (the balanced split of
// split_evenly in ../cell2d.py) for every step, a thread a cell (then the
// next blockDim.x).  What the block's stencils read of a step's state sits
// in shared memory:
//   mid        the cells [first - 2 W, first + n_own + 2 W): the owned run
//              with two rows on each side, which holds every +-1, +-2
//              neighbour along the width and along the height, except where
//              the height wraps around the plane;
//   side[j]    the owned run shifted by +1, -1, +2, -2 planes (the depth
//              neighbours, wrapped).
// A step t stages them from the buffer step t - 1 wrote (h0 at t = 0), with
// __ldcg (L2, not the SM's L1, which may hold a stale line of a buffer
// written during the launch) and coalesced.  A height neighbour that wraps
// (the 4 rows at a plane's edges) is read from L2 directly, with the
// staging loads.  So each staged float2 moves from L2 once a block and step
// (about 35 KB a block at 48^3) where the 12 neighbours read one by one
// would move 2.3 times more (keeping the block's own run in shared memory
// from one step to the next, and staging only the rest, saved nothing
// measurable on the card).  Then each thread takes its cells' steps
// (euler_step3d) and writes them; one grid.sync() makes them visible, and
// the next step stages again.  A step reads only the previous buffer and
// writes only the next, so one barrier a step suffices.  The frames path's buffers are the frames (each block
// also copies its own cells of h0 into frame 0); the final path ping-pongs
// between out and scratch in the order that makes the last step write out.
__global__ void __launch_bounds__(kMaxPersistentThreads, 1)
    rollout3d_persistent_kernel(const float* __restrict__ coef, const float2* h0, float2* out,
                                float2* scratch, int n_steps, int D, int H, int W,
                                int final_only) {
  cg::grid_group grid = cg::this_grid();
  const int HW = H * W, cells = D * HW;
  const int nblk = gridDim.x, b = blockIdx.x;
  const int q = cells / nblk, m = cells % nblk;
  const int n_own = q + (b < m ? 1 : 0);
  const int first = b * q + (b < m ? b : m);
  const int cap = (cells + nblk - 1) / nblk;
  const int halo = 2 * W;

  extern __shared__ float4 smem_fwd3[];
  float* e = reinterpret_cast<float*>(smem_fwd3);         // [2 kRow]
  float2* mid = reinterpret_cast<float2*>(e + 2 * kRow);  // [cap + 4 W]
  float2* side = mid + cap + 2 * halo;                    // [4][cap]
  for (int k = threadIdx.x; k < 2 * kRow; k += blockDim.x) e[k] = coef[k];
  if (!final_only)
    for (int k = threadIdx.x; k < n_own; k += blockDim.x) out[first + k] = h0[first + k];
  // this thread's first cell, worked out once: its row i and column j
  const int k_a = threadIdx.x;
  int i_a = 0, j_a = 0;
  if (k_a < n_own) {
    const int r = (first + k_a) % HW;
    i_a = r / W;
    j_a = r - i_a * W;
  }

  // One Euler step of own cell k (row i, column j) from mid and side, its
  // height neighbours at +-1 and +-2 that wrap around the plane given (w1,
  // w2: the one of each distance that wraps, where one does).
  auto cell_step = [&](int k, int i, int j, float2 w1, float2 w2) {
    const int c = k + halo;   // this cell in mid
    float2 x[kPoints];
    x[0] = mid[c];
    x[1] = side[k];
    x[2] = side[cap + k];
    x[3] = i + 1 < H ? mid[c + W] : w1;
    x[4] = i >= 1 ? mid[c - W] : w1;
    x[5] = mid[c + (j + 1 < W ? 1 : 1 - W)];
    x[6] = mid[c + (j >= 1 ? -1 : W - 1)];
    x[7] = side[2 * cap + k];
    x[8] = side[3 * cap + k];
    x[9] = i + 2 < H ? mid[c + 2 * W] : w2;
    x[10] = i >= 2 ? mid[c - 2 * W] : w2;
    x[11] = mid[c + (j + 2 < W ? 2 : 2 - W)];
    x[12] = mid[c + (j >= 2 ? -2 : W - 2)];
    return euler_step3d(e, x);
  };
  // the wrapped height neighbours of own cell k (row i) in src
  auto wraps = [&](const float2* src, int k, int i, float2& w1, float2& w2) {
    const int idx = first + k;
    if (i == 0) w1 = __ldcg(src + idx - W + HW);
    else if (i == H - 1) w1 = __ldcg(src + idx + W - HW);
    if (i <= 1) w2 = __ldcg(src + idx - 2 * W + HW);
    else if (i >= H - 2) w2 = __ldcg(src + idx + 2 * W - HW);
  };

  // The staged float2s, numbered mid first, then the side runs cell by cell
  // (side j of cell k is number n_mid + 4 k + j); a thread starts kBatch of
  // its loads, and its first cell's wrapped neighbours, before it stores
  // any, so they are in flight together.
  const int n_mid = n_own + 2 * halo, n_stage = n_mid + 4 * n_own;
  const float2* src = h0;
  for (int t = 0; t < n_steps; ++t) {
    float2* dst = !final_only ? out + static_cast<size_t>(t + 1) * cells
                              : ((n_steps - 1 - t) % 2 == 0 ? out : scratch);
    float2 w1_a = make_float2(0.0f, 0.0f), w2_a = w1_a;
    if (k_a < n_own) wraps(src, k_a, i_a, w1_a, w2_a);
    for (int base = threadIdx.x; base < n_stage; base += kBatch * blockDim.x) {
      float2 v[kBatch];
      int slot[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * blockDim.x;
        slot[u] = -1;
        if (i >= n_stage) continue;
        int g;
        if (i < n_mid) {
          g = first - halo + i;
          slot[u] = i;
        } else {
          const int k = (i - n_mid) >> 2, j = (i - n_mid) & 3;
          g = first + k + (j < 2 ? HW : 2 * HW) * (j % 2 == 0 ? 1 : -1);
          slot[u] = cap + 2 * halo + j * cap + k;   // side[j * cap + k]
        }
        g = g < 0 ? g + cells : (g >= cells ? g - cells : g);
        v[u] = __ldcg(src + g);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (slot[u] >= 0) mid[slot[u]] = v[u];
    }
    __syncthreads();
    if (k_a < n_own) dst[first + k_a] = cell_step(k_a, i_a, j_a, w1_a, w2_a);
    for (int k = k_a + blockDim.x; k < n_own; k += blockDim.x) {
      const int r = (first + k) % HW;
      const int i = r / W;
      float2 w1 = make_float2(0.0f, 0.0f), w2 = w1;
      wraps(src, k, i, w1, w2);
      dst[first + k] = cell_step(k, i, r - i * W, w1, w2);
    }
    src = dst;
    if (t + 1 < n_steps) grid.sync();
  }
}

// Dynamic shared memory of rollout3d_persistent_kernel on `blocks` blocks:
// the coefficients, then mid and side for the most cells a block owns
// (rollout3d_smem_bytes in ../cell3d.py).
size_t persistent_smem(int D, int H, int W, int blocks) {
  const size_t cap = (static_cast<size_t>(D) * H * W + blocks - 1) / blocks;
  return 2 * kRow * sizeof(float) + (5 * cap + 4 * static_cast<size_t>(W)) * sizeof(float2);
}

cudaError_t persistent_occupancy(size_t smem, int threads, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(rollout3d_persistent_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, rollout3d_persistent_kernel,
                                                       threads, smem);
}

bool valid_grid(int blocks, int threads, long long cells) {
  return blocks >= 1 && blocks <= cells && threads >= 32 &&
         threads <= kMaxPersistentThreads && threads % 32 == 0;
}

}  // namespace

// coef: [24] (expand_packed_3d); h0: [D, H, W, 2].
// final_only = 0: out is [n_steps + 1, D, H, W, 2]; frame 0 is a copy of h0
//   and step t reads frame t and writes frame t + 1; scratch is null.
// final_only = 1: out and scratch are [D, H, W, 2]; the steps ping-pong
//   between them in the order that makes the last step write out.
extern "C" int cell3d_rollout(const void* coef, const void* h0, void* out,
                              void* scratch, int n_steps, int D, int H, int W,
                              int final_only, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* e = static_cast<const float*>(coef);
  const size_t cells = static_cast<size_t>(D) * H * W;
  cudaError_t err;
  if (!final_only) {
    float2* f = static_cast<float2*>(out);
    err = cudaMemcpyAsync(f, h0, cells * sizeof(float2), cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return err;
    for (int t = 0; t < n_steps; ++t) {
      err = launch_step(e, f + t * cells, f + (t + 1) * cells, D, H, W, s);
      if (err != cudaSuccess) return err;
    }
    return cudaGetLastError();
  }
  if (n_steps == 0) {
    err = cudaMemcpyAsync(out, h0, cells * sizeof(float2), cudaMemcpyDeviceToDevice, s);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  const float2* src = static_cast<const float2*>(h0);
  for (int t = 0; t < n_steps; ++t) {
    float2* dst = static_cast<float2*>((n_steps - 1 - t) % 2 == 0 ? out : scratch);
    err = launch_step(e, src, dst, D, H, W, s);
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaGetLastError();
}

// The same rollout, either form, in one cooperative launch of
// rollout3d_persistent_kernel on `blocks` blocks of `threads` threads with
// `smem` bytes (rollout3d_plan: at most the card's co-resident count, else
// cudaErrorCooperativeLaunchTooLarge before anything is launched; bytes
// other than the kernel's own, cudaErrorInvalidValue).  With n_steps = 0
// nothing is launched: h0 is copied to out.  `per_sm` gets the occupancy
// query's blocks an SM.
extern "C" int cell3d_rollout_persistent(const void* coef, const void* h0, void* out,
                                         void* scratch, int n_steps, int D, int H, int W,
                                         int final_only, int blocks, int threads, int smem,
                                         void* stream, int* per_sm) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(D) * H * W;
  if (!valid_grid(blocks, threads, cells) || (final_only && scratch == nullptr))
    return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(smem);
  if (bytes != persistent_smem(D, H, W, blocks)) return cudaErrorInvalidValue;
  cudaError_t err = persistent_occupancy(bytes, threads, per_sm);
  if (err != cudaSuccess) return err;
  int device, sms;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // a cooperative grid must be co-resident; one past it would be refused
  if (blocks > *per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  if (n_steps == 0) {
    err = cudaMemcpyAsync(out, h0, cells * sizeof(float2), cudaMemcpyDeviceToDevice, s);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  const float* e = static_cast<const float*>(coef);
  const float2* h = static_cast<const float2*>(h0);
  float2* o = static_cast<float2*>(out);
  float2* sc = static_cast<float2*>(scratch);
  void* args[] = {&e, &h, &o, &sc, &n_steps, &D, &H, &W, &final_only};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(rollout3d_persistent_kernel),
                                    dim3(blocks), dim3(threads), args, bytes, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// How many blocks of rollout3d_persistent_kernel an SM holds at once, on
// `blocks` blocks of `threads` threads.
extern "C" int cell3d_occupancy(int D, int H, int W, int blocks, int threads, int* per_sm) {
  if (!valid_grid(blocks, threads, static_cast<long long>(D) * H * W))
    return cudaErrorInvalidValue;
  return persistent_occupancy(persistent_smem(D, H, W, blocks), threads, per_sm);
}
