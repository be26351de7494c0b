// The per-cell arithmetic of the 1x1 Pi-cell backward sweeps, which differ
// only in their stencil.  pg_accumulate is the accumulation of the fully
// fused backward, shared by pg2d_kernel (backward2d.cu) and pg3d_kernel
// (backward3d.cu); jacobian_t_1x1, at the end, is the Jacobian's transpose
// alone, for the streaming sweeps adj2d_kernel (adj2d.cu) and adj3d_kernel
// (backward3d.cu).  At one cell, for one reverse step,
// with g_in the adjoint entering the step, (u, v) = h_t and Lap h_t given:
//   acc[diff + o] += g_in[o] * Lap(h_t)[o];   acc[bout + o] += g_in[o]
//   per equation o, hidden channel c, branch i, y_i = w_i[0,c] u + w_i[1,c] v + b_i[c]:
//     acc[wout + o C + c]                   += g * prod_j y_j
//     zz = g * prod_{j != i} y_j
//     acc[dw + ((o nb + i) C + c) 2 + cin]  += zz * (u, v)[cin]
//     acc[db + (o nb + i) C + c]            += zz
// and it returns in (du, dv) the Pi Jacobian's transpose applied to g_in,
// sum_{o,c,i} (w_i[0,c], w_i[1,c]) w_out[c] zz.  The plane layout is
// _pg_layout in ../backward2d.py; `sp` holds the packed parameters
// (pack_pi_params_2d), `a` points at this cell's entry of plane 0 and plane
// q is a[q * cells].

#pragma once

template <int NB>
__device__ __forceinline__ void pg_accumulate(const float* sp, float u, float v,
                                              const float gin[2], float lap_hu,
                                              float lap_hv, float* a, int cells,
                                              int hidden, float& du, float& dv) {
  // plane offsets (backward2d.py: _pg_layout)
  const int C = hidden;
  const int p_dw = 0;
  const int p_db = 2 * NB * C * 2;
  const int p_wout = p_db + 2 * NB * C;
  const int p_bout = p_wout + 2 * C;
  const int p_diff = p_bout + 2;
  // Plane q of this cell is a[q * cells].  Each group of planes is loaded
  // before any of it is stored: the offsets are known only at run time, so
  // the compiler cannot move a load above an earlier store, and without
  // that every update would wait a full L2 round trip for the one before.
  {
    float* pd = a + p_diff * cells;
    float* pb = a + p_bout * cells;
    const float d0 = pd[0], d1 = pd[cells], b0 = pb[0], b1 = pb[cells];
    pd[0] = d0 + gin[0] * lap_hu;
    pd[cells] = d1 + gin[1] * lap_hv;
    pb[0] = b0 + gin[0];
    pb[cells] = b1 + gin[1];
  }

  const int stride = 3 * C;                // per branch: w_i[0, :], w_i[1, :], b_i
  const int block = NB * stride + C + 1;   // per equation, then w_out [C], b_out
  du = 0.0f;
  dv = 0.0f;
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const float* p = sp + 2 + o * block;
    const float g = gin[o];
    for (int c = 0; c < C; ++c) {
      // this (o, c)'s planes: w_out, then per branch dw (u, v) and db
      float* pw = a + (p_wout + o * C + c) * cells;
      float* pdw[NB];
      float* pdb[NB];
      float old_dw[NB][2], old_db[NB];
      const float old_w = *pw;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int q = (o * NB + b) * C + c;
        pdw[b] = a + (p_dw + 2 * q) * cells;
        pdb[b] = a + (p_db + q) * cells;
        old_dw[b][0] = pdw[b][0];
        old_dw[b][1] = pdw[b][cells];
        old_db[b] = *pdb[b];
      }
      float y[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b)
        y[b] = p[b * stride + c] * u + p[b * stride + C + c] * v + p[b * stride + 2 * C + c];
      // prod_{j != b} y_j from prefix and suffix products
      float pre[NB + 1], suf[NB + 1];
      pre[0] = 1.0f;
      suf[NB] = 1.0f;
#pragma unroll
      for (int b = 0; b < NB; ++b) pre[b + 1] = pre[b] * y[b];
#pragma unroll
      for (int b = NB - 1; b >= 0; --b) suf[b] = suf[b + 1] * y[b];
      *pw = old_w + g * pre[NB];
      const float wo = p[NB * stride + c];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float zz = g * (pre[b] * suf[b + 1]);
        pdw[b][0] = old_dw[b][0] + zz * u;
        pdw[b][cells] = old_dw[b][1] + zz * v;
        *pdb[b] = old_db[b] + zz;
        du += (p[b * stride + c] * wo) * zz;
        dv += (p[b * stride + C + c] * wo) * zz;
      }
    }
  }
}

// The 1x1 Pi Jacobian's transpose applied to g_in at a cell with state
// (u, v): sum_{o,c,i} (w_i[0,c], w_i[1,c]) w_out[c] g_o prod_{j != i} y_j.
template <int NB>
__device__ __forceinline__ void jacobian_t_1x1(const float* sp, float u, float v,
                                               const float gin[2], int hidden, float& du,
                                               float& dv) {
  const int C = hidden;
  const int stride = 3 * C;                // per branch: w_i[0, :], w_i[1, :], b_i
  const int block = NB * stride + C + 1;   // per equation, then w_out [C], b_out
  du = 0.0f;
  dv = 0.0f;
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const float* p = sp + 2 + o * block;
    const float g = gin[o];
    for (int c = 0; c < C; ++c) {
      float y[NB], pre[NB + 1], suf[NB + 1];
#pragma unroll
      for (int b = 0; b < NB; ++b)
        y[b] = p[b * stride + c] * u + p[b * stride + C + c] * v + p[b * stride + 2 * C + c];
      pre[0] = 1.0f;
      suf[NB] = 1.0f;
#pragma unroll
      for (int b = 0; b < NB; ++b) pre[b + 1] = pre[b] * y[b];
#pragma unroll
      for (int b = NB - 1; b >= 0; --b) suf[b] = suf[b + 1] * y[b];
      const float wo = p[NB * stride + c];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float zz = g * (pre[b] * suf[b + 1]);
        du += (p[b * stride + c] * wo) * zz;
        dv += (p[b * stride + C + c] * wo) * zz;
      }
    }
  }
}
