// The 13-point stencil of the periodic 3D grid, shared by rollout3d_kernel
// (cell3d.cu) and pg3d_kernel (backward3d.cu).  Cells are numbered
// d * H * W + h * W + w.  stencil13 gives the cell itself, then its
// neighbours at +-1 along depth, height and width, then those at +-2, in
// the order of the plain versions (../cell3d.py, ../backward3d.py), with the
// indices wrapped periodically.

#pragma once

constexpr int kPoints = 13;   // the centre, 6 at distance 1, 6 at distance 2

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

__device__ __forceinline__ void stencil13(int idx, int D, int H, int W,
                                          int nbr[kPoints]) {
  const int HW = H * W;
  const int d = idx / HW;
  const int r = idx - d * HW;
  const int i = r / W;
  const int j = r - i * W;
  const int dh = d * HW, ih = i * W;
  nbr[0] = idx;
  nbr[1] = wrap(d + 1, D) * HW + ih + j;
  nbr[2] = wrap(d - 1, D) * HW + ih + j;
  nbr[3] = dh + wrap(i + 1, H) * W + j;
  nbr[4] = dh + wrap(i - 1, H) * W + j;
  nbr[5] = dh + ih + wrap(j + 1, W);
  nbr[6] = dh + ih + wrap(j - 1, W);
  nbr[7] = wrap(d + 2, D) * HW + ih + j;
  nbr[8] = wrap(d - 2, D) * HW + ih + j;
  nbr[9] = dh + wrap(i + 2, H) * W + j;
  nbr[10] = dh + wrap(i - 2, H) * W + j;
  nbr[11] = dh + ih + wrap(j + 2, W);
  nbr[12] = dh + ih + wrap(j - 2, W);
}
