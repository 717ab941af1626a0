// Work-splitting helpers shared by the port's kernels.
#pragma once

// The t-th 4x4 tile of the lower triangle, row by row: (0,0), (1,0),
// (1,1), (2,0), ... (K1's and K12a's symmetric tiles).
__device__ __forceinline__ void lower_tile(int t, int& ti, int& tj) {
  int i = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  ti = i;
  tj = t - i * (i + 1) / 2;
}

// Lanes that share one row of k floats read as float4s: the smallest power
// of two with lanes x 4 >= k, at most 32 (K12b's and K14's row groups).
__host__ __device__ inline int row_lanes(int k) {
  int g = 1;
  while (g < 32 && 4 * g < k) g *= 2;
  return g;
}
