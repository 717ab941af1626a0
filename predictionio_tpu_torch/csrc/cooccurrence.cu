// K19: DIMSUM's all-pairs item cosine — the hand-written Hopper kernels
// that replace the reference's dense product in
// predictionio_tpu/models/similarproduct/engine.py:615-622
// (DIMSUMAlgorithm.train: the binary [U, I] view matrix R, its columns
// L2-normalized, then one f32 Rn·Rnᵀ, the diagonal and everything under
// the threshold zeroed on the host).
//
// What it computes. R is binary, so Rn·Rnᵀ[i, j] = C[i, j]·rinv_i·rinv_j,
// where C[i, j] counts the users who viewed both items and
// rinv_i = 1/sqrt(n_i), n_i = C[i, i] the item's distinct viewers. The host
// deduplicates the (user, item) pairs (as setting R to 1.0 does) and hands
// the per-user item lists as CSR, each list sorted ascending:
//   cooccur_counts (K19a): C[i, j] += 1, int32, for every pair i >= j of one
//     user's items: only the lower triangle (diagonal included) is written.
//   cosine_from_counts (K19b): S [I, I] float32 with
//     S[i, j] = S[j, i] = (float)C[hi, lo]·rinv[lo]·rinv[hi] for i != j
//     (hi = max(i, j), lo = min(i, j): one value, mirrored, so S is exactly
//     symmetric), 0 on the diagonal, 0 where the value is under the
//     threshold; an item nobody viewed has rinv 0, so its row is 0, not NaN.
//
// Bound on an H100 SXM, at 2M views (1,864,777 distinct pairs, 26,744
// items): zeroing C (2.86 GB), the ≈38.5M integer atomics, one read of C's
// lower triangle and one write of S (2.86 GB): ≈3 ms at 3.35 TB/s, bound by
// bytes. The dense product the reference runs is 2·I²·U ≈ 198 TFLOP.
//
// Design.
//   cooccur_counts_users: a block per user (a grid-stride loop over users);
//     thread t takes items a = t, t + blockDim, ... of the list and adds 1
//     to C[item_a, item_b] for every b <= a. Integer atomicAdd is exact in
//     any order, so runs are bit-identical.
//   cosine_from_counts_tiles: a block per 32 x 32 tile of the lower
//     triangle (tiling.cuh lower_tile). It reads the tile of C row by row
//     (coalesced), writes S's tile and, through shared memory, S's
//     transposed tile above the diagonal (also coalesced). The products
//     are two float32 multiplies in a fixed order (no sums), so the plain
//     twin matches bit for bit.

#include <cuda_runtime.h>

#include "tiling.cuh"

namespace {

constexpr int COUNT_THREADS = 256;
constexpr int TILE = 32;
constexpr int TILE_ROWS = 8;  // a block of 32 x 8 threads per tile

__global__ void __launch_bounds__(COUNT_THREADS) cooccur_counts_users(
    const long long* __restrict__ user_ptr, const int* __restrict__ items,
    int n_users, long long n_items, int* __restrict__ C) {
  for (int u = blockIdx.x; u < n_users; u += gridDim.x) {
    const long long p0 = user_ptr[u];
    const int m = (int)(user_ptr[u + 1] - p0);
    const int* it = items + p0;
    for (int a = threadIdx.x; a < m; a += COUNT_THREADS) {
      int* row = C + (long long)it[a] * n_items;
      for (int b = 0; b <= a; ++b) atomicAdd(row + it[b], 1);
    }
  }
}

__global__ void __launch_bounds__(TILE * TILE_ROWS) cosine_from_counts_tiles(
    const int* __restrict__ C, const float* __restrict__ rinv, int n_items,
    float threshold, float* __restrict__ S) {
  __shared__ float tile[TILE][TILE + 1];
  int ti, tj;
  lower_tile(blockIdx.x, ti, tj);  // ti >= tj
  const int x = threadIdx.x;
  const long long n = n_items;
  const int j = tj * TILE + x;  // column of S's lower tile
  const float rj = j < n_items ? rinv[j] : 0.f;
  for (int y = threadIdx.y; y < TILE; y += TILE_ROWS) {
    const int i = ti * TILE + y;
    float v = 0.f;
    if (i < n_items && j < n_items && i > j) {
      v = (float)C[i * n + j] * rj * rinv[i];
      if (v < threshold) v = 0.f;
    }
    tile[y][x] = v;
  }
  __syncthreads();
  for (int y = threadIdx.y; y < TILE; y += TILE_ROWS) {
    const int i = ti * TILE + y;
    if (i < n_items && j < n_items) {
      // the diagonal tile's upper half comes from its lower half
      S[i * n + j] = (ti == tj && y < x) ? tile[x][y] : tile[y][x];
    }
    if (ti != tj) {  // the mirrored tile: row tj*32 + y, column ti*32 + x
      const int r = tj * TILE + y;
      const int c = ti * TILE + x;
      if (r < n_items && c < n_items) S[r * n + c] = tile[x][y];
    }
  }
}

}  // namespace

extern "C" {

// K19a on `stream`: C [I, I] int32 (zeroed by the caller) += the pair
// counts of n_users per-user item lists (CSR: user_ptr [n_users + 1]
// int64, items int32, each list sorted ascending, ids below n_items).
// Returns cudaGetLastError(); no launch when n_users is 0.
int cooccur_counts_i32(const long long* user_ptr, const int* items,
                       int n_users, int n_items, int* C,
                       cudaStream_t stream) {
  if (n_users <= 0) return (int)cudaSuccess;
  const int blocks = n_users < 65536 ? n_users : 65536;
  cooccur_counts_users<<<blocks, COUNT_THREADS, 0, stream>>>(
      user_ptr, items, n_users, n_items, C);
  return (int)cudaGetLastError();
}

// K19b on `stream`: S [I, I] float32 from C's lower triangle and
// rinv [I] (1/sqrt of each item's viewers, 0 for none), values under
// `threshold` zeroed. Returns cudaGetLastError(). The caller checks
// n_items >= 1.
int cosine_from_counts_f32(const int* C, const float* rinv, int n_items,
                           float threshold, float* S, cudaStream_t stream) {
  const long long T = (n_items + TILE - 1) / TILE;
  const long long tiles = T * (T + 1) / 2;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  cosine_from_counts_tiles<<<(unsigned)tiles, dim3(TILE, TILE_ROWS), 0,
                             stream>>>(C, rinv, n_items, threshold, S);
  return (int)cudaGetLastError();
}

const char* cooccurrence_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
