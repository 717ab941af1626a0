// K2: the batched SPD solve of an ALS half-step — the hand-written Hopper
// kernel that replaces the reference's predictionio_tpu/ops/als.py:549
// _spd_solve together with the epilogue of :612 _solve_side.
//
// What it computes. For every row r of R systems: A[r] (+ G) + lam[r]·I
// (k x k, symmetric positive definite; G, when given, is the implicit
// mode's shared Gramian YᵀY of :630-632, added before the regularizer as
// the reference adds it), its Cholesky factor with the forward
// substitution of b[r] fused into the factorization sweep (the pivot
// through rsqrt, as the reference does), then back substitution, giving
// x[r]. X[r] = has_obs[r] ? x[r] : X_prev[r]: rows without observations
// keep their previous factors and are not solved. For the sweep telemetry
// it also sums, over all R rows, (X − X_prev)² and X² into sums[0..1],
// through per-block partial sums reduced in a fixed order.
//
// Bound on an H100 SXM. Per solved row it reads the lower triangle of A
// (all that Cholesky needs: 80 of the 128 32-byte sectors at k=32) and b;
// per row lam, has_obs and X_prev, and it writes X: at ML-20M's user side
// (R=147,456, k=32) ≈0.41 GB, ≈0.12 ms at 3.35 TB/s; the item side
// (R=28,672) ≈0.08 GB, ≈0.024 ms. The k³/3 + 2k² flops per row are ≈1.8
// GFLOP, ≈0.03 ms at 67 TFLOP/s: it is bound by bytes.
//
// At the grid's ranks (3e's fold 0 user side, R = 147,456 with V = 2) the
// bytes are smaller still: k = 16 ≈ 0.08 ms, k = 8 ≈ 0.03 ms.
//
// Design: one warp per system (below k = 16: a group of lanes), in one of
// three kernels.
//   spd_solve_small (k <= 16: KS = 8 for k <= 8, KS = 16 above; the
//     evaluation grid's ranks and K2 at those ranks): rows32 below sized to
//     KS. A group of KS lanes holds a system, 32 / KS systems a warp, 8 a
//     block; KS pivot steps, shuffles of width KS, identity padding only up
//     to KS. Every bit of X and of the telemetry sums is rows32's (the
//     kernel's comment in spd_solve.cuh shows why), with 1/4 (k = 8) or
//     1/2 (k = 16) of rows32's lanes and about 1/8 or 1/4 of its FMAs.
//   spd_solve_rows32 (k <= 32, the main path's rank): G, when given, is
//     staged once per block in shared memory (one 4 KB tile, row stride 33
//     so a warp's reads of a column hit 32 banks) and added to A as each
//     lane loads its row; no [R, k, k] pass forms A + G. With G or without
//     it is a template argument, so the instantiation without G is the
//     explicit kernel as it was, code and registers. Lane i
//     holds row i of the system in 32 registers (padded to 32 with identity rows, which
//     leave the solution unchanged). In step j the pivot and the
//     right-hand side come by shuffle from lane j, every lane scales its
//     entry of column j, publishes it in a 32-float shared vector, and
//     updates its row of the trailing lower triangle from that vector:
//     about 500 register FMAs and 150 shared reads per system. Back
//     substitution is row-wise: x_j = (y_j − Σ_{i>j} L_ij·x_i)·(1/L_jj), the
//     sum a fixed xor butterfly over the lanes.
//   spd_solve_rows (any other k for which a warp's matrix fits in shared
//     memory; the caller allows k <= 200): the matrix in shared memory with
//     G's entries (read through the cache: a k x k tile does not fit
//     beside the warps' matrices) added as it is loaded, a row stride of k+1, lanes owning rows i = lane, lane+32, ...; step j
//     scales column j and applies the rank-1 update row by row; back
//     substitution goes column-wise.
// The telemetry partials come from a butterfly over each warp and an
// ordered sum over the block's warps; a one-block kernel sums the partials
// in a fixed tree. No atomics: a run is bit-for-bit repeatable.
//
// The kernels live in spd_solve.cuh, shared with K13b (csrc/grid.cu),
// which runs them over a variant axis; here V = 1.

#include "spd_solve.cuh"

extern "C" {

// Blocks spd_solve_f32 launches for R systems of size k (the partials
// buffer holds two floats per block).
int spd_solve_blocks(int R, int k) { return k2::blocks_for(R, k); }

// Launches the solve on `stream` (and, when `sums` is not null, the
// reduction of the telemetry sums, using `partials` of 2·blocks floats) and
// returns cudaGetLastError(). G is a [k, k] matrix added to every system,
// or null. The caller checks shapes, dtypes, devices, R >= 1 and
// 1 <= k <= 200.
int spd_solve_f32(const float* A, const float* G, const float* b,
                  const float* lam,
                  const unsigned char* has_obs, const float* X_prev,
                  float* X, float* partials, float* sums, int R, int k,
                  cudaStream_t stream) {
  return (int)k2::launch(A, G, b, lam, has_obs, X_prev, X, partials, sums, R,
                         k, 1, R, stream);
}

const char* spd_solve_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
