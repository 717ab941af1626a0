// K13: the regularizer-grid training loop of an ALS evaluation — the
// hand-written Hopper kernels that replace the reference's
// predictionio_tpu/ops/als.py:942 _run_iterations_grid (float32, the exact
// solver, explicit and implicit feedback).
//
// What it computes. V regularizer variants of one ALS configuration share
// one packed side per half-step (the same ratings, rank and sweeps; only
// λ differs) and each has its own factors. The reference vmaps K1 and K2
// over the variant axis inside one program, its loop outside the vmap
// (:976-996), so each variant sweeps exactly as a serial run. Here:
//   K13a normal_eq_variants: for every variant v and system row r,
//     A[v,r] = Σ w_a·y yᵀ and b[v,r] = Σ w_b·y over the row's ratings,
//     y = Y[v][col] (K1's systems and, in implicit mode, K1's weights).
//   K13b spd_solve_variants: X[v,r] = has_obs[r] ? (A[v,r] + G[v] +
//     λ[v,r]·I)⁻¹ b[v,r] : X_prev[v,r] (K2's solve; G[v] is variant v's
//     own Gramian in implicit mode, none in explicit mode). No telemetry:
//     the reference's grid keeps none.
//
// Bound on an H100 SXM, at the evaluation's shape (an ML-20M fold: about
// 13.3M training ratings, V = 2, k = 8 or 16). K13a: each rating needs
// k(k+1)/2 + k FMAs per variant, V·(k²+3k) flops in all (0.11 GFLOP per
// variant at k = 8, 0.40 at k = 16: ≈3.2 / ≈12 µs at 67 TFLOP/s), against
// the pack read once (8 B a rating, 4 B a segment) plus V·R·(k²+k)·4 bytes
// of systems written (≈0.14 GB on the user side at k = 16): bound by
// bytes. K13b reads each variant's lower triangle and b and writes X:
// bound by bytes too.
//
// Design. Both are K1's and K2's own kernels (normal_eq.cuh,
// spd_solve.cuh) with a variant axis, so variant v is summed and solved
// in exactly K1's and K2's order: bit-equal to K1 and K2 run on variant
// v's factors. K13a walks K1's group plan unchanged. At the grid's ranks
// (k <= 16) it runs the form sized to the rank (normal_eq.cu's header):
// one warp takes a group and its variants (two at k = 16, four at k = 8;
// more variants take more warps a group), loads the group's column ids and
// ratings once for all of them and gathers each variant's rows into tiles
// k wide; its lanes own the lower triangle and b of every variant, each
// entry summed in K1's order. Above k = 16 (K1's warp-MMA form to k = 32,
// its block form above) a group's V variants run in neighbouring blocks
// (block = group block · V + v), so the group's column
// ids, ratings and plan entries come from device memory once and from L2
// for the other variants; each variant gathers its own factor rows. The
// multi-group rows' partials and their ordered combine are per variant
// (blockIdx.z). K13b runs K2's kernels with the variant on blockIdx.y; each
// block stages its variant's G. At the grid's ranks that is K2's form sized
// to the rank (spd_solve.cuh spd_solve_small: a system to a group of 8 or
// 16 lanes, 4 or 2 systems a warp, 8 a block), every bit the k <= 32
// form's; its floor is the bytes, ≈0.08 ms at rank 16 and ≈0.03 at rank 8
// on fold 0's user side with V = 2. Later work: the sized K13a form's row
// gather, which bounds it at rank 16 with V = 2.

//
// K13a-bf16 (normal_eq_variants_f32 with bf16 = 1): the grid in the
// reference's compute_dtype="bfloat16" (its :942 with _solve_side's cast
// weights): the same kernels with K1-bf16's rounding (csrc/normal_eq.cu),
// so variant v stays bit-equal to K1-bf16 on its factors. K13b is unchanged (float32).
//
// K13s (the grid on a row-sharded mesh, ops/als.py train_als_grid(mesh=)):
// per row shard, K13a on the shard's own pack (its rows numbered from 0,
// the whole [V, n, k] counter side read by global id) and K13b with ldr,
// the whole factor arrays' row count, so the shard reads and writes its
// rows of the [V, R, k] arrays where they lie, with no gather or copy.
// Every row is summed and solved as on one device, so bit-equal to it.

#include "normal_eq.cuh"
#include "spd_solve.cuh"

extern "C" {

// K13a on `stream`; returns cudaGetLastError(). Y is [V, y_rows, k]
// (y_stride = y_rows·k floats between variants); A [V, R, k, k], b
// [V, R, k] and partials [V, max(P, 1), k·k + k] are allocated by the
// caller, which checks shapes, dtypes, devices, id ranges and
// 1 <= k <= 1024, and builds the plan as for K1 (normal_eq_f32). bf16 != 0
// runs K13a-bf16, with Yh the [V, y_rows, kh] bfloat16 copy of Y as
// normal_eq_f32 takes it (kh = k rounded up to 8), read at 17 <= k <= 32
// only. small is the k <= 16 form's lane plan for V variants
// (ops/normal_eq.py small_form_plan), read only at k <= 16.
int normal_eq_variants_f32(const float* Y, const void* Yh, const int* cols,
                           const float* vals, const int* rem,
                           const int* groups, int n_groups, const int* c_rows,
                           const int* c_start, int n_combine, float* partials,
                           float* A, float* b, int k, int L, int implicit,
                           float alpha, int V, long long y_stride, int R,
                           int P, int bf16, const int* small, cudaStream_t stream) {
  return (int)(bf16 ? k1::launch<true, true>(Y, Yh, cols, vals, rem, groups,
                                             n_groups, c_rows, c_start,
                                             n_combine, partials, A, b, k, L,
                                             implicit, alpha, V, y_stride, R,
                                             P, small, stream)
                    : k1::launch<true, false>(Y, Yh, cols, vals, rem, groups,
                                              n_groups, c_rows, c_start,
                                              n_combine, partials, A, b, k, L,
                                              implicit, alpha, V, y_stride, R,
                                              P, small, stream));
}

// K13b on `stream`; returns cudaGetLastError(). A [V, R, k, k] and b
// [V, R, k]; X_prev and X [V, ldr, k], lam [V, ldr], has_obs [ldr] and G
// [V, k, k] or null, where ldr >= R: the R rows solved are the R rows at
// X_prev, X, lam and has_obs (a row shard passes its first row's
// pointers; ldr = R solves whole arrays). The caller checks shapes,
// dtypes, devices, R >= 1 and 1 <= k <= 200.
int spd_solve_variants_f32(const float* A, const float* G, const float* b,
                           const float* lam, const unsigned char* has_obs,
                           const float* X_prev, float* X, int R, int k, int V,
                           long long ldr, cudaStream_t stream) {
  return (int)k2::launch(A, G, b, lam, has_obs, X_prev, X, nullptr, nullptr,
                         R, k, V, ldr, stream);
}

const char* grid_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
