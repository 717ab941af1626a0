// K1: the per-row normal equations of an ALS half-step — the hand-written
// Hopper kernel that replaces the reference's jitted loop body
// predictionio_tpu/ops/als.py:481 _accumulate_systems (explicit and
// implicit feedback, float32, precision="highest").
//
// What it computes. For every system row r: A[r] = Σ w_a·y yᵀ and
// b[r] = Σ w_b·y over the row's observations, y = Y[col] (the counter-side
// factor row), v the rating. Explicit: w_a = 1, w_b = v. Implicit (the
// reference's :521-530, Hu-Koren-Volinsky as MLlib trainImplicit):
// w_a = α·|v| (a confidence, so a dislike v < 0 still adds to A) and
// w_b = 1(v>0)·(1 + α·|v|). The weights are a template argument chosen by
// the launch, so the explicit instantiation is the explicit loop as it
// was, arithmetic for arithmetic. The observations come in the packed segment
// layout (cols/vals [S, L], valid slots a prefix of rem[s] per segment, a
// row's segments consecutive). A [R, k, k] and b [R, k] are written in
// full, zeros for rows without observations.
//
// Bound on an H100 SXM. A is symmetric, so a rating needs k(k+1)/2 + k
// FMAs, 2 flops each (implicit mode adds k products per slot, scaling the
// gathered row by w_a): at ML-20M (20M ratings, k=32) ≈22.4 GFLOP per
// half-step, ≈0.33 ms at the fp32 CUDA-core peak (67 TFLOP/s). The bytes
// (packed planes plus A and b, ≈0.90 GB on the user side, ≈0.34 GB on the
// item side) take ≈0.27 ms and ≈0.10 ms at 3.35 TB/s: it is bound by
// operations. The gathered factor
// matrices (3.7 MB and 18.9 MB) fit in the 50 MB L2. Products are fp32
// FMAs on the CUDA cores, never TF32: the reference holds f32 parity.
//
// Design. Every form walks a plan the host builds once per pack: groups of
// up to GROUP_SEGMENTS (8) consecutive segments of one row. A row with one
// group writes its A and b directly; a longer row (the skew: the most rated
// ML-20M item has 8,531 segments, which one block would take ≈2 ms to
// sum) writes one partial per group, so its work spreads over many blocks.
//   normal_eq_small (k <= 16, the evaluation grid's ranks 8 and 16): a form
//     sized to the rank. One warp takes a group and up to VW of its
//     variants (VW·kp <= 32 floats of gathered rows a slot, kp = k rounded
//     up to 4; K1 is V = 1). It walks the group in chunks of 32 slots as
//     normal_eq_groups32 does, loading each chunk's column ids and weights
//     once for all its variants, and gathers every variant's rows with
//     cp.async (16 bytes a lane where k is a multiple of 4) into two shared
//     tiles kp wide, not 32. Lanes own only the lower triangle and b: the
//     host's plan (ops/normal_eq.py small_form_plan) gives each lane a run
//     of U "units" of one variant's row group ti (rows 4ti..4ti+3), a unit
//     being column j of those rows (j < min(k, 4ti+4); entries above the
//     diagonal are computed and dropped) or their entries of b; U is the
//     fewest of {1, 2, 3, 4, 8} that fits the warp (rank 16 with V = 2:
//     U = 3 on all 32 lanes; rank 8 with V = 2: U = 1 on 28 lanes). So a
//     slot costs a lane one 16-byte shared read of its rows, U reads of a
//     column and 4·U FMAs, where normal_eq_groups32 spends 32 FMAs a lane
//     on each variant's padded 32 x 32 square. At k = 8 a warp could also
//     take several groups with its lanes split by group; this form gives
//     the lanes finer units instead (U = 1), which cuts the work a slot as
//     far without a chunk stream per group or lanes idling where groups
//     differ in length. Every lane runs U units a slot (one with fewer
//     repeats its last, unkept), so the slot loop has no divergent branch,
//     and it is unrolled 8 deep: the loop is bound by shared-memory
//     latency. The lower triangle and b go through shared memory, are
//     mirrored into the upper triangle there and stored coalesced. Each
//     entry's chain is normal_eq_groups32's: the slots in order from 0,
//     fmaf(w_a·y_i, y_j, acc) for i >= j and fmaf(w_b, y_i, acc) for b, so
//     the lower triangle and b are its bits, and in explicit mode (w_a = 1)
//     the mirrored square too, since fmaf(a, b, c) = fmaf(b, a, c). In
//     implicit mode groups32 formed the upper triangle as (w_a·y_j)·y_i,
//     which may round apart from the mirror; no solve reads above the
//     diagonal (spd_solve.cuh: spd_solve_rows32 and spd_solve_rows read
//     L_ij, i >= j, only), so X is the same bits either way. The products
//     stay fp32 FMAs on the CUDA cores: TF32 rounds the operands to 10
//     mantissa bits and an exact 3xTF32 split reorders each sum, and either
//     would break the chain that keeps K13a equal to K1 and the grid's
//     factors the serial path's.
//   normal_eq_groups32 (17 <= k <= 32, the main path's rank): one warp per group
//     and no block barrier. The warp walks its group in chunks of 32 slots:
//     it gathers a chunk's Y rows into one of its two shared tiles with
//     cp.async (a row per request, lanes along k, zeros past k) while it
//     multiplies the previous chunk, and loads the column ids of the chunk
//     after. Every lane adds the slots' products to its 4x8 tile of the
//     32x32 square (3 float4 shared reads per 32 FMAs) and its row of b.
//     The tiles go back through shared memory, so A is stored coalesced.
//   normal_eq_groups (k > 32): one block of 256 threads per group. It
//     stages CH=64 gathered rows at a time (a warp per row, lanes along k);
//     each thread owns a 4x4 tile of the lower triangle (A is symmetric;
//     each tile is written to both triangles) for every SG-th staged slot,
//     the tiles in column 0 also sum b, and the SG slot groups are summed
//     in a fixed order through shared memory. Above k=88 the tiles split
//     over blockIdx.y.
//   normal_eq_combine: per multi-group row and 256-entry range of its k²+k
//     outputs, the partials summed in slot order.
// No atomics: every
// sum has a fixed order, so a run is bit-for-bit repeatable. Slots past rem
// are never read; groups without segments (empty, padding and sentinel
// rows) write zeros. Products are fp32 FMAs, never TF32. Later work:
// fusing K2; the sized form's gather (its floor at rank 16, V = 2).
//
// The kernels live in normal_eq.cuh, shared with K13a (csrc/grid.cu),
// which runs them over a variant axis; here V = 1.
//
// K1-bf16 (normal_eq_f32 with bf16 = 1): the reference's
// compute_dtype="bfloat16" form of the same function (its :506
// Yc = Y.astype(bf16), :528-534 the cast weights). Y is rounded to
// bfloat16 as each gathered row lands in shared memory; explicit w_a = 1
// (exact) and w_b = bf16(v); implicit w_a = bf16(α|v|) and
// w_b = bf16(1(v>0)(1 + α|v|)). Every product of two
// such values is exact in float32 (8-bit significands; w_a·y then has 16
// bits and (w_a·y)·y 24), so the kernel runs the float32 FMA path above on
// the rounded values and computes what the reference computes: its CPU
// program forms w_a·y in float32 and never rounds it back to bf16. A bf16
// MMA on bf16(w_a·y) would not (it is exact only where w_a is 0 or 1,
// explicit mode). Bound: the same FMAs, now counted at the bf16
// tensor-core peak (989 TFLOP/s), against the pack, 2-byte rows of Y and
// the float32 A and b: ≈0.79 GB on the user side at ML-20M, ≈0.23 ms at
// 3.35 TB/s, so bound by bytes; the kernel, on the CUDA cores, runs near
// K1's float32 time.

#include "normal_eq.cuh"

extern "C" {

// Launches both kernels on `stream` and returns cudaGetLastError(). The
// caller checks shapes, dtypes, devices, id ranges and 1 <= k <= 1024,
// allocates A [R,k,k], b [R,k] and partials [max(P,1), k*k+k], and builds
// the plan: groups [4, n_groups] int32 (row, first segment, segment
// count, partial slot or -1), c_rows [n_combine], c_start [n_combine+1].
// implicit != 0 takes the implicit weights with confidence scale alpha;
// bf16 != 0 runs K1-bf16, with Y and the weights rounded to bfloat16
// where the reference casts them (see the header). small is the k <= 16
// form's lane plan for V = 1 ({U, VW, lane[32]} int32, from
// ops/normal_eq.py small_form_plan); it is read only at k <= 16, where a
// missing or malformed plan returns cudaErrorInvalidValue.
int normal_eq_f32(const float* Y, const int* cols, const float* vals,
                  const int* rem, const int* groups, int n_groups,
                  const int* c_rows, const int* c_start, int n_combine,
                  float* partials, float* A, float* b, int k, int L,
                  int implicit, float alpha, int bf16, const int* small,
                  cudaStream_t stream) {
  return (int)(bf16 ? k1::launch<false, true>(Y, cols, vals, rem, groups,
                                              n_groups, c_rows, c_start,
                                              n_combine, partials, A, b, k, L,
                                              implicit, alpha, 1, 0, 0, 0,
                                              small, stream)
                    : k1::launch<false, false>(Y, cols, vals, rem, groups,
                                               n_groups, c_rows, c_start,
                                               n_combine, partials, A, b, k, L,
                                               implicit, alpha, 1, 0, 0, 0,
                                               small, stream));
}

const char* normal_eq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
