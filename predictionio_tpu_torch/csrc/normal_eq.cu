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
// operations. The gathered factor matrices (3.7 MB and 18.9 MB) fit in the
// 50 MB L2, but every slot gathers its row from there: 20M slots × 128 B =
// 2.56 GB a half-step at k = 32, ≈0.46 ms at the ≈5.5 TB/s L2 rate that
// K11a's carried floor implies, a floor above the bound. The rank-32
// form's MMA work (six products on six m16n8 tiles, 9,216 flops a slot,
// ≈0.18 TFLOP a half-step) takes ≈0.19 ms at the bf16 tensor-core peak.
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
//     normal_eq_mma does, loading each chunk's column ids and weights
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
//     column and 4·U FMAs, where a padded 32 x 32 square costs 32 FMAs a
//     lane a variant. At k = 8 a warp could also
//     take several groups with its lanes split by group; this form gives
//     the lanes finer units instead (U = 1), which cuts the work a slot as
//     far without a chunk stream per group or lanes idling where groups
//     differ in length. Every lane runs U units a slot (one with fewer
//     repeats its last, unkept), so the slot loop has no divergent branch,
//     and it is unrolled 8 deep: the loop is bound by shared-memory
//     latency. The lower triangle and b go through shared memory, are
//     mirrored into the upper triangle there and stored coalesced. Each
//     entry is one fmaf chain over the slots in order from 0:
//     fmaf(w_a·y_i, y_j, acc) for i >= j and fmaf(w_b, y_i, acc) for b, the
//     bits of the padded 32 x 32 CUDA-core form that ran here before, so
//     the evaluation grid's "grid = serial, bit for bit" gate holds at its
//     ranks 8 and 16. No solve reads above the diagonal (spd_solve.cuh:
//     spd_solve_rows32 and spd_solve_rows read L_ij, i >= j, only). The
//     products stay fp32 FMAs on the CUDA cores: TF32 rounds the operands
//     to 10 mantissa bits.
//   normal_eq_mma (17 <= k <= 32, the main path's rank 32): A on the tensor
//     cores. A block of one warp per group, so a block ends with its group
//     and a long group holds no other warp's resources. The warp walks its
//     group in chunks of 32 slots of one segment: it gathers a chunk's rows
//     into one of its two shared tiles with cp.async (16 bytes a lane where
//     k is a multiple of 4, else 4 bytes a lane; rows 36 floats apart, so
//     the fragment reads hit 32 banks; the rows past the chunk's slots
//     zero-filled, so a chunk is 32 slots to every sum and no read is
//     masked) while it multiplies the previous chunk, and loads the column
//     ids and ratings of the chunk after; a slot's weights are formed when
//     its chunk is multiplied (and read from shared memory as broadcasts),
//     so nothing waits on those loads sooner. A
//     chunk's share of A is a 32 x 32 x (slots) product, M = the factor
//     index i (rows padded to 32 with zeros), N = j, K = the slots, run as
//     mma.sync m16n8k16 bf16 with float32 sums, on the 6 of the 8 m16n8
//     tiles that touch the lower triangle (5 up to k = 24), mirrored into
//     the upper triangle when A is stored. Operand A is (w_a·y)ᵀ, operand B
//     is yᵀ, each split into bfloat16 parts in registers as the lane reads
//     its fragment entries (slot pairs 2c, 2c + 1 and 2c + 8, 2c + 9 at
//     features r + 8n, so both operands come from the same 16 values a
//     k-step; K1-bf16's staged rows are the operand's bits already, so
//     ldmatrix.trans loads its fragments, four 8 x 8 blocks a call).
//     Builds that left out one part at a time, on an H100 at ML-20M's user
//     side, ran faster by most without the gather's walk, then the split
//     and fragment reads, the MMAs and b's chain, and the savings added
//     up: the SM's issue slots bound the form more than any one wait. The
//     split: a float32 x with |x| in [2^-110, 2^127] (or 0)
//     is exactly h + m + l, h = bf16(x), m = bf16(x − h),
//     l = bf16(x − h − m), with both differences exact: x has 24
//     significant bits, h takes the top 8 (rounded), x − h at most the next
//     16, m 8 of them, and the rest fits 8 bits down to x's last bit, which
//     a bfloat16 holds at 2^-133 and above (tests/test_torch_k1_mma.py).
//     A slot's term is summed as the six products h·h + h·m + m·h + h·l +
//     l·h + m·m, each exact in float32 (the three left out, m·l, l·m and
//     l·l, lie below 2^-24 of |y_i y_j|): six MMAs a tile and k-step,
//     smallest first. In implicit mode operand A is fl(w_a·y), rounded once
//     in float32 as the CUDA-core form did, split the same way. At k = 32
//     over 4,096 slots the six products summed exactly lie 7.6e-10 of the
//     row scale from the exact A, a float32 fmaf chain 1.5e-6. Each chunk's
//     MMAs start from zeroed fragments, and the chunk's sum is added,
//     rounded to nearest, into float32 running sums in chunk order: the
//     tensor cores' own accumulation spans one chunk, and a row's result
//     depends only on its slots and its plan, so a second launch, a resumed
//     run and a mesh shard are one device's bits. b stays on the CUDA
//     cores, the fmaf chain of the padded form that ran here before (lane i
//     sums w_b·y_i over the slots in order), so b keeps those bits; A moves
//     by float32 roundings, far inside chip_smoke.py's 1e-4 of the row
//     scale.
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
// rows) write zeros. Never TF32. Later work: fusing K2; the sized form's
// gather (its floor at rank 16, V = 2); the rank-32 form's L2 gather.
//
// The kernels live in normal_eq.cuh, shared with K13a (csrc/grid.cu),
// which runs them over a variant axis; here V = 1.
//
// K1-bf16 (normal_eq_f32 with bf16 = 1): the reference's
// compute_dtype="bfloat16" form of the same function (its :506
// Yc = Y.astype(bf16), :528-534 the cast weights). Explicit w_a = 1
// (exact) and w_b = bf16(v); implicit w_a = bf16(α|v|) and
// w_b = bf16(1(v>0)(1 + α|v|)). Every product of two such values is exact
// in float32 (8-bit significands; w_a·y has 16 bits and (w_a·y)·y 24), and
// the reference's CPU program forms w_a·y in float32 and never rounds it
// back to bf16, so a bf16 MMA on bf16(w_a·y) would not compute its
// function (it is exact only where w_a is 0 or 1). At 17 <= k <= 32
// normal_eq_mma gathers rows rounded once, the wrapper's bfloat16 copy of
// Y (one cast a call, as the reference's :506; 2 bytes an entry, rows
// padded with zeros to a multiple of 8 entries), and runs one product a
// tile in explicit mode (y·y, exact) and two in implicit mode: w_a·y is
// split exactly into hi + lo, two bfloat16 values (its 16 bits), so
// hi·y + lo·y is w_a·y·y with no rounding before the float32 sums. b is
// the float32 form's chain on the rounded rows. The other forms round each
// gathered float32 row as it lands in shared memory and run the float32
// FMA path on the rounded values. Bound: the same FMAs, now counted at the
// bf16 tensor-core peak (989 TFLOP/s), against the pack, 2-byte rows of Y
// and the float32 A and b: ≈0.79 GB on the user side at ML-20M, ≈0.23 ms
// at 3.35 TB/s, so bound by bytes. The rank-32 form's L2 gather is
// 20M × 64 B = 1.28 GB, ≈0.23 ms at ≈5.5 TB/s; its MMA work (one product,
// ≈31 GFLOP explicit; two implicit) takes ≈0.03–0.06 ms.

#include "normal_eq.cuh"

extern "C" {

// Launches both kernels on `stream` and returns cudaGetLastError(). The
// caller checks shapes, dtypes, devices, id ranges and 1 <= k <= 1024,
// allocates A [R,k,k], b [R,k] and partials [max(P,1), k*k+k], and builds
// the plan: groups [4, n_groups] int32 (row, first segment, segment
// count, partial slot or -1), c_rows [n_combine], c_start [n_combine+1].
// implicit != 0 takes the implicit weights with confidence scale alpha;
// bf16 != 0 runs K1-bf16, with Y and the weights rounded to bfloat16
// where the reference casts them (see the header); Yh is then Y rounded to
// bfloat16 with rows padded with zeros to k rounded up to 8 entries,
// 16-byte aligned, read (and required) at 17 <= k <= 32 only, null
// elsewhere. small is the k <= 16 form's lane plan for V = 1 ({U, VW,
// lane[32]} int32, from ops/normal_eq.py small_form_plan); it is read only
// at k <= 16, where a missing or malformed plan returns
// cudaErrorInvalidValue.
int normal_eq_f32(const float* Y, const void* Yh, const int* cols, const float* vals,
                  const int* rem, const int* groups, int n_groups,
                  const int* c_rows, const int* c_start, int n_combine,
                  float* partials, float* A, float* b, int k, int L,
                  int implicit, float alpha, int bf16, const int* small,
                  cudaStream_t stream) {
  return (int)(bf16 ? k1::launch<false, true>(Y, Yh, cols, vals, rem, groups,
                                              n_groups, c_rows, c_start,
                                              n_combine, partials, A, b, k, L,
                                              implicit, alpha, 1, 0, 0, 0,
                                              small, stream)
                    : k1::launch<false, false>(Y, Yh, cols, vals, rem, groups,
                                               n_groups, c_rows, c_start,
                                               n_combine, partials, A, b, k, L,
                                               implicit, alpha, 1, 0, 0, 0,
                                               small, stream));
}

const char* normal_eq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
