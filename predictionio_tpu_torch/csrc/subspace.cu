// K11: one column block of the iALS++ subspace solver — the hand-written
// Hopper kernels that replace the block body of the reference's
// predictionio_tpu/ops/als.py:640 _solve_side_subspace (explicit and
// implicit feedback, float32, precision="highest").
//
// What it computes. A half-step sweeps the k/b column blocks B = [s0, s0+b)
// of the factors in order, each block reading what the block before it has
// just written (Gauss–Seidel), so every block is two launches in stream
// order, never fused across blocks:
//   subspace_accumulate (K11a): for every system row r, over its
//     observations (y = Y[col], v the rating, x the row's CURRENT factors,
//     d = y·x over all k columns, the slot's score):
//       A[r] = Σ w_a·y_B y_Bᵀ            [b, b]
//       r[r] = Σ (w_b − w_a·d)·y_B        [b]
//     explicit w_a = 1, w_b = v; implicit w_a = α|v|, w_b = 1(v>0)(1+α|v|),
//     as K1 weighs them. A and r are written in full (zeros for rows
//     without observations).
//   subspace_block_solve (K11b): for every row with observations,
//       δ = (A + G_BB + λ[r]·I)⁻¹ (r − (G x)_B − λ[r]·x_B)
//     (G, implicit mode's Gramian of the counter side, omitted in explicit
//     mode) by Cholesky with the forward substitution fused (rsqrt pivot,
//     as K2), then x_B += δ in place. Rows without observations keep x
//     (δ = 0). It also sums δ² over all rows (the block's delta RMS) and,
//     after the sweep's last block, x² over the whole factor array (the
//     factor RMS), through per-block partials summed in a fixed order.
// The carried score. Between two blocks of a half-step only x_{B−1}
// changes, so d need not be formed anew over all k columns: block 0 forms
// it and keeps it in a score buffer (one float a slot of the pack), K11b
// writes Δ = x_new − x_old over its block's columns, and block j >= 1
// reads d + y_{B−1}·Δ[row], writes it back (but in the half-step's last
// block, whose score nothing reads) and forms A and r from it. In exact
// arithmetic d is the same; in float32 it drifts from a full recompute by
// a few roundings a block (ops/subspace.py states the limits the tests
// hold it to).
//
// Bound on an H100 SXM, at the ML-20M stream with rank 64 and b = 8. Per
// slot and block K11a needs k FMAs for d, b(b+1)/2 for the triangle and b
// for r: 108 FMAs, 216 operations; ≈34.6 GFLOP per half-step over 20M
// slots, ≈0.52 ms at 67 TFLOP/s fp32. Its bytes are the 8-byte slots of
// the pack re-read once per block (≈1.28 GB over the 8 blocks, ≈0.38 ms at
// 3.35 TB/s) plus each block's A and r: it is bound by operations, near
// balance (the function's bound, 0.0742 ms a launch by bytes at 3p's user
// side, 0.0645 by operations). The gathered rows come from L2: X is 37.7
// MB at rank 64, Y 7.3 MB. Block 0 gathers each slot's whole row (256 B):
// 5.1 GB a launch at ML-20M, ≈0.9 ms at L2's rate (≈5.5 TB/s). The carried
// blocks gather 2b columns a slot (64 B at b = 8: ≈1.28 GB, ≈0.23 ms from
// L2) and move about 16 B a slot from device memory (the pack's 8, the
// score read and written: ≈0.32 GB, ≈0.096 ms); they do b + b(b+1)/2 + b
// = 52 FMAs a slot, not 108. Those two floors, not the function's bound,
// are what the carried form can reach. K11b is bound by bytes: A, r, x_B
// and Δ of every row.
//
// Design. K11a walks K1's plan of groups (up to 8 consecutive segments of
// one row; a row with several groups writes one partial per group, summed
// in slot order by subspace_combine, so a skewed row spreads over many
// warps and no atomics are used), a group to a warp at a time, in one of
// three forms:
//   subspace_accumulate_lanes (k <= 64 and b in {1, 2, 4, 8}, block 0: the
//     main path's first block of a half-step): one lane per slot. The warp
//     gathers each 32-slot chunk's whole rows into a shared tile (cp.async,
//     16 bytes a copy, several slots a wave) while the next chunk's column
//     ids and ratings load; lane q forms its slot's d from its row and the
//     group's x row (shared, a broadcast), writes it to the score buffer
//     and adds the slot into its own b(b+1)/2 + b sums; at the group's end
//     the lanes' sums are added up per output in lane order through the
//     tile. Two warps a block: the tile is 8.7 KB a warp at rank 64.
//   subspace_accumulate_carried (the same k and b, blocks j >= 1): the
//     same lanes and sums, but each slot gathers only columns [s0 − b,
//     s0 + b) (64 B at b = 8) and carries its score with its row's Δ. With
//     so little to gather, a group is too short to hide the chain of loads
//     that starts it (header, slot counts, first slots, gather), so each
//     warp walks a stride of groups as one stream of 64-slot chunks (two
//     slots a lane), its pipeline running across the groups' bounds: slots
//     loaded two chunks before their sums, rows gathered one chunk ahead
//     into two tiles, a group's Δ row, row and slot parked in a small
//     shared ring of groups, and a group written out where its successor's
//     first chunk is summed. The grid holds as many warps as the card runs
//     at once. PERF.md (PR 20) has the times beside the floors above.
//   subspace_accumulate_groups (any other k <= 200 and b): lanes along k,
//     off the main path; it keeps the full recompute of d in every block
//     and takes no score buffer.
//     The row's x stays in registers (lane l holds columns l, l+32, ...).
//     The warp walks its slots 32 at a time: each lane loads one slot's
//     column id and weights; then for QU = 4 slots at a time it gathers
//     their y rows (128 bytes a load, QU rows in flight), forms each d by
//     a fixed butterfly, and parks y_B and the weights in shared memory.
//     Then every lane adds the parked slots into the outputs it owns (up
//     to 4 entries of the b(b+1)/2 + b outputs; wider blocks split their
//     outputs over blockIdx.y, each re-walking the slots). About 55 warp
//     instructions a slot at b = 8; the main path ran on it first.
//   subspace_block_solve_rows: one warp per row, the b x b system in shared
//     memory (row stride b+1) with G_BB and λ added as it is loaded;
//     (G x)_B by a butterfly per entry with G's rows read through the
//     cache; the Cholesky and the substitutions as K2's shared-memory form;
//     when given the Δ buffer, each row's change of x_B written there.
//   Sums are fixed-order: no atomics, so a run repeats bit for bit.
// Products are fp32 FMAs on the CUDA cores, never TF32.
//
// K11a-bf16 (subspace_accumulate_f32 with bf16 = 1): the reference's
// compute_dtype="bfloat16" form of the block body (:680 Yc = bf16(Y), :701
// xg = bf16(x[rows]), :716 and :721 the cast weights), both forms above
// with BF16 set. Each gathered y row and the row's current x are rounded
// to bfloat16 as they are read, in every block (x changes after each
// block); d = Σ y·x is summed in float32 from exact products; A's weight
// is bf16(w_a), and the residual's weight bf16(w_b − w_a·d) is formed in
// float32 from the unrounded w_a and w_b with a separate product and
// difference (no FMA contraction: the reference rounds the product), then
// rounded. The products and sums stay the float32 FMAs above. The carried
// score: K11b writes Δ = bf16(x_new) − bf16(x_old), and the increment
// Σ bf16(y)·Δ is summed in float32, so d stays Σ bf16(y)·bf16(x) up to
// float32 rounding. Bound: the same operations at the bf16 tensor-core
// peak against the same pack bytes, so bound by bytes. K11b solves in
// float32.

#include <cuda_runtime.h>

#include <cstdint>

#include "bf16.cuh"
#include "tiling.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;            // warps per accumulate block (groups, carried forms)
constexpr int LANES_WARPS = 2;      // warps (= groups) per block of the lanes form
constexpr int QU = 4;               // slots whose gathers are in flight together
constexpr int OUT_PER_LANE = 4;     // outputs a lane owns per output tile
constexpr int OUT_TILE = 32 * OUT_PER_LANE;
constexpr int COMBINE_THREADS = 256;
constexpr int MAX_SOLVE_WARPS = 8;
constexpr int REDUCE_THREADS = 256;
constexpr size_t DEFAULT_SMEM = 48 * 1024;
constexpr size_t MAX_SMEM = 227 * 1024;

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// The residual's weight w_b − w_a·d. In bfloat16 compute the reference
// forms it in float32 with the product rounded on its own, then casts it.
template <bool BF16>
__device__ __forceinline__ float residual_weight(float wa, float wb, float d) {
  if constexpr (BF16) {
    return round_bf16(__fsub_rn(wb, __fmul_rn(wa, d)));
  } else {
    return wb - wa * d;
  }
}

// T = ceil(k / 32) columns per lane, a template argument so the main
// path's rank (k = 64, T = 2) runs without guards on unused chunks.
template <int T, bool BF16>
__global__ void __launch_bounds__(32 * WARPS) subspace_accumulate_groups(
    const float* __restrict__ Y, const float* __restrict__ X,
    const int* __restrict__ cols, const float* __restrict__ vals,
    const int* __restrict__ rem, const int* __restrict__ groups, int n_groups,
    float* __restrict__ partials, float* __restrict__ A, float* __restrict__ r,
    int k, int L, int s0, int b, int implicit, float alpha) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sy = smem + warp * (32 * b + 64);  // [32][b] parked y_B rows
  float* swa = sy + 32 * b;                 // [32] w_a
  float* sco = swa + 32;                    // [32] w_b − w_a·d
  const int g = blockIdx.x * WARPS + warp;
  if (g >= n_groups) return;  // no block barrier below
  const int row = groups[g];
  const int seg0 = groups[n_groups + g];
  const int s_end = seg0 + groups[2 * n_groups + g];
  const int slot = groups[3 * n_groups + g];
  const int ntri = b * (b + 1) / 2;
  const int nout = ntri + b;

  float xv[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int c = lane + 32 * t;
    xv[t] = c < k ? in_cdt<BF16>(X[(long long)row * k + c]) : 0.f;
  }
  // owned outputs: triangle entries (oi >= oj), r entries (oj = -1), or
  // none (oi = -1)
  int oi[OUT_PER_LANE], oj[OUT_PER_LANE];
  float acc[OUT_PER_LANE];
#pragma unroll
  for (int m = 0; m < OUT_PER_LANE; ++m) {
    const int e = blockIdx.y * OUT_TILE + lane + 32 * m;
    acc[m] = 0.f;
    oi[m] = -1;
    oj[m] = -1;
    if (e < ntri) {
      lower_tile(e, oi[m], oj[m]);
    } else if (e < nout) {
      oi[m] = e - ntri;
    }
  }

  for (int s = seg0; s < s_end; ++s) {
    const int n = rem[s];
    const long long base = (long long)s * L;
    for (int l0 = 0; l0 < n; l0 += 32) {
      const int c = min(32, n - l0);
      int col = 0;
      float wa = 0.f, wb = 0.f;
      if (lane < c) {
        col = cols[base + l0 + lane];
        const float v = vals[base + l0 + lane];
        if (implicit) {
          wa = alpha * fabsf(v);
          wb = v > 0.f ? 1.f + wa : 0.f;
        } else {
          wa = 1.f;
          wb = v;
        }
      }
      for (int q0 = 0; q0 < c; q0 += QU) {
        float yv[QU][T];
#pragma unroll
        for (int u = 0; u < QU; ++u) {
          const int q = q0 + u;
          const int cq = __shfl_sync(FULL, col, q & 31);
          const float* src = Y + (long long)cq * k;
#pragma unroll
          for (int t = 0; t < T; ++t) {
            const int cc = lane + 32 * t;
            yv[u][t] = (q < c && cc < k) ? in_cdt<BF16>(src[cc]) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < QU; ++u) {
          const int q = q0 + u;
          float part = 0.f;
#pragma unroll
          for (int t = 0; t < T; ++t) part = fmaf(yv[u][t], xv[t], part);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
          const float waq = __shfl_sync(FULL, wa, q & 31);
          const float wbq = __shfl_sync(FULL, wb, q & 31);
          if (q < c) {
#pragma unroll
            for (int t = 0; t < T; ++t) {
              const int cc = lane + 32 * t;
              if (cc >= s0 && cc < s0 + b) sy[q * b + (cc - s0)] = yv[u][t];
            }
            if (lane == 0) {
              swa[q] = in_cdt<BF16>(waq);
              sco[q] = residual_weight<BF16>(waq, wbq, part);
            }
          }
        }
        __syncwarp();
      }
#pragma unroll
      for (int m = 0; m < OUT_PER_LANE; ++m) {
        if (oi[m] < 0) continue;
        float a = acc[m];
        if (oj[m] >= 0) {
          for (int q = 0; q < c; ++q) {
            a = fmaf(swa[q] * sy[q * b + oi[m]], sy[q * b + oj[m]], a);
          }
        } else {
          for (int q = 0; q < c; ++q) a = fmaf(sco[q], sy[q * b + oi[m]], a);
        }
        acc[m] = a;
      }
      __syncwarp();  // the parked slots' readers are done before the next chunk
    }
  }

  float* dA;
  float* dr;
  if (slot < 0) {
    dA = A + (long long)row * b * b;
    dr = r + (long long)row * b;
  } else {
    dA = partials + (long long)slot * (b * b + b);
    dr = dA + b * b;
  }
#pragma unroll
  for (int m = 0; m < OUT_PER_LANE; ++m) {
    if (oi[m] < 0) continue;
    if (oj[m] >= 0) {
      dA[oi[m] * b + oj[m]] = acc[m];
      if (oi[m] != oj[m]) dA[oj[m] * b + oi[m]] = acc[m];
    } else {
      dr[oi[m]] = acc[m];
    }
  }
}

// The lanes form's tile (k <= 32·T, T <= 2, b = B in {1, 2, 4, 8}): each
// slot's whole row padded to K = 32·T, 16 bytes a copy (4 where k is not a
// multiple of 4), at a row stride of NWP = K + 4 floats, an odd number of
// float4s, so a quarter warp's float4 reads of their own rows hit distinct
// banks. One tile a warp, so that an SM's shared memory holds twice the
// warps two would; the lanes' sums reuse it at the group's end.
template <int T, int B>
struct LanesTile {
  static constexpr int K = 32 * T;
  static constexpr int NWP = K + 4;
  static constexpr int NTRI = B * (B + 1) / 2;
  static constexpr int NOUT = NTRI + B;
  static constexpr int RP = NOUT | 1;  // odd stride of the lanes' sums
  static constexpr int TILE = 32 * NWP;
  static constexpr int SUMS = 32 * RP;
  static constexpr int XS = TILE > SUMS ? TILE : SUMS;  // the row's x after it
  static constexpr int WARP_FLOATS = XS + K;
};

// One chunk of up to 32 consecutive slots of a segment: lane q holds slot
// q's column id and rating.
struct SlotChunk {
  int s, l0, c;  // segment, first slot, slot count (0: past the group)
  int col;
  float v;
};

// The group's segments' slot counts: lane l holds rem[seg0 + l] (a group
// has at most 32 segments: K1's plan takes 8), read back by shuffle, so
// walking the chunks loads nothing but the slots themselves.
struct GroupRem {
  int seg0, mine;
  __device__ __forceinline__ int of(const int* __restrict__ rem, int s) const {
    const int i = s - seg0;
    const int v = __shfl_sync(FULL, mine, i & 31);
    return i < 32 ? v : rem[s];
  }
};

__device__ __forceinline__ SlotChunk load_slots(const int* __restrict__ cols,
                                                const float* __restrict__ vals,
                                                const int* __restrict__ rem,
                                                const GroupRem& gr, int s, int l0,
                                                int s_end, int L, int lane) {
  SlotChunk ch{s, l0, 0, 0, 0.f};
  if (s < s_end) {
    ch.c = min(32, gr.of(rem, s) - l0);
    const long long at = (long long)s * L + l0 + lane;
    if (lane < ch.c) {
      ch.col = cols[at];
      ch.v = vals[at];
    }
  }
  return ch;
}

// The segment and first slot of the chunk after the one at (s, l0) (a
// group's segments all hold slots: K1's plan leaves the empty ones out).
__device__ __forceinline__ void next_slots(const int* __restrict__ rem,
                                           const GroupRem& gr, int& s,
                                           int& l0) {
  l0 += 32;
  if (l0 >= gr.of(rem, s)) {
    ++s;
    l0 = 0;
  }
}

// N floats of a tile row into registers, VW at a time, in the compute
// type (rounded to bfloat16 when BF16).
template <int VW, bool BF16, int N>
__device__ __forceinline__ void read_row(const float* src, float (&dst)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += VW) {
    if constexpr (VW == 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      dst[i] = v.x;
      dst[i + 1] = v.y;
      dst[i + 2] = v.z;
      dst[i + 3] = v.w;
    } else if constexpr (VW == 2) {
      const float2 v = *reinterpret_cast<const float2*>(src + i);
      dst[i] = v.x;
      dst[i + 1] = v.y;
    } else {
      dst[i] = src[i];
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = in_cdt<BF16>(dst[i]);
}

// k <= 32·T, T <= 2, and b = B in {1, 2, 4, 8} (the main path's rank 64
// with b = 8): one lane per slot, block 0 of a half-step (or any block
// without a carried score). The warp walks its group's slots 32 at a time:
// it gathers a chunk's whole rows into its tile (cp.async, 16 bytes a
// copy where k is a multiple of 4, several slots a wave; the column ids
// and ratings of the next chunk loaded meanwhile, the segments' slot
// counts held in registers); lane q forms slot q's d = y·x over the K
// columns (the group's x row in shared memory, read as a broadcast),
// writes it to score[slot] when score is given, and adds the slot into
// its private b(b+1)/2 + b sums. At the group's end the lanes' sums go
// through the tile, and lane e adds up output e over the 32 lanes in
// order.
template <int T, int B, bool BF16>
__global__ void __launch_bounds__(32 * LANES_WARPS) subspace_accumulate_lanes(
    const float* __restrict__ Y, const float* __restrict__ X,
    const int* __restrict__ cols, const float* __restrict__ vals,
    const int* __restrict__ rem, const int* __restrict__ groups, int n_groups,
    float* __restrict__ partials, float* __restrict__ A, float* __restrict__ r,
    int k, int L, int s0, int implicit, float alpha, float* __restrict__ score,
    int vec) {
  using G = LanesTile<T, B>;
  constexpr int K = G::K;
  constexpr int NWP = G::NWP;
  constexpr int NTRI = G::NTRI;
  constexpr int NOUT = G::NOUT;
  constexpr int RP = G::RP;
  extern __shared__ __align__(16) float lanes_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * LANES_WARPS + warp;
  if (g >= n_groups) return;  // no block barrier below
  float* tile = lanes_smem + warp * G::WARP_FLOATS;
  float* sx = tile + G::XS;  // the row's x
  const int row = groups[g];
  const int seg0 = groups[n_groups + g];
  const int s_end = seg0 + groups[2 * n_groups + g];
  const int slot = groups[3 * n_groups + g];

#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int c = lane + 32 * t;
    sx[c] = c < k ? in_cdt<BF16>(X[(long long)row * k + c]) : 0.f;
  }
  // the lane's share of a gather: piece p (pw floats) of slot qs's row, for
  // np pieces a slot (a power of two) and 32 / np slots a wave
  const int pw = vec ? 4 : 1;
  const int np = K / pw;
  const int shift = __ffs(np) - 1;
  auto gather = [&](const SlotChunk& ch) {
    for (int e = lane; e < 32 * np; e += 32) {
      const int qs = e >> shift;
      const int p = e & (np - 1);
      const int col = __shfl_sync(FULL, ch.col, qs);
      if (qs < ch.c) {
        const int cc = p * pw;
        const bool in = cc < k;
        const float* src = Y + (long long)col * k + (in ? cc : 0);
        const unsigned dst = (unsigned)__cvta_generic_to_shared(tile + qs * NWP + cc);
        if (pw == 4) {
          asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                       "r"(in ? 16 : 0));
        } else {
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                       "r"(in ? 4 : 0));
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[NOUT];
#pragma unroll
  for (int e = 0; e < NOUT; ++e) acc[e] = 0.f;

  const GroupRem gr{seg0, lane < s_end - seg0 ? rem[seg0 + lane] : 0};
  int s = seg0, l0 = 0;
  SlotChunk cur = load_slots(cols, vals, rem, gr, s, l0, s_end, L, lane);
  if (cur.c) next_slots(rem, gr, s, l0);
  while (cur.c) {
    gather(cur);
    const SlotChunk nxt = load_slots(cols, vals, rem, gr, s, l0, s_end, L, lane);
    if (nxt.c) next_slots(rem, gr, s, l0);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncwarp();
    if (lane < cur.c) {
      const float* y = tile + lane * NWP;
      const long long at = (long long)cur.s * L + cur.l0 + lane;
      float d = 0.f;
#pragma unroll
      for (int cc = 0; cc < K; cc += 4) {
        const float4 yv = *reinterpret_cast<const float4*>(y + cc);
        const float4 xv = *reinterpret_cast<const float4*>(sx + cc);
        d = fmaf(in_cdt<BF16>(yv.x), xv.x, d);
        d = fmaf(in_cdt<BF16>(yv.y), xv.y, d);
        d = fmaf(in_cdt<BF16>(yv.z), xv.z, d);
        d = fmaf(in_cdt<BF16>(yv.w), xv.w, d);
      }
      if (score != nullptr) score[at] = d;
      float yb[B];
#pragma unroll
      for (int i = 0; i < B; ++i) yb[i] = in_cdt<BF16>(y[s0 + i]);
      float wa, wb;
      if (implicit) {
        wa = alpha * fabsf(cur.v);
        wb = cur.v > 0.f ? 1.f + wa : 0.f;
      } else {
        wa = 1.f;
        wb = cur.v;
      }
      const float co = residual_weight<BF16>(wa, wb, d);
      const float wA = in_cdt<BF16>(wa);
      int e = 0;
#pragma unroll
      for (int i = 0; i < B; ++i) {
        const float wy = wA * yb[i];
#pragma unroll
        for (int j = 0; j <= i; ++j, ++e) acc[e] = fmaf(wy, yb[j], acc[e]);
      }
#pragma unroll
      for (int i = 0; i < B; ++i) acc[NTRI + i] = fmaf(co, yb[i], acc[NTRI + i]);
    }
    __syncwarp();  // the tile's readers are done before it is refilled
    cur = nxt;
  }

  float* sums = tile;
#pragma unroll
  for (int e = 0; e < NOUT; ++e) sums[lane * RP + e] = acc[e];
  __syncwarp();
  float* dA;
  float* dr;
  if (slot < 0) {
    dA = A + (long long)row * B * B;
    dr = r + (long long)row * B;
  } else {
    dA = partials + (long long)slot * (B * B + B);
    dr = dA + B * B;
  }
  for (int e = lane; e < NOUT; e += 32) {
    float sum = 0.f;
#pragma unroll 8
    for (int q = 0; q < 32; ++q) sum += sums[q * RP + e];
    if (e < NTRI) {
      int i, j;
      lower_tile(e, i, j);
      dA[i * B + j] = sum;
      dA[j * B + i] = sum;
    } else {
      dr[e - NTRI] = sum;
    }
  }
}

// The carried blocks' form, streamed: each warp walks a stride of groups
// (g, g + W, g + 2W, ... for W warps in the grid, about as many as the
// card holds at once) as one stream of 32·U-slot chunks, so the loads of a
// group's header, slot counts, Δ row and first slots are in flight while
// the group before it is summed. Chunk n's slots (column ids, ratings,
// scores) are loaded RING − S + 1 chunks before its gather, its gather
// (cp.async, min(B, 4) floats a copy, 2B columns a slot) S − 1 chunks
// before its sums; a group's Δ row goes by cp.async into a small ring of
// groups in shared memory, behind its first chunk's loads. Where a chunk
// starts a group, the group before it is written out first (its lanes'
// sums through a shared region of their own, added up per output in lane
// order, as the lanes form does); a group without slots streams one empty
// chunk, so its zeros are written too.
template <int B>
struct CarriedTile {
  static constexpr int NW = 2 * B;
  static constexpr int VW = B < 4 ? B : 4;
  static constexpr int NWP = NW + VW;
  static constexpr int NTRI = B * (B + 1) / 2;
  static constexpr int NOUT = NTRI + B;
  static constexpr int RP = NOUT | 1;
  static constexpr int U = 2;         // slots a lane a chunk: chunks of 32·U slots
  static constexpr int S = 2;         // tiles: a chunk's gather one chunk ahead of its sums
  static constexpr int RING = 2;      // chunks held in registers: n .. n + RING − 1
  static constexpr int GR = 8;        // groups in flight (> RING + 1), a power of two
  static constexpr int TILES = S * 32 * U * NWP;
  static constexpr int SUMS = 32 * RP;
  // tiles, the lanes' sums, the groups' Δ rows, their rows and slots
  static constexpr int WARP_FLOATS = (TILES + SUMS + GR * B + 2 * GR + 3) / 4 * 4;
};

// A group's header: its row, first segment, end segment and partial slot,
// and lane l's slot count of segment seg0 + l.
struct GroupHead {
  int row, seg0, s_end, slot;
};

__device__ __forceinline__ GroupHead load_head(const int* __restrict__ groups, int n_groups,
                                               int g) {
  GroupHead h{0, 0, 0, -1};
  if (g < n_groups) {
    h.row = groups[g];
    h.seg0 = groups[n_groups + g];
    h.s_end = h.seg0 + groups[2 * n_groups + g];
    h.slot = groups[3 * n_groups + g];
  }
  return h;
}

// One streamed chunk: up to 32·U slots of one group, lane q's slots q,
// q + 32, ... meta packs whether it is a chunk at all (bit 0), whether it
// starts its group (bit 1), its group's place in the shared ring (bits
// 2-4) and its slot count (bits 8-15; 0 for a group without slots).
template <int U>
struct StreamChunk {
  int meta;
  long long at;
  int col[U];
  float v[U], d[U];
  __device__ __forceinline__ bool valid() const { return meta & 1; }
  __device__ __forceinline__ bool first() const { return meta & 2; }
  __device__ __forceinline__ int gq() const { return (meta >> 2) & 7; }
  __device__ __forceinline__ int c() const { return meta >> 8; }
};

template <int B, bool BF16>
__global__ void __launch_bounds__(32 * WARPS) subspace_accumulate_carried(
    const float* __restrict__ Y, const int* __restrict__ cols,
    const float* __restrict__ vals, const int* __restrict__ rem,
    const int* __restrict__ groups, int n_groups, float* __restrict__ partials,
    float* __restrict__ A, float* __restrict__ r, int k, int L, int s0,
    int implicit, float alpha, float* __restrict__ score,
    const float* __restrict__ delta, int write_score) {
  using G = CarriedTile<B>;
  constexpr int U = G::U;
  using Chunk = StreamChunk<U>;
  constexpr int NWP = G::NWP;
  constexpr int VW = G::VW;
  constexpr int NP = G::NW / VW;  // copies a slot
  constexpr int NTRI = G::NTRI;
  constexpr int NOUT = G::NOUT;
  constexpr int RP = G::RP;
  constexpr int S = G::S;
  constexpr int RING = G::RING;
  constexpr int GR = G::GR;
  extern __shared__ __align__(16) float carried_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* tiles = carried_smem + warp * G::WARP_FLOATS;
  float* sums = tiles + G::TILES;
  float* gring = sums + G::SUMS;  // [GR][B] the groups' Δ rows
  int* ghead = reinterpret_cast<int*>(gring + GR * B);  // [GR][2] their rows and slots
  const int stride = gridDim.x * WARPS;
  const int c0 = s0 - B;

  // the load frontier: group lg (header lh, slot counts lgr), at (s, l0);
  // the next group's header nh, its slot counts loaded one step later
  int lg = blockIdx.x * WARPS + warp;
  GroupHead lh = load_head(groups, n_groups, lg);
  GroupRem lgr{lh.seg0, lane < lh.s_end - lh.seg0 ? rem[lh.seg0 + lane] : 0};
  GroupHead nh = load_head(groups, n_groups, lg + stride);
  int n_rem = 0;
  bool n_rem_due = true;
  int s = lh.seg0, l0 = 0, lq = 0;
  bool lfirst = true;

  auto emit = [&]() {
    Chunk ch{};
    if (lg >= n_groups) return ch;
    if (n_rem_due) {  // the next group's slot counts, its header now in
      n_rem = lane < nh.s_end - nh.seg0 ? rem[nh.seg0 + lane] : 0;
      n_rem_due = false;
    }
    int c = 0;
    if (lfirst && lane == 0) {
      ghead[2 * lq] = lh.row;
      ghead[2 * lq + 1] = lh.slot;
    }
    if (lfirst && lane < B / VW) {  // the group's Δ row into its place in the ring
      const unsigned dst = (unsigned)__cvta_generic_to_shared(gring + lq * B + lane * VW);
      const float* src = delta + (long long)lh.row * B + lane * VW;
      if constexpr (VW == 4) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
      } else if constexpr (VW == 2) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src));
      } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
      }
    }
    ch.meta = 1 | (lfirst ? 2 : 0) | (lq << 2);
    lfirst = false;
    if (s < lh.s_end) {
      const int n = lgr.of(rem, s);
      c = min(32 * U, n - l0);
      ch.meta |= c << 8;
      ch.at = (long long)s * L + l0;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (32 * u + lane < c) {
          ch.col[u] = cols[ch.at + 32 * u + lane];
          ch.v[u] = vals[ch.at + 32 * u + lane];
          ch.d[u] = score[ch.at + 32 * u + lane];
        }
      }
      l0 += 32 * U;
      if (l0 >= n) {
        ++s;
        l0 = 0;
      }
    }
    if (s >= lh.s_end) {  // the group is streamed: on to the next
      lg += stride;
      lh = nh;
      lgr = GroupRem{nh.seg0, n_rem};
      nh = load_head(groups, n_groups, lg + stride);
      n_rem_due = true;
      s = lh.seg0;
      l0 = 0;
      lq = (lq + 1) & (GR - 1);
      lfirst = true;
    }
    return ch;
  };
  auto gather = [&](float* tile, const Chunk& ch) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int e = lane; e < 32 * NP; e += 32) {
        const int qs = 32 * u + e / NP;
        const int p = e % NP;
        const int col = __shfl_sync(FULL, ch.col[u], e / NP);
        if (qs < ch.c()) {
          const float* src = Y + (long long)col * k + c0 + p * VW;
          const unsigned dst = (unsigned)__cvta_generic_to_shared(tile + qs * NWP + p * VW);
          if constexpr (VW == 4) {
            asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
          } else if constexpr (VW == 2) {
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src));
          } else {
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
          }
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[NOUT];
#pragma unroll
  for (int e = 0; e < NOUT; ++e) acc[e] = 0.f;
  int crow = 0, cslot = -1;
  bool cactive = false;
  float dl[B];
#pragma unroll
  for (int i = 0; i < B; ++i) dl[i] = 0.f;

  // the group's sums out: through `sums`, each output added up in lane order
  auto flush = [&]() {
#pragma unroll
    for (int e = 0; e < NOUT; ++e) sums[lane * RP + e] = acc[e];
    __syncwarp();
    float* dA;
    float* dr;
    if (cslot < 0) {
      dA = A + (long long)crow * B * B;
      dr = r + (long long)crow * B;
    } else {
      dA = partials + (long long)cslot * (B * B + B);
      dr = dA + B * B;
    }
    for (int e = lane; e < NOUT; e += 32) {
      float sum = 0.f;
#pragma unroll 8
      for (int q = 0; q < 32; ++q) sum += sums[q * RP + e];
      if (e < NTRI) {
        int i, j;
        lower_tile(e, i, j);
        dA[i * B + j] = sum;
        dA[j * B + i] = sum;
      } else {
        dr[e - NTRI] = sum;
      }
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < NOUT; ++e) acc[e] = 0.f;
  };

  Chunk ring[RING + 1];
#pragma unroll
  for (int i = 0; i < RING; ++i) ring[i] = emit();
#pragma unroll
  for (int i = 0; i < S - 1; ++i) gather(tiles + i * 32 * U * NWP, ring[i]);
  for (int t = 0; ring[0].valid(); t = t + 1 == S ? 0 : t + 1) {
    gather(tiles + (t == 0 ? S - 1 : t - 1) * 32 * U * NWP, ring[S - 1]);
    ring[RING] = emit();
    if constexpr (S == 3) {
      asm volatile("cp.async.wait_group 2;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 1;\n" ::);
    }
    __syncwarp();
    const Chunk cur = ring[0];
    if (cur.first()) {
      if (cactive) flush();
      cactive = true;
      crow = ghead[2 * cur.gq()];
      cslot = ghead[2 * cur.gq() + 1];
#pragma unroll
      for (int i = 0; i < B; ++i) dl[i] = gring[cur.gq() * B + i];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (32 * u + lane < cur.c()) {
        const float* y = tiles + (t * 32 * U + 32 * u + lane) * NWP;
        float yp[B], yb[B];
        read_row<VW, BF16>(y, yp);
        read_row<VW, BF16>(y + B, yb);
        float inc = 0.f;
#pragma unroll
        for (int i = 0; i < B; ++i) inc = fmaf(yp[i], dl[i], inc);
        const float d = cur.d[u] + inc;
        if (write_score) score[cur.at + 32 * u + lane] = d;
        float wa, wb;
        if (implicit) {
          wa = alpha * fabsf(cur.v[u]);
          wb = cur.v[u] > 0.f ? 1.f + wa : 0.f;
        } else {
          wa = 1.f;
          wb = cur.v[u];
        }
        const float co = residual_weight<BF16>(wa, wb, d);
        const float wA = in_cdt<BF16>(wa);
        int e = 0;
#pragma unroll
        for (int i = 0; i < B; ++i) {
          const float wy = wA * yb[i];
#pragma unroll
          for (int j = 0; j <= i; ++j, ++e) acc[e] = fmaf(wy, yb[j], acc[e]);
        }
#pragma unroll
        for (int i = 0; i < B; ++i) acc[NTRI + i] = fmaf(co, yb[i], acc[NTRI + i]);
      }
    }
    __syncwarp();  // the tile's readers are done before it is refilled
#pragma unroll
    for (int i = 0; i < RING; ++i) ring[i] = ring[i + 1];
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  if (cactive) flush();
}

__global__ void __launch_bounds__(COMBINE_THREADS) subspace_combine(
    const float* __restrict__ partials, const int* __restrict__ c_rows,
    const int* __restrict__ c_start, float* __restrict__ A,
    float* __restrict__ r, int b) {
  const int m = blockIdx.x;
  const int E = b * b + b;
  const int e = blockIdx.y * COMBINE_THREADS + threadIdx.x;
  if (e >= E) return;
  const int p1 = c_start[m + 1];
  float s = 0.f;
  for (int p = c_start[m]; p < p1; ++p) s += partials[(long long)p * E + e];
  const long long row = c_rows[m];
  if (e < b * b) {
    A[row * b * b + e] = s;
  } else {
    r[row * b + (e - b * b)] = s;
  }
}

__host__ __device__ inline int solve_floats(int b) { return b * (b + 1) + 3 * b; }

inline int solve_warps(int b) {
  const size_t bytes = (size_t)solve_floats(b) * sizeof(float);
  int w = (int)(DEFAULT_SMEM / bytes);
  if (w > MAX_SOLVE_WARPS) w = MAX_SOLVE_WARPS;
  return w < 1 ? 1 : w;
}

__global__ void subspace_block_solve_rows(
    const float* __restrict__ A, const float* __restrict__ rv,
    const float* __restrict__ G, const float* __restrict__ lam,
    const unsigned char* __restrict__ has_obs, float* __restrict__ X,
    float* __restrict__ partials, float* __restrict__ delta, int R, int k,
    int s0, int b, int W, int last, int bf16) {
  extern __shared__ float smem[];
  const int bp = b + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sA = smem + warp * solve_floats(b);  // [b][b+1]
  float* sy = sA + b * bp;                    // rhs, then y
  float* sd = sy + b;                         // 1 / L_jj
  float* sx = sd + b;                         // δ
  float* red = smem + W * solve_floats(b);    // [2 * W]
  const long long row = (long long)blockIdx.x * W + warp;
  float dsq = 0.f, xsq = 0.f;

  if (row < R) {
    float* xr = X + row * k;
    if (has_obs[row]) {
      const float* a = A + row * b * b;
      const float lr = lam[row];
      for (int e = lane; e < b * b; e += 32) {
        const int i = e / b;
        const int j = e - i * b;
        float v = a[e];
        if (G != nullptr) v += G[(long long)(s0 + i) * k + s0 + j];
        sA[i * bp + j] = i == j ? v + lr : v;
      }
      // the right side r − (G x)_B − λ·x_B, (G x)_B by a butterfly per entry
      for (int i = 0; i < b; ++i) {
        float gx = 0.f;
        if (G != nullptr) {
          const float* gi = G + (long long)(s0 + i) * k;
          for (int c = lane; c < k; c += 32) gx = fmaf(gi[c], xr[c], gx);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) gx += __shfl_xor_sync(FULL, gx, o);
        }
        if (lane == 0) {
          float v = rv[row * b + i];
          if (G != nullptr) v -= gx;
          sy[i] = v - lr * xr[s0 + i];
        }
      }
      __syncwarp();
      // Cholesky with the forward substitution fused
      for (int j = 0; j < b; ++j) {
        const float d = rsqrtf(sA[j * bp + j]);
        const float yj = sy[j] * d;
        for (int i = j + 1 + lane; i < b; i += 32) sA[i * bp + j] *= d;
        __syncwarp();
        if (lane == 0) {
          sy[j] = yj;
          sd[j] = d;
        }
        for (int i = j + 1 + lane; i < b; i += 32) {
          const float ci = sA[i * bp + j];
          sy[i] = fmaf(-ci, yj, sy[i]);
          for (int l = j + 1; l <= i; ++l) {
            sA[i * bp + l] = fmaf(-ci, sA[l * bp + j], sA[i * bp + l]);
          }
        }
        __syncwarp();
      }
      // back substitution, column by column
      for (int j = b - 1; j >= 0; --j) {
        const float xj = sy[j] * sd[j];
        if (lane == 0) sx[j] = xj;
        for (int i = lane; i < j; i += 32) sy[i] = fmaf(-sA[j * bp + i], xj, sy[i]);
        __syncwarp();
      }
      for (int i = lane; i < b; i += 32) {
        const float dl = sx[i];
        const float xo = xr[s0 + i];
        const float xn = xo + dl;
        xr[s0 + i] = xn;
        dsq = fmaf(dl, dl, dsq);
        // the carried score's increment: the change of x as the next
        // block's K11a reads it (rounded first in bfloat16 compute)
        if (delta != nullptr) {
          delta[row * b + i] = bf16 ? round_bf16(xn) - round_bf16(xo) : xn - xo;
        }
      }
      __syncwarp();
    } else if (delta != nullptr) {
      for (int i = lane; i < b; i += 32) delta[row * b + i] = 0.f;
    }
    if (last) {
      for (int c = lane; c < k; c += 32) {
        const float v = xr[c];
        xsq = fmaf(v, v, xsq);
      }
    }
  }

  if (partials != nullptr) {  // a butterfly, then the block's warps in order
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      dsq += __shfl_xor_sync(FULL, dsq, o);
      xsq += __shfl_xor_sync(FULL, xsq, o);
    }
    if (lane == 0) {
      red[2 * warp] = dsq;
      red[2 * warp + 1] = xsq;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float a0 = 0.f, a1 = 0.f;
      for (int w = 0; w < W; ++w) {
        a0 += red[2 * w];
        a1 += red[2 * w + 1];
      }
      partials[2 * blockIdx.x] = a0;
      partials[2 * blockIdx.x + 1] = a1;
    }
  }
}

__global__ void __launch_bounds__(REDUCE_THREADS) subspace_reduce(
    const float* __restrict__ partials, int n, float* __restrict__ sums) {
  __shared__ float s0[REDUCE_THREADS], s1[REDUCE_THREADS];
  const int t = threadIdx.x;
  float a = 0.f, c = 0.f;
  for (int p = t; p < n; p += REDUCE_THREADS) {
    a += partials[2 * p];
    c += partials[2 * p + 1];
  }
  s0[t] = a;
  s1[t] = c;
  __syncthreads();
  for (int o = REDUCE_THREADS / 2; o > 0; o >>= 1) {
    if (t < o) {
      s0[t] += s0[t + o];
      s1[t] += s1[t + o];
    }
    __syncthreads();
  }
  if (t == 0) {
    sums[0] = s0[0];
    sums[1] = s1[0];
  }
}

template <int T, bool BF16>
cudaError_t launch_accumulate(const float* Y, const float* X, const int* cols,
                              const float* vals, const int* rem,
                              const int* groups, int n_groups,
                              float* partials, float* A, float* r, int k,
                              int L, int s0, int b, int implicit, float alpha,
                              cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * (32 * b + 64) * sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        subspace_accumulate_groups<T, BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int nout = b * (b + 1) / 2 + b;
  dim3 grid(ceil_div(n_groups, WARPS), ceil_div(nout, OUT_TILE));
  subspace_accumulate_groups<T, BF16><<<grid, 32 * WARPS, smem, stream>>>(
      Y, X, cols, vals, rem, groups, n_groups, partials, A, r, k, L, s0, b,
      implicit, alpha);
  return cudaGetLastError();
}

template <int T, int B, bool BF16>
cudaError_t launch_lanes(const float* Y, const float* X, const int* cols,
                         const float* vals, const int* rem, const int* groups,
                         int n_groups, float* partials, float* A, float* r,
                         int k, int L, int s0, int implicit, float alpha,
                         float* score, int vec, cudaStream_t stream) {
  const size_t smem = (size_t)LANES_WARPS * LanesTile<T, B>::WARP_FLOATS * sizeof(float);
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        subspace_accumulate_lanes<T, B, BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  subspace_accumulate_lanes<T, B, BF16><<<ceil_div(n_groups, LANES_WARPS), 32 * LANES_WARPS,
                                          smem, stream>>>(
      Y, X, cols, vals, rem, groups, n_groups, partials, A, r, k, L, s0, implicit, alpha, score,
      vec);
  return cudaGetLastError();
}

template <int B, bool BF16>
cudaError_t launch_carried(const float* Y, const int* cols, const float* vals, const int* rem,
                           const int* groups, int n_groups, float* partials, float* A, float* r,
                           int k, int L, int s0, int implicit, float alpha, float* score,
                           const float* delta, int write_score, cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * CarriedTile<B>::WARP_FLOATS * sizeof(float);
  cudaError_t err;
  if (smem > DEFAULT_SMEM) {
    err = cudaFuncSetAttribute(subspace_accumulate_carried<B, BF16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // as many warps as the card holds at once, each walking a stride of groups
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, subspace_accumulate_carried<B, BF16>, 32 * WARPS, smem);
  if (err != cudaSuccess) return err;
  const int blocks = min(ceil_div(n_groups, WARPS), max(1, per_sm) * sms);
  subspace_accumulate_carried<B, BF16><<<blocks, 32 * WARPS, smem, stream>>>(
      Y, cols, vals, rem, groups, n_groups, partials, A, r, k, L, s0, implicit, alpha, score,
      delta, write_score);
  return cudaGetLastError();
}

template <bool BF16>
int accumulate(const float* Y, const float* X, const int* cols,
               const float* vals, const int* rem, const int* groups,
               int n_groups, const int* c_rows, const int* c_start,
               int n_combine, float* partials, float* A, float* r, int k,
               int L, int s0, int b, int implicit, float alpha, float* score,
               const float* delta, int write_score, cudaStream_t stream) {
  if (n_groups < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  const int T = (k + 31) / 32;
  const bool lanes = T <= 2 && (b == 1 || b == 2 || b == 4 || b == 8);
  const uintptr_t y_at = (uintptr_t)Y;
  if (delta != nullptr) {  // the carried form: lanes only, block j >= 1
    if (!lanes || score == nullptr || s0 < b) return (int)cudaErrorInvalidValue;
    const size_t vw_bytes = sizeof(float) * (b < 4 ? b : 4);
    if (y_at % vw_bytes != 0 || (uintptr_t)delta % vw_bytes != 0) {
      return (int)cudaErrorMisalignedAddress;
    }
#define SUBSPACE_CARRY(BB)                                                    \
  if (b == BB) {                                                              \
    err = launch_carried<BB, BF16>(Y, cols, vals, rem, groups, n_groups,      \
                                   partials, A, r, k, L, s0, implicit, alpha, \
                                   score, delta, write_score, stream);        \
  }
    SUBSPACE_CARRY(1)
    SUBSPACE_CARRY(2)
    SUBSPACE_CARRY(4)
    SUBSPACE_CARRY(8)
#undef SUBSPACE_CARRY
  } else if (lanes) {
    const int vec = k % 4 == 0 && y_at % 16 == 0;
#define SUBSPACE_LANES(TT, BB)                                                \
  if (T == TT && b == BB) {                                                   \
    err = launch_lanes<TT, BB, BF16>(Y, X, cols, vals, rem, groups, n_groups, \
                                     partials, A, r, k, L, s0, implicit,      \
                                     alpha, score, vec, stream);              \
  }
    SUBSPACE_LANES(1, 1)
    SUBSPACE_LANES(1, 2)
    SUBSPACE_LANES(1, 4)
    SUBSPACE_LANES(1, 8)
    SUBSPACE_LANES(2, 1)
    SUBSPACE_LANES(2, 2)
    SUBSPACE_LANES(2, 4)
    SUBSPACE_LANES(2, 8)
#undef SUBSPACE_LANES
  } else {
    if (score != nullptr) return (int)cudaErrorInvalidValue;  // no score here
    switch (T) {
#define SUBSPACE_CASE(TT)                                                     \
  case TT:                                                                    \
    err = launch_accumulate<TT, BF16>(Y, X, cols, vals, rem, groups, n_groups,\
                               partials, A, r, k, L, s0, b, implicit, alpha,  \
                               stream);                                       \
    break;
      SUBSPACE_CASE(1)
      SUBSPACE_CASE(2)
      SUBSPACE_CASE(3)
      SUBSPACE_CASE(4)
      SUBSPACE_CASE(5)
      SUBSPACE_CASE(6)
      SUBSPACE_CASE(7)
#undef SUBSPACE_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (err != cudaSuccess || n_combine == 0) return (int)err;
  dim3 grid2(n_combine, ceil_div(b * b + b, COMBINE_THREADS));
  subspace_combine<<<grid2, COMBINE_THREADS, 0, stream>>>(partials, c_rows,
                                                          c_start, A, r, b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K11a on `stream`: A [R, b, b] and r [R, b] of the column block
// [s0, s0 + b) against Y [n, k] and the current X [R, k], over a packed
// side (cols/vals [S, L], rem [S]) walked through K1's group plan
// (groups [4, n_groups]: row, first segment, segment count, partial slot
// or -1; c_rows [n_combine], c_start [n_combine + 1]), partials
// [max(P, 1), b*b + b]. The carried score (the lanes form only:
// k <= 64, b in {1, 2, 4, 8}): score [S, L] is one float a slot. With
// delta null, score null or not, d is formed over all k columns, and
// written to score when it is given (block 0). With delta [R, b] (the
// previous block's change of X, as K11b writes it; s0 >= b, Y aligned to
// min(b, 4) floats), d = score + Y[:, s0−b:s0]·delta, written back to
// score when write_score. Returns cudaGetLastError(); an unaligned Y,
// or a score where the form carries none, returns an error and launches
// nothing. The caller checks shapes, dtypes, devices, id ranges, 1 <= b,
// b | k and k <= 200. bf16 != 0 runs K11a-bf16 (see the header).
int subspace_accumulate_f32(const float* Y, const float* X, const int* cols,
                            const float* vals, const int* rem,
                            const int* groups, int n_groups,
                            const int* c_rows, const int* c_start,
                            int n_combine, float* partials, float* A,
                            float* r, int k, int L, int s0, int b,
                            int implicit, float alpha, int bf16,
                            float* score, const float* delta,
                            int write_score, cudaStream_t stream) {
  return bf16 ? accumulate<true>(Y, X, cols, vals, rem, groups, n_groups,
                                 c_rows, c_start, n_combine, partials, A, r, k,
                                 L, s0, b, implicit, alpha, score, delta,
                                 write_score, stream)
              : accumulate<false>(Y, X, cols, vals, rem, groups, n_groups,
                                  c_rows, c_start, n_combine, partials, A, r,
                                  k, L, s0, b, implicit, alpha, score, delta,
                                  write_score, stream);
}

// Blocks subspace_block_solve_f32 launches for R rows at block width b
// (its partials buffer holds two floats per block).
int subspace_solve_blocks(int R, int b) {
  const int W = solve_warps(b);
  return (R + W - 1) / W;
}

// K11b on `stream`: solve every row's block system and add δ into
// X[:, s0:s0+b] in place; G [k, k] or null (explicit). When `sums` is not
// null, sums[0] = Σ δ² and sums[1] = (last ? Σ X² : 0), through `partials`
// of 2·blocks floats. When `delta` ([R, b]) is not null, it receives each
// row's x_new − x_old over the block's columns (bf16 != 0: bf16(x_new) −
// bf16(x_old)), zeros for rows without observations: the next block's
// carried score reads it. Returns cudaGetLastError(). The caller checks
// shapes, dtypes, devices, R >= 1 and 1 <= b <= k <= 200.
int subspace_block_solve_f32(const float* A, const float* rv, const float* G,
                             const float* lam, const unsigned char* has_obs,
                             float* X, float* partials, float* sums,
                             float* delta, int R, int k, int s0, int b,
                             int last, int bf16, cudaStream_t stream) {
  const int W = solve_warps(b);
  const int blocks = (R + W - 1) / W;
  const size_t smem = ((size_t)W * solve_floats(b) + 2 * W) * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (smem > DEFAULT_SMEM) {
    err = cudaFuncSetAttribute(subspace_block_solve_rows,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  float* part = sums ? partials : nullptr;
  subspace_block_solve_rows<<<blocks, 32 * W, smem, stream>>>(
      A, rv, G, lam, has_obs, X, part, delta, R, k, s0, b, W, last, bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess || sums == nullptr) return (int)err;
  subspace_reduce<<<1, REDUCE_THREADS, 0, stream>>>(partials, blocks, sums);
  return (int)cudaGetLastError();
}

const char* subspace_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
