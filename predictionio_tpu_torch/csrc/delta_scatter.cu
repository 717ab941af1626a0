// K8: the resident delta scatter — the hand-written Hopper kernels that
// replace the device work of the reference's eager program
// predictionio_tpu/ops/streaming.py:1036 _fold_delta_resident
// (:1147-1268).
//
// What they compute. A device-resident training pack holds the wire's
// user-sorted COO planes (item ids i [P_old], uint16 or int32; value
// codes v [P_old], int8 or float32; the first n_old slots real, the rest
// padding), both sides' CSR offsets su [Su] / si [Si] and segment bases
// bu / bi (int32, edge-padded), each side's segment rows and valid-slot
// counts, and the regularizer vectors. A delta of d ratings on EXISTING
// ids arrives user-sorted: du [d] int32, di [d] (the plane's id type),
// dv [d] (the plane's value type).
//   K8a delta_counts_prefix: dense_u[n_users + 1] and dense_i[n_items + 1],
//     the delta's rows per user and per item, and their exclusive prefixes
//     sh_u[0] = 0, sh_u[r + 1] = Σ_{q <= r} dense_u[q] (sh_i likewise).
//   K8b move_and_append: new planes of P_new slots. Old slot p, whose user
//     key = #{m >= 1 : su[m] <= p} (padding slots get keys past n_users,
//     clamped to n_users), moves to p + sh_u[key]; delta row j goes to
//     su[du[j] + 1] + sh_u[du[j]] + (j - first(j)), first(j) the start of
//     its user's run; positions at or past P_new are dropped. Slots that
//     neither reaches (the tail [P_old + d, P_new) when the bucketed
//     length grows past the moved padding) get init_id and 0.
//   K8c shift_offsets: su2[m] = su[m] + sh_u[min(m, n_users)] (si2
//     likewise); rem2[s] = rem[s] + dense[row] on each row's LAST segment
//     only (s + 1 == bu[row + 1]); with weighted regularization, the
//     regularizer at each touched row (a sorted list with its host-computed
//     value) replaced, every other row copied.
// Everything is integer copy work, so the outputs equal the reference's
// (and the plain twins in ops/delta_scatter.py) bit for bit. Gathers clamp
// their index and scatters drop out-of-range positions, as the
// reference's do.
//
// Bound on an H100 SXM at ML-20M (P = 20,971,520 slots, uint16 ids, int8
// codes, 138,493 users, 26,744 items, a delta of d = 10,000 rows). K8b
// reads the old planes once and writes the new ones once (6 bytes a slot,
// ≈126 MB, ≈37.6 µs at 3.35 TB/s) plus the offsets and the delta rows;
// K8a and K8c move catalog-sized arrays (≈1-4 MB, ≈1 µs). All three are
// bound by bytes; none does arithmetic to speak of.
//
// Design.
//   K8a: one block of 1,024 threads per side (grid of 2). The block zeroes
//     its histogram, adds the delta's ids with integer atomics (exact in
//     any order), then scans the histogram in tiles of 4,096 (four
//     consecutive entries a thread, a warp-shuffle scan, the warp totals
//     scanned by warp 0, a running carry between tiles). The histogram is
//     read back through L2 (__ldcg): the atomics wrote it there.
//   K8b: one launch, three block ranges. Old slots: a thread takes 4 slots
//     a block-width apart (coalesced) and finds the first one's key by a
//     binary search of su and each next one's from the previous key, as
//     K5a (csrc/device_pack.cu) does, in place of the reference's
//     P_old-long marks + cumsum; shifts within a user are one constant, so
//     the writes are nearly contiguous. Delta rows: a thread each, its
//     run's start by a binary search of the sorted du. Tail: a thread a
//     slot. Every slot of the new planes is written exactly once, so no
//     fill pass precedes the moves.
//   K8c: one flat launch over the concatenated outputs (su2, si2, rem_u2,
//     rem_i2, then the two regularizer vectors when weighted), a thread an
//     entry; a regularizer row finds its replacement by a binary search of
//     the touched rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// --- K8a ---

constexpr int COUNT_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;

// Exclusive scan of one int per thread of the block; *total receives the
// block's sum. warp_sums holds 33 ints.
__device__ __forceinline__ int block_exclusive_scan(int x, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    const int w = lane < n_warps ? warp_sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < n_warps) warp_sums[lane] = wi - w;
    if (lane == 31) warp_sums[32] = wi;
  }
  __syncthreads();
  const int excl = warp_sums[warp] + incl - x;
  *total = warp_sums[32];
  __syncthreads();  // warp_sums is reused by the next tile
  return excl;
}

template <typename IdT>
__device__ __forceinline__ void count_and_scan(const IdT* __restrict__ ids,
                                               int d, int n,
                                               int* __restrict__ dense,
                                               int* __restrict__ sh,
                                               int* warp_sums) {
  for (int r = threadIdx.x; r <= n; r += blockDim.x) dense[r] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    // the reference's scatter-add drops ids outside [0, n]
    const long long id = (long long)ids[j];
    if (id >= 0 && id <= n) atomicAdd(&dense[id], 1);
  }
  __syncthreads();
  int carry = 0;
  for (int base = 0; base < n; base += COUNT_THREADS * SCAN_ITEMS) {
    const int s0 = base + threadIdx.x * SCAN_ITEMS;
    int v[SCAN_ITEMS];
    int sum = 0;
#pragma unroll
    for (int q = 0; q < SCAN_ITEMS; ++q) {
      v[q] = s0 + q < n ? __ldcg(dense + s0 + q) : 0;
      sum += v[q];
    }
    int total;
    int run = carry + block_exclusive_scan(sum, warp_sums, &total);
#pragma unroll
    for (int q = 0; q < SCAN_ITEMS; ++q) {
      if (s0 + q < n) {
        run += v[q];
        sh[s0 + q + 1] = run;
      }
    }
    carry += total;
  }
  if (threadIdx.x == 0) sh[0] = 0;
}

template <typename IdT>
__global__ void __launch_bounds__(COUNT_THREADS) counts_prefix_kernel(
    const int* __restrict__ du, const IdT* __restrict__ di, int d,
    int n_users, int n_items, int* __restrict__ dense_u,
    int* __restrict__ dense_i, int* __restrict__ sh_u,
    int* __restrict__ sh_i) {
  __shared__ int warp_sums[33];
  if (blockIdx.x == 0) {
    count_and_scan<int>(du, d, n_users, dense_u, sh_u, warp_sums);
  } else {
    count_and_scan<IdT>(di, d, n_items, dense_i, sh_i, warp_sums);
  }
}

// --- K8b ---

constexpr int MOVE_THREADS = 256;
constexpr int MOVE_ITEMS = 4;
constexpr int MOVE_SPAN = MOVE_THREADS * MOVE_ITEMS;

// the first m in [lo, hi) with a[m] > j, or hi
__device__ __forceinline__ int first_above(const int* __restrict__ a, int lo,
                                           int hi, long long j) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (a[mid] <= j) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// the first m in [lo, hi) with a[m] >= x, or hi
__device__ __forceinline__ int first_not_below(const int* __restrict__ a,
                                               int lo, int hi, int x) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (a[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ int clamp_index(long long x, int len) {
  return x < 0 ? 0 : (x >= len ? len - 1 : (int)x);
}

template <typename IdT, typename ValT>
__global__ void __launch_bounds__(MOVE_THREADS) move_and_append_kernel(
    const IdT* __restrict__ i_old, const ValT* __restrict__ v_old,
    long long P_old, const int* __restrict__ su, int Su,
    const int* __restrict__ sh_u, int n_users, const int* __restrict__ du,
    const IdT* __restrict__ di, const ValT* __restrict__ dv, int d,
    IdT init_id, IdT* __restrict__ i_new, ValT* __restrict__ v_new,
    long long P_new, long long move_blocks, long long append_blocks) {
  const long long b = blockIdx.x;
  if (b < move_blocks) {
    const long long base = b * MOVE_SPAN + threadIdx.x;
    int key = -1;
#pragma unroll
    for (int t = 0; t < MOVE_ITEMS; ++t) {
      const long long p = base + (long long)t * MOVE_THREADS;
      if (p >= P_old) break;
      if (key < 0) {
        key = first_above(su, 1, Su, p) - 1;
      } else if (key + 1 < Su && su[key + 1] <= p) {
        key = first_above(su, key + 1, Su, p) - 1;
      }
      const long long q = p + sh_u[key < n_users ? key : n_users];
      if (q >= 0 && q < P_new) {
        i_new[q] = i_old[p];
        v_new[q] = v_old[p];
      }
    }
    return;
  }
  if (b < move_blocks + append_blocks) {
    const int j = (int)((b - move_blocks) * MOVE_THREADS + threadIdx.x);
    if (j >= d) return;
    const int u = du[j];
    const int first = first_not_below(du, 0, j, u);  // du is sorted
    const long long q = (long long)su[clamp_index((long long)u + 1, Su)] +
                        sh_u[clamp_index(u, n_users + 1)] + (j - first);
    if (q >= 0 && q < P_new) {
      i_new[q] = di[j];
      v_new[q] = dv[j];
    }
    return;
  }
  const long long q = P_old + d +
                      (b - move_blocks - append_blocks) * MOVE_THREADS +
                      threadIdx.x;
  if (q < P_new) {
    i_new[q] = init_id;
    v_new[q] = (ValT)0;
  }
}

// --- K8c ---

constexpr int SHIFT_THREADS = 256;

struct ShiftArgs {
  const int* su;
  const int* si;
  const int* sh_u;
  const int* sh_i;
  const int* dense_u;
  const int* dense_i;
  const int* bu;
  const int* bi;
  const int* seg_rows_u;
  const int* rem_u;
  const int* seg_rows_i;
  const int* rem_i;
  const float* lam_u;
  const int* rows_u;
  const float* vals_u;
  const float* lam_i;
  const int* rows_i;
  const float* vals_i;
  int* su2;
  int* si2;
  int* rem_u2;
  int* rem_i2;
  float* lam_u2;
  float* lam_i2;
  int Su, Si, Bu, Bi, Tu, Ti, Ru, Ri, mu, mi, n_users, n_items;
};

__device__ __forceinline__ int last_segment_add(int s, const int* seg_rows,
                                                const int* seg_base, int B,
                                                const int* dense, int n) {
  const int row = seg_rows[s];
  const bool last = s + 1 == seg_base[clamp_index((long long)row + 1, B)];
  return last ? dense[clamp_index(row, n + 1)] : 0;
}

__device__ __forceinline__ float touched_or_kept(int r, const float* lam,
                                                 const int* rows,
                                                 const float* vals, int m) {
  const int idx = first_not_below(rows, 0, m, r);
  return idx < m && rows[idx] == r ? vals[idx] : lam[r];
}

__global__ void __launch_bounds__(SHIFT_THREADS) shift_offsets_kernel(
    ShiftArgs a) {
  long long t = (long long)blockIdx.x * SHIFT_THREADS + threadIdx.x;
  if (t < a.Su) {
    a.su2[t] = a.su[t] + a.sh_u[t < a.n_users ? t : a.n_users];
    return;
  }
  t -= a.Su;
  if (t < a.Si) {
    a.si2[t] = a.si[t] + a.sh_i[t < a.n_items ? t : a.n_items];
    return;
  }
  t -= a.Si;
  if (t < a.Tu) {
    const int s = (int)t;
    a.rem_u2[s] = a.rem_u[s] + last_segment_add(s, a.seg_rows_u, a.bu, a.Bu,
                                                a.dense_u, a.n_users);
    return;
  }
  t -= a.Tu;
  if (t < a.Ti) {
    const int s = (int)t;
    a.rem_i2[s] = a.rem_i[s] + last_segment_add(s, a.seg_rows_i, a.bi, a.Bi,
                                                a.dense_i, a.n_items);
    return;
  }
  t -= a.Ti;
  if (t < a.Ru) {
    const int r = (int)t;
    a.lam_u2[r] = touched_or_kept(r, a.lam_u, a.rows_u, a.vals_u, a.mu);
    return;
  }
  t -= a.Ru;
  if (t < a.Ri) {
    const int r = (int)t;
    a.lam_i2[r] = touched_or_kept(r, a.lam_i, a.rows_i, a.vals_i, a.mi);
  }
}

template <typename IdT, typename ValT>
cudaError_t launch_move(const void* i_old, const void* v_old, long long P_old,
                        const int* su, int Su, const int* sh_u, int n_users,
                        const int* du, const void* di, const void* dv, int d,
                        int init_id, void* i_new, void* v_new,
                        long long P_new, cudaStream_t stream) {
  const long long move_blocks = (P_old + MOVE_SPAN - 1) / MOVE_SPAN;
  const long long append_blocks = ((long long)d + MOVE_THREADS - 1) / MOVE_THREADS;
  const long long tail = P_new - P_old - d;
  const long long tail_blocks =
      tail > 0 ? (tail + MOVE_THREADS - 1) / MOVE_THREADS : 0;
  const long long blocks = move_blocks + append_blocks + tail_blocks;
  if (blocks == 0) return cudaSuccess;
  move_and_append_kernel<IdT, ValT><<<(unsigned)blocks, MOVE_THREADS, 0,
                                      stream>>>(
      static_cast<const IdT*>(i_old), static_cast<const ValT*>(v_old), P_old,
      su, Su, sh_u, n_users, du, static_cast<const IdT*>(di),
      static_cast<const ValT*>(dv), d, (IdT)init_id, static_cast<IdT*>(i_new),
      static_cast<ValT*>(v_new), P_new, move_blocks, append_blocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each function launches on `stream` and returns cudaGetLastError(). The
// caller checks shapes, dtypes, devices and contiguity.

// K8a: du [d] int32, di [d] uint16 (di_i32 = 0) or int32 -> dense_u /
// sh_u [n_users + 1], dense_i / sh_i [n_items + 1], all int32.
int delta_counts_prefix(const int* du, const void* di, int di_i32, int d,
                        int n_users, int n_items, int* dense_u, int* dense_i,
                        int* sh_u, int* sh_i, cudaStream_t stream) {
  if (di_i32) {
    counts_prefix_kernel<int><<<2, COUNT_THREADS, 0, stream>>>(
        du, static_cast<const int*>(di), d, n_users, n_items, dense_u,
        dense_i, sh_u, sh_i);
  } else {
    counts_prefix_kernel<uint16_t><<<2, COUNT_THREADS, 0, stream>>>(
        du, static_cast<const uint16_t*>(di), d, n_users, n_items, dense_u,
        dense_i, sh_u, sh_i);
  }
  return (int)cudaGetLastError();
}

// K8b: old planes i_old [P_old] (uint16, or int32 with ids_i32) and v_old
// [P_old] (int8, or float32 with vals_f32); su [Su] and sh_u [n_users + 1]
// int32; the user-sorted delta du [d] int32, di [d] and dv [d] of the
// planes' types -> i_new, v_new [P_new].
int move_and_append(const void* i_old, int ids_i32, const void* v_old,
                    int vals_f32, long long P_old, const int* su, int Su,
                    const int* sh_u, int n_users, const int* du,
                    const void* di, const void* dv, int d, int init_id,
                    void* i_new, void* v_new, long long P_new,
                    cudaStream_t stream) {
  if (ids_i32) {
    if (vals_f32)
      return (int)launch_move<int, float>(i_old, v_old, P_old, su, Su, sh_u,
                                          n_users, du, di, dv, d, init_id,
                                          i_new, v_new, P_new, stream);
    return (int)launch_move<int, int8_t>(i_old, v_old, P_old, su, Su, sh_u,
                                         n_users, du, di, dv, d, init_id,
                                         i_new, v_new, P_new, stream);
  }
  if (vals_f32)
    return (int)launch_move<uint16_t, float>(i_old, v_old, P_old, su, Su,
                                             sh_u, n_users, du, di, dv, d,
                                             init_id, i_new, v_new, P_new,
                                             stream);
  return (int)launch_move<uint16_t, int8_t>(i_old, v_old, P_old, su, Su,
                                            sh_u, n_users, du, di, dv, d,
                                            init_id, i_new, v_new, P_new,
                                            stream);
}

// K8c: offsets su/si, prefixes and counts from K8a, segment bases bu/bi,
// segment rows and counts of both sides, and (Ru, Ri > 0: weighted
// regularization) the regularizer vectors with their touched rows (sorted,
// unique) and values -> su2, si2, rem_u2, rem_i2 and lam_u2, lam_i2.
int shift_offsets(const int* su, int Su, const int* si, int Si,
                  const int* sh_u, const int* sh_i, const int* dense_u,
                  const int* dense_i, int n_users, int n_items,
                  const int* bu, int Bu, const int* bi, int Bi,
                  const int* seg_rows_u, const int* rem_u, int Tu,
                  const int* seg_rows_i, const int* rem_i, int Ti,
                  const float* lam_u, int Ru, const int* rows_u,
                  const float* vals_u, int mu, const float* lam_i, int Ri,
                  const int* rows_i, const float* vals_i, int mi, int* su2,
                  int* si2, int* rem_u2, int* rem_i2, float* lam_u2,
                  float* lam_i2, cudaStream_t stream) {
  ShiftArgs a{su,      si,      sh_u,    sh_i,   dense_u, dense_i,
              bu,      bi,      seg_rows_u, rem_u, seg_rows_i, rem_i,
              lam_u,   rows_u,  vals_u,  lam_i,  rows_i,  vals_i,
              su2,     si2,     rem_u2,  rem_i2, lam_u2,  lam_i2,
              Su,      Si,      Bu,      Bi,     Tu,      Ti,
              Ru,      Ri,      mu,      mi,     n_users, n_items};
  const long long total =
      (long long)Su + Si + Tu + Ti + (long long)Ru + Ri;
  if (total == 0) return cudaSuccess;
  const unsigned blocks =
      (unsigned)((total + SHIFT_THREADS - 1) / SHIFT_THREADS);
  shift_offsets_kernel<<<blocks, SHIFT_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

const char* delta_scatter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
