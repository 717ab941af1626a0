// K15: multinomial naive Bayes — the hand-written Hopper kernels that
// replace the reference's two device programs in
// predictionio_tpu/ops/naive_bayes.py:
//   K15a, _fit (:55-69): the one-hot [C, n] x [n, F] product that forms the
//     per-class feature sums S, the class counts, and the smoothed logs
//       pi[c]       = log(count[c] + lam) - log(n + lam·C),  n = Σ count
//       theta[c][f] = log(S[c][f] + lam) - log(Σ_j S[c][j] + lam·F);
//   K15b, _scores (:72-77) fused with the eager jnp.argmax of
//     predict_naive_bayes (:151): X·θᵀ + π over C classes per query row,
//     then the index of the first NaN if the row has one, else of the
//     first maximum (jnp.argmax's rule; NB scores are NaN where lam = 0
//     leaves θ = -inf against a 0 feature).
//
// Bound on an H100 SXM. K15a reads features and labels once and writes
// C·(F + 1) outputs: at the bench's shape (50,000 x 3, C = 4) 800 kB,
// ≈0.00024 ms at 3.35 TB/s, so a fit is far above its bound: at this size
// its cost is the launch and the host's call. K15b reads B·F + C·(F + 1)
// floats and writes B labels (and, when asked, B·C scores): ≈25 kB at
// B = 2,048.
//
// Design.
//   K15a pass 1: work items of (row block, F tile, class tile). A block of
//     L lanes x Ft columns (L·Ft ≤ 256; the block has 256 threads, the
//     rest idle in this pass) walks an item's row block; lane l takes rows
//     r0 + l, r0 + l + L, ... in order and adds feature f0 + col into its
//     own shared-memory partial [l][c][col], so no two threads write one
//     address and no float atomic is used. The class counts are integer
//     atomics (exact in any order). The lanes are then summed in lane
//     order into the block's partial [block][C][F]. The grid's blocks take
//     the items i = blockIdx.x, + gridDim.x, ... one after another, and
//     each item is computed by one block in one order whatever the grid's
//     size, so its partial's bits do not depend on the grid.
//   The row blocks come from a shard table: shard s gives its rows X_s,
//     y_s and the index of its first block in the partials, every shard a
//     whole number of the plan's blocks of rows_per_block rows (its last
//     may be short only at the end of all rows). The items walk the
//     shards' blocks one after another. A block's partial is the same
//     whatever table it is part of: a one-device fit is a table of one,
//     and K15s's fit (the reference's :103-121) a table of the shards on
//     a device, so the model is one device's bit for bit.
//   K15a pass 2: per class, the partials summed over the blocks in block
//     order, the row sum in a fixed tree (256 threads), n from the integer
//     counts, then the log epilogue. Every sum has a fixed order, so a
//     rerun gives the same bits; integer-valued features (the bench's
//     Poisson counts, sums below 2^24) give exact sums in any order.
//   One launch for both passes: a cooperative launch of at most as many
//     blocks as the card holds at once (the caller's occupancy query,
//     naive_bayes_fit_capacity), whose blocks walk the items of pass 1,
//     meet at a grid-wide sync, and then run pass 2 with the classes
//     spread over the grid's blocks. A fit with more items than the card
//     holds blocks (a wide feature set) walks several items a block in the
//     same launch, so every shape runs one launch. No counter outlives a
//     launch (the grid sync is the hardware's barrier), so concurrent fits
//     on any streams never meet. Pass 1 alone (the shards on a device
//     other than the result's) is an ordinary launch of one block an item.
//   nb_scores_argmax (K15b): G lanes per query row (G the smallest power
//     of two >= C, at most 32), so a warp takes 32 / G rows (8 at the
//     bench's C = 4; one row and lanes looping over the classes past 32).
//     Each lane forms its classes' dots in feature order with separate
//     rounded products and adds (__fmul_rn, __fadd_rn: no FMA), so the
//     plain twin, which does the same in torch ops, matches bit for bit.
//     The (score, class) pairs are reduced over the row's G lanes by a total
//     order (NaN first, then the larger score, then the lower class), so the
//     result does not depend on the reduction's shape or on G.
//   K15b's shard table. One launch covers every shard of one device: shard
//     s gives its rows X_s (a row range of the device's upload of the
//     batch), their count, and its blocks of one [B] int32 result and, when
//     asked, of one [B, C] scores array. blockIdx.x walks the shards' row
//     blocks one after another, and a row's arithmetic does not depend on
//     its shard or block, so every label is one device's bit for bit. The
//     single-device call is a table of one; K15s's scores (the reference's
//     :144-151) are a table of the shards on each distinct device. At the
//     bench's shape the kernel is at an H100's launch floor (≈3 µs); what
//     the table saves is host time: one launch, one ctypes call with two
//     arguments, and the device switch in C, a no-op where current.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int FIT_THREADS = 256;
constexpr int SCORE_WARPS = 8;
constexpr int MAX_SHARDS = 64;
constexpr size_t FIT_SMEM_MAX = 48 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long warp_sum_ll(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum over the block (FIT_THREADS threads) in a fixed order: the
// warps' butterfly sums, then warp 0's values in warp order
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[w] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < FIT_THREADS / 32; ++i) s += red[i];
  __syncthreads();
  return s;
}

__device__ long long block_sum_ll(long long v, long long* red) {
  v = warp_sum_ll(v);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[w] = v;
  __syncthreads();
  long long s = 0;
  for (int i = 0; i < FIT_THREADS / 32; ++i) s += red[i];
  __syncthreads();
  return s;
}

// the plan of one fit (K15a's, from the caller's fit_plan)
struct FitPlan {
  long long rows_per_block;
  int F, C, nblk, Ft, L, Ct;
  int blocks;  // the table's row blocks
  int gy, gz;  // the F tiles and the class tiles
  float lam;
};

struct FitShard {
  const float* X;
  const int* y;
  long long rows;
  long long part0;  // its first block in the partials
  long long grid0;  // its first row block in the walk (the earlier shards' blocks)
};

template <int M>
struct FitShards {
  FitShard s[M];
  int n;
};

// pass 1's dynamic shared memory in floats: the lanes' partials [L][Ct][Ft]
// and Ct counts (pass 2 stages partials in the same space)
__host__ __device__ inline size_t fit_smem_floats(const FitPlan& p) {
  return (size_t)p.L * p.Ct * p.Ft + p.Ct;
}

// pass 1 on one row block (rows r0..r1 of X) into partial block b: the
// F tile fy and the class tile fz
__device__ void fit_block(const float* __restrict__ X, const int* __restrict__ y,
                          long long r0, long long r1, long long b, int fy, int fz,
                          const FitPlan& p, float* part, int* cpart, float* sm) {
  const int Ft = p.Ft, L = p.L, Ct = p.Ct, F = p.F, C = p.C;
  int* cnt = reinterpret_cast<int*>(sm + (size_t)L * Ct * Ft);
  const int f0 = fy * Ft, c0 = fz * Ct;
  const int ft = min(Ft, F - f0), ct = min(Ct, C - c0);
  for (int i = threadIdx.x; i < L * Ct * Ft; i += blockDim.x) sm[i] = 0.f;
  for (int i = threadIdx.x; i < Ct; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x / Ft, col = threadIdx.x % Ft;
  const bool counts = fy == 0 && col == 0;
  if (lane < L && col < ft) {
    float* mine = sm + (size_t)lane * Ct * Ft + col;
    const float* x = X + f0 + col;
    long long r = r0 + lane;
    // ROWS of the lane's rows loaded at once, then added in row order
    constexpr int ROWS = 4;
    for (; r + (ROWS - 1) * (long long)L < r1; r += ROWS * (long long)L) {
      int yr[ROWS];
      float xr[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        yr[j] = y[r + j * (long long)L];
        xr[j] = x[(r + j * (long long)L) * F];
      }
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const unsigned c = (unsigned)(yr[j] - c0);  // out of range: no class here
        if (c < (unsigned)ct) {
          mine[c * Ft] += xr[j];
          if (counts) atomicAdd(cnt + c, 1);
        }
      }
    }
    for (; r < r1; r += L) {
      const unsigned c = (unsigned)(y[r] - c0);
      if (c < (unsigned)ct) {
        mine[c * Ft] += x[r * F];
        if (counts) atomicAdd(cnt + c, 1);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ct * ft; i += blockDim.x) {
    const int c = i / ft, f = i % ft;
    float s = 0.f;
    for (int l = 0; l < L; ++l) s += sm[((size_t)l * Ct + c) * Ft + f];
    part[(b * C + c0 + c) * F + f0 + f] = s;
  }
  if (fy == 0) {
    for (int i = threadIdx.x; i < ct; i += blockDim.x) cpart[b * C + c0 + i] = cnt[i];
  }
  __syncthreads();  // the block's next item clears the shared partials
}

// pass 2 for class c: the partials of nblk blocks summed in block order,
// then the logs. The partials are read through L2 (__ldcg): other blocks
// of the same launch wrote them. Where `stage` (`staged`
// floats of shared memory) holds the class's partials of every block, the
// block's threads load them all at once first. The row sum reads the column
// sums back, thread t taking columns t, t + 256, ... in order, so its bits
// do not depend on which thread summed a column.
__device__ void finish_class(int c, const FitPlan& p, const float* part, const int* cpart,
                             int* counts, float* sums, float* pi, float* theta,
                             float* red, long long* red_ll, float* stage, int staged) {
  const int nblk = p.nblk, C = p.C, F = p.F;
  const float lam = p.lam;
  // n = Σ counts and the class's count: integers, exact in any order
  long long n_part = 0, k_part = 0;
  for (long long i = threadIdx.x; i < (long long)nblk * C; i += blockDim.x) {
    const int v = __ldcg(cpart + i);
    n_part += v;
    if (i % C == c) k_part += v;
  }
  const long long n = block_sum_ll(n_part, red_ll);
  const long long k = block_sum_ll(k_part, red_ll);
  float* srow = sums + (long long)c * F;
  const float* cls = part + (long long)c * F;
  const long long stride = (long long)C * F;
  if (F < FIT_THREADS && (long long)nblk * F <= staged) {
    // few columns: every block's partials of the class loaded at once by
    // all threads, then one thread a column adds them in block order
    for (int i = threadIdx.x; i < nblk * F; i += blockDim.x)
      stage[i] = __ldcg(cls + (i / F) * stride + i % F);
    __syncthreads();
    if (threadIdx.x < F) {
      float s = 0.f;
      for (int b = 0; b < nblk; ++b) s += stage[b * F + threadIdx.x];
      srow[threadIdx.x] = s;
    }
  } else {
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
      // BATCH blocks' partials loaded at once, then added in block order
      constexpr int BATCH = 16;
      float s = 0.f;
      int b = 0;
      for (; b + BATCH <= nblk; b += BATCH) {
        float v[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j) v[j] = __ldcg(cls + (b + j) * stride + f);
#pragma unroll
        for (int j = 0; j < BATCH; ++j) s += v[j];
      }
      for (; b < nblk; ++b) s += __ldcg(cls + b * stride + f);
      srow[f] = s;
    }
  }
  __syncthreads();
  float row_part = 0.f;
  for (int f = threadIdx.x; f < F; f += blockDim.x) row_part += srow[f];
  const float row = block_sum(row_part, red);
  const float log_row = logf(row + lam * (float)F);
  for (int f = threadIdx.x; f < F; f += blockDim.x)
    theta[(long long)c * F + f] = logf(srow[f] + lam) - log_row;
  if (threadIdx.x == 0) {
    counts[c] = (int)k;
    pi[c] = logf((float)(int)k + lam) - logf((float)n + lam * (float)C);
  }
}

// K15a: pass 1 over the table's items (row block, F tile, class tile),
// the grid's blocks taking items blockIdx.x, + gridDim.x, ..., and with
// FUSED (a cooperative launch) pass 2 after the grid-wide sync, each block
// taking the classes c = blockIdx.x, + gridDim.x, ...
template <int M, bool FUSED>
__global__ void __launch_bounds__(FIT_THREADS) nb_fit(
    const FitPlan p, const FitShards<M> t, float* part, int* cpart, int* counts,
    float* sums, float* pi, float* theta) {
  extern __shared__ float sm[];  // [L][Ct][Ft] floats, then Ct int counts
  const int items = p.blocks * p.gy * p.gz;  // below 2^31 (fit_launch)
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int bid = w % p.blocks, tile = w / p.blocks;
    // the shard whose blocks hold this one (an empty shard shares its
    // first block with the next)
    FitShard sh = t.s[0];
#pragma unroll
    for (int i = 1; i < M; ++i)
      if (i < t.n && bid >= t.s[i].grid0) sh = t.s[i];
    const long long j = bid - sh.grid0;
    const long long r0 = j * p.rows_per_block;
    const long long r1 = min(sh.rows, r0 + p.rows_per_block);
    fit_block(sh.X, sh.y, r0, r1, sh.part0 + j, tile % p.gy, tile / p.gy, p, part, cpart, sm);
  }
  if (!FUSED) return;
  cooperative_groups::this_grid().sync();
  __shared__ float red[FIT_THREADS / 32];
  __shared__ long long red_ll[FIT_THREADS / 32];
  const int staged = (int)(fit_smem_floats(p));
  for (int c = blockIdx.x; c < p.C; c += gridDim.x)
    finish_class(c, p, part, cpart, counts, sums, pi, theta, red, red_ll, sm, staged);
}

size_t fit_smem(const FitPlan& p) { return fit_smem_floats(p) * sizeof(float); }

// cap: the fused launch's most blocks (the card's capacity), 0 for pass 1
// alone
template <int M>
cudaError_t fit_launch(const long long* a, FitPlan p, long long cap, cudaStream_t stream) {
  const int n_shards = (int)a[16];
  FitShards<M> t;
  t.n = n_shards;
  long long blocks = 0;
  for (int s = 0; s < n_shards; ++s) {
    const long long* e = a + 17 + 4 * s;
    const long long nb = (e[2] + p.rows_per_block - 1) / p.rows_per_block;
    if (e[2] < 0 || e[3] < 0 || e[3] + nb > p.nblk) return cudaErrorInvalidValue;
    t.s[s].X = reinterpret_cast<const float*>(e[0]);
    t.s[s].y = reinterpret_cast<const int*>(e[1]);
    t.s[s].rows = e[2];
    t.s[s].part0 = e[3];
    t.s[s].grid0 = blocks;
    blocks += nb;
  }
  p.blocks = (int)blocks;
  p.gy = (p.F + p.Ft - 1) / p.Ft;
  p.gz = (p.C + p.Ct - 1) / p.Ct;
  const long long items = blocks * p.gy * p.gz;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  float* part = reinterpret_cast<float*>(a[10]);
  int* cpart = reinterpret_cast<int*>(a[11]);
  int* counts = reinterpret_cast<int*>(a[12]);
  float* sums = reinterpret_cast<float*>(a[13]);
  float* pi = reinterpret_cast<float*>(a[14]);
  float* theta = reinterpret_cast<float*>(a[15]);
  const size_t smem = fit_smem(p);
  if (cap > 0) {
    const unsigned grid = (unsigned)(items < 1 ? 1 : items < cap ? items : cap);
    void* args[] = {&p, &t, &part, &cpart, &counts, &sums, &pi, &theta};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(&nb_fit<M, true>), dim3(grid), dim3(FIT_THREADS), args,
        smem, stream);
    if (err != cudaSuccess) cudaGetLastError();  // returned here: not left for torch's next check
    return err;
  }
  if (items == 0) return cudaSuccess;
  nb_fit<M, false><<<(unsigned)items, FIT_THREADS, smem, stream>>>(p, t, part, cpart, counts,
                                                                   sums, pi, theta);
  return cudaGetLastError();
}

// the table's template size for n shards
template <typename Fn>
cudaError_t by_table_size(int n, Fn&& fn) {
  if (n <= 1) return fn(std::integral_constant<int, 1>());
  if (n <= 8) return fn(std::integral_constant<int, 8>());
  return fn(std::integral_constant<int, MAX_SHARDS>());
}

// does (v2, i2) come before (v1, i1) in jnp.argmax's order? i = -1 marks
// no candidate
__device__ __forceinline__ bool precedes(float v2, int i2, float v1, int i1) {
  if (i2 < 0) return false;
  if (i1 < 0) return true;
  const bool n1 = isnan(v1), n2 = isnan(v2);
  if (n1 || n2) return n1 && n2 ? i2 < i1 : n2;
  return v2 > v1 || (v2 == v1 && i2 < i1);
}

struct ScoreShard {
  const float* X;  // [rows, F] row-major
  int* out;        // the shard's block of the [B] labels
  float* scores;   // its block of the [B, C] scores, or null
  long long rows;
  long long block0;  // its first block of the grid
};

template <int M>
struct ScoreShards {
  ScoreShard s[M];
  int n;
};

// G lanes (a power of two, at most 32) per query row, 32 / G rows a warp
template <int M>
__global__ void __launch_bounds__(SCORE_WARPS * 32) nb_scores_argmax(
    const ScoreShards<M> t, const float* __restrict__ pi, const float* __restrict__ theta,
    int C, int F, int G) {
  // the block's shard: the last whose first block is at most this one (an
  // empty shard shares its first block with the next, which wins)
  const long long bid = blockIdx.x;
  ScoreShard sh = t.s[0];
#pragma unroll
  for (int i = 1; i < M; ++i)
    if (i < t.n && bid >= t.s[i].block0) sh = t.s[i];
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const int per_warp = 32 / G;
  const long long row = (bid - sh.block0) * (SCORE_WARPS * per_warp) +
                        (threadIdx.x >> 5) * per_warp + lane / G;
  const bool valid = row < sh.rows;
  float best = 0.f;
  int arg = -1;  // no candidate: an invalid row's lanes take part in the shuffles only
  if (valid) {
    const float* x = sh.X + row * F;
    for (int c = sub; c < C; c += G) {
      const float* tc = theta + (long long)c * F;
      float acc = 0.f;
      for (int f = 0; f < F; ++f) acc = __fadd_rn(acc, __fmul_rn(x[f], tc[f]));
      const float s = __fadd_rn(acc, pi[c]);
      if (sh.scores != nullptr) sh.scores[row * C + c] = s;
      if (precedes(s, c, best, arg)) {
        best = s;
        arg = c;
      }
    }
  }
  for (int o = G >> 1; o > 0; o >>= 1) {  // within the row's aligned G lanes
    const float v = __shfl_xor_sync(0xffffffffu, best, o);
    const int i = __shfl_xor_sync(0xffffffffu, arg, o);
    if (precedes(v, i, best, arg)) {
      best = v;
      arg = i;
    }
  }
  if (valid && sub == 0) sh.out[row] = arg;
}

template <int M>
cudaError_t scores_launch(const long long* a, int n_shards, cudaStream_t stream) {
  const int C = (int)a[1], F = (int)a[2];
  int G = 1;
  while (G < C && G < 32) G <<= 1;
  const long long per_block = SCORE_WARPS * (32 / G);
  ScoreShards<M> t;
  t.n = n_shards;
  long long blocks = 0;
  for (int s = 0; s < n_shards; ++s) {
    const long long* e = a + 6 + 4 * s;
    if (e[3] < 0) return cudaErrorInvalidValue;
    t.s[s].X = reinterpret_cast<const float*>(e[0]);
    t.s[s].out = reinterpret_cast<int*>(e[1]);
    t.s[s].scores = reinterpret_cast<float*>(e[2]);
    t.s[s].rows = e[3];
    t.s[s].block0 = blocks;
    blocks += (e[3] + per_block - 1) / per_block;
  }
  if (blocks == 0) return cudaSuccess;  // every shard empty: nothing to write
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  nb_scores_argmax<M><<<(unsigned)blocks, SCORE_WARPS * 32, 0, stream>>>(
      t, reinterpret_cast<const float*>(a[3]), reinterpret_cast<const float*>(a[4]), C, F, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K15a on `stream`, on device a[0] (made current for the launch and
// restored after). a holds 64-bit integers: {device, n, F, C, nblk,
// rows_per_block, Ft, L, Ct, cap, part, cpart, counts, sums, pi, theta,
// n_shards (0 to 64), then per shard (X, y, rows, part0)}: the plan (nblk blocks of
// rows_per_block rows over all n rows, F tiles of Ft, class tiles of Ct, L
// lanes with L·Ft <= 256), the partials part [nblk, C, F] float32 and cpart
// [nblk, C] int32, the outputs counts [C] int32, sums [C, F], pi [C] and
// theta [C, F] float32, and the shard table (X [rows, F] float32 and y
// [rows] int32 row-major, its blocks at part0.. of the partials; a label
// outside [0, C) counts nowhere). cap 0: pass 1 alone (the outputs
// unused); cap > 0: both passes in one cooperative launch of at most cap
// blocks (at most what the card holds at once: naive_bayes_fit_capacity).
// Returns a cudaError_t: cudaErrorInvalidValue for a plan or table it does
// not take, cudaErrorCooperativeLaunchTooLarge where cap passes what the
// card holds and the fit has more items than it.
int naive_bayes_fit_f32(const long long* a, float lam, cudaStream_t stream) {
  FitPlan p;
  p.F = (int)a[2];
  p.C = (int)a[3];
  p.nblk = (int)a[4];
  p.rows_per_block = a[5];
  p.Ft = (int)a[6];
  p.L = (int)a[7];
  p.Ct = (int)a[8];
  p.blocks = p.gy = p.gz = 0;
  p.lam = lam;
  const int device = (int)a[0], n_shards = (int)a[16];
  const long long cap = a[9];
  if (a[1] < 1 || p.F < 1 || p.C < 1 || p.nblk < 1 || p.rows_per_block < 1 || p.Ft < 1 ||
      p.L < 1 || p.Ct < 1 || p.L * p.Ft > FIT_THREADS || fit_smem(p) > FIT_SMEM_MAX ||
      (long long)(p.nblk - 1) * p.rows_per_block >= a[1] || cap < 0 || n_shards < 0 ||
      n_shards > MAX_SHARDS)
    return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  err = by_table_size(n_shards, [&](auto m) {
    return fit_launch<decltype(m)::value>(a, p, cap, stream);
  });
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

// How many blocks of the fused fit (n_shards' table size, smem bytes of
// dynamic shared memory a block) device `device` holds at once: the
// occupancy query times the SM count, into *capacity. Returns a
// cudaError_t.
int naive_bayes_fit_capacity(int device, int n_shards, int smem, int* capacity) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return (int)err;
  int prev = 0;
  if ((err = cudaGetDevice(&prev)) != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  err = by_table_size(n_shards, [&](auto m) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, &nb_fit<decltype(m)::value, true>, FIT_THREADS, (size_t)smem);
  });
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  *capacity = coop ? per_sm * sms : 0;
  return (int)err;
}

// K15b over a shard table on `stream`, on device a[0] (made current for
// the launch and restored after). a holds 64-bit integers: {device, C, F,
// pi, theta, n_shards (1 to 64), then per shard (X, out, scores, rows)}:
// pi [C] and theta [C, F] float32, and per shard its rows X [rows, F]
// float32 row-major, its block out [rows] int32 of the labels (the
// jnp.argmax of X·θᵀ + π per row) and, where scores is not 0, its block
// [rows, C] float32 of the scores, all on the device. One launch covers
// every shard; none where every shard is empty. Returns a cudaError_t:
// cudaErrorInvalidValue for a table it does not take. The caller checks
// dtypes, devices, shapes and that the blocks do not overlap.
int naive_bayes_scores_f32(const long long* a, cudaStream_t stream) {
  const int device = (int)a[0], n_shards = (int)a[5];
  if (a[1] < 1 || a[2] < 1 || a[1] > 0x7fffffffLL || a[2] > 0x7fffffffLL || n_shards < 1 ||
      n_shards > MAX_SHARDS)
    return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  err = by_table_size(n_shards, [&](auto m) {
    return scores_launch<decltype(m)::value>(a, n_shards, stream);
  });
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

const char* naive_bayes_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
