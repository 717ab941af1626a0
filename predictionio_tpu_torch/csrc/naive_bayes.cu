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
// ≈0.00024 ms at 3.35 TB/s, so every launch is far above its bound (two
// launches of a few µs each). K15b reads B·F + C·(F + 1) floats and writes
// B labels (and, when asked, B·C scores): ≈25 kB at B = 2,048.
//
// Design.
//   nb_fit_partial (K15a pass 1): a grid of row ranges x F tiles x class
//     tiles. A block of L lanes x Ft columns (L·Ft ≤ 256) walks its row
//     range; lane l takes rows r0 + l, r0 + l + L, ... in order and adds
//     feature f0 + col into its own shared-memory partial [l][c][col], so
//     no two threads write one address and no float atomic is used. The
//     class counts are integer atomics (exact in any order). The lanes are
//     then summed in lane order into the block's partial [block][C][F].
//   nb_fit_finish (K15a pass 2): a block per class sums the partials over
//     the blocks in block order, the row sum in a fixed tree, n from the
//     integer counts, then the log epilogue. Every sum has a fixed order,
//     so a rerun gives the same bits; integer-valued features (the bench's
//     Poisson counts, sums below 2^24) give exact sums in any order.
//   nb_scores_argmax (K15b): a warp per query row, lanes over classes;
//     each lane forms its classes' dots in feature order with separate
//     rounded products and adds (__fmul_rn, __fadd_rn: no FMA), so the
//     plain twin, which does the same in torch ops, matches bit for bit.
//     The (score, class) pairs are reduced over the warp by a total order
//     (NaN first, then the larger score, then the lower class), so the
//     result does not depend on the reduction's shape.
//
// K15s, the reference's two programs on a 1-D `data` mesh (:103-121 fit,
// :144-151 scores), needs no other kernel. The fit cuts the rows of the
// whole-n plan at block boundaries into the mesh's shards: each shard runs
// pass 1 on its rows alone (naive_bayes_fit_partial_f32) into its blocks'
// slice of one partials array on the first device, and one pass 2 there
// (naive_bayes_fit_finish_f32) sums them in block order, so the model is
// one device's bit for bit whatever the shard count (no padding rows are
// needed: the cut is at whole blocks). The scores cut the query batch into
// row shards, each scored by nb_scores_argmax into its block of one [B]
// result; every row is one device's.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int FIT_THREADS = 256;
constexpr int FINISH_THREADS = 256;
constexpr int SCORE_WARPS = 8;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long warp_sum_ll(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum over the block (FINISH_THREADS threads) in a fixed order: the
// warps' butterfly sums, then warp 0's values in warp order
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[w] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < FINISH_THREADS / 32; ++i) s += red[i];
  __syncthreads();
  return s;
}

__device__ long long block_sum_ll(long long v, long long* red) {
  v = warp_sum_ll(v);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[w] = v;
  __syncthreads();
  long long s = 0;
  for (int i = 0; i < FINISH_THREADS / 32; ++i) s += red[i];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(FIT_THREADS) nb_fit_partial(
    const float* __restrict__ X, const int* __restrict__ y, long long n,
    int F, int C, long long rows_per_block, int Ft, int L, int Ct,
    float* __restrict__ part, int* __restrict__ cpart) {
  extern __shared__ float sm[];  // [L][Ct][Ft] floats, then Ct int counts
  int* cnt = reinterpret_cast<int*>(sm + (size_t)L * Ct * Ft);
  const int f0 = blockIdx.y * Ft, c0 = blockIdx.z * Ct;
  const int ft = min(Ft, F - f0), ct = min(Ct, C - c0);
  for (int i = threadIdx.x; i < L * Ct * Ft; i += blockDim.x) sm[i] = 0.f;
  for (int i = threadIdx.x; i < Ct; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x / Ft, col = threadIdx.x % Ft;
  const bool counts = blockIdx.y == 0 && col == 0;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  if (lane < L && col < ft) {
    float* mine = sm + (size_t)lane * Ct * Ft + col;
    for (long long r = r0 + lane; r < r1; r += L) {
      const unsigned c = (unsigned)(y[r] - c0);  // out of range: no class here
      if (c < (unsigned)ct) {
        mine[c * Ft] += X[r * F + f0 + col];
        if (counts) atomicAdd(cnt + c, 1);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ct * ft; i += blockDim.x) {
    const int c = i / ft, f = i % ft;
    float s = 0.f;
    for (int l = 0; l < L; ++l) s += sm[((size_t)l * Ct + c) * Ft + f];
    part[((long long)blockIdx.x * C + c0 + c) * F + f0 + f] = s;
  }
  if (blockIdx.y == 0) {
    for (int i = threadIdx.x; i < ct; i += blockDim.x)
      cpart[(long long)blockIdx.x * C + c0 + i] = cnt[i];
  }
}

__global__ void __launch_bounds__(FINISH_THREADS) nb_fit_finish(
    const float* __restrict__ part, const int* __restrict__ cpart, int nblk,
    int C, int F, float lam, int* __restrict__ counts,
    float* __restrict__ sums, float* __restrict__ pi,
    float* __restrict__ theta) {
  __shared__ float red[FINISH_THREADS / 32];
  __shared__ long long red_ll[FINISH_THREADS / 32];
  const int c = blockIdx.x;
  long long n_part = 0;  // n = Σ counts: integers, exact in any order
  for (long long i = threadIdx.x; i < (long long)nblk * C; i += blockDim.x)
    n_part += cpart[i];
  const long long n = block_sum_ll(n_part, red_ll);
  float row_part = 0.f;
  float* srow = sums + (long long)c * F;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < nblk; ++b) s += part[((long long)b * C + c) * F + f];
    srow[f] = s;
    row_part += s;
  }
  const float row = block_sum(row_part, red);
  const float log_row = logf(row + lam * (float)F);
  for (int f = threadIdx.x; f < F; f += blockDim.x)
    theta[(long long)c * F + f] = logf(srow[f] + lam) - log_row;
  if (threadIdx.x == 0) {
    int k = 0;
    for (int b = 0; b < nblk; ++b) k += cpart[(long long)b * C + c];
    counts[c] = k;
    pi[c] = logf((float)k + lam) - logf((float)n + lam * (float)C);
  }
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

__global__ void __launch_bounds__(SCORE_WARPS * 32) nb_scores_argmax(
    const float* __restrict__ X, const float* __restrict__ pi,
    const float* __restrict__ theta, int B, int C, int F,
    float* __restrict__ scores, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * SCORE_WARPS + (threadIdx.x >> 5);
  if (row >= B) return;
  const float* x = X + row * F;
  float best = 0.f;
  int arg = -1;
  for (int c = lane; c < C; c += 32) {
    const float* t = theta + (long long)c * F;
    float acc = 0.f;
    for (int f = 0; f < F; ++f) acc = __fadd_rn(acc, __fmul_rn(x[f], t[f]));
    const float s = __fadd_rn(acc, pi[c]);
    if (scores != nullptr) scores[row * C + c] = s;
    if (precedes(s, c, best, arg)) {
      best = s;
      arg = c;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_xor_sync(0xffffffffu, best, o);
    const int i = __shfl_xor_sync(0xffffffffu, arg, o);
    if (precedes(v, i, best, arg)) {
      best = v;
      arg = i;
    }
  }
  if (lane == 0) out[row] = arg;
}

}  // namespace

extern "C" {

// K15a's pass 1 on `stream`: the block partials part [nblk, C, F] float32
// and cpart [nblk, C] int32 of the rows X [n, F] float32 under label
// indices y [n] int32 (a row whose index is outside [0, C) counts nowhere),
// block b holding rows b·rows_per_block.. of X. A shard of K15s passes its
// rows (a whole number of the whole-n plan's blocks, the last shard's last
// block may be short) and its slice of the partials: the partials are then
// the single-device launch's, bit for bit. Returns cudaGetLastError().
int naive_bayes_fit_partial_f32(const float* X, const int* y, long long n,
                                int F, int C, int nblk,
                                long long rows_per_block, int Ft, int L,
                                int Ct, float* part, int* cpart,
                                cudaStream_t stream) {
  if (n < 1 || F < 1 || C < 1 || nblk < 1 || Ft < 1 || L < 1 || Ct < 1 ||
      L * Ft > FIT_THREADS || (long long)(nblk - 1) * rows_per_block >= n)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)L * Ct * Ft + Ct) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid(nblk, (F + Ft - 1) / Ft, (C + Ct - 1) / Ct);
  nb_fit_partial<<<grid, L * Ft, smem, stream>>>(X, y, n, F, C, rows_per_block,
                                                 Ft, L, Ct, part, cpart);
  return (int)cudaGetLastError();
}

// K15a's pass 2 on `stream`: the class counts [C] int32, sums [C, F], pi
// [C] and theta [C, F] float32 from the partials of nblk blocks, summed in
// block order. Returns cudaGetLastError().
int naive_bayes_fit_finish_f32(const float* part, const int* cpart, int nblk,
                               int C, int F, float lam, int* counts,
                               float* sums, float* pi, float* theta,
                               cudaStream_t stream) {
  if (nblk < 1 || C < 1 || F < 1) return (int)cudaErrorInvalidValue;
  nb_fit_finish<<<C, FINISH_THREADS, 0, stream>>>(part, cpart, nblk, C, F, lam,
                                                  counts, sums, pi, theta);
  return (int)cudaGetLastError();
}

// K15a on `stream`: both passes over X [n, F] (see above). The plan (nblk
// blocks of rows_per_block rows, F tiles of Ft, class tiles of Ct, L lanes
// with L·Ft <= 256) comes from the caller, as do the partials part
// [nblk, C, F] float32 and cpart [nblk, C] int32. Returns
// cudaGetLastError().
int naive_bayes_fit_f32(const float* X, const int* y, long long n, int F,
                        int C, float lam, int nblk, long long rows_per_block,
                        int Ft, int L, int Ct, float* part, int* cpart,
                        int* counts, float* sums, float* pi, float* theta,
                        cudaStream_t stream) {
  const int err = naive_bayes_fit_partial_f32(X, y, n, F, C, nblk,
                                              rows_per_block, Ft, L, Ct, part,
                                              cpart, stream);
  if (err != (int)cudaSuccess) return err;
  return naive_bayes_fit_finish_f32(part, cpart, nblk, C, F, lam, counts,
                                    sums, pi, theta, stream);
}

// K15b on `stream`: out [B] int32, the jnp.argmax of X·θᵀ + π per row of
// X [B, F] (θ [C, F], π [C], float32), and, when `scores` is not null,
// the scores [B, C]. Returns cudaGetLastError(); no launch when B is 0.
int naive_bayes_scores_f32(const float* X, const float* pi,
                           const float* theta, int B, int C, int F,
                           float* scores, int* out, cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  if (B < 0 || C < 1 || F < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (B + SCORE_WARPS - 1) / SCORE_WARPS;
  nb_scores_argmax<<<blocks, SCORE_WARPS * 32, 0, stream>>>(X, pi, theta, B, C,
                                                            F, scores, out);
  return (int)cudaGetLastError();
}

const char* naive_bayes_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
