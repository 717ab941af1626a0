// K17: categorical naive Bayes — the hand-written Hopper kernels that
// replace the reference's two device programs in
// predictionio_tpu/e2/naive_bayes.py:
//   K17a, _count_flat (:49, called by CategoricalNaiveBayes.train at :222):
//     the histogram of the flat keys (s·L + l)·V + v of every (point, slot),
//     a float32 scatter-add of ones there (out-of-range keys dropped);
//   K17b, _batch_scores (:160) fused with the eager jnp.argmax of
//     predict_batch (:154): for each query row n and label l
//       scores[n, l] = prior[l] + Σ_s (known[n, s] ? ll[l, s, enc[n, s]] : -inf)
//     then the first maximum per row (label 0 where every score is -inf).
//
// Bound on an H100 SXM. K17a reads the keys once and writes the counts: at
// 1,000,000 points x 8 slots 32 MB, ≈0.0096 ms at 3.35 TB/s. K17b reads
// the queries' codes and masks, the priors and the likelihoods it gathers,
// and writes N·L scores and N labels: ≈0.2 MB at N = 2,048, L = 2, S = 8,
// far below one launch's overhead.
//
// Design.
//   cnb_count_partial (K17a pass 1): a grid of key ranges x key tiles; a
//     block zeroes a histogram of its key tile in shared memory, adds its
//     range's keys with integer atomics, and writes its partial
//     [block][key]. cnb_count_finish (pass 2): a thread per key adds the
//     blocks' partials in block order. Integer adds are exact in any
//     order, so the counts are exact and the same on every launch; int32
//     counts go past 2^24 = 16,777,216 per key, where the reference's
//     float32 ones stop.
//   cnb_scores_argmax (K17b): a warp per query row, lanes over labels; a
//     lane sums its label's slots in slot order (an unknown slot, or a code
//     outside [0, V), adds -inf), then adds the prior. The (score, label)
//     pairs are reduced over the warp by a total order (NaN first, then the
//     larger score, then the lower label: jnp.argmax's rule), so the label
//     does not depend on the reduction's shape.
//
// K17s, K17a on a 1-D `data` mesh (the reference's :208-221, whose key
// vector is padded with the sentinel n_keys), needs no other kernel: the
// flat keys are cut at the whole-M plan's block boundaries into the mesh's
// shards, each shard runs pass 1 (cnb_count_partial_i32) on its keys into
// its blocks' slice of one partials array on the first device, and one
// pass 2 (cnb_count_finish_i32) adds them there. The counts are integers,
// so they are one device's bit for bit, with no padding.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int COUNT_THREADS = 256;
constexpr int FINISH_THREADS = 256;
constexpr int SCORE_WARPS = 8;

__global__ void __launch_bounds__(COUNT_THREADS) cnb_count_partial(
    const int* __restrict__ keys, long long M, int n_keys, int tile,
    long long per_block, int* __restrict__ partial) {
  extern __shared__ int hist[];  // [tile]
  const int k0 = blockIdx.y * tile;
  const int kt = min(tile, n_keys - k0);
  for (int i = threadIdx.x; i < kt; i += COUNT_THREADS) hist[i] = 0;
  __syncthreads();
  const long long r0 = (long long)blockIdx.x * per_block;
  const long long r1 = min(M, r0 + per_block);
  for (long long r = r0 + threadIdx.x; r < r1; r += COUNT_THREADS) {
    // a key below k0 wraps to a large unsigned value: not in this tile
    const unsigned k = (unsigned)(keys[r] - k0);
    if (k < (unsigned)kt) atomicAdd(hist + k, 1);
  }
  __syncthreads();
  int* out = partial + (long long)blockIdx.x * n_keys + k0;
  for (int i = threadIdx.x; i < kt; i += COUNT_THREADS) out[i] = hist[i];
}

__global__ void __launch_bounds__(FINISH_THREADS) cnb_count_finish(
    const int* __restrict__ partial, int nblk, int n_keys,
    int* __restrict__ counts) {
  const int k = blockIdx.x * FINISH_THREADS + threadIdx.x;
  if (k >= n_keys) return;
  int s = 0;
  for (int b = 0; b < nblk; ++b) s += partial[(long long)b * n_keys + k];
  counts[k] = s;
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

__global__ void __launch_bounds__(SCORE_WARPS * 32) cnb_scores_argmax(
    const float* __restrict__ ll, const float* __restrict__ prior,
    const int* __restrict__ enc, const unsigned char* __restrict__ known,
    int N, int L, int S, int V, float* __restrict__ scores,
    int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * SCORE_WARPS + (threadIdx.x >> 5);
  if (row >= N) return;
  const int* e = enc + row * S;
  const unsigned char* k = known + row * S;
  float best = 0.f;
  int arg = -1;
  for (int l = lane; l < L; l += 32) {
    const float* lll = ll + (long long)l * S * V;
    float acc = 0.f;
    for (int s = 0; s < S; ++s) {
      const int v = e[s];
      const float t = (k[s] && (unsigned)v < (unsigned)V) ? lll[(long long)s * V + v] : -INFINITY;
      acc = __fadd_rn(acc, t);
    }
    const float sc = __fadd_rn(prior[l], acc);
    scores[row * L + l] = sc;
    if (precedes(sc, l, best, arg)) {
      best = sc;
      arg = l;
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

// K17a's pass 1 on `stream`: the partial histograms partial [nblk, n_keys]
// int32 of keys [M] int32 (a key outside [0, n_keys) counts nowhere), block
// b counting keys b·per_block..; key tiles of `tile` keys. A shard of K17s
// passes its keys (whole blocks of the whole-M plan, the last shard's last
// block may be short) and its blocks' slice of the partials. Returns
// cudaGetLastError().
int cnb_count_partial_i32(const int* keys, long long M, int n_keys, int nblk,
                          long long per_block, int tile, int* partial,
                          cudaStream_t stream) {
  if (M < 1 || n_keys < 1 || nblk < 1 || per_block < 1 || tile < 1 ||
      (long long)tile * sizeof(int) > 48 * 1024 ||
      (long long)(nblk - 1) * per_block >= M)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nblk, (n_keys + tile - 1) / tile);
  cnb_count_partial<<<grid, COUNT_THREADS, tile * sizeof(int), stream>>>(
      keys, M, n_keys, tile, per_block, partial);
  return (int)cudaGetLastError();
}

// K17a's pass 2 on `stream`: counts [n_keys] int32, the nblk partials added
// in block order (integers: exact in any order). Returns
// cudaGetLastError().
int cnb_count_finish_i32(const int* partial, int nblk, int n_keys, int* counts,
                         cudaStream_t stream) {
  if (nblk < 1 || n_keys < 1) return (int)cudaErrorInvalidValue;
  cnb_count_finish<<<(n_keys + FINISH_THREADS - 1) / FINISH_THREADS,
                     FINISH_THREADS, 0, stream>>>(partial, nblk, n_keys, counts);
  return (int)cudaGetLastError();
}

// K17a on `stream`: counts [n_keys] int32, the histogram of keys [M] int32
// (a key outside [0, n_keys) counts nowhere): both passes. The plan (nblk
// key ranges of per_block keys, key tiles of `tile` keys) comes from the
// caller, as does the partials' scratch partial [nblk, n_keys] int32.
// Returns cudaGetLastError().
int cnb_count_i32(const int* keys, long long M, int n_keys, int nblk,
                  long long per_block, int tile, int* partial, int* counts,
                  cudaStream_t stream) {
  const int err = cnb_count_partial_i32(keys, M, n_keys, nblk, per_block, tile,
                                        partial, stream);
  if (err != (int)cudaSuccess) return err;
  return cnb_count_finish_i32(partial, nblk, n_keys, counts, stream);
}

// K17b on `stream`: scores [N, L] float32 and out [N] int32 (the first
// maximum per row) of the queries' codes enc [N, S] int32 and masks
// known [N, S] uint8 under ll [L, S, V] and prior [L] float32. Returns
// cudaGetLastError(); no launch when N is 0.
int cnb_scores_argmax_f32(const float* ll, const float* prior, const int* enc,
                          const unsigned char* known, int N, int L, int S,
                          int V, float* scores, int* out, cudaStream_t stream) {
  if (N == 0) return (int)cudaSuccess;
  if (N < 0 || L < 1 || S < 0 || V < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (N + SCORE_WARPS - 1) / SCORE_WARPS;
  cnb_scores_argmax<<<blocks, SCORE_WARPS * 32, 0, stream>>>(
      ll, prior, enc, known, N, L, S, V, scores, out);
  return (int)cudaGetLastError();
}

const char* categorical_nb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
