// K9m: the row-sharded retriever's cross-shard merge — the hand-written
// Hopper kernel that replaces the reference's jitted
// predictionio_tpu/ops/retrieval.py:425 _merge_candidates.
//
// What it computes. cand [S, B, 2L] is the sharded retriever's candidate
// buffer as it lays it out (ops/retrieval.py): for each shard s and query
// row b, the shard's packed top-L candidates, L scores, then L int32 global
// ids as raw bits, each shard's list sorted by score descending (kernel
// A's order, csrc/masked_topn.cu, or kernel B's, csrc/rescore.cu; -inf
// slots last). Per row, out [B, 2n] gets the n best of the S·L candidates
// in the order lax.top_k gives over their concatenation [shard 0's L,
// shard 1's L, ...]: score descending, ties to the LOWER position — the
// lower shard first, then the shard's own order. Then the n ids, copied as
// raw bits.
//
// Design: exact, no shared-memory ceiling, one pass. One thread per
// candidate (s, p) computes its output rank directly:
//   rank = p + Σ_{s' < s} #{entries of s' with score >= v}
//            + Σ_{s' > s} #{entries of s' with score >  v}
// each count one binary search over a sorted list (entries of a lower
// shard precede on ties, those of a higher shard do not; within its own
// shard the p entries ahead of it precede). The ranks are a permutation of
// [0, S·L), so each slot r < n is written by exactly one thread, and
// S·L >= n (the retriever's n_local = min(n, rows per shard) makes it so).
// -inf is an ordinary value here; a NaN score is not ordered (neither
// kernel A's selection nor lax.top_k's order is defined for one; the
// served factors are finite).
//
// Bound on an H100 SXM at the serving shape (B = 128, S = 4, L = n = 16):
// it reads B·S·2L·4 = 64 KB and writes B·2n·4 = 16 KB, ≈0.02 µs at
// 3.35 TB/s: bytes-bound, and in practice bound by the launch and the
// host's call. So the kernel reads the buffer as it lies (no view or copy
// a batch), and its entry point takes only what the kernel reads and makes
// the device current itself (a no-op where it is current), so the wrapper
// spends no host time on a device context. Each thread reads (S-1)·log2(L)
// scores more, from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// #{j < L : list[j] >= v} (ge) or #{j < L : list[j] > v}, on a list sorted
// descending
__device__ __forceinline__ int count_ahead(const float* __restrict__ list, int L,
                                           float v, bool ge) {
  int lo = 0, hi = L;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float x = list[mid];
    if (ge ? x >= v : x > v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
merge_topn(const float* __restrict__ cand, int B, int S, int L, int n,
           float* __restrict__ out) {
  const int b = blockIdx.y;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= (long long)S * L) return;
  const int s = (int)(t / L), p = (int)(t - (long long)s * L);
  if (p >= n) return;  // p entries of its own shard precede it already
  // entry (s, b) of the [S, B, 2L] buffer
  const long long stride_s = (long long)B * 2 * L;
  const float* row = cand + (long long)b * 2 * L;
  const float* mine = row + (long long)s * stride_s;
  const float v = mine[p];
  int rank = p;
  for (int o = 0; o < S && rank < n; ++o) {
    if (o == s) continue;
    rank += count_ahead(row + (long long)o * stride_s, L, v, o < s);
  }
  if (rank >= n) return;
  float* orow = out + (long long)b * 2 * n;
  orow[rank] = v;
  reinterpret_cast<unsigned*>(orow)[n + rank] =
      reinterpret_cast<const unsigned*>(mine + L)[p];
}

}  // namespace

extern "C" {

// K9m on `device`'s `stream`, made current for the launch and restored
// after; returns a cudaError_t. cand is the contiguous [S, B, 2L] buffer
// (see the header), out [B, 2n]. The caller checks 1 <= n <= S·L,
// 1 <= B <= 65,535, dtypes, contiguity and devices.
int merge_topn_f32(int device, const float* cand, int B, int S, int L, int n,
                   float* out, cudaStream_t stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  const long long total = (long long)S * L;
  dim3 grid((unsigned)((total + THREADS - 1) / THREADS), (unsigned)B);
  merge_topn<<<grid, THREADS, 0, stream>>>(cand, B, S, L, n, out);
  err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

const char* merge_topn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
