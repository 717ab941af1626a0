// K3: serving score + top-n, packed — the hand-written Hopper kernel that
// replaces the reference's jitted program predictionio_tpu/ops/als.py:2354
// _topn_packed_impl (jitted as _topn_packed at :2365).
//
// What it computes. q [B,k] f32 and Y [N,k] f32 (both row-major,
// contiguous); for every query row the n best items by score q·y, ordered
// by (score descending, item id ascending) — lax.top_k's order, lowest
// index first on ties — packed into out [B, 2n] f32: the n scores, then
// the n int32 item ids stored as raw bits (never a float cast, which would
// corrupt ids >= 2^24).
//
// Bound on an H100 SXM. At the full-width serving shape (B=128,
// N=26,744, k=32) the product is 2·B·N·k ≈ 219 MFLOP, ≈3.3 µs on the
// fp32 CUDA cores (67 TFLOP/s), while the bytes are Y's ≈3.4 MB,
// ≈1.0 µs at 3.35 TB/s: compute-bound. At B=8 it is memory-bound. The
// products are fp32 FMAs on the CUDA cores, never TF32: the reference
// holds parity in full f32.
//
// Design, simple and correct first (wgmma/TMA and a fused single pass are
// later work):
//   pass 1 (tile_topm): one block of WARPS warps per (item tile of TILE
//     rows, group of WARPS query rows); warp w serves query row w of the
//     group. Y's tile is staged through shared memory KC rank columns at a
//     time with coalesced loads, so each Y byte is read from device memory
//     once per query group, not once per query row. Each lane scores
//     PER_LANE items of the tile for its warp's row (float4 reads of the
//     staged rows, the query element broadcast by shuffle), sorts them in
//     registers, and the warp then takes the tile's best m = min(n, TILE)
//     one by one: a butterfly finds the best lane head, that lane steps to
//     its next entry. No block barrier is needed after scoring. The output
//     is the tile's sorted candidate list; the [B,N] score matrix is never
//     written to device memory. Any global top-n item is inside its own
//     tile's top-m, so nothing is lost.
//   pass 2 (merge_lists): one block per query row merges the sorted
//     candidate lists pairwise, round by round (merge path: each output
//     position finds its split by binary search), keeping the first
//     min(n, 2·len) of every merged pair, until one list is left, and
//     writes the packed row. The rounds run in shared memory when the
//     row's lists fit there, else in the scratch buffers. Lists are padded
//     with (-inf, INT_MAX) sentinels, which sort after every real item, so
//     tiles shorter than m (the ragged last tile) need no special case.
// Correct for every 1 <= n <= N, any N (not only multiples of TILE), any
// k, and exact ties.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;              // items per pass-1 block
constexpr int WARPS = 8;               // warps (= query rows) per pass-1 block
constexpr int THREADS = WARPS * 32;
constexpr int PER_LANE = TILE / 32;    // items each lane scores
constexpr int KC = 32;                 // rank columns staged per chunk
constexpr int KS = KC + 4;             // staged row stride: float4-aligned,
                                       // conflict-free for a warp's reads
constexpr int MERGE_THREADS = 256;
constexpr int SENTINEL_ID = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
// the most dynamic shared memory a Hopper block can opt into
constexpr long long MAX_MERGE_SMEM = 227 * 1024;

__device__ __forceinline__ bool before(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// bitonic sort of n register entries, best first
template <int n>
__device__ __forceinline__ void sort_lane(float (&s)[n], int (&id)[n]) {
#pragma unroll
  for (int size = 2; size <= n; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < n; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          const bool best_first = (i & size) == 0;
          const bool swap = best_first ? before(s[j], id[j], s[i], id[i])
                                       : before(s[i], id[i], s[j], id[j]);
          if (swap) {
            const float ts = s[i]; s[i] = s[j]; s[j] = ts;
            const int ti = id[i]; id[i] = id[j]; id[j] = ti;
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
tile_topm(const float* __restrict__ q, const float* __restrict__ Y,
          float* __restrict__ cand_s, int* __restrict__ cand_i,
          int B, int N, int k, int m, long long list_stride) {
  __shared__ __align__(16) float ys[TILE * KS];
  const int tid = threadIdx.x, lane = tid & 31;
  const int row = blockIdx.y * WARPS + (tid >> 5);
  const bool row_live = row < B;
  const long long item0 = (long long)blockIdx.x * TILE;

  float s[PER_LANE];  // scores of items item0 + lane + 32·t, summed over
  int id[PER_LANE];   // the rank in order, one fp32 FMA per element
#pragma unroll
  for (int t = 0; t < PER_LANE; ++t) s[t] = 0.f;

  for (int c0 = 0; c0 < k; c0 += KC) {
    const int kc = min(KC, k - c0);
    const int kc4 = (kc + 3) & ~3;  // zero-padded to whole float4s
    __syncthreads();  // the previous chunk's readers are done
    // consecutive threads read consecutive addresses (one contiguous run
    // when kc == k)
    for (int e = tid; e < TILE * kc4; e += THREADS) {
      const int r = e / kc4, c = e - r * kc4;
      const long long it = item0 + r;
      ys[r * KS + c] = (c < kc && it < N) ? Y[it * k + c0 + c] : 0.f;
    }
    // lane c holds q[row, c0 + c], zero past the chunk and for rows past B
    const float qc =
        (row_live && lane < kc) ? q[(long long)row * k + c0 + lane] : 0.f;
    __syncthreads();
    for (int c = 0; c < kc4; c += 4) {
      const float q0 = __shfl_sync(FULL, qc, c);
      const float q1 = __shfl_sync(FULL, qc, c + 1);
      const float q2 = __shfl_sync(FULL, qc, c + 2);
      const float q3 = __shfl_sync(FULL, qc, c + 3);
#pragma unroll
      for (int t = 0; t < PER_LANE; ++t) {
        const float4 y =
            *reinterpret_cast<const float4*>(&ys[(lane + 32 * t) * KS + c]);
        s[t] = fmaf(q0, y.x, s[t]);
        s[t] = fmaf(q1, y.y, s[t]);
        s[t] = fmaf(q2, y.z, s[t]);
        s[t] = fmaf(q3, y.w, s[t]);
      }
    }
  }
  if (!row_live) return;  // no block barrier follows

#pragma unroll
  for (int t = 0; t < PER_LANE; ++t) {
    const long long it = item0 + lane + 32 * t;
    if (it < N) {
      id[t] = (int)it;
    } else {
      s[t] = -INFINITY;
      id[t] = SENTINEL_ID;
    }
  }
  sort_lane(s, id);
  // the tile's best m, one per round: the warp's best lane head wins and
  // that lane steps to its next entry. Lane (i mod 32) keeps winner i
  // until the warp writes 32 of them at once.
  const long long base = (long long)row * list_stride + (long long)blockIdx.x * m;
  float keep_s = -INFINITY;
  int keep_i = SENTINEL_ID;
  for (int i = 0; i < m; ++i) {
    float bs = s[0];
    int bi = id[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(FULL, bs, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (before(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (id[0] == bi && s[0] == bs) {
#pragma unroll
      for (int t = 0; t + 1 < PER_LANE; ++t) {
        s[t] = s[t + 1];
        id[t] = id[t + 1];
      }
      s[PER_LANE - 1] = -INFINITY;
      id[PER_LANE - 1] = SENTINEL_ID;
    }
    if (lane == (i & 31)) {
      keep_s = bs;
      keep_i = bi;
    }
    if ((i & 31) == 31 || i == m - 1) {
      if (lane <= (i & 31)) {
        cand_s[base + (i & ~31) + lane] = keep_s;
        cand_i[base + (i & ~31) + lane] = keep_i;
      }
    }
  }
}

// `in_smem`: the row's lists, twice over (ping and pong), fit in the
// block's dynamic shared memory, so they are copied in once and every
// merge round runs on chip; otherwise the rounds ping-pong in the scratch
// buffers in device memory.
__global__ void __launch_bounds__(MERGE_THREADS)
merge_lists(float* s0, int* i0, float* s1, int* i1, float* out, int n,
            int num_lists, int m, long long list_stride, int in_smem) {
  extern __shared__ __align__(16) unsigned char merge_smem[];
  const long long base = (long long)blockIdx.x * list_stride;
  float* src_s = s0 + base;
  int* src_i = i0 + base;
  float* dst_s = s1 + base;
  int* dst_i = i1 + base;
  if (in_smem) {
    float* ss = reinterpret_cast<float*>(merge_smem);
    int* si = reinterpret_cast<int*>(ss + list_stride);
    const long long count = (long long)num_lists * m;
#pragma unroll 8
    for (long long e = threadIdx.x; e < count; e += blockDim.x) {
      ss[e] = src_s[e];
      si[e] = src_i[e];
    }
    src_s = ss;
    src_i = si;
    dst_s = reinterpret_cast<float*>(si + list_stride);
    dst_i = reinterpret_cast<int*>(dst_s + list_stride);
    __syncthreads();
  }
  int lists = num_lists, len = m;
  while (lists > 1) {
    const int out_len = (int)min((long long)n, 2LL * len);
    const int pairs = (lists + 1) / 2;
    const long long total = (long long)pairs * out_len;
    for (long long e = threadIdx.x; e < total; e += blockDim.x) {
      const int pair = (int)(e / out_len);
      const int p = (int)(e - (long long)pair * out_len);
      const float* as = src_s + (long long)(2 * pair) * len;
      const int* ai = src_i + (long long)(2 * pair) * len;
      const float* bs = as + len;
      const int* bi = ai + len;
      const int la = len;
      const int lb = 2 * pair + 1 < lists ? len : 0;
      float s = -INFINITY;
      int id = SENTINEL_ID;
      if (p < la + lb) {
        // merge path: i = how many of A are among the first p outputs
        // (A wins ties, so the merge is stable)
        int lo = max(0, p - lb), hi = min(p, la);
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          const int j = p - 1 - mid;
          if (!before(bs[j], bi[j], as[mid], ai[mid])) lo = mid + 1;
          else hi = mid;
        }
        const int i = lo, j = p - lo;
        const bool take_a =
            j >= lb || (i < la && !before(bs[j], bi[j], as[i], ai[i]));
        if (take_a) { s = as[i]; id = ai[i]; }
        else { s = bs[j]; id = bi[j]; }
      }
      dst_s[(long long)pair * out_len + p] = s;
      dst_i[(long long)pair * out_len + p] = id;
    }
    __syncthreads();  // this round's lists are complete before they are read
    float* ts = dst_s;
    int* ti = dst_i;
    dst_s = src_s;
    dst_i = src_i;
    src_s = ts;
    src_i = ti;
    lists = pairs;
    len = out_len;
  }
  float* row_out = out + (long long)blockIdx.x * 2 * n;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    row_out[p] = src_s[p];
    row_out[n + p] = __int_as_float(src_i[p]);
  }
}

long long list_stride_of(int N, int n) {
  const long long tiles = (N + TILE - 1) / TILE;
  const long long m = n < TILE ? n : TILE;
  // merge round r holds ceil(tiles/2^r) lists of at most m·2^r entries;
  // rounding the list count up to a power of two bounds every round
  long long lists = 1;
  while (lists < tiles) lists <<= 1;
  return lists * m;
}

}  // namespace

extern "C" {

// Floats of scratch the caller allocates for topn_packed_f32: two
// ping-pong candidate buffers, each a score plane and an id plane.
long long topn_scratch_floats(int B, int N, int n) {
  return 4LL * B * list_stride_of(N, n);
}

// Launches both passes on `stream` and returns cudaGetLastError(). The
// caller checks 1 <= n <= N, B >= 1, k >= 1, dtypes, devices and
// contiguity.
int topn_packed_f32(const float* q, const float* Y, float* out,
                    float* scratch, int B, int N, int k, int n,
                    cudaStream_t stream) {
  const long long stride = list_stride_of(N, n);
  const int tiles = (N + TILE - 1) / TILE;
  const int m = n < TILE ? n : TILE;
  float* s0 = scratch;
  int* i0 = reinterpret_cast<int*>(scratch + (long long)B * stride);
  float* s1 = scratch + 2LL * B * stride;
  int* i1 = reinterpret_cast<int*>(scratch + 3LL * B * stride);
  dim3 grid1(tiles, (B + WARPS - 1) / WARPS);
  tile_topm<<<grid1, THREADS, 0, stream>>>(q, Y, s0, i0, B, N, k, m, stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long smem = 2 * stride * (long long)(sizeof(float) + sizeof(int));
  const int in_smem = smem <= MAX_MERGE_SMEM;
  if (in_smem) {
    err = cudaFuncSetAttribute(merge_lists,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  merge_lists<<<B, MERGE_THREADS, in_smem ? (size_t)smem : 0, stream>>>(
      s0, i0, s1, i1, out, n, tiles, m, stride, in_smem);
  return (int)cudaGetLastError();
}

const char* topn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
