// The selection passes shared by the serving top-n kernels (K3,
// csrc/topn.cu, and the masked/quantized retriever's stage 1,
// csrc/masked_topn.cu): the per-tile register sort and warp extraction of
// a tile's best m, and the merge-path pass that merges the tiles' sorted
// candidate lists into one packed row.
//
// Order everywhere: (score descending, id ascending), lax.top_k's order.
// Lists are padded with (-inf, SENTINEL_ID) sentinels, which sort after
// every real item, a masked real item (-inf, its id) included, so tiles
// shorter than m need no special case.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace topn_select {

constexpr int TILE = 256;              // items per tile block
constexpr int WARPS = 8;               // warps (= query rows) per tile block
constexpr int THREADS = WARPS * 32;
constexpr int PER_LANE = TILE / 32;    // items each lane scores
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

// Bitonic sort of one warp's TILE entries, best first: entry e is register
// e % PER_LANE of lane e / PER_LANE. Strides below PER_LANE compare within
// a lane's registers, wider ones across lanes by shuffles.
__device__ __forceinline__ void warp_sort_tile(float (&s)[PER_LANE],
                                               int (&id)[PER_LANE], int lane) {
#pragma unroll
  for (int size = 2; size <= TILE; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= PER_LANE) {
        const int lstride = stride / PER_LANE;
        const bool lower = (lane & lstride) == 0;
#pragma unroll
        for (int t = 0; t < PER_LANE; ++t) {
          const float os = __shfl_xor_sync(FULL, s[t], lstride);
          const int oi = __shfl_xor_sync(FULL, id[t], lstride);
          const bool best_first = ((lane * PER_LANE + t) & size) == 0;
          // the lower entry of a best-first pair keeps the better one
          const bool take = lower == best_first ? before(os, oi, s[t], id[t])
                                                : before(s[t], id[t], os, oi);
          if (take) {
            s[t] = os;
            id[t] = oi;
          }
        }
      } else {
#pragma unroll
        for (int t = 0; t < PER_LANE; ++t) {
          const int j = t ^ stride;
          if (j > t) {
            const bool best_first = ((lane * PER_LANE + t) & size) == 0;
            const bool swap = best_first ? before(s[j], id[j], s[t], id[t])
                                         : before(s[t], id[t], s[j], id[j]);
            if (swap) {
              const float ts = s[t]; s[t] = s[j]; s[j] = ts;
              const int ti = id[t]; id[t] = id[j]; id[j] = ti;
            }
          }
        }
      }
    }
  }
}

// One warp's tile entries (lane holds PER_LANE scored items) -> the tile's
// best m, sorted, at cand_s/cand_i[base ..]. Up to m = 32: each lane sorts
// its entries in registers; then one winner per round: a butterfly finds
// the best lane head, that lane steps to its next entry. Lane (i mod 32)
// keeps winner i until the warp writes 32 of them at once. A wider m (a
// quantized shortlist keeps whole tiles) sorts the whole tile instead:
// 15 shuffle stages in place of m rounds of 5. Needs no block barrier.
__device__ __forceinline__ void warp_take_topm(
    float (&s)[PER_LANE], int (&id)[PER_LANE], int m, int lane,
    float* __restrict__ cand_s, int* __restrict__ cand_i, long long base) {
  if (m > 32) {
    warp_sort_tile(s, id, lane);
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int e = lane * PER_LANE + t;
      if (e < m) {
        cand_s[base + e] = s[t];
        cand_i[base + e] = id[t];
      }
    }
    return;
  }
  sort_lane(s, id);
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

// The row of the packed result a merge block writes: its own query row
// (every kernel but K3 over a shard table, csrc/topn.cu).
struct SameRows {
  __device__ __forceinline__ long long operator()(long long row) const { return row; }
};

// One block per query row merges the row's sorted candidate lists
// pairwise, round by round (merge path: each output position finds its
// split by binary search), keeping the first min(n, 2·len) of every merged
// pair, until one list is left, and writes it: with out_i == nullptr as
// the packed row rows(row) of `out` (n scores, then the n ids plus
// id_offset as raw int32 bits: a row shard's local ids made global), else
// as n scores at out and n ids at out_i, at the block's own row. `in_smem`:
// the row's lists, twice over (ping and pong), fit in the block's dynamic
// shared memory, so they are copied in once and every merge round runs on
// chip; otherwise the rounds ping-pong in the scratch buffers in device
// memory.
template <class Rows>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_lists(float* s0, int* i0, float* s1, int* i1, float* out, int* out_i,
            int n, int num_lists, int m, long long list_stride, int in_smem,
            int id_offset, const Rows rows) {
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
  if (out_i == nullptr) {
    float* row_out = out + rows((long long)blockIdx.x) * 2 * n;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      row_out[p] = src_s[p];
      row_out[n + p] = __int_as_float(src_i[p] + id_offset);
    }
  } else {
    const long long o = (long long)blockIdx.x * n;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      out[o + p] = src_s[p];
      out_i[o + p] = src_i[p];
    }
  }
}

inline long long pow2_at_least(long long x) {
  long long p = 1;
  while (p < x) p <<= 1;
  return p;
}

inline long long list_stride_of(int N, int n) {
  const long long tiles = (N + TILE - 1) / TILE;
  const long long m = n < TILE ? n : TILE;
  // merge round r holds ceil(tiles/2^r) lists of at most m·2^r entries;
  // rounding the list count up to a power of two bounds every round
  return pow2_at_least(tiles) * m;
}

// Floats of scratch for B rows: two ping-pong candidate buffers, each a
// score plane and an id plane.
inline long long scratch_floats(int B, int N, int n) {
  return 4LL * B * list_stride_of(N, n);
}

// Shared memory one merge block needs for `lists` lists of m, ping and pong.
inline long long merge_bytes(long long lists, int m) {
  return 2 * lists * m * (long long)(sizeof(float) + sizeof(int));
}

// Whether a row's lists are too many to merge in one block's shared memory,
// so the merge runs in levels (see launch_merge).
inline bool merge_in_levels(int N, int n) {
  return merge_bytes(list_stride_of(N, n) / (n < TILE ? n : TILE),
                     n < TILE ? n : TILE) > MAX_MERGE_SMEM;
}

// Tile blocks the tile pass launches per group of query rows: one per tile,
// or pow2(tiles) when the merge runs in levels, which read the padding
// tiles' sentinel lists (sentinel_tile).
inline unsigned tile_blocks(int N, int n) {
  const long long tiles = (N + TILE - 1) / TILE;
  return (unsigned)(merge_in_levels(N, n) ? pow2_at_least(tiles) : tiles);
}

// A tile block past the catalog (a padding tile of a leveled merge) writes
// its rows' sentinel lists without scoring; returns whether it was one. The
// whole block returns together: item0 is the block's.
__device__ __forceinline__ bool sentinel_tile(
    long long item0, int N, bool row_live, int lane, int m,
    float* __restrict__ cand_s, int* __restrict__ cand_i, long long base) {
  if (item0 < N) return false;
  if (row_live) {
    for (int i = lane; i < m; i += 32) {
      cand_s[base + i] = -INFINITY;
      cand_i[base + i] = SENTINEL_ID;
    }
  }
  return true;
}

// The merge pass over the tile pass's lists in `scratch`, on `stream`, into
// the packed rows at `out` (query row b into row rows(b)); returns the
// launches' cudaError_t. When a row's lists fit in one block's shared
// memory, one block per row merges them there; the packed ids get
// id_offset added (0 but on a row shard's retriever). Otherwise the merge
// runs in levels: each level merges groups of G lists on chip, one block
// per group, into one list of n, until one block can merge a row's
// remaining lists on chip (or, where even a group cannot fit, in device
// memory).
template <class Rows = SameRows>
inline cudaError_t launch_merge(float* scratch, float* out, int B, int N,
                                int n, cudaStream_t stream, int id_offset = 0,
                                const Rows& rows = Rows()) {
  const long long stride = list_stride_of(N, n);
  int len = n < TILE ? n : TILE;
  long long lists = stride / len;  // pow2(tiles)
  int num_lists = (N + TILE - 1) / TILE;
  float* src_s = scratch;
  int* src_i = reinterpret_cast<int*>(scratch + (long long)B * stride);
  float* oth_s = scratch + 2LL * B * stride;
  int* oth_i = reinterpret_cast<int*>(scratch + 3LL * B * stride);
  cudaError_t err;
  if (merge_in_levels(N, n)) {
    num_lists = (int)lists;  // the padding tiles' sentinel lists included
    while (merge_bytes(lists, len) > MAX_MERGE_SMEM) {
      long long G = 2;  // a group's lists must hold n entries between them
      while (G * len < n) G *= 2;
      if (G >= lists || merge_bytes(G, len) > MAX_MERGE_SMEM) break;
      while (2 * G < lists && merge_bytes(2 * G, len) <= MAX_MERGE_SMEM) G *= 2;
      const long long groups = lists / G;
      const long long smem = merge_bytes(G, len);
      err = cudaFuncSetAttribute(merge_lists<SameRows>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      merge_lists<<<(unsigned)(B * groups), MERGE_THREADS, (size_t)smem,
                    stream>>>(src_s, src_i, oth_s, oth_i, oth_s, oth_i, n,
                              (int)G, len, G * len, 1, 0, SameRows());
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      float* ts = src_s; src_s = oth_s; oth_s = ts;
      int* ti = src_i; src_i = oth_i; oth_i = ti;
      lists = num_lists = (int)groups;
      len = n;
    }
  }
  const long long smem = merge_bytes(lists, len);
  const int in_smem = smem <= MAX_MERGE_SMEM;
  if (in_smem) {
    err = cudaFuncSetAttribute(merge_lists<Rows>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  merge_lists<<<B, MERGE_THREADS, in_smem ? (size_t)smem : 0, stream>>>(
      src_s, src_i, oth_s, oth_i, out, nullptr, n, num_lists, len,
      lists * len, in_smem, id_offset, rows);
  return cudaGetLastError();
}

}  // namespace topn_select
