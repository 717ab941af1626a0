// K4, K5a and K5b: the device side of the single-device training wire —
// the hand-written Hopper kernels that replace the reference's jitted
// programs predictionio_tpu/ops/als.py:407 _unpack_nibbles,
// :416 _device_pack_presorted and :449 _device_scatter_pack.
//
// What they compute. The wire is the COO presorted by user: item ids iw
// [n] (uint16 or int32), values v [n] (int8 doubled half-steps, shipped
// nibble-packed, or float32), and each side's CSR offsets `starts` and
// first-segment bases `seg_base` (int32, edge-padded to S entries). The
// last n - nnz elements are padding with item id n_items and value 0.
//   K4 unpack_nibbles: uint8 [m] -> int8 [2m], the low nibble to the even
//     index, the high nibble to the odd one.
//   K5a pack_presorted: keys[j] = #{m >= 1 : starts[m] <= j} (the user of
//     element j; the padding tail gets keys past the last real row), then
//     offset = j - starts[key], flat = (seg_base[key] + offset / L) * L +
//     offset % L, and p_cols[flat] = iw[j], p_vals[flat] = v[j] * scale
//     into zeroed [total * L] planes, dropping flat outside them.
//   K5b scatter_pack: a stable sort of (item, user key, value) by item,
//     then the same offset/flat scatter over the sorted position j.
// Indices that the reference's gathers would clamp are clamped here too,
// so the planes equal the reference's bit for bit, padding segments
// included (the padding tail lands in the segments past the last real one).
//
// Bound on an H100 SXM, at ML-20M (n = 20,971,520, total·L = 33,554,432
// user slots and 25,165,824 item slots). Each kernel moves its inputs once
// and its outputs once and does no arithmetic to speak of: K4 31.5 MB
// (≈9.4 µs at 3.35 TB/s), K5a ≈415 MB (≈0.124 ms), K5b ≈348 MB (≈0.104
// ms). All three are bound by bytes.
//
// Design.
//   K4: a thread expands 16 wire bytes into 32 with one 16-byte load, two
//     16-byte stores and byte permutes (scalar bytes at a ragged tail or
//     when a pointer is not 16-byte aligned, as a chunk slice may be).
//   K5a: a thread takes 4 elements a block-width apart (coalesced), finds
//     the first one's key by binary search over starts and each next one's
//     from the previous key (one compare unless it crosses a row), then
//     writes the key and scatters. The flat indices rise with j, so the
//     scatter writes are nearly contiguous. The planes are zeroed first.
//   K5b: an LSD radix sort on 8-bit digits, ⌈key bits / 8⌉ passes (two at
//     ML-20M), written by hand. Each pass: a per-tile (4,096 elements)
//     digit histogram, an exclusive scan of the [digit][tile] counts, and a
//     scatter in which each warp ranks its 32-element rounds with
//     __match_any_sync and a per-warp digit count in shared memory, in
//     element order, so equal keys keep their order (stable) with no
//     atomics. The last pass scatters straight into the planes at the
//     offset/flat index of each element's sorted position.
// Later work: stage K5b's scatter through shared memory so its writes
// coalesce, and fuse K5a's key search into K5b's first histogram.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// --- K4 ---

constexpr int UNPACK_THREADS = 256;

__device__ __forceinline__ void expand_word(uint32_t w, uint32_t& a,
                                            uint32_t& b) {
  const uint32_t lo = w & 0x0F0F0F0Fu;
  const uint32_t hi = (w >> 4) & 0x0F0F0F0Fu;
  a = __byte_perm(lo, hi, 0x5140);  // lo.b0 hi.b0 lo.b1 hi.b1
  b = __byte_perm(lo, hi, 0x7362);  // lo.b2 hi.b2 lo.b3 hi.b3
}

__global__ void __launch_bounds__(UNPACK_THREADS) unpack_nibbles_kernel(
    const uint8_t* __restrict__ in, int8_t* __restrict__ out, long long m,
    int vec) {
  const long long s =
      ((long long)blockIdx.x * UNPACK_THREADS + threadIdx.x) * 16;
  if (s >= m) return;
  if (vec && s + 16 <= m) {
    const uint4 w = *reinterpret_cast<const uint4*>(in + s);
    uint4 a, b;
    expand_word(w.x, a.x, a.y);
    expand_word(w.y, a.z, a.w);
    expand_word(w.z, b.x, b.y);
    expand_word(w.w, b.z, b.w);
    uint4* o = reinterpret_cast<uint4*>(out + 2 * s);
    o[0] = a;
    o[1] = b;
    return;
  }
  const long long e = s + 16 < m ? s + 16 : m;
  for (long long j = s; j < e; ++j) {
    const uint8_t v = in[j];
    out[2 * j] = (int8_t)(v & 0xF);
    out[2 * j + 1] = (int8_t)(v >> 4);
  }
}

// --- the scatter shared by K5a and K5b's last pass ---

__device__ __forceinline__ int clamp_row(int key, int S) {
  return key < 0 ? 0 : (key >= S ? S - 1 : key);
}

// The reference's offset/flat scatter of sorted position j with row key.
template <typename ValT>
__device__ __forceinline__ void scatter_slot(
    int j, int key, int col, ValT val, const int* __restrict__ starts,
    const int* __restrict__ seg_base, int S, int L, long long total_slots,
    float scale, int* __restrict__ p_cols, float* __restrict__ p_vals) {
  const int r = clamp_row(key, S);
  const long long offset = (long long)j - starts[r];
  // floor division, as the reference's (offset < 0 only on a wire whose
  // offsets disagree with its keys)
  long long q = offset / L, m = offset % L;
  if (m < 0) {
    m += L;
    q -= 1;
  }
  const long long flat = ((long long)seg_base[r] + q) * L + m;
  if (flat >= 0 && flat < total_slots) {
    p_cols[flat] = col;
    p_vals[flat] = (float)val * scale;
  }
}

// --- K5a ---

constexpr int PRESORTED_THREADS = 256;
constexpr int PRESORTED_ITEMS = 4;

// the first m in [lo, S) with starts[m] > j, or S
__device__ __forceinline__ int first_above(const int* __restrict__ starts,
                                           int lo, int S, int j) {
  int hi = S;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (starts[mid] <= j) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename ColT, typename ValT>
__global__ void __launch_bounds__(PRESORTED_THREADS) pack_presorted_kernel(
    const ColT* __restrict__ cols, const ValT* __restrict__ vals,
    const int* __restrict__ starts, const int* __restrict__ seg_base, int S,
    int n, int L, long long total_slots, float scale, int* __restrict__ keys,
    int* __restrict__ p_cols, float* __restrict__ p_vals) {
  const long long base =
      (long long)blockIdx.x * PRESORTED_THREADS * PRESORTED_ITEMS +
      threadIdx.x;
  int key = -1;
#pragma unroll
  for (int t = 0; t < PRESORTED_ITEMS; ++t) {
    const long long jl = base + (long long)t * PRESORTED_THREADS;
    if (jl >= n) break;
    const int j = (int)jl;
    if (key < 0) {
      key = first_above(starts, 1, S, j) - 1;
    } else if (key + 1 < S && starts[key + 1] <= j) {
      key = first_above(starts, key + 1, S, j) - 1;
    }
    keys[j] = key;
    scatter_slot(j, key, (int)cols[j], vals[j], starts, seg_base, S, L,
                 total_slots, scale, p_cols, p_vals);
  }
}

// --- K5b: the radix sort ---

constexpr int RADIX = 256;
constexpr int SORT_THREADS = 256;  // = RADIX: one thread per digit where needed
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int SORT_ROUNDS = 16;  // 32-element rounds per warp
constexpr int TILE = SORT_THREADS * SORT_ROUNDS;  // 4,096 elements
constexpr int WARP_SPAN = TILE / SORT_WARPS;  // 512 consecutive per warp
constexpr int SCAN_THREADS = 1024;
static_assert(SORT_THREADS == RADIX, "the scatter gives each thread one digit");

template <typename KeyT>
__device__ __forceinline__ int digit_of(KeyT k, int shift) {
  return (int)(((uint32_t)k >> shift) & (RADIX - 1));
}

// hist[d * num_tiles + t]: how many elements of tile t have digit d
template <typename KeyT>
__global__ void __launch_bounds__(SORT_THREADS) radix_hist_kernel(
    const KeyT* __restrict__ keys, int n, int shift, int num_tiles,
    int* __restrict__ hist) {
  __shared__ int h[RADIX];
  h[threadIdx.x] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * TILE;
#pragma unroll 4
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    const long long j = base + (long long)r * SORT_THREADS + threadIdx.x;
    if (j < n) atomicAdd(&h[digit_of(keys[j], shift)], 1);
  }
  __syncthreads();
  hist[(long long)threadIdx.x * num_tiles + blockIdx.x] = h[threadIdx.x];
}

// inclusive scan of one value per thread across a block of `threads`
// threads (a multiple of 32, at most 1,024); `sums` holds 32 ints
__device__ __forceinline__ int block_inclusive_scan(int v, int* sums,
                                                    int threads) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < threads / 32 ? sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    sums[lane] = s;
  }
  __syncthreads();
  const int out = x + (warp > 0 ? sums[warp - 1] : 0);
  __syncthreads();  // sums is reused by the next call
  return out;
}

// Block d scans row d of hist in place (exclusive) and writes its total.
__global__ void __launch_bounds__(SCAN_THREADS) radix_scan_rows_kernel(
    int* __restrict__ hist, int num_tiles, int* __restrict__ totals) {
  __shared__ int sums[32];
  int* row = hist + (long long)blockIdx.x * num_tiles;
  int carry = 0;
  for (int b = 0; b < num_tiles; b += SCAN_THREADS) {
    const int i = b + threadIdx.x;
    const int v = i < num_tiles ? row[i] : 0;
    const int incl = block_inclusive_scan(v, sums, SCAN_THREADS);
    if (i < num_tiles) row[i] = carry + incl - v;
    // the last thread's inclusive sum is the chunk's total
    if (threadIdx.x == SCAN_THREADS - 1) sums[0] = incl;
    __syncthreads();
    carry += sums[0];
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// One pass's stable scatter. Warp w of the block owns the tile's elements
// [w * 512, (w + 1) * 512) and ranks them in 32-element rounds, in order.
// Not FINAL: (key, col, val) go to the sorted position in the out arrays.
// FINAL: they go to the planes at that position's flat index.
template <typename KeyT, typename ValT, bool FINAL>
__global__ void __launch_bounds__(SORT_THREADS) radix_scatter_kernel(
    const KeyT* __restrict__ keys_in, const int* __restrict__ cols_in,
    const ValT* __restrict__ vals_in, int n, int shift, int num_tiles,
    const int* __restrict__ hist, const int* __restrict__ totals,
    KeyT* __restrict__ keys_out, int* __restrict__ cols_out,
    ValT* __restrict__ vals_out, const int* __restrict__ starts,
    const int* __restrict__ seg_base, int S, int L, long long total_slots,
    float scale, int* __restrict__ p_cols, float* __restrict__ p_vals) {
  __shared__ int sums[32];
  __shared__ int tile_base[RADIX];  // where digit d of this tile starts
  __shared__ int warp_count[SORT_WARPS][RADIX];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = threadIdx.x;  // one digit per thread (SORT_THREADS == RADIX)
  {
    const int tot = totals[d];
    const int below = block_inclusive_scan(tot, sums, SORT_THREADS) - tot;
    tile_base[d] = below + hist[(long long)d * num_tiles + blockIdx.x];
  }
#pragma unroll
  for (int w = 0; w < SORT_WARPS; ++w) warp_count[w][d] = 0;
  __syncthreads();

  const unsigned lt_mask = (1u << lane) - 1u;
  const long long base = (long long)blockIdx.x * TILE + warp * WARP_SPAN;
  KeyT key[SORT_ROUNDS] = {};
  int col[SORT_ROUNDS] = {};
  ValT val[SORT_ROUNDS] = {};
  int rank[SORT_ROUNDS] = {};
#pragma unroll
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    const long long j = base + r * 32 + lane;
    const bool valid = j < n;
    int dig = RADIX;  // invalid lanes group apart from every digit
    if (valid) {
      key[r] = keys_in[j];
      col[r] = cols_in[j];
      val[r] = vals_in[j];
      dig = digit_of(key[r], shift);
    }
    const unsigned peers = __match_any_sync(FULL, dig);
    const int before = valid ? warp_count[warp][dig] : 0;
    rank[r] = before + __popc(peers & lt_mask);
    __syncwarp();
    if (valid && lane == 31 - __clz(peers)) {
      warp_count[warp][dig] = before + __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  {  // per digit, the counts of the warps before each warp
    int s = 0;
#pragma unroll
    for (int w = 0; w < SORT_WARPS; ++w) {
      const int c = warp_count[w][d];
      warp_count[w][d] = s;
      s += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    const long long j = base + r * 32 + lane;
    if (j >= n) continue;
    const int dig = digit_of(key[r], shift);
    const int pos = tile_base[dig] + warp_count[warp][dig] + rank[r];
    if (FINAL) {
      scatter_slot(pos, (int)key[r], col[r], val[r], starts, seg_base, S, L,
                   total_slots, scale, p_cols, p_vals);
    } else {
      keys_out[pos] = key[r];
      cols_out[pos] = col[r];
      vals_out[pos] = val[r];
    }
  }
}

template <typename ColT, typename ValT>
cudaError_t launch_presorted(const void* cols, const void* vals,
                             const int* starts, const int* seg_base, int S,
                             int n, int L, long long total_slots, float scale,
                             int* keys, int* p_cols, float* p_vals,
                             cudaStream_t stream) {
  const long long per_block = (long long)PRESORTED_THREADS * PRESORTED_ITEMS;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  pack_presorted_kernel<ColT, ValT><<<blocks, PRESORTED_THREADS, 0, stream>>>(
      static_cast<const ColT*>(cols), static_cast<const ValT*>(vals), starts,
      seg_base, S, n, L, total_slots, scale, keys, p_cols, p_vals);
  return cudaGetLastError();
}

template <typename KeyT, typename ValT>
cudaError_t launch_scatter(const void* keys, const int* cols, const void* vals,
                           const int* starts, const int* seg_base, int S,
                           int n, int L, long long total_slots, float scale,
                           int passes, void* keys_tmp, int* cols_tmp,
                           void* vals_tmp, int* hist, int* p_cols,
                           float* p_vals, cudaStream_t stream) {
  const int num_tiles = (n + TILE - 1) / TILE;
  int* totals = hist + (long long)RADIX * num_tiles;
  // ping-pong between the two halves of the scratch arrays
  const KeyT* k_in = static_cast<const KeyT*>(keys);
  const int* c_in = cols;
  const ValT* v_in = static_cast<const ValT*>(vals);
  KeyT* k_tmp = static_cast<KeyT*>(keys_tmp);
  ValT* v_tmp = static_cast<ValT*>(vals_tmp);
  for (int p = 0; p < passes; ++p) {
    const int shift = 8 * p;
    radix_hist_kernel<KeyT><<<num_tiles, SORT_THREADS, 0, stream>>>(
        k_in, n, shift, num_tiles, hist);
    radix_scan_rows_kernel<<<RADIX, SCAN_THREADS, 0, stream>>>(hist, num_tiles,
                                                               totals);
    if (p + 1 == passes) {
      radix_scatter_kernel<KeyT, ValT, true>
          <<<num_tiles, SORT_THREADS, 0, stream>>>(
              k_in, c_in, v_in, n, shift, num_tiles, hist, totals, nullptr,
              nullptr, nullptr, starts, seg_base, S, L, total_slots, scale,
              p_cols, p_vals);
    } else {
      const long long half = (long long)(p % 2) * n;
      KeyT* k_out = k_tmp + half;
      int* c_out = cols_tmp + half;
      ValT* v_out = v_tmp + half;
      radix_scatter_kernel<KeyT, ValT, false>
          <<<num_tiles, SORT_THREADS, 0, stream>>>(
              k_in, c_in, v_in, n, shift, num_tiles, hist, totals, k_out,
              c_out, v_out, starts, seg_base, S, L, total_slots, scale,
              nullptr, nullptr);
      k_in = k_out;
      c_in = c_out;
      v_in = v_out;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Each function launches on `stream` and returns cudaGetLastError(). The
// caller checks shapes, dtypes, devices and contiguity.

// K4: packed uint8 [m] -> out int8 [2m].
int unpack_nibbles_u8(const uint8_t* in, int8_t* out, long long m,
                      cudaStream_t stream) {
  const int vec = ((uintptr_t)in % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const long long groups = (m + 15) / 16;
  const unsigned blocks =
      (unsigned)((groups + UNPACK_THREADS - 1) / UNPACK_THREADS);
  unpack_nibbles_kernel<<<blocks, UNPACK_THREADS, 0, stream>>>(in, out, m,
                                                               vec);
  return (int)cudaGetLastError();
}

// K5a: cols [n] uint16 (cols_i32 = 0) or int32, vals [n] int8 (vals_f32 =
// 0) or float32, starts/seg_base [S] int32 -> keys [n] int32 and the
// zeroed-then-scattered planes p_cols/p_vals [total_slots]. n >= 1, S >= 1.
int pack_presorted(const void* cols, int cols_i32, const void* vals,
                   int vals_f32, const int* starts, const int* seg_base,
                   int S, int n, int L, long long total_slots, float scale,
                   int* keys, int* p_cols, float* p_vals,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaMemsetAsync(p_cols, 0, total_slots * sizeof(int), stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(p_vals, 0, total_slots * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  if (cols_i32) {
    if (vals_f32)
      return (int)launch_presorted<int, float>(cols, vals, starts, seg_base, S,
                                               n, L, total_slots, scale, keys,
                                               p_cols, p_vals, stream);
    return (int)launch_presorted<int, int8_t>(cols, vals, starts, seg_base, S,
                                              n, L, total_slots, scale, keys,
                                              p_cols, p_vals, stream);
  }
  if (vals_f32)
    return (int)launch_presorted<uint16_t, float>(cols, vals, starts, seg_base,
                                                  S, n, L, total_slots, scale,
                                                  keys, p_cols, p_vals, stream);
  return (int)launch_presorted<uint16_t, int8_t>(cols, vals, starts, seg_base,
                                                 S, n, L, total_slots, scale,
                                                 keys, p_cols, p_vals, stream);
}

// K5b: keys [n] uint16 (keys_i32 = 0) or int32, every key below 2^(8 ·
// passes); cols [n] int32; vals [n] int8 or float32. Scratch: keys_tmp,
// cols_tmp, vals_tmp of 2n elements each of their types when passes >= 3,
// n when passes == 2, unused when 1; hist of 256 · ⌈n / 4096⌉ + 256 ints.
int scatter_pack(const void* keys, int keys_i32, const int* cols,
                 const void* vals, int vals_f32, const int* starts,
                 const int* seg_base, int S, int n, int L,
                 long long total_slots, float scale, int passes,
                 void* keys_tmp, int* cols_tmp, void* vals_tmp, int* hist,
                 int* p_cols, float* p_vals, cudaStream_t stream) {
  cudaError_t err =
      cudaMemsetAsync(p_cols, 0, total_slots * sizeof(int), stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(p_vals, 0, total_slots * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  if (keys_i32) {
    if (vals_f32)
      return (int)launch_scatter<int, float>(
          keys, cols, vals, starts, seg_base, S, n, L, total_slots, scale,
          passes, keys_tmp, cols_tmp, vals_tmp, hist, p_cols, p_vals, stream);
    return (int)launch_scatter<int, int8_t>(
        keys, cols, vals, starts, seg_base, S, n, L, total_slots, scale,
        passes, keys_tmp, cols_tmp, vals_tmp, hist, p_cols, p_vals, stream);
  }
  if (vals_f32)
    return (int)launch_scatter<uint16_t, float>(
        keys, cols, vals, starts, seg_base, S, n, L, total_slots, scale,
        passes, keys_tmp, cols_tmp, vals_tmp, hist, p_cols, p_vals, stream);
  return (int)launch_scatter<uint16_t, int8_t>(
      keys, cols, vals, starts, seg_base, S, n, L, total_slots, scale, passes,
      keys_tmp, cols_tmp, vals_tmp, hist, p_cols, p_vals, stream);
}

const char* device_pack_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
