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
// later work). Both passes are shared with the retriever's masked top-n
// (csrc/masked_topn.cu): the tile pass in tile_topm.cuh, which K3 runs in
// its f32 form with no mask and no epilogue flags, the selection (the warp
// extraction of a tile's best m and the merge pass) in topn_select.cuh:
//   pass 1 (masked_tile_topm<PREC_F32>): one block of WARPS warps per
//     (item tile of TILE rows, group of WARPS query rows); warp w serves
//     query row w of the group. Y's tile is staged through shared memory
//     KC rank columns at a time with coalesced loads, so each Y byte is
//     read from device memory
//     once per query group, not once per query row. Each lane scores
//     PER_LANE items of the tile for its warp's row (float4 reads of the
//     staged rows, the query element broadcast by shuffle), sorts them in
//     registers, and the warp then takes the tile's best m = min(n, TILE)
//     one by one: a butterfly finds the best lane head, that lane steps to
//     its next entry (for m > 32 the warp sorts the whole tile by a bitonic
//     network instead). No block barrier is needed after scoring. The output
//     is the tile's sorted candidate list; the [B,N] score matrix is never
//     written to device memory. Any global top-n item is inside its own
//     tile's top-m, so nothing is lost.
//   pass 2 (merge_lists): one block per query row merges the sorted
//     candidate lists pairwise, round by round (merge path: each output
//     position finds its split by binary search), keeping the first
//     min(n, 2·len) of every merged pair, until one list is left, and
//     writes the packed row. The rounds run in shared memory when the
//     row's lists fit there; else groups of lists first merge in shared
//     memory, a block per group, in levels (the grid then covers pow2(tiles)
//     tiles, the padding ones writing sentinel lists). Lists are padded
//     with (-inf, INT_MAX) sentinels, which sort after every real item, so
//     tiles shorter than m (the ragged last tile) need no special case.
// Correct for every 1 <= n <= N, any N (not only multiples of TILE), any
// k, and exact ties.
//
// K3c: the chained passes that replace the reference's timing program
// predictionio_tpu/ops/als.py:2382 _topn_packed_chain (called by
// ServingFactors.measure_compute_ms, :2517): n_iters K3 passes back to back
// on one stream from one host call, pass i on the query q + float32(i) ·
// float32(1e-7), the last pass's packed rows left in `out`. The offset is
// formed on the host as a float32 product (one rounding, as the reference's
// two float32 operations give it) and added to each query element as the
// tile pass loads it, with __fadd_rn, so nvcc cannot contract it into an
// FMA: pass i equals K3 on that offset query bit for bit. Its bound per
// pass is K3's.
//
// K3s: K3 over a shard table, the mesh serving path's one launch per
// distinct device (ServingFactors(mesh), ops/als.py). The device's shards'
// query rows lie back to back in one upload, shard s from row row0_s; the
// tile pass runs over the whole upload unchanged, and the merge pass writes
// query row b of shard s into row out0_s + (b - row0_s) of the result, so
// a device's shards fill their blocks of one result in one launch, in any
// order and with gaps (the first device of an interleaved mesh). K3 reduces
// a row in one fixed order whatever the batch and the row's position, so
// each row is K3's on the whole batch bit for bit. The table (at most
// MAX_SHARDS shards) goes by value in the merge kernel's parameters, in two
// sizes (8, 64), and K3c takes it too. The entry point makes the device
// current for its launches and restores it after (a no-op where it is
// current), so the wrapper spends no host time on a device context.

#include "tile_topm.cuh"

using namespace topn_select;

namespace {

constexpr int MAX_SHARDS = 64;

// K3s's map from a query row of the upload to its row of the result: the
// shard whose rows start at or before the row, the last such (an empty
// shard starts where the next does, which wins). Unrolled over M, so the
// table is read at fixed offsets of the parameters.
template <int M>
struct ShardRows {
  int row0[M];
  int out0[M];
  int n;
  __device__ __forceinline__ long long operator()(long long row) const {
    int r0 = row0[0], o0 = out0[0];
#pragma unroll
    for (int i = 1; i < M; ++i)
      if (i < n && row >= row0[i]) {
        r0 = row0[i];
        o0 = out0[i];
      }
    return (long long)o0 + (row - r0);
  }
};

// n_iters == 0: one K3 pass; else K3c's n_iters passes, pass i on
// q + float32(i) · float32(1e-7). The merge writes query row b into rows(b).
template <class Rows>
cudaError_t passes(const float* q, const float* Y, float* out, float* scratch,
                   int B, int N, int k, int n, int n_iters, cudaStream_t stream,
                   const Rows& rows) {
  const long long stride = list_stride_of(N, n);
  const int m = n < TILE ? n : TILE;
  float* s0 = scratch;
  int* i0 = reinterpret_cast<int*>(scratch + (long long)B * stride);
  dim3 grid1(tile_blocks(N, n), (B + WARPS - 1) / WARPS);
  const int count = n_iters < 1 ? 1 : n_iters;
  for (int i = 0; i < count; ++i) {
    if (n_iters < 1) {
      masked_tile_topm<PREC_F32><<<grid1, THREADS, 0, stream>>>(
          q, Y, nullptr, nullptr, nullptr, 0, s0, i0, B, N, k, m, stride, 0, 0, 0.f);
    } else {
      const float off = (float)i * 1e-7f;  // float32(i) · float32(1e-7)
      masked_tile_topm<PREC_F32, true><<<grid1, THREADS, 0, stream>>>(
          q, Y, nullptr, nullptr, nullptr, 0, s0, i0, B, N, k, m, stride, 0, 0, off);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = launch_merge(scratch, out, B, N, n, stream, 0, rows);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int M>
cudaError_t table_passes(const long long* table, const float* q, const float* Y,
                         float* out, float* scratch, int B, int N, int k, int n,
                         int n_iters, cudaStream_t stream) {
  ShardRows<M> rows;
  rows.n = (int)table[0];
  for (int s = 0; s < rows.n; ++s) {
    const long long r0 = table[1 + 2 * s], o0 = table[2 + 2 * s];
    if (r0 < (s ? rows.row0[s - 1] : 0) || r0 > B || o0 < 0 || o0 > 0x7fffffffLL ||
        (s == 0 && r0 != 0))
      return cudaErrorInvalidValue;
    rows.row0[s] = (int)r0;
    rows.out0[s] = (int)o0;
  }
  for (int s = rows.n; s < M; ++s) rows.row0[s] = rows.out0[s] = 0;
  return passes(q, Y, out, scratch, B, N, k, n, n_iters, stream, rows);
}

}  // namespace

extern "C" {

// Floats of scratch the caller allocates for topn_f32 over B query rows:
// two ping-pong candidate buffers, each a score plane and an id plane.
long long topn_scratch_floats(int B, int N, int n) {
  return scratch_floats(B, N, n);
}

// K3 (n_iters == 0) or K3c (n_iters >= 1 passes) over the B query rows of
// q on `device`'s `stream`, made current for the launches and restored
// after. table == nullptr: query row b into row b of out; else table =
// {n_shards, then per shard (row0, out0)} as 64-bit integers, the shards'
// rows back to back from row 0 (see the header). Returns the first
// cudaError_t: cudaErrorInvalidValue for a table it does not take. The
// caller checks 1 <= n <= N, B >= 1, k >= 1, dtypes, devices, contiguity,
// and that every shard's block lies inside `out`.
int topn_f32(int device, const long long* table, const float* q, const float* Y,
             float* out, float* scratch, int B, int N, int k, int n, int n_iters,
             cudaStream_t stream) {
  if (table != nullptr && (table[0] < 1 || table[0] > MAX_SHARDS))
    return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  if (table == nullptr)
    err = passes(q, Y, out, scratch, B, N, k, n, n_iters, stream, SameRows());
  else if (table[0] <= 8)
    err = table_passes<8>(table, q, Y, out, scratch, B, N, k, n, n_iters, stream);
  else
    err = table_passes<MAX_SHARDS>(table, q, Y, out, scratch, B, N, k, n, n_iters, stream);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

const char* topn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
