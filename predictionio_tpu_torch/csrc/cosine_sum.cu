// K14: the sum of cosines of Similar Product's host scoring path — the
// hand-written Hopper kernel that replaces the reference's jitted
// predictionio_tpu/ops/similarity.py:63 _cosine_sum, and, over a shard
// table, its row-sharded form K14s (:84-90, :118-120).
//
// What it computes. out[n] = Σ_q q_q · y_n over Q query rows q [Q, k] and
// the N catalog rows Y [N, k], both L2-normalized by the caller, so each
// product is a cosine: the reference's (q @ Yᵀ).sum(0). The products are
// summed without forming Σ_q q first (the twin's function); the kernel's
// order: each lane sums its share of the row's entries over the queries
// in query order, then a fixed butterfly adds the lanes. So the only
// difference from the twin is the order of the sums. Zero query rows (the
// pow2 padding) add exact zeros.
//
// The shard table. One launch covers every shard of one device: shard s
// gives its rows Y_s [rows_s, k] and the offset out0_s of its block of the
// result, out[out0_s + r] = Σ_q q_q · Y_s[r]. blockIdx.x walks the
// shards' row blocks one after another (shard s starts at block block0_s,
// the prefix of the earlier shards' blocks), and each row's arithmetic
// does not depend on its shard or its block, so a row's sum is the same
// bits in every table it is part of: K14s equals K14 bit for bit. The
// single-device K14 is a table of one shard. A table holds at most
// MAX_SHARDS shards; it is passed by value in the kernel's parameters, in
// three sizes (1, 8, 64) so a small table costs the launch little.
//
// Bound on an H100 SXM. At the Similar Product path's shape (N=26,744,
// k=32, Q=4..16) Y is 3.4 MB, ≈1.0 µs at 3.35 TB/s; 2·Q·N·k operations
// (≈27 MFLOP at Q=16, ≈0.4 µs at 67 TFLOP/s): bound by bytes, and at this
// size by the launch and the host's call, which is why a device's shards
// share one launch and the entry point switches to the table's device
// itself (a no-op where it is current) and takes the table as one pointer.
//
// Design: G lanes per catalog row (G = 8 at k = 32, the smallest power of
// two with 4·G >= k), 256 / G rows a block. Each lane reads its float4s of
// the row (a warp reads 4 whole rows per load at k = 32, coalesced) and
// keeps them in registers when one float4 each suffices. The query rows go
// to shared memory in tiles that fit 48 KB. No atomics: a run repeats bit
// for bit.

#include <cuda_runtime.h>

#include "tiling.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_FLOATS = 48 * 1024 / 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SHARDS = 64;

struct Shard {
  const float* Y;
  long long rows;
  long long out0;
  long long block0;  // the shard's first block of the grid
};

template <int M>
struct Shards {
  Shard s[M];
  int n;
};

template <int M>
__global__ void __launch_bounds__(THREADS) cosine_sum_rows(
    const float* __restrict__ q, int Q, int k, int qt, const Shards<M> t,
    float* __restrict__ out) {
  extern __shared__ float4 qs4[];  // [qt][kp]
  float* qs = reinterpret_cast<float*>(qs4);
  // the block's shard: the last whose first block is at most this one (an
  // empty shard shares its first block with the next, which wins)
  const long long bid = blockIdx.x;
  Shard sh = t.s[0];
#pragma unroll
  for (int i = 1; i < M; ++i)
    if (i < t.n && bid >= t.s[i].block0) sh = t.s[i];
  const int G = row_lanes(k);
  const int kp = (k + 3) & ~3;
  const int k4 = k >> 2;
  const int grp = threadIdx.x / G;
  const int sub = threadIdx.x % G;
  const long long n = (bid - sh.block0) * (THREADS / G) + grp;
  const bool valid = n < sh.rows;
  const float* y = sh.Y + (valid ? n : 0) * k;
  const bool vec = (k & 3) == 0;
  const bool one = vec && k4 <= G;  // at most one float4 of the row a lane
  float4 y1 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (one && valid && sub < k4) y1 = __ldg(reinterpret_cast<const float4*>(y) + sub);
  float acc = 0.f;
  for (int q0 = 0; q0 < Q; q0 += qt) {
    const int c = min(qt, Q - q0);
    __syncthreads();  // the previous tile's readers are done
    for (int e = threadIdx.x; e < c * kp; e += THREADS) {
      const int r = e / kp;
      const int col = e - r * kp;
      qs[e] = col < k ? q[(long long)(q0 + r) * k + col] : 0.f;
    }
    __syncthreads();
    if (!valid) continue;
    for (int qi = 0; qi < c; ++qi) {
      const float* qr = qs + qi * kp;
      if (one) {
        if (sub < k4) {
          const float4 a = reinterpret_cast<const float4*>(qr)[sub];
          acc = fmaf(a.x, y1.x, acc);
          acc = fmaf(a.y, y1.y, acc);
          acc = fmaf(a.z, y1.z, acc);
          acc = fmaf(a.w, y1.w, acc);
        }
      } else if (vec) {
        for (int cc = sub; cc < k4; cc += G) {
          const float4 a = reinterpret_cast<const float4*>(qr)[cc];
          const float4 b = __ldg(reinterpret_cast<const float4*>(y) + cc);
          acc = fmaf(a.x, b.x, acc);
          acc = fmaf(a.y, b.y, acc);
          acc = fmaf(a.z, b.z, acc);
          acc = fmaf(a.w, b.w, acc);
        }
      } else {
        for (int j = sub; j < k; j += G) acc = fmaf(qr[j], __ldg(y + j), acc);
      }
    }
  }
  for (int o = G >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
  if (valid && sub == 0) out[sh.out0 + n] = acc;
}

template <int M>
cudaError_t launch(const long long* table, int n_shards, const float* q, int Q,
                   int k, float* out, cudaStream_t stream) {
  Shards<M> t;
  t.n = n_shards;
  const int rows_per_block = THREADS / row_lanes(k);
  long long blocks = 0;
  for (int s = 0; s < n_shards; ++s) {
    const long long* e = table + 3 + 3 * s;
    if (e[1] < 0 || e[2] < 0) return cudaErrorInvalidValue;
    t.s[s].Y = reinterpret_cast<const float*>(e[0]);
    t.s[s].rows = e[1];
    t.s[s].out0 = e[2];
    t.s[s].block0 = blocks;
    blocks += (e[1] + rows_per_block - 1) / rows_per_block;
  }
  if (blocks == 0) return cudaSuccess;  // every shard empty: nothing to write
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int kp = (k + 3) & ~3;
  int qt = SMEM_FLOATS / kp;
  if (qt > Q) qt = Q;
  const size_t smem = (size_t)qt * kp * sizeof(float);
  cosine_sum_rows<M><<<(unsigned)blocks, THREADS, smem, stream>>>(q, Q, k, qt, t, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K14 over a shard table on `stream`: table = {device, k, n_shards, then
// per shard (Y, rows, out0)} as 64-bit integers (Y a row-major [rows, k]
// float32 pointer), q [Q, k] row-major; writes out[out0 + r] for every row
// r of every shard, in one launch on `device` (made current for the launch
// and restored after). Returns a cudaError_t: cudaErrorInvalidValue for a
// table it does not take. The caller checks dtypes, devices and that the
// shards' blocks of `out` lie inside it.
int cosine_sum_f32(const long long* table, const float* q, int Q, float* out,
                   cudaStream_t stream) {
  const int device = (int)table[0], k = (int)table[1], n = (int)table[2];
  if (n < 1 || n > MAX_SHARDS || k < 1 || k > SMEM_FLOATS || Q < 1)
    return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  if (n == 1)
    err = launch<1>(table, n, q, Q, k, out, stream);
  else if (n <= 8)
    err = launch<8>(table, n, q, Q, k, out, stream);
  else
    err = launch<MAX_SHARDS>(table, n, q, Q, k, out, stream);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

const char* cosine_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
