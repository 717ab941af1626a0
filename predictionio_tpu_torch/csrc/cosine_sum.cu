// K14: the sum of cosines of Similar Product's host scoring path — the
// hand-written Hopper kernel that replaces the reference's jitted
// predictionio_tpu/ops/similarity.py:63 _cosine_sum.
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
// Bound on an H100 SXM. At the Similar Product path's shape (N=26,744,
// k=32, Q=4..16) Y is 3.4 MB, ≈1.0 µs at 3.35 TB/s; 2·Q·N·k operations
// (≈27 MFLOP at Q=16, ≈0.4 µs at 67 TFLOP/s): bound by bytes, and at this
// size by the launch.
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

__global__ void __launch_bounds__(THREADS) cosine_sum_rows(
    const float* __restrict__ q, int Q, const float* __restrict__ Y, int N,
    int k, int qt, float* __restrict__ out) {
  extern __shared__ float4 qs4[];  // [qt][kp]
  float* qs = reinterpret_cast<float*>(qs4);
  const int G = row_lanes(k);
  const int kp = (k + 3) & ~3;
  const int k4 = k >> 2;
  const int grp = threadIdx.x / G;
  const int sub = threadIdx.x % G;
  const int n = blockIdx.x * (THREADS / G) + grp;
  const bool valid = n < N;
  const float* y = Y + (long long)(valid ? n : 0) * k;
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
  if (valid && sub == 0) out[n] = acc;
}

}  // namespace

extern "C" {

// out [N] = (q @ Yᵀ).sum(0) for q [Q, k] and Y [N, k] row-major; launches
// on `stream` and returns cudaGetLastError(). The caller checks shapes,
// dtypes, devices, Q >= 1, N >= 1 and 1 <= k <= SMEM_FLOATS.
int cosine_sum_f32(const float* q, int Q, const float* Y, int N, int k,
                   float* out, cudaStream_t stream) {
  const int kp = (k + 3) & ~3;
  int qt = SMEM_FLOATS / kp;
  if (qt > Q) qt = Q;
  const int rows = THREADS / row_lanes(k);
  const size_t smem = (size_t)qt * kp * sizeof(float);
  cosine_sum_rows<<<(N + rows - 1) / rows, THREADS, smem, stream>>>(
      q, Q, Y, N, k, qt, out);
  return (int)cudaGetLastError();
}

const char* cosine_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
