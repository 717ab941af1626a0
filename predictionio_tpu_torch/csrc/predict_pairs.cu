// K7: rating prediction for (user, item) pairs — the hand-written Hopper
// kernel that replaces the reference's jitted program
// predictionio_tpu/ops/als.py:2330 _predict_pairs.
//
// What it computes. out[p] = Σ_c X[u[p], c] · Y[i[p], c] for P pairs;
// X [n_users, k], Y [n_items, k] f32 row-major, u and i int32.
//
// Bound on an H100 SXM. Per pair it reads two int32 ids and writes one
// float (12 bytes) and gathers two factor rows: a chunk of 1,048,576 pairs
// moves ≈12.6 MB of ids and results plus, at most once each, the factor
// matrices (17.7 MB and 3.4 MB at ML-20M, k=32), ≈10 µs at 3.35 TB/s; its
// 2·k flops per pair take ≈1 µs at 67 TFLOP/s. It is bound by bytes; the
// gathered rows repeat across pairs and stay in the 50 MB L2.
//
// Design: eight lanes per pair. When k is a multiple of 4 each lane reads
// float4 slices of both rows (a pair's 128-byte rows in one request per
// row at k=32), else single floats; each lane sums its slice in rank
// order and three xor shuffles combine the eight lanes, a fixed order, so
// a run is bit-for-bit repeatable. Products are fp32 FMAs, never TF32.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 8;  // lanes per pair
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS) predict_pairs_kernel(
    const float* __restrict__ X, const float* __restrict__ Y,
    const int* __restrict__ u, const int* __restrict__ it,
    float* __restrict__ out, long long P, int k) {
  const long long p = ((long long)blockIdx.x * THREADS + threadIdx.x) / LANES;
  const int sub = threadIdx.x & (LANES - 1);
  float s = 0.f;
  if (p < P) {
    const float* x = X + (long long)u[p] * k;
    const float* y = Y + (long long)it[p] * k;
    if ((k & 3) == 0) {
      for (int c = 4 * sub; c < k; c += 4 * LANES) {
        const float4 a = *reinterpret_cast<const float4*>(x + c);
        const float4 b = *reinterpret_cast<const float4*>(y + c);
        s = fmaf(a.x, b.x, s);
        s = fmaf(a.y, b.y, s);
        s = fmaf(a.z, b.z, s);
        s = fmaf(a.w, b.w, s);
      }
    } else {
      for (int c = sub; c < k; c += LANES) s = fmaf(x[c], y[c], s);
    }
  }
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o, LANES);
  if (p < P && sub == 0) out[p] = s;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError(). The caller checks
// shapes, dtypes, devices, contiguity, P >= 1 and that every id indexes a
// row of X or Y.
int predict_pairs_f32(const float* X, const float* Y, const int* u,
                      const int* it, float* out, long long P, int k,
                      cudaStream_t stream) {
  const long long blocks = (P * LANES + THREADS - 1) / THREADS;
  predict_pairs_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(X, Y, u, it,
                                                                  out, P, k);
  return (int)cudaGetLastError();
}

const char* predict_pairs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
