// K18: softmax regression by full-batch gradient descent — the
// hand-written Hopper kernels that replace the jitted `fit` of the
// reference's LogisticRegressionAlgorithm.train
// (predictionio_tpu/models/classification/engine.py:213-251: jit at :230,
// lax.scan of jax.grad at :245). From W = 0 [C, F], b = 0 [C], each of
// `iterations` steps does
//   P = softmax(X·Wᵀ + b)   (each row's maximum subtracted, as log_softmax)
//   R = (P - onehot(y)) / n
//   W -= lr·(Rᵀ·X + 2·l2·W),  b -= lr·Σ_i R[i]
// which is the gradient jax.grad forms of the template's loss
// -mean(Σ_c Y·log_softmax(X·Wᵀ + b)) + l2·ΣW², written out in closed form.
//
// Bound on an H100 SXM. The function reads X [n, F] and y [n] once and
// writes W and b; its operations are, per step, 2·n·C·F for the logits,
// 2·n·C·F for Rᵀ·X and about 6·n·C for the softmax and R. At the bench's
// shape (50,000 x 3, C = 4, 200 steps) that is ≈0.72 GFLOP, ≈0.011 ms at
// 67 TFLOP/s, above the bytes' ≈0.00024 ms; re-reading X every step, as
// these kernels do, moves 200 x 0.8 MB, ≈0.048 ms. Each step is two short
// launches, so the steps are launch-bound at this shape.
//
// Design. Two kernels a step, all steps enqueued back to back by one host
// call with no synchronisation between them:
//   sr_partial: a block per row range. It walks the range in tiles of
//     `tile` rows: the tile's rows are copied to shared memory (one
//     coalesced run of tile·F floats); thread j forms row j's logits (a
//     fused multiply-add chain in feature order, recomputed per use so no
//     per-row array is held), the row maximum, the exponentials' sum and
//     R[j][c]; then thread e owns entries e, e + blockDim, ... of the
//     block's partial [C][F + 1] (column F is Σ R) and adds the tile's rows
//     to them in row order. No two threads write one entry and no float
//     atomic is used.
//   sr_update: a thread per entry of [C][F + 1] sums the blocks' partials
//     in block order and updates W (with its 2·l2·W term) or b in place.
// Every sum has a fixed order, so a rerun gives the same bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int PARTIAL_THREADS = 128;
constexpr int UPDATE_THREADS = 256;

__device__ __forceinline__ float logit(const float* __restrict__ x,
                                       const float* __restrict__ w, int F,
                                       float bias) {
  float z = 0.f;
  for (int f = 0; f < F; ++f) z = fmaf(x[f], w[f], z);
  return z + bias;
}

__global__ void __launch_bounds__(PARTIAL_THREADS) sr_partial(
    const float* __restrict__ X, const int* __restrict__ y, long long n,
    int F, int C, long long rows_per_block, int tile,
    const float* __restrict__ W, const float* __restrict__ b,
    float* __restrict__ part) {
  extern __shared__ float sm[];
  float* xs = sm;                         // [tile][F]
  float* rs = xs + (size_t)tile * F;      // [tile][C]
  float* acc = rs + (size_t)tile * C;     // [C][F + 1]
  const int E = C * (F + 1);
  for (int e = threadIdx.x; e < E; e += blockDim.x) acc[e] = 0.f;
  const float nf = (float)n;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  for (long long t0 = r0; t0 < r1; t0 += tile) {
    const int rows = (int)min((long long)tile, r1 - t0);
    __syncthreads();  // the last tile's entries are summed before xs, rs change
    const float* src = X + t0 * F;
    for (int i = threadIdx.x; i < rows * F; i += blockDim.x) xs[i] = src[i];
    __syncthreads();
    for (int j = threadIdx.x; j < rows; j += blockDim.x) {
      const float* x = xs + (size_t)j * F;
      float m = -INFINITY;
      for (int c = 0; c < C; ++c) m = fmaxf(m, logit(x, W + (size_t)c * F, F, b[c]));
      float s = 0.f;
      for (int c = 0; c < C; ++c) s += expf(logit(x, W + (size_t)c * F, F, b[c]) - m);
      const int yj = y[t0 + j];
      for (int c = 0; c < C; ++c) {
        const float p = expf(logit(x, W + (size_t)c * F, F, b[c]) - m) / s;
        rs[(size_t)j * C + c] = (p - (c == yj ? 1.f : 0.f)) / nf;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      const int c = e / (F + 1), f = e % (F + 1);
      float a = acc[e];
      if (f < F) {
        for (int j = 0; j < rows; ++j) a = fmaf(rs[(size_t)j * C + c], xs[(size_t)j * F + f], a);
      } else {
        for (int j = 0; j < rows; ++j) a += rs[(size_t)j * C + c];
      }
      acc[e] = a;
    }
  }
  __syncthreads();
  float* out = part + (long long)blockIdx.x * E;
  for (int e = threadIdx.x; e < E; e += blockDim.x) out[e] = acc[e];
}

__global__ void __launch_bounds__(UPDATE_THREADS) sr_update(
    const float* __restrict__ part, int nblk, int C, int F, float lr,
    float l2, float* __restrict__ W, float* __restrict__ b) {
  const int E = C * (F + 1);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float g = 0.f;
  for (int k = 0; k < nblk; ++k) g += part[(long long)k * E + e];
  const int c = e / (F + 1), f = e % (F + 1);
  if (f < F) {
    float* w = W + (size_t)c * F + f;
    *w -= lr * (g + 2.f * l2 * *w);
  } else {
    b[c] -= lr * g;
  }
}

}  // namespace

extern "C" {

// K18 on `stream`: `iterations` steps of full-batch gradient descent from
// the W [C, F] and b [C] float32 given (zeros for the reference's start),
// updated in place, on X [n, F] float32 and y [n] int32 (an index outside
// [0, C) is a row of no class). The plan (nblk blocks of rows_per_block
// rows, tiles of `tile` rows) and the partials part [nblk, C·(F + 1)]
// float32 come from the caller. Returns cudaGetLastError(); no launch
// when iterations is 0.
int softmax_regression_f32(const float* X, const int* y, long long n, int F,
                           int C, float lr, float l2, int iterations,
                           int nblk, long long rows_per_block, int tile,
                           float* part, float* W, float* b,
                           cudaStream_t stream) {
  if (iterations == 0) return (int)cudaSuccess;
  if (n < 1 || F < 1 || C < 1 || nblk < 1 || tile < 1 || iterations < 0)
    return (int)cudaErrorInvalidValue;
  // the tile's rows and R, and the block's partial [C][F + 1]
  const long long smem =
      ((long long)tile * (F + C) + (long long)C * (F + 1)) * (long long)sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int E = C * (F + 1);
  const int ublocks = (E + UPDATE_THREADS - 1) / UPDATE_THREADS;
  for (int it = 0; it < iterations; ++it) {
    sr_partial<<<nblk, PARTIAL_THREADS, (size_t)smem, stream>>>(
        X, y, n, F, C, rows_per_block, tile, W, b, part);
    sr_update<<<ublocks, UPDATE_THREADS, 0, stream>>>(part, nblk, C, F, lr, l2,
                                                      W, b);
    if (it == 0) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

const char* softmax_regression_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
