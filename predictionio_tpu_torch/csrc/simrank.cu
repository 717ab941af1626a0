// K20: one SimRank iteration — the hand-written Hopper kernels that replace
// the reference's device program
// predictionio_tpu/models/experimental/friend_recommendation.py:433 run
// (the jitted fori_loop of SimRankAlgorithm.train, :432-442), whose body is
//   S' = fill_diagonal(decay · ((P S) Pᵀ), 1)
// with P the out-degree-normalised adjacency [n, n], dense there. Here P is
// its CSR (ops/simrank.py build_transition_csr: row i holds the out-edges
// of vertex i, columns ascending, weight 1/out_deg(i), duplicate edges
// merged by summing), and the step is two kernels in the reference's
// association:
//   K20a simrank_propagate: U = P S,  U[i, :] = Σ_{k ∈ O(i)} w_ik · S[k, :]
//   K20b simrank_contract:  S'[i, j] = decay · Σ_{k ∈ O(j)} w_jk · U[i, k],
//                           S'[i, i] = 1.
//
// Bound on an H100 SXM. At a Wiki-Vote-sized graph (n = 7,115, m ≈ 103,689
// edges) each kernel reads one [n, n] float32 matrix (202.5 MB) and writes
// one: 405 MB, ≈0.121 ms at 3.35 TB/s; its products are 2·m·n ≈ 1.5 GFLOP,
// ≈0.022 ms at 67 TFLOP/s. The bytes bound both. The dense form of the
// reference does 2·n³ ≈ 0.72 TFLOP a product, ≥10.7 ms each.
//
// Design, simple and correct first.
//   K20a: a block per (row i, chunk of 1,024 columns); a thread owns 4
//     columns, 256 apart, and walks row i's CSR entries in order, adding
//     w·S[k, j] with fmaf: the loads of a warp are 32 consecutive floats of
//     row k (coalesced). A vertex of high out-degree (the power-law head)
//     makes a longer walk for its own blocks only; a row with no out-edges
//     writes zeros.
//   K20b: a block per R rows of U (R = 8, 4, 2 or 1, the most whose rows
//     fit in the shared-memory budget). The block stages those R rows in
//     shared memory with coalesced loads, then a thread per column j walks
//     CSR row j (the out-edges of j) once and adds w·U[r, k] for all R rows
//     from shared memory, in CSR order; the R outputs of column j are
//     written by neighbouring threads (coalesced). The CSR (m entries)
//     stays in L2 and is read once per block. A row of U must fit in one
//     block's shared memory: n ≤ 58,112 (227 KB of float32); the wrapper
//     raises above that, and so does the launch function.
// Every sum has a fixed order (CSR order; no atomics), so every launch gives
// the same bits; the dense reference sums the same non-zero terms in
// another order, so the two agree to float32 rounding. A vertex without
// out-edges gets exactly 0 off the diagonal, in row and column.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int COLS_PER_THREAD = 4;
constexpr int COLS_PER_BLOCK = THREADS * COLS_PER_THREAD;
// the shared memory a K20b block aims to stay under when it takes more
// than one row, so that several blocks share an SM
constexpr long long ROWS_SMEM_BUDGET = 64 * 1024;

__global__ void __launch_bounds__(THREADS) simrank_propagate_kernel(
    const float* __restrict__ S, const int* __restrict__ indptr,
    const int* __restrict__ cols, const float* __restrict__ vals, int n,
    float* __restrict__ U) {
  const int i = blockIdx.x;
  const int j0 = blockIdx.y * COLS_PER_BLOCK + threadIdx.x;
  const int p0 = indptr[i], p1 = indptr[i + 1];
  float acc[COLS_PER_THREAD];
#pragma unroll
  for (int t = 0; t < COLS_PER_THREAD; ++t) acc[t] = 0.f;
  for (int p = p0; p < p1; ++p) {
    const float w = vals[p];
    const float* srow = S + (long long)cols[p] * n;
#pragma unroll
    for (int t = 0; t < COLS_PER_THREAD; ++t) {
      const int j = j0 + t * THREADS;
      if (j < n) acc[t] = fmaf(w, srow[j], acc[t]);
    }
  }
  float* urow = U + (long long)i * n;
#pragma unroll
  for (int t = 0; t < COLS_PER_THREAD; ++t) {
    const int j = j0 + t * THREADS;
    if (j < n) urow[j] = acc[t];
  }
}

template <int R>
__global__ void __launch_bounds__(THREADS) simrank_contract_kernel(
    const float* __restrict__ U, const int* __restrict__ indptr,
    const int* __restrict__ cols, const float* __restrict__ vals, int n,
    float decay, float* __restrict__ out) {
  extern __shared__ float us[];  // [R][n]
  const int i0 = blockIdx.x * R;
  const int rows = min(R, n - i0);
  for (long long e = threadIdx.x; e < (long long)rows * n; e += THREADS)
    us[e] = U[(long long)i0 * n + e];
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += THREADS) {
    const int p0 = indptr[j], p1 = indptr[j + 1];
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int p = p0; p < p1; ++p) {
      const float w = vals[p];
      const int k = cols[p];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rows) acc[r] = fmaf(w, us[r * n + k], acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows) {
        const int i = i0 + r;
        out[(long long)i * n + j] = i == j ? 1.f : decay * acc[r];
      }
    }
  }
}

// Rows of U one K20b block takes at n vertices, given the card's opt-in
// shared memory per block; 0 when one row does not fit.
int contract_rows(int n, int smem_optin) {
  const long long row = 4LL * n;
  if (row > smem_optin) return 0;
  for (int R = 8; R > 1; R >>= 1)
    if (R * row <= ROWS_SMEM_BUDGET && R * row <= smem_optin) return R;
  return 1;
}

template <int R>
cudaError_t launch_contract(const float* U, const int* indptr, const int* cols,
                            const float* vals, int n, float decay, float* out,
                            cudaStream_t stream) {
  const size_t smem = (size_t)R * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      simrank_contract_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  simrank_contract_kernel<R><<<(n + R - 1) / R, THREADS, smem, stream>>>(
      U, indptr, cols, vals, n, decay, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K20a on `stream`: U [n, n] = P S for S [n, n] float32 row-major and P's
// CSR (indptr [n + 1], cols [m] int32, vals [m] float32). Returns
// cudaGetLastError(); no launch when n is 0.
int simrank_propagate_f32(const float* S, const int* indptr, const int* cols,
                          const float* vals, int n, float* U,
                          cudaStream_t stream) {
  if (n == 0) return (int)cudaSuccess;
  if (n < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(n, (n + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK);
  simrank_propagate_kernel<<<grid, THREADS, 0, stream>>>(S, indptr, cols, vals,
                                                        n, U);
  return (int)cudaGetLastError();
}

// K20b on `stream`: out [n, n] = decay · U Pᵀ with the diagonal set to 1.
// Returns cudaErrorInvalidValue, launching nothing, when a row of U does
// not fit in one block's shared memory; no launch when n is 0.
int simrank_contract_f32(const float* U, const int* indptr, const int* cols,
                         const float* vals, int n, float decay, float* out,
                         cudaStream_t stream) {
  if (n == 0) return (int)cudaSuccess;
  if (n < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  switch (contract_rows(n, optin)) {
    case 8: return (int)launch_contract<8>(U, indptr, cols, vals, n, decay, out, stream);
    case 4: return (int)launch_contract<4>(U, indptr, cols, vals, n, decay, out, stream);
    case 2: return (int)launch_contract<2>(U, indptr, cols, vals, n, decay, out, stream);
    case 1: return (int)launch_contract<1>(U, indptr, cols, vals, n, decay, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* simrank_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
