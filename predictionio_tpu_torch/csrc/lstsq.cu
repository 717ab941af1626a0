// K21/K22: minimum-norm least squares — the hand-written Hopper kernels
// that replace the reference's two device programs:
//   K21, predictionio_tpu/models/experimental/stock.py:325 solve_all, the
//     vmap of jnp.linalg.lstsq over N per-ticker systems [obs, F + 1];
//   K22, predictionio_tpu/models/experimental/regression.py:139, one eager
//     jnp.linalg.lstsq of a tall system [n, F].
// The function is JAX's _lstsq: with A = U·diag(s)·Vᵀ,
//   x = V·diag(mask/s)·Uᵀb,  mask = (s > 0) & (s ≥ rcond·s_max),
//   rcond = eps_f32·max(m, n),
// the minimum-norm answer when A is rank-deficient.
//
// Bound on an H100 SXM. The solve reads A and b once and writes x: at
// K22's 200,000 x 10 8.8 MB, ≈0.0026 ms at 3.35 TB/s, against ≈26 M float64
// operations for the Gram (0.0008 ms at 34 TFLOP/s); at K21's 500 x 173 x
// 5 2.1 MB. Both sit at microseconds, below a launch's overhead.
//
// Design. The card has no SVD of its own in this repository, and a small
// SVD per block is a serial algorithm, so the kernels take the normal
// equations' route in float64, which keeps JAX's answer:
//   lsq_gram_partial: a block per (system, row chunk) stages tiles of
//     [A b] rows in shared memory and accumulates its share of
//     G = [A b]ᵀ[A b] (the upper triangle, w = n + 1 columns) in float64:
//     each (pair, lane) slot is owned by one thread, which sums rows lane,
//     lane + lanes, ... of each tile; the lanes are added in lane order.
//     A tall system (K22's 200,000 rows) spreads over many blocks, not one
//     SM.
//   lsq_solve: a block per system adds its chunks' partials in chunk
//     order, then runs a cyclic Jacobi eigensolver on AᵀA = G[:n, :n] in
//     float64 (each rotation's row and column updates across the threads,
//     sweeps until the off-diagonal norm is below eps_f64 of the whole, at
//     most max_sweeps: a system still above it then reports -1 sweeps),
//     giving AᵀA = V·diag(λ)·Vᵀ and s = sqrt(λ). It applies JAX's cutoff to
//     s and forms x = V·diag(mask/λ)·Vᵀ·(Aᵀb), which equals JAX's x in
//     exact arithmetic (Uᵀb = diag(1/s)·Vᵀ·Aᵀb on the kept directions).
// Every sum has a fixed order, so every launch gives the same bits. The
// Gram squares the condition number: in float64 that loses less than
// JAX's own float32 SVD until cond(A) reaches about 1e7; past that the
// answer drifts from JAX's. The products of float32 inputs are exact in
// float64.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int GRAM_THREADS = 256;
constexpr int GRAM_TILE = 64;  // rows of [A b] staged per step
constexpr int SOLVE_THREADS = 64;
constexpr int MAX_COLS = 64;  // n at most: one solve thread per column

__device__ __forceinline__ int n_pairs(int w) { return w * (w + 1) / 2; }

__global__ void __launch_bounds__(GRAM_THREADS) lsq_gram_partial(
    const float* __restrict__ A, const float* __restrict__ b, int m, int n,
    int rows_per_chunk, int P, double* __restrict__ part) {
  extern __shared__ double smem[];
  const int w = n + 1, np_ = n_pairs(w);
  const int lanes = np_ <= GRAM_THREADS ? GRAM_THREADS / np_ : 1;
  const int slots = lanes * np_;
  double* acc = smem;                                   // [lanes][np_]
  float* tile = reinterpret_cast<float*>(acc + slots);  // [GRAM_TILE][w]
  short* pi = reinterpret_cast<short*>(tile + GRAM_TILE * w);
  short* pj = pi + np_;
  for (int p = threadIdx.x; p < np_; p += GRAM_THREADS) {
    int i = 0, rest = p;
    while (rest >= w - i) {
      rest -= w - i;
      ++i;
    }
    pi[p] = (short)i;
    pj[p] = (short)(i + rest);
  }
  for (int q = threadIdx.x; q < slots; q += GRAM_THREADS) acc[q] = 0.0;
  const long long sys = blockIdx.y;
  const int r0 = blockIdx.x * rows_per_chunk;
  const int r1 = min(m, r0 + rows_per_chunk);
  const float* As = A + sys * m * n;
  const float* bs = b + sys * m;
  for (int base = r0; base < r1; base += GRAM_TILE) {
    const int rows = min(GRAM_TILE, r1 - base);
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows * w; idx += GRAM_THREADS) {
      const int r = idx / w, c = idx - r * w;
      tile[idx] = c < n ? As[(long long)(base + r) * n + c] : bs[base + r];
    }
    __syncthreads();
    for (int q = threadIdx.x; q < slots; q += GRAM_THREADS) {
      const int p = q % np_, lane = q / np_;
      const int i = pi[p], j = pj[p];
      double s = acc[q];
      for (int r = lane; r < rows; r += lanes)
        s = fma((double)tile[r * w + i], (double)tile[r * w + j], s);
      acc[q] = s;
    }
  }
  __syncthreads();
  double* out = part + (sys * P + blockIdx.x) * np_;
  for (int p = threadIdx.x; p < np_; p += GRAM_THREADS) {
    double s = 0.0;
    for (int l = 0; l < lanes; ++l) s += acc[l * np_ + p];
    out[p] = s;
  }
}

__global__ void __launch_bounds__(SOLVE_THREADS) lsq_solve(
    const double* __restrict__ part, int m, int n, int P, float rcond,
    int max_sweeps, float* __restrict__ x, int* __restrict__ rank,
    float* __restrict__ sv, int* __restrict__ sweeps_out) {
  extern __shared__ double smem[];
  const int w = n + 1, np_ = n_pairs(w), k = threadIdx.x;
  double* S = smem;          // [n][n]: AᵀA, rotated to diag(λ)
  double* V = S + n * n;     // [n][n]: the eigenvectors, by column
  double* c = V + n * n;     // [n]: Aᵀb
  double* y = c + n;         // [n]
  double* sing = y + n;      // [n]: s = sqrt(λ)
  __shared__ int done;
  const long long sys = blockIdx.x;
  // the Gram, the chunks' partials added in chunk order
  for (int p = k; p < np_; p += SOLVE_THREADS) {
    int i = 0, rest = p;
    while (rest >= w - i) {
      rest -= w - i;
      ++i;
    }
    const int j = i + rest;
    double g = 0.0;
    for (int ch = 0; ch < P; ++ch) g += part[(sys * P + ch) * np_ + p];
    if (j < n) {
      S[i * n + j] = g;
      S[j * n + i] = g;
    } else if (i < n) {
      c[i] = g;  // column n of [A b]: Aᵀb (the corner bᵀb is unused)
    }
  }
  if (k < n)
    for (int j = 0; j < n; ++j) V[k * n + j] = (k == j) ? 1.0 : 0.0;
  __syncthreads();
  int sweep = 0;
  bool converged = false;
  for (; sweep < max_sweeps; ++sweep) {
    if (k == 0) {
      double off = 0.0, all = 0.0;
      for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j) {
          const double a2 = S[i * n + j] * S[i * n + j];
          all += a2;
          if (i != j) off += a2;
        }
      done = off <= DBL_EPSILON * DBL_EPSILON * all;
    }
    __syncthreads();
    converged = done;
    __syncthreads();  // read before thread 0 may write it again
    if (converged) break;
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        const double apq = S[p * n + q];
        if (apq == 0.0) continue;  // the same shared value for every thread
        const double app = S[p * n + p], aqq = S[q * n + q];
        const double theta = (aqq - app) / (2.0 * apq);
        const double t = fabs(theta) > 1e150
                             ? 0.5 / theta
                             : (theta >= 0.0 ? 1.0 : -1.0) /
                                   (fabs(theta) + sqrt(theta * theta + 1.0));
        const double cs = 1.0 / sqrt(t * t + 1.0), sn = t * cs;
        const double tau = sn / (1.0 + cs);
        __syncthreads();  // every thread has read S[p][q], S[p][p], S[q][q]
        if (k < n) {
          if (k != p && k != q) {
            const double g = S[k * n + p], h = S[k * n + q];
            const double gp = g - sn * (h + g * tau), hq = h + sn * (g - h * tau);
            S[k * n + p] = gp;
            S[p * n + k] = gp;
            S[k * n + q] = hq;
            S[q * n + k] = hq;
          }
          const double g = V[k * n + p], h = V[k * n + q];
          V[k * n + p] = g - sn * (h + g * tau);
          V[k * n + q] = h + sn * (g - h * tau);
        }
        if (k == 0) {
          S[p * n + p] = app - t * apq;
          S[q * n + q] = aqq + t * apq;
          S[p * n + q] = 0.0;
          S[q * n + p] = 0.0;
        }
        __syncthreads();
      }
    }
  }
  // the singular values, JAX's cutoff, and the projection onto V
  if (k < n) sing[k] = sqrt(fmax(S[k * n + k], 0.0));
  __syncthreads();
  double smax = 0.0;
  for (int i = 0; i < n; ++i) smax = fmax(smax, sing[i]);
  const double cut = (double)rcond * smax;
  if (k < n) {
    const bool keep = sing[k] > 0.0 && sing[k] >= cut;
    double proj = 0.0;
    for (int i = 0; i < n; ++i) proj += V[i * n + k] * c[i];
    y[k] = keep ? proj / S[k * n + k] : 0.0;
  }
  __syncthreads();
  if (k < n) {
    double xk = 0.0;
    for (int i = 0; i < n; ++i) xk += V[k * n + i] * y[i];
    x[sys * n + k] = __double2float_rn(xk);
  }
  if (k == 0) {
    // rank, and the min(m, n) largest singular values in descending order
    int r = 0;
    for (int i = 0; i < n; ++i) r += (sing[i] > 0.0 && sing[i] >= cut);
    rank[sys] = r;
    sweeps_out[sys] = converged ? sweep : -1;
    const int ns = min(m, n);
    for (int o = 0; o < ns; ++o) {
      int best = -1;
      for (int i = 0; i < n; ++i)
        if (sing[i] >= 0.0 && (best < 0 || sing[i] > sing[best])) best = i;
      sv[sys * ns + o] = __double2float_rn(sing[best]);
      sing[best] = -1.0;  // taken
    }
  }
}

}  // namespace

extern "C" {

// The shared-memory bytes of the two kernels for n columns.
static size_t gram_smem(int n) {
  const int w = n + 1, np_ = w * (w + 1) / 2;
  const int lanes = np_ <= GRAM_THREADS ? GRAM_THREADS / np_ : 1;
  return (size_t)lanes * np_ * sizeof(double) + (size_t)GRAM_TILE * w * sizeof(float) +
         2 * (size_t)np_ * sizeof(short);
}

static size_t solve_smem(int n) {
  return (2 * (size_t)n * n + 3 * (size_t)n) * sizeof(double);
}

// K21/K22 on `stream`: x [N, n] float32, rank [N] int32, sv [N, min(m, n)]
// float32 (descending) and sweeps [N] int32 (the Jacobi sweeps each
// system took, -1 where it had not converged after max_sweeps) of the N
// systems A [N, m, n], b [N, m] float32, with JAX's cutoff `rcond`. The plan (P row chunks of rows_per_chunk rows) comes
// from the caller, as does the partials' scratch part [N, P, (n+1)(n+2)/2]
// float64. Returns cudaGetLastError().
int lsq_f32(const float* A, const float* b, int N, int m, int n, int P,
            int rows_per_chunk, float rcond, int max_sweeps, double* part, float* x,
            int* rank, float* sv, int* sweeps, cudaStream_t stream) {
  if (N < 1 || m < 1 || n < 1 || n > MAX_COLS || P < 1 || rows_per_chunk < 1 ||
      max_sweeps < 1 ||
      (long long)P * rows_per_chunk < m || N > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t g_smem = gram_smem(n), s_smem = solve_smem(n);
  cudaError_t err;
  if (g_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lsq_gram_partial,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g_smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (s_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lsq_solve, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)s_smem);
    if (err != cudaSuccess) return (int)err;
  }
  lsq_gram_partial<<<dim3(P, N), GRAM_THREADS, g_smem, stream>>>(A, b, m, n,
                                                                rows_per_chunk, P, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lsq_solve<<<N, SOLVE_THREADS, s_smem, stream>>>(part, m, n, P, rcond, max_sweeps, x,
                                                 rank, sv, sweeps);
  return (int)cudaGetLastError();
}

const char* lstsq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
