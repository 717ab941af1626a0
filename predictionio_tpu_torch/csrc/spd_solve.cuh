// K2's kernels (csrc/spd_solve.cu says what they compute, their bound and
// their design), with a variant axis over blockIdx.y: V sets of R systems,
// each variant with its own λ row and G, sharing has_obs, each solved by
// exactly K2's arithmetic. spd_solve.cu launches them with V = 1; grid.cu's
// K13b (the regularizer grid) with V variants. launch() takes the form by
// k: spd_solve_small<8> (k <= 8, four systems a warp), spd_solve_small<16>
// (k <= 16, two), spd_solve_rows32 (k <= 32), spd_solve_rows (above);
// ops/spd_solve.py solve_form(k) names the same choice.
#pragma once

#include <cuda_runtime.h>

namespace k2 {

constexpr int MAX_WARPS = 8;
constexpr int SYSTEMS = 8;  // systems a block for k <= 32 (8 warps of rows32)
constexpr int REDUCE_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t DEFAULT_SMEM = 48 * 1024;
constexpr size_t MAX_SMEM = 227 * 1024;

__host__ __device__ inline int per_warp_floats(int k) { return k * (k + 1) + 3 * k; }

// Systems a block (k <= 32) or warps a block (one system each, above).
inline int warps_for(int k) {
  if (k <= 32) return SYSTEMS;  // spd_solve_small, spd_solve_rows32
  const size_t bytes = (size_t)per_warp_floats(k) * sizeof(float);
  int w = (int)(DEFAULT_SMEM / bytes);
  if (w > MAX_WARPS) w = MAX_WARPS;
  return w < 1 ? 1 : w;
}

// The telemetry epilogue of both solve kernels: a butterfly over the
// warp, then thread 0 sums the block's warps in order.
__device__ __forceinline__ void block_partials(float dsq, float xsq,
                                               float* red, int W,
                                               float* partials) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    dsq += __shfl_xor_sync(FULL, dsq, o);
    xsq += __shfl_xor_sync(FULL, xsq, o);
  }
  if (lane == 0) {
    red[2 * warp] = dsq;
    red[2 * warp + 1] = xsq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s0 = 0.f, s1 = 0.f;
    for (int w = 0; w < W; ++w) {
      s0 += red[2 * w];
      s1 += red[2 * w + 1];
    }
    partials[2 * blockIdx.x] = s0;
    partials[2 * blockIdx.x + 1] = s1;
  }
}

__global__ void spd_solve_rows(const float* __restrict__ A,
                               const float* __restrict__ G,
                               const float* __restrict__ b,
                               const float* __restrict__ lam,
                               const unsigned char* __restrict__ has_obs,
                               const float* __restrict__ X_prev,
                               float* __restrict__ X,
                               float* __restrict__ partials, int R, int k,
                               int W, long long ldr) {
  extern __shared__ float smem[];
  // variant blockIdx.y: its systems, λ, G, X_prev and X (λ, X_prev and X
  // ldr rows apart: a row shard's rows of the whole arrays); has_obs shared
  const long long var = blockIdx.y;
  A += var * R * k * k;
  b += var * R * k;
  lam += var * ldr;
  X_prev += var * ldr * k;
  X += var * ldr * k;
  if (G != nullptr) G += var * k * k;
  const int kp = k + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sA = smem + warp * per_warp_floats(k);  // [k][k+1]
  float* sy = sA + k * kp;                       // rhs, then y
  float* sd = sy + k;                            // 1 / L_jj
  float* sx = sd + k;                            // solution
  float* red = smem + W * per_warp_floats(k);    // [2 * W]
  const long long row = (long long)blockIdx.x * W + warp;
  float dsq = 0.f, xsq = 0.f;

  if (row < R) {
    const float* xp = X_prev + row * k;
    float* xo = X + row * k;
    if (has_obs[row]) {
      const float* a = A + row * k * k;
      const float lr = lam[row];
      for (int e = lane; e < k * k; e += 32) {
        const int i = e / k;
        const int j = e - i * k;
        float v = a[e];
        if (G != nullptr) v += G[e];
        sA[i * kp + j] = i == j ? v + lr : v;
      }
      for (int i = lane; i < k; i += 32) sy[i] = b[row * k + i];
      __syncwarp();
      // Cholesky with the forward substitution fused
      for (int j = 0; j < k; ++j) {
        const float d = rsqrtf(sA[j * kp + j]);
        const float yj = sy[j] * d;
        for (int i = j + 1 + lane; i < k; i += 32) sA[i * kp + j] *= d;
        __syncwarp();
        if (lane == 0) {
          sy[j] = yj;
          sd[j] = d;
        }
        for (int i = j + 1 + lane; i < k; i += 32) {
          const float ci = sA[i * kp + j];
          sy[i] = fmaf(-ci, yj, sy[i]);
          for (int l = j + 1; l <= i; ++l) {
            sA[i * kp + l] = fmaf(-ci, sA[l * kp + j], sA[i * kp + l]);
          }
        }
        __syncwarp();
      }
      // back substitution, column by column
      for (int j = k - 1; j >= 0; --j) {
        const float xj = sy[j] * sd[j];
        if (lane == 0) sx[j] = xj;
        for (int i = lane; i < j; i += 32) sy[i] = fmaf(-sA[j * kp + i], xj, sy[i]);
        __syncwarp();
      }
      for (int i = lane; i < k; i += 32) {
        const float x = sx[i];
        const float dl = x - xp[i];
        xo[i] = x;
        dsq = fmaf(dl, dl, dsq);
        xsq = fmaf(x, x, xsq);
      }
    } else {
      for (int i = lane; i < k; i += 32) {
        const float x = xp[i];
        xo[i] = x;
        xsq = fmaf(x, x, xsq);
      }
    }
  }

  if (partials != nullptr) block_partials(dsq, xsq, red, W, partials);
}

template <bool HAS_G>
__global__ void __launch_bounds__(32 * MAX_WARPS) spd_solve_rows32(
    const float* __restrict__ A, const float* __restrict__ G,
    const float* __restrict__ b,
    const float* __restrict__ lam, const unsigned char* __restrict__ has_obs,
    const float* __restrict__ X_prev, float* __restrict__ X,
    float* __restrict__ partials, int R, int k, long long ldr) {
  __shared__ __align__(16) float sc[MAX_WARPS][32];
  // variant blockIdx.y, as in spd_solve_rows
  const long long var = blockIdx.y;
  A += var * R * k * k;
  b += var * R * k;
  lam += var * ldr;
  X_prev += var * ldr * k;
  X += var * ldr * k;
  if constexpr (HAS_G) G += var * k * k;
  __shared__ float red[2 * MAX_WARPS];
  __shared__ float sG[HAS_G ? 32 : 1][33];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * MAX_WARPS + warp;
  const bool mine = lane < k;
  float dsq = 0.f, xsq = 0.f;
  if constexpr (HAS_G) {
    for (int e = threadIdx.x; e < k * k; e += blockDim.x) sG[e / k][e % k] = G[e];
    __syncthreads();
  }

  if (row < R) {
    const float* xp = X_prev + row * k;
    float* xo = X + row * k;
    if (has_obs[row]) {
      float a[32];
      const float* arow = A + row * k * k + (long long)lane * k;
      if ((k & 3) == 0) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (mine && 4 * q < k) v = *reinterpret_cast<const float4*>(arow + 4 * q);
          a[4 * q] = v.x;
          a[4 * q + 1] = v.y;
          a[4 * q + 2] = v.z;
          a[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int l = 0; l < 32; ++l) a[l] = (mine && l < k) ? arow[l] : 0.f;
      }
      if constexpr (HAS_G) {
#pragma unroll
        for (int l = 0; l < 32; ++l) {
          if (mine && l < k) a[l] += sG[lane][l];
        }
      }
      const float lr = lam[row];
#pragma unroll
      for (int l = 0; l < 32; ++l) {
        if (l == lane) a[l] = mine ? a[l] + lr : 1.f;
      }
      float r = mine ? b[row * k + lane] : 0.f;
      float y = 0.f, dinv = 0.f;
      // Cholesky with the forward substitution fused
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float d = rsqrtf(__shfl_sync(FULL, a[j], j));
        const float yj = __shfl_sync(FULL, r, j) * d;
        const float c = a[j] * d;  // L_ij on lanes i > j
        if (lane == j) {
          y = yj;
          dinv = d;
        }
        if (lane > j) r = fmaf(-c, yj, r);
        a[j] = c;
        sc[warp][lane] = c;
        __syncwarp();
#pragma unroll
        for (int l = j + 1; l < 32; ++l) {
          if (lane >= l) a[l] = fmaf(-c, sc[warp][l], a[l]);
        }
        __syncwarp();
      }
      // back substitution, row by row
      float x = 0.f;
#pragma unroll
      for (int j = 31; j >= 0; --j) {
        float p = lane > j ? a[j] * x : 0.f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(FULL, p, o);
        if (lane == j) x = (y - p) * dinv;
      }
      if (mine) {
        const float dl = x - xp[lane];
        xo[lane] = x;
        dsq = dl * dl;
        xsq = x * x;
      }
    } else if (mine) {
      const float x = xp[lane];
      xo[lane] = x;
      xsq = x * x;
    }
  }
  if (partials != nullptr) block_partials(dsq, xsq, red, MAX_WARPS, partials);
}

// k <= KS, KS in {8, 16}: spd_solve_rows32 sized to the rank. A group of
// KS lanes holds one system (lane i of the group its row i, in KS
// registers, identity rows past k), so a warp holds 32 / KS systems and a
// block SYSTEMS of them, as rows32's block does. The steps are rows32's
// with KS in place of 32: KS pivot steps, shuffles of width KS, and the
// updates of columns j < l < KS. Every bit of X and of the telemetry
// partials is rows32's: rows32's padded lanes and steps add exact +0s to
// the real lanes' values (a row's entries past k stay +0, a padded lane's
// x is +0), which change no value but a −0; the one +0 rows32's butterfly
// adds across the padding (offset 16, and 8 for KS = 8, each lane's value
// + +0) is added here before the group's own butterfly, so even a −0
// sums as rows32 sums it. Each group's telemetry goes through its own
// butterfly, then thread 0 sums the block's SYSTEMS systems in row order,
// as rows32 sums its warps. Groups whose row is past R or has no
// observations solve an identity system alongside (no warp diverges
// around a shuffle) and keep X_prev as rows32 does.
template <int KS, bool HAS_G>
__global__ void __launch_bounds__(SYSTEMS * KS) spd_solve_small(
    const float* __restrict__ A, const float* __restrict__ G,
    const float* __restrict__ b,
    const float* __restrict__ lam, const unsigned char* __restrict__ has_obs,
    const float* __restrict__ X_prev, float* __restrict__ X,
    float* __restrict__ partials, int R, int k, long long ldr) {
  constexpr int SPW = 32 / KS;        // systems a warp
  constexpr int W = SYSTEMS / SPW;    // warps a block
  __shared__ __align__(16) float sc[W][32];
  // variant blockIdx.y, as in spd_solve_rows
  const long long var = blockIdx.y;
  A += var * R * k * k;
  b += var * R * k;
  lam += var * ldr;
  X_prev += var * ldr * k;
  X += var * ldr * k;
  if constexpr (HAS_G) G += var * k * k;
  __shared__ float red[2 * SYSTEMS];
  __shared__ float sG[HAS_G ? KS : 1][KS + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / KS;          // the warp's system
  const int li = lane % KS;           // the system's row held by this lane
  const int sys = warp * SPW + grp;   // the block's system, in row order
  const long long row = (long long)blockIdx.x * SYSTEMS + sys;
  const bool mine = li < k;
  const bool live = row < R;
  const bool solve = live && has_obs[row];
  float dsq = 0.f, xsq = 0.f;
  if constexpr (HAS_G) {
    for (int e = threadIdx.x; e < k * k; e += blockDim.x) sG[e / k][e % k] = G[e];
    __syncthreads();
  }

  float a[KS];
  const float* arow = A + (solve ? row : 0) * k * k + (long long)li * k;
  if ((k & 3) == 0) {
#pragma unroll
    for (int q = 0; q < KS / 4; ++q) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (solve && mine && 4 * q < k) v = *reinterpret_cast<const float4*>(arow + 4 * q);
      a[4 * q] = v.x;
      a[4 * q + 1] = v.y;
      a[4 * q + 2] = v.z;
      a[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int l = 0; l < KS; ++l) a[l] = (solve && mine && l < k) ? arow[l] : 0.f;
  }
  if constexpr (HAS_G) {
#pragma unroll
    for (int l = 0; l < KS; ++l) {
      if (solve && mine && l < k) a[l] += sG[li][l];
    }
  }
  const float lr = solve ? lam[row] : 0.f;
#pragma unroll
  for (int l = 0; l < KS; ++l) {
    if (l == li) a[l] = (solve && mine) ? a[l] + lr : 1.f;
  }
  float r = (solve && mine) ? b[row * k + li] : 0.f;
  float y = 0.f, dinv = 0.f;
  float* scg = &sc[warp][grp * KS];
  // Cholesky with the forward substitution fused
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const float d = rsqrtf(__shfl_sync(FULL, a[j], j, KS));
    const float yj = __shfl_sync(FULL, r, j, KS) * d;
    const float c = a[j] * d;  // L_ij on lanes i > j
    if (li == j) {
      y = yj;
      dinv = d;
    }
    if (li > j) r = fmaf(-c, yj, r);
    a[j] = c;
    scg[li] = c;
    __syncwarp();
#pragma unroll
    for (int l = j + 1; l < KS; ++l) {
      if (li >= l) a[l] = fmaf(-c, scg[l], a[l]);
    }
    __syncwarp();
  }
  // back substitution, row by row
  float x = 0.f;
#pragma unroll
  for (int j = KS - 1; j >= 0; --j) {
    float p = li > j ? a[j] * x : 0.f;
    p += 0.f;  // rows32's first butterfly step adds a padded lane's +0
#pragma unroll
    for (int o = KS / 2; o > 0; o >>= 1) p += __shfl_xor_sync(FULL, p, o, KS);
    if (li == j) x = (y - p) * dinv;
  }
  if (live && mine) {
    const float* xp = X_prev + row * k;
    float* xo = X + row * k;
    if (solve) {
      const float dl = x - xp[li];
      xo[li] = x;
      dsq = dl * dl;
      xsq = x * x;
    } else {
      const float xv = xp[li];
      xo[li] = xv;
      xsq = xv * xv;
    }
  }
  if (partials != nullptr) {  // each system's butterfly, then the block's systems in order
#pragma unroll
    for (int o = KS / 2; o > 0; o >>= 1) {
      dsq += __shfl_xor_sync(FULL, dsq, o, KS);
      xsq += __shfl_xor_sync(FULL, xsq, o, KS);
    }
    if (li == 0) {
      red[2 * sys] = dsq;
      red[2 * sys + 1] = xsq;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float s0 = 0.f, s1 = 0.f;
      for (int w = 0; w < SYSTEMS; ++w) {
        s0 += red[2 * w];
        s1 += red[2 * w + 1];
      }
      partials[2 * blockIdx.x] = s0;
      partials[2 * blockIdx.x + 1] = s1;
    }
  }
}

__global__ void __launch_bounds__(REDUCE_THREADS) spd_reduce(
    const float* __restrict__ partials, int n, float* __restrict__ sums) {
  __shared__ float s0[REDUCE_THREADS], s1[REDUCE_THREADS];
  const int t = threadIdx.x;
  float a = 0.f, c = 0.f;
  for (int p = t; p < n; p += REDUCE_THREADS) {
    a += partials[2 * p];
    c += partials[2 * p + 1];
  }
  s0[t] = a;
  s1[t] = c;
  __syncthreads();
  for (int o = REDUCE_THREADS / 2; o > 0; o >>= 1) {
    if (t < o) {
      s0[t] += s0[t + o];
      s1[t] += s1[t + o];
    }
    __syncthreads();
  }
  if (t == 0) {
    sums[0] = s0[0];
    sums[1] = s1[0];
  }
}

// Blocks per variant for R systems of size k (the partials buffer holds
// two floats per block).
inline int blocks_for(int R, int k) {
  const int W = warps_for(k);
  return (R + W - 1) / W;
}

// The solve of V variants' R systems each on `stream` (and, when `sums` is
// not null, which needs V = 1, the reduction of the telemetry sums, using
// `partials` of 2·blocks floats); returns cudaGetLastError(). Variant v
// reads A + v·R·k², b, X_prev + v·ldr·k, lam + v·ldr and G + v·k² (G may
// be null), writes X + v·ldr·k, and shares has_obs [R]. ldr = R but for a
// row shard of [V, ldr, ·] arrays, whose pointers then start at the
// shard's first row.
inline cudaError_t launch(const float* A, const float* G, const float* b,
                          const float* lam, const unsigned char* has_obs,
                          const float* X_prev, float* X, float* partials,
                          float* sums, int R, int k, int V, long long ldr,
                          cudaStream_t stream) {
  if (sums != nullptr && V != 1) return cudaErrorInvalidValue;
  const int W = warps_for(k);
  const dim3 grid(blocks_for(R, k), V);
  float* part = sums ? partials : nullptr;
  cudaError_t err;
  if (k <= 16) {
#define SPD_SMALL(KS)                                                         \
  if (G != nullptr) {                                                         \
    spd_solve_small<KS, true><<<grid, SYSTEMS * KS, 0, stream>>>(              \
        A, G, b, lam, has_obs, X_prev, X, part, R, k, ldr);                    \
  } else {                                                                    \
    spd_solve_small<KS, false><<<grid, SYSTEMS * KS, 0, stream>>>(             \
        A, G, b, lam, has_obs, X_prev, X, part, R, k, ldr);                    \
  }
    if (k <= 8) {
      SPD_SMALL(8)
    } else {
      SPD_SMALL(16)
    }
#undef SPD_SMALL
  } else if (k <= 32) {
    if (G != nullptr) {
      spd_solve_rows32<true><<<grid, 32 * W, 0, stream>>>(
          A, G, b, lam, has_obs, X_prev, X, part, R, k, ldr);
    } else {
      spd_solve_rows32<false><<<grid, 32 * W, 0, stream>>>(
          A, G, b, lam, has_obs, X_prev, X, part, R, k, ldr);
    }
  } else {
    const size_t smem =
        ((size_t)W * per_warp_floats(k) + 2 * W) * sizeof(float);
    if (smem > MAX_SMEM) return cudaErrorInvalidValue;
    if (smem > DEFAULT_SMEM) {
      err = cudaFuncSetAttribute(spd_solve_rows,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return err;
    }
    spd_solve_rows<<<grid, 32 * W, smem, stream>>>(A, G, b, lam, has_obs,
                                                   X_prev, X, part, R, k, W,
                                                   ldr);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || sums == nullptr) return err;
  spd_reduce<<<1, REDUCE_THREADS, 0, stream>>>(partials, grid.x, sums);
  return cudaGetLastError();
}

}  // namespace k2
