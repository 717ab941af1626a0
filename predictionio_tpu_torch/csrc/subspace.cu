// K11: one column block of the iALS++ subspace solver — the hand-written
// Hopper kernels that replace the block body of the reference's
// predictionio_tpu/ops/als.py:640 _solve_side_subspace (explicit and
// implicit feedback, float32, precision="highest").
//
// What it computes. A half-step sweeps the k/b column blocks B = [s0, s0+b)
// of the factors in order, each block reading what the block before it has
// just written (Gauss–Seidel), so every block is two launches in stream
// order, never fused across blocks:
//   subspace_accumulate (K11a): for every system row r, over its
//     observations (y = Y[col], v the rating, x the row's CURRENT factors,
//     d = y·x over all k columns):
//       A[r] = Σ w_a·y_B y_Bᵀ            [b, b]
//       r[r] = Σ (w_b − w_a·d)·y_B        [b]
//     explicit w_a = 1, w_b = v; implicit w_a = α|v|, w_b = 1(v>0)(1+α|v|),
//     as K1 weighs them. A and r are written in full (zeros for rows
//     without observations).
//   subspace_block_solve (K11b): for every row with observations,
//       δ = (A + G_BB + λ[r]·I)⁻¹ (r − (G x)_B − λ[r]·x_B)
//     (G, implicit mode's Gramian of the counter side, omitted in explicit
//     mode) by Cholesky with the forward substitution fused (rsqrt pivot,
//     as K2), then x_B += δ in place. Rows without observations keep x
//     (δ = 0). It also sums δ² over all rows (the block's delta RMS) and,
//     after the sweep's last block, x² over the whole factor array (the
//     factor RMS), through per-block partials summed in a fixed order.
//
// Bound on an H100 SXM, at the ML-20M stream with rank 64 and b = 8. Per
// slot and block K11a needs k FMAs for d, b(b+1)/2 for the triangle and b
// for r: 108 FMAs, 216 operations; ≈34.6 GFLOP per half-step over 20M
// slots, ≈0.52 ms at 67 TFLOP/s fp32. Its bytes are the 8-byte slots of
// the pack re-read once per block (≈1.28 GB over the 8 blocks, ≈0.38 ms at
// 3.35 TB/s) plus each block's A and r: it is bound by operations, near
// balance. The gathered rows (256 B each) come from L2: X is 37.7 MB at
// rank 64, Y 7.3 MB. Since d needs every column, each slot re-reads its
// whole row from L2 in every block: 5.1 GB per launch at ML-20M, which at
// L2's rate (≈5.5 TB/s) takes ≈0.9 ms; only a d carried across blocks
// would lift that floor. K11b is bound by bytes: A, r and x_B of every
// row.
//
// Design. K11a takes one warp per group of K1's plan (up to 8 consecutive
// segments of one row; a row with several groups writes one partial per
// group, summed in slot order by subspace_combine, so a skewed row spreads
// over many warps and no atomics are used), in one of two forms:
//   subspace_accumulate_lanes (k <= 64 and b in {1, 2, 4, 8}: the main
//     path): one lane per slot. The warp gathers 32 slots' y rows into a
//     shared tile (cp.async, a row per request); lane q forms its slot's d
//     from its row and the group's x row (shared, a broadcast), and adds
//     the slot into its own b(b+1)/2 + b sums; at the group's end the
//     lanes' sums are added up per output in lane order through the tile.
//     About 5 warp instructions a slot: the gathers' L2 traffic bounds it.
//   subspace_accumulate_groups (any other k <= 200 and b): lanes along k.
//     The row's x stays in registers (lane l holds columns l, l+32, ...).
//     The warp walks its slots 32 at a time: each lane loads one slot's
//     column id and weights; then for QU = 4 slots at a time it gathers
//     their y rows (128 bytes a load, QU rows in flight), forms each d by
//     a fixed butterfly, and parks y_B and the weights in shared memory.
//     Then every lane adds the parked slots into the outputs it owns (up
//     to 4 entries of the b(b+1)/2 + b outputs; wider blocks split their
//     outputs over blockIdx.y, each re-walking the slots). About 55 warp
//     instructions a slot at b = 8; the main path ran on it first.
//   subspace_block_solve_rows: one warp per row, the b x b system in shared
//     memory (row stride b+1) with G_BB and λ added as it is loaded;
//     (G x)_B by a butterfly per entry with G's rows read through the
//     cache; the Cholesky and the substitutions as K2's shared-memory form.
//   Sums are fixed-order: no atomics, so a run repeats bit for bit.
// Products are fp32 FMAs on the CUDA cores, never TF32.
//
// K11a-bf16 (subspace_accumulate_f32 with bf16 = 1): the reference's
// compute_dtype="bfloat16" form of the block body (:680 Yc = bf16(Y), :701
// xg = bf16(x[rows]), :716 and :721 the cast weights), both forms above
// with BF16 set. Each gathered y row and the row's current x are rounded
// to bfloat16 as they are read, in every block (x changes after each
// block); d = Σ y·x is summed in float32 from exact products; A's weight
// is bf16(w_a), and the residual's weight bf16(w_b − w_a·d) is formed in
// float32 from the unrounded w_a and w_b with a separate product and
// difference (no FMA contraction: the reference rounds the product), then
// rounded. The products and sums stay the float32 FMAs above. Bound: the
// same operations at the bf16 tensor-core peak against the same pack
// bytes, so bound by bytes. K11b is unchanged (float32).

#include <cuda_runtime.h>

#include "bf16.cuh"
#include "tiling.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;            // warps (= groups) per accumulate block
constexpr int QU = 4;               // slots whose gathers are in flight together
constexpr int OUT_PER_LANE = 4;     // outputs a lane owns per output tile
constexpr int OUT_TILE = 32 * OUT_PER_LANE;
constexpr int COMBINE_THREADS = 256;
constexpr int MAX_SOLVE_WARPS = 8;
constexpr int REDUCE_THREADS = 256;
constexpr size_t DEFAULT_SMEM = 48 * 1024;
constexpr size_t MAX_SMEM = 227 * 1024;

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// The residual's weight w_b − w_a·d. In bfloat16 compute the reference
// forms it in float32 with the product rounded on its own, then casts it.
template <bool BF16>
__device__ __forceinline__ float residual_weight(float wa, float wb, float d) {
  if constexpr (BF16) {
    return round_bf16(__fsub_rn(wb, __fmul_rn(wa, d)));
  } else {
    return wb - wa * d;
  }
}

// T = ceil(k / 32) columns per lane, a template argument so the main
// path's rank (k = 64, T = 2) runs without guards on unused chunks.
template <int T, bool BF16>
__global__ void __launch_bounds__(32 * WARPS) subspace_accumulate_groups(
    const float* __restrict__ Y, const float* __restrict__ X,
    const int* __restrict__ cols, const float* __restrict__ vals,
    const int* __restrict__ rem, const int* __restrict__ groups, int n_groups,
    float* __restrict__ partials, float* __restrict__ A, float* __restrict__ r,
    int k, int L, int s0, int b, int implicit, float alpha) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sy = smem + warp * (32 * b + 64);  // [32][b] parked y_B rows
  float* swa = sy + 32 * b;                 // [32] w_a
  float* sco = swa + 32;                    // [32] w_b − w_a·d
  const int g = blockIdx.x * WARPS + warp;
  if (g >= n_groups) return;  // no block barrier below
  const int row = groups[g];
  const int seg0 = groups[n_groups + g];
  const int s_end = seg0 + groups[2 * n_groups + g];
  const int slot = groups[3 * n_groups + g];
  const int ntri = b * (b + 1) / 2;
  const int nout = ntri + b;

  float xv[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int c = lane + 32 * t;
    xv[t] = c < k ? in_cdt<BF16>(X[(long long)row * k + c]) : 0.f;
  }
  // owned outputs: triangle entries (oi >= oj), r entries (oj = -1), or
  // none (oi = -1)
  int oi[OUT_PER_LANE], oj[OUT_PER_LANE];
  float acc[OUT_PER_LANE];
#pragma unroll
  for (int m = 0; m < OUT_PER_LANE; ++m) {
    const int e = blockIdx.y * OUT_TILE + lane + 32 * m;
    acc[m] = 0.f;
    oi[m] = -1;
    oj[m] = -1;
    if (e < ntri) {
      lower_tile(e, oi[m], oj[m]);
    } else if (e < nout) {
      oi[m] = e - ntri;
    }
  }

  for (int s = seg0; s < s_end; ++s) {
    const int n = rem[s];
    const long long base = (long long)s * L;
    for (int l0 = 0; l0 < n; l0 += 32) {
      const int c = min(32, n - l0);
      int col = 0;
      float wa = 0.f, wb = 0.f;
      if (lane < c) {
        col = cols[base + l0 + lane];
        const float v = vals[base + l0 + lane];
        if (implicit) {
          wa = alpha * fabsf(v);
          wb = v > 0.f ? 1.f + wa : 0.f;
        } else {
          wa = 1.f;
          wb = v;
        }
      }
      for (int q0 = 0; q0 < c; q0 += QU) {
        float yv[QU][T];
#pragma unroll
        for (int u = 0; u < QU; ++u) {
          const int q = q0 + u;
          const int cq = __shfl_sync(FULL, col, q & 31);
          const float* src = Y + (long long)cq * k;
#pragma unroll
          for (int t = 0; t < T; ++t) {
            const int cc = lane + 32 * t;
            yv[u][t] = (q < c && cc < k) ? in_cdt<BF16>(src[cc]) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < QU; ++u) {
          const int q = q0 + u;
          float part = 0.f;
#pragma unroll
          for (int t = 0; t < T; ++t) part = fmaf(yv[u][t], xv[t], part);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
          const float waq = __shfl_sync(FULL, wa, q & 31);
          const float wbq = __shfl_sync(FULL, wb, q & 31);
          if (q < c) {
#pragma unroll
            for (int t = 0; t < T; ++t) {
              const int cc = lane + 32 * t;
              if (cc >= s0 && cc < s0 + b) sy[q * b + (cc - s0)] = yv[u][t];
            }
            if (lane == 0) {
              swa[q] = in_cdt<BF16>(waq);
              sco[q] = residual_weight<BF16>(waq, wbq, part);
            }
          }
        }
        __syncwarp();
      }
#pragma unroll
      for (int m = 0; m < OUT_PER_LANE; ++m) {
        if (oi[m] < 0) continue;
        float a = acc[m];
        if (oj[m] >= 0) {
          for (int q = 0; q < c; ++q) {
            a = fmaf(swa[q] * sy[q * b + oi[m]], sy[q * b + oj[m]], a);
          }
        } else {
          for (int q = 0; q < c; ++q) a = fmaf(sco[q], sy[q * b + oi[m]], a);
        }
        acc[m] = a;
      }
      __syncwarp();  // the parked slots' readers are done before the next chunk
    }
  }

  float* dA;
  float* dr;
  if (slot < 0) {
    dA = A + (long long)row * b * b;
    dr = r + (long long)row * b;
  } else {
    dA = partials + (long long)slot * (b * b + b);
    dr = dA + b * b;
  }
#pragma unroll
  for (int m = 0; m < OUT_PER_LANE; ++m) {
    if (oi[m] < 0) continue;
    if (oj[m] >= 0) {
      dA[oi[m] * b + oj[m]] = acc[m];
      if (oi[m] != oj[m]) dA[oj[m] * b + oi[m]] = acc[m];
    } else {
      dr[oi[m]] = acc[m];
    }
  }
}

// k <= 32·T, T <= 2, and b = B in {1, 2, 4, 8} (the main path's rank 64
// with b = 8): one lane per slot. The warp gathers a chunk's 32 y rows
// into a shared tile (cp.async, a row per request, lanes along k, row
// stride 32·T + 1 so that a lane reading its own row hits its own banks),
// then lane q forms slot q's d from its row and the group's x row (in
// shared memory, read as a broadcast), and adds its slot into its private
// b(b+1)/2 + b sums. At the group's end the lanes' sums go through the
// tile, and lane e adds up output e over the 32 lanes in order.
template <int T, int B, bool BF16>
__global__ void __launch_bounds__(32 * WARPS) subspace_accumulate_lanes(
    const float* __restrict__ Y, const float* __restrict__ X,
    const int* __restrict__ cols, const float* __restrict__ vals,
    const int* __restrict__ rem, const int* __restrict__ groups, int n_groups,
    float* __restrict__ partials, float* __restrict__ A, float* __restrict__ r,
    int k, int L, int s0, int implicit, float alpha) {
  constexpr int K = 32 * T;
  constexpr int KP = K + 1;
  constexpr int NTRI = B * (B + 1) / 2;
  constexpr int NOUT = NTRI + B;
  constexpr int RP = NOUT | 1;  // odd stride of the lanes' sums in the tile
  __shared__ float tiles[WARPS][32 * (KP > RP ? KP : RP)];
  __shared__ float xs[WARPS][K];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * WARPS + warp;
  if (g >= n_groups) return;  // no block barrier below
  float* sy = tiles[warp];
  float* sx = xs[warp];
  const int row = groups[g];
  const int seg0 = groups[n_groups + g];
  const int s_end = seg0 + groups[2 * n_groups + g];
  const int slot = groups[3 * n_groups + g];

#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int c = lane + 32 * t;
    sx[c] = c < k ? in_cdt<BF16>(X[(long long)row * k + c]) : 0.f;
  }
  float acc[NOUT];
#pragma unroll
  for (int e = 0; e < NOUT; ++e) acc[e] = 0.f;

  for (int s = seg0; s < s_end; ++s) {
    const int n = rem[s];
    const long long base = (long long)s * L;
    for (int l0 = 0; l0 < n; l0 += 32) {
      const int c = min(32, n - l0);
      int col = 0;
      float v = 0.f;
      if (lane < c) {
        col = cols[base + l0 + lane];
        v = vals[base + l0 + lane];
      }
      for (int q = 0; q < c; ++q) {
        const int cq = __shfl_sync(FULL, col, q);
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const int cc = lane + 32 * t;
          const float* src = Y + (long long)cq * k + (cc < k ? cc : 0);
          const unsigned dst = (unsigned)__cvta_generic_to_shared(&sy[q * KP + cc]);
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                       "l"(src), "r"(cc < k ? 4 : 0));
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::);
      if constexpr (BF16) {  // each lane rounds the columns its own copies wrote
        for (int q = 0; q < c; ++q) {
#pragma unroll
          for (int t = 0; t < T; ++t) {
            float* e = &sy[q * KP + lane + 32 * t];
            *e = round_bf16(*e);
          }
        }
      }
      __syncwarp();
      if (lane < c) {
        const float* y = sy + lane * KP;
        float d = 0.f;
#pragma unroll
        for (int cc = 0; cc < K; ++cc) d = fmaf(y[cc], sx[cc], d);
        float wa, wb;
        if (implicit) {
          wa = alpha * fabsf(v);
          wb = v > 0.f ? 1.f + wa : 0.f;
        } else {
          wa = 1.f;
          wb = v;
        }
        const float co = residual_weight<BF16>(wa, wb, d);
        const float wA = in_cdt<BF16>(wa);
        float yb[B];
#pragma unroll
        for (int i = 0; i < B; ++i) yb[i] = y[s0 + i];
        int e = 0;
#pragma unroll
        for (int i = 0; i < B; ++i) {
          const float wy = wA * yb[i];
#pragma unroll
          for (int j = 0; j <= i; ++j, ++e) acc[e] = fmaf(wy, yb[j], acc[e]);
        }
#pragma unroll
        for (int i = 0; i < B; ++i) acc[NTRI + i] = fmaf(co, yb[i], acc[NTRI + i]);
      }
      __syncwarp();  // the tile's readers are done before it is refilled
    }
  }

#pragma unroll
  for (int e = 0; e < NOUT; ++e) sy[lane * RP + e] = acc[e];
  __syncwarp();
  float* dA;
  float* dr;
  if (slot < 0) {
    dA = A + (long long)row * B * B;
    dr = r + (long long)row * B;
  } else {
    dA = partials + (long long)slot * (B * B + B);
    dr = dA + B * B;
  }
  for (int e = lane; e < NOUT; e += 32) {
    float sum = 0.f;
#pragma unroll 8
    for (int q = 0; q < 32; ++q) sum += sy[q * RP + e];
    if (e < NTRI) {
      int i, j;
      lower_tile(e, i, j);
      dA[i * B + j] = sum;
      dA[j * B + i] = sum;
    } else {
      dr[e - NTRI] = sum;
    }
  }
}

__global__ void __launch_bounds__(COMBINE_THREADS) subspace_combine(
    const float* __restrict__ partials, const int* __restrict__ c_rows,
    const int* __restrict__ c_start, float* __restrict__ A,
    float* __restrict__ r, int b) {
  const int m = blockIdx.x;
  const int E = b * b + b;
  const int e = blockIdx.y * COMBINE_THREADS + threadIdx.x;
  if (e >= E) return;
  const int p1 = c_start[m + 1];
  float s = 0.f;
  for (int p = c_start[m]; p < p1; ++p) s += partials[(long long)p * E + e];
  const long long row = c_rows[m];
  if (e < b * b) {
    A[row * b * b + e] = s;
  } else {
    r[row * b + (e - b * b)] = s;
  }
}

__host__ __device__ inline int solve_floats(int b) { return b * (b + 1) + 3 * b; }

inline int solve_warps(int b) {
  const size_t bytes = (size_t)solve_floats(b) * sizeof(float);
  int w = (int)(DEFAULT_SMEM / bytes);
  if (w > MAX_SOLVE_WARPS) w = MAX_SOLVE_WARPS;
  return w < 1 ? 1 : w;
}

__global__ void subspace_block_solve_rows(
    const float* __restrict__ A, const float* __restrict__ rv,
    const float* __restrict__ G, const float* __restrict__ lam,
    const unsigned char* __restrict__ has_obs, float* __restrict__ X,
    float* __restrict__ partials, int R, int k, int s0, int b, int W,
    int last) {
  extern __shared__ float smem[];
  const int bp = b + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sA = smem + warp * solve_floats(b);  // [b][b+1]
  float* sy = sA + b * bp;                    // rhs, then y
  float* sd = sy + b;                         // 1 / L_jj
  float* sx = sd + b;                         // δ
  float* red = smem + W * solve_floats(b);    // [2 * W]
  const long long row = (long long)blockIdx.x * W + warp;
  float dsq = 0.f, xsq = 0.f;

  if (row < R) {
    float* xr = X + row * k;
    if (has_obs[row]) {
      const float* a = A + row * b * b;
      const float lr = lam[row];
      for (int e = lane; e < b * b; e += 32) {
        const int i = e / b;
        const int j = e - i * b;
        float v = a[e];
        if (G != nullptr) v += G[(long long)(s0 + i) * k + s0 + j];
        sA[i * bp + j] = i == j ? v + lr : v;
      }
      // the right side r − (G x)_B − λ·x_B, (G x)_B by a butterfly per entry
      for (int i = 0; i < b; ++i) {
        float gx = 0.f;
        if (G != nullptr) {
          const float* gi = G + (long long)(s0 + i) * k;
          for (int c = lane; c < k; c += 32) gx = fmaf(gi[c], xr[c], gx);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) gx += __shfl_xor_sync(FULL, gx, o);
        }
        if (lane == 0) {
          float v = rv[row * b + i];
          if (G != nullptr) v -= gx;
          sy[i] = v - lr * xr[s0 + i];
        }
      }
      __syncwarp();
      // Cholesky with the forward substitution fused
      for (int j = 0; j < b; ++j) {
        const float d = rsqrtf(sA[j * bp + j]);
        const float yj = sy[j] * d;
        for (int i = j + 1 + lane; i < b; i += 32) sA[i * bp + j] *= d;
        __syncwarp();
        if (lane == 0) {
          sy[j] = yj;
          sd[j] = d;
        }
        for (int i = j + 1 + lane; i < b; i += 32) {
          const float ci = sA[i * bp + j];
          sy[i] = fmaf(-ci, yj, sy[i]);
          for (int l = j + 1; l <= i; ++l) {
            sA[i * bp + l] = fmaf(-ci, sA[l * bp + j], sA[i * bp + l]);
          }
        }
        __syncwarp();
      }
      // back substitution, column by column
      for (int j = b - 1; j >= 0; --j) {
        const float xj = sy[j] * sd[j];
        if (lane == 0) sx[j] = xj;
        for (int i = lane; i < j; i += 32) sy[i] = fmaf(-sA[j * bp + i], xj, sy[i]);
        __syncwarp();
      }
      for (int i = lane; i < b; i += 32) {
        const float dl = sx[i];
        xr[s0 + i] = xr[s0 + i] + dl;
        dsq = fmaf(dl, dl, dsq);
      }
      __syncwarp();
    }
    if (last) {
      for (int c = lane; c < k; c += 32) {
        const float v = xr[c];
        xsq = fmaf(v, v, xsq);
      }
    }
  }

  if (partials != nullptr) {  // a butterfly, then the block's warps in order
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
      float a0 = 0.f, a1 = 0.f;
      for (int w = 0; w < W; ++w) {
        a0 += red[2 * w];
        a1 += red[2 * w + 1];
      }
      partials[2 * blockIdx.x] = a0;
      partials[2 * blockIdx.x + 1] = a1;
    }
  }
}

__global__ void __launch_bounds__(REDUCE_THREADS) subspace_reduce(
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

template <int T, bool BF16>
cudaError_t launch_accumulate(const float* Y, const float* X, const int* cols,
                              const float* vals, const int* rem,
                              const int* groups, int n_groups,
                              float* partials, float* A, float* r, int k,
                              int L, int s0, int b, int implicit, float alpha,
                              cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * (32 * b + 64) * sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        subspace_accumulate_groups<T, BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int nout = b * (b + 1) / 2 + b;
  dim3 grid(ceil_div(n_groups, WARPS), ceil_div(nout, OUT_TILE));
  subspace_accumulate_groups<T, BF16><<<grid, 32 * WARPS, smem, stream>>>(
      Y, X, cols, vals, rem, groups, n_groups, partials, A, r, k, L, s0, b,
      implicit, alpha);
  return cudaGetLastError();
}

template <bool BF16>
int accumulate(const float* Y, const float* X, const int* cols,
               const float* vals, const int* rem, const int* groups,
               int n_groups, const int* c_rows, const int* c_start,
               int n_combine, float* partials, float* A, float* r, int k,
               int L, int s0, int b, int implicit, float alpha,
               cudaStream_t stream) {
  if (n_groups < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  const int T = (k + 31) / 32;
  if (T <= 2 && (b == 1 || b == 2 || b == 4 || b == 8)) {
    const dim3 grid(ceil_div(n_groups, WARPS));
#define SUBSPACE_LANES(TT, BB)                                                \
  if (T == TT && b == BB) {                                                   \
    subspace_accumulate_lanes<TT, BB, BF16><<<grid, 32 * WARPS, 0, stream>>>( \
        Y, X, cols, vals, rem, groups, n_groups, partials, A, r, k, L, s0,     \
        implicit, alpha);                                                     \
    err = cudaGetLastError();                                                 \
  }
    SUBSPACE_LANES(1, 1)
    SUBSPACE_LANES(1, 2)
    SUBSPACE_LANES(1, 4)
    SUBSPACE_LANES(1, 8)
    SUBSPACE_LANES(2, 1)
    SUBSPACE_LANES(2, 2)
    SUBSPACE_LANES(2, 4)
    SUBSPACE_LANES(2, 8)
#undef SUBSPACE_LANES
  } else switch (T) {
#define SUBSPACE_CASE(TT)                                                     \
  case TT:                                                                    \
    err = launch_accumulate<TT, BF16>(Y, X, cols, vals, rem, groups, n_groups,\
                               partials, A, r, k, L, s0, b, implicit, alpha,  \
                               stream);                                       \
    break;
    SUBSPACE_CASE(1)
    SUBSPACE_CASE(2)
    SUBSPACE_CASE(3)
    SUBSPACE_CASE(4)
    SUBSPACE_CASE(5)
    SUBSPACE_CASE(6)
    SUBSPACE_CASE(7)
#undef SUBSPACE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || n_combine == 0) return (int)err;
  dim3 grid2(n_combine, ceil_div(b * b + b, COMBINE_THREADS));
  subspace_combine<<<grid2, COMBINE_THREADS, 0, stream>>>(partials, c_rows,
                                                          c_start, A, r, b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K11a on `stream`: A [R, b, b] and r [R, b] of the column block
// [s0, s0 + b) against Y [n, k] and the current X [R, k], over a packed
// side (cols/vals [S, L], rem [S]) walked through K1's group plan
// (groups [4, n_groups]: row, first segment, segment count, partial slot
// or -1; c_rows [n_combine], c_start [n_combine + 1]), partials
// [max(P, 1), b*b + b]. Returns cudaGetLastError(). The caller checks
// shapes, dtypes, devices, id ranges, 1 <= b, b | k and k <= 200.
// bf16 != 0 runs K11a-bf16 (see the header).
int subspace_accumulate_f32(const float* Y, const float* X, const int* cols,
                            const float* vals, const int* rem,
                            const int* groups, int n_groups,
                            const int* c_rows, const int* c_start,
                            int n_combine, float* partials, float* A,
                            float* r, int k, int L, int s0, int b,
                            int implicit, float alpha, int bf16,
                            cudaStream_t stream) {
  return bf16 ? accumulate<true>(Y, X, cols, vals, rem, groups, n_groups,
                                 c_rows, c_start, n_combine, partials, A, r, k,
                                 L, s0, b, implicit, alpha, stream)
              : accumulate<false>(Y, X, cols, vals, rem, groups, n_groups,
                                  c_rows, c_start, n_combine, partials, A, r,
                                  k, L, s0, b, implicit, alpha, stream);
}

// Blocks subspace_block_solve_f32 launches for R rows at block width b
// (its partials buffer holds two floats per block).
int subspace_solve_blocks(int R, int b) {
  const int W = solve_warps(b);
  return (R + W - 1) / W;
}

// K11b on `stream`: solve every row's block system and add δ into
// X[:, s0:s0+b] in place; G [k, k] or null (explicit). When `sums` is not
// null, sums[0] = Σ δ² and sums[1] = (last ? Σ X² : 0), through `partials`
// of 2·blocks floats. Returns cudaGetLastError(). The caller checks
// shapes, dtypes, devices, R >= 1 and 1 <= b <= k <= 200.
int subspace_block_solve_f32(const float* A, const float* rv, const float* G,
                             const float* lam, const unsigned char* has_obs,
                             float* X, float* partials, float* sums, int R,
                             int k, int s0, int b, int last,
                             cudaStream_t stream) {
  const int W = solve_warps(b);
  const int blocks = (R + W - 1) / W;
  const size_t smem = ((size_t)W * solve_floats(b) + 2 * W) * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (smem > DEFAULT_SMEM) {
    err = cudaFuncSetAttribute(subspace_block_solve_rows,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  float* part = sums ? partials : nullptr;
  subspace_block_solve_rows<<<blocks, 32 * W, smem, stream>>>(
      A, rv, G, lam, has_obs, X, part, R, k, s0, b, W, last);
  err = cudaGetLastError();
  if (err != cudaSuccess || sums == nullptr) return (int)err;
  subspace_reduce<<<1, REDUCE_THREADS, 0, stream>>>(partials, blocks, sums);
  return (int)cudaGetLastError();
}

const char* subspace_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
