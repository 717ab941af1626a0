// K12: the Gramian and the implicit objective of implicit-feedback ALS —
// the hand-written Hopper kernels that replace the reference's jitted
// predictionio_tpu/ops/als.py:742 _gramian (K12a) and :752
// _implicit_objective (K12b).
//
// K12a, what it computes. G = YᵀY [k, k] over a factor array Y [n, k]
// (the padded array: padding rows are zero, unobserved real rows keep
// their init and count), in float32 FMAs on the CUDA cores, never TF32
// (the reference asks for precision="highest").
//
// K12a, bound on an H100 SXM. At ML-20M's user side (147,456 padded rows,
// k=32) Y is 18.9 MB, ≈5.6 µs at 3.35 TB/s; the k(k+1)/2 products per
// row that a symmetric G needs are 0.16 GFLOP, ≈2.3 µs at 67 TFLOP/s
// (0.30 GFLOP, ≈4.5 µs, for the full k²): it is bound by bytes, and the
// partials' round trip (≤ 264 x k² floats) is small beside Y.
//
// K12a, design: a fixed two-level reduction with no atomics, so a run
// repeats bit for bit. gramian_partial: block p sums a fixed range of
// rows (the ranges depend on n only): it stages 32 rows at a time in
// shared memory (coalesced, zero-padded to a multiple of 4), each thread
// owns a 4x4 tile of the lower triangle for every SG-th staged row, and
// the SG row groups are summed in order through shared memory; the tile
// is written to both triangles of the block's partial. gramian_combine:
// each entry's partials summed in block order.
//
// K12b, what it computes. The Hu-Koren-Volinsky objective at the current
// factors, as the reference does: Σ_obs [c·s² − 2(1+c)·p·s + (1+c)·p²]
// over the user pack's slots (s = x·y, c = α·|r|, p = 1(r>0); every event
// a slot, so a store with repeated events can give a negative value),
// plus ⟨XᵀX, YᵀY⟩ (the two Gramians, from K12a) plus Σ_r λ_r·‖x_r‖² over
// both padded sides.
//
// K12b, bound. Per observed slot one column id and one rating (8 bytes)
// and per segment its row and count; X and Y once and the per-row λ of
// both sides: at ML-20M ≈0.16 GB of user pack plus 23 MB, ≈0.055 ms at
// 3.35 TB/s; 2k + 8 operations per slot (≈1.4 GFLOP at k=32, ≈0.02 ms at
// 67 TFLOP/s): bound by bytes.
//
// K12b, design. objective_partial runs three kinds of blocks, each
// writing one partial: blocks over fixed ranges of segments (a warp per
// segment, its x row in shared memory; G = 8 lanes per slot at k = 32,
// each reading a float4 of the slot's gathered y row, so a warp reads 4
// whole rows per load, and 4 such loads in flight at once, each slot's
// column id loaded ahead of its row: the pass is bound by the latency of
// these dependent gathers, so it keeps many in flight; the dot is a fixed
// butterfly over the 8; each group's terms summed in slot order, then a
// fixed tree over the block's threads), and blocks over fixed row ranges
// of X and of Y for the regularizer, G lanes per row the same way. objective_finish
// (one block) sums each kind's partials in a fixed tree, ⟨Gx, Gy⟩ in a
// fixed tree, and writes (⟨Gx, Gy⟩ + obs) + (reg_x + reg_y), the
// reference's order of the three terms. No atomics: a run repeats bit for
// bit. Slots past a segment's count are never read.
//
// K12b on a row-sharded mesh (ops/gramian.implicit_objective_shards): the
// same two kernels, split. Each shard launches objective_partial over its
// own user segments, its rows of X and its rows of Y (the item side's row
// split), writing each kind's partials at the shard's offset in one buffer
// per kind on the mesh's first device; one objective_finish then sums every
// shard's partials of a kind in one fixed tree. Only the order of the
// cross-shard sums differs from one device.
//
// K12b-bf16 (implicit_objective_f32 with bf16 = 1): the reference's
// compute_dtype="bfloat16" objective (:779-780 Xc = bf16(X), Yc = bf16(Y)):
// the scores s = x·y are formed from x and y rounded to bfloat16 as they
// are read (exact products, float32 sums); the weights c and p, the
// Gramians (K12a, float32) and the regularizer's norms stay unrounded
// float32, as in the reference. Bound: K12b's bytes (the regularizer
// reads the float32 factors), so bound by bytes. K12a has no bf16 form.

#include <cuda_runtime.h>

#include "bf16.cuh"
#include "tiling.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int GCH = 32;  // rows K12a stages per round
constexpr int RED = 16;  // floats a thread hands over in the row-group sum
constexpr int MAX_PARTIAL_BLOCKS = 264;  // two blocks per SM
constexpr int OBJ_WARPS = THREADS / 32;
constexpr int UNROLL = 4;  // slot groups a warp scores per round of K12b
constexpr int OBJ_BLOCKS = 8 * MAX_PARTIAL_BLOCKS;  // K12b's segment blocks, at most
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t DEFAULT_SMEM = 48 * 1024;

__global__ void __launch_bounds__(THREADS) gramian_partial(
    const float* __restrict__ Y, int n, int k, int rows_per_block,
    float* __restrict__ partials, int T, int tiles_per_block, int SG) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int kp = 4 * T;
  float* ys = smem;               // [GCH][kp]
  float* red = ys + GCH * kp;     // [(SG-1) * tiles_per_block * RED]

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  const int NT = T * (T + 1) / 2;
  const int tid = threadIdx.x;
  const int tl = tid % tiles_per_block;
  const int sg = tid / tiles_per_block;
  const int tile = blockIdx.y * tiles_per_block + tl;
  const bool active = sg < SG && tile < NT;
  int ti = 0, tj = 0;
  if (active) lower_tile(tile, ti, tj);

  float acc[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
#pragma unroll
    for (int z = 0; z < 4; ++z) acc[x][z] = 0.f;
  }
  for (int l0 = r0; l0 < r1; l0 += GCH) {
    const int c = min(GCH, r1 - l0);
    __syncthreads();  // the previous round's readers are done
    for (int e = tid; e < c * kp; e += THREADS) {
      const int r = e / kp;
      const int col = e - r * kp;
      ys[e] = col < k ? Y[(long long)(l0 + r) * k + col] : 0.f;
    }
    __syncthreads();
    if (active) {
      for (int cc = sg; cc < c; cc += SG) {
        const float4 a = *reinterpret_cast<const float4*>(ys + cc * kp + ti * 4);
        const float4 y = *reinterpret_cast<const float4*>(ys + cc * kp + tj * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
#pragma unroll
          for (int z = 0; z < 4; ++z) acc[x][z] = fmaf(av[x], yv[z], acc[x][z]);
        }
      }
    }
  }
  if (SG > 1) {  // sum the row groups, in order, into row group 0
    if (active && sg > 0) {
      float* r = red + ((sg - 1) * tiles_per_block + tl) * RED;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int z = 0; z < 4; ++z) r[x * 4 + z] = acc[x][z];
      }
    }
    __syncthreads();
    if (active && sg == 0) {
      for (int q = 1; q < SG; ++q) {
        const float* r = red + ((q - 1) * tiles_per_block + tl) * RED;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
#pragma unroll
          for (int z = 0; z < 4; ++z) acc[x][z] += r[x * 4 + z];
        }
      }
    }
  }
  if (active && sg == 0) {
    float* P = partials + (long long)blockIdx.x * k * k;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = ti * 4 + x;
      if (i >= k) break;
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        const int j = tj * 4 + z;
        if (j < k) {
          P[i * k + j] = acc[x][z];
          if (ti != tj) P[j * k + i] = acc[x][z];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) gramian_combine(
    const float* __restrict__ partials, int n_partials, int kk,
    float* __restrict__ G) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= kk) return;
  float s = 0.f;
  for (int p = 0; p < n_partials; ++p) s += partials[(long long)p * kk + e];
  G[e] = s;
}

// The sum of one float per thread of a block, in a fixed tree; every
// thread gets it back.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  const int t = threadIdx.x;
  __syncthreads();
  sh[t] = v;
  __syncthreads();
  for (int o = THREADS / 2; o > 0; o >>= 1) {
    if (t < o) sh[t] += sh[t + o];
    __syncthreads();
  }
  return sh[0];
}

// One lane's share of the dot product of a shared row x and a device row
// y over k entries, for a group of G lanes (sub = this lane's place in
// it): its chunks summed in order, y in the compute type (x is staged in
// it). The group's shares are then added in a fixed butterfly.
template <bool BF16>
__device__ __forceinline__ float lane_dot(const float* __restrict__ x,
                                          const float* __restrict__ y,
                                          bool valid, int k, int sub, int G) {
  float d = 0.f;
  if (valid) {
    if ((k & 3) == 0) {
      const float4* x4 = reinterpret_cast<const float4*>(x);
      const float4* y4 = reinterpret_cast<const float4*>(y);
      for (int c = sub; c < (k >> 2); c += G) {
        const float4 a = x4[c];
        const float4 b = __ldg(y4 + c);
        d = fmaf(a.x, in_cdt<BF16>(b.x), d);
        d = fmaf(a.y, in_cdt<BF16>(b.y), d);
        d = fmaf(a.z, in_cdt<BF16>(b.z), d);
        d = fmaf(a.w, in_cdt<BF16>(b.w), d);
      }
    } else {
      for (int j = sub; j < k; j += G) d = fmaf(x[j], in_cdt<BF16>(__ldg(y + j)), d);
    }
  }
  return d;
}

// Blocks [0, b_obs): segments; [b_obs, b_obs + b_x): rows of X;
// [b_obs + b_x, b_obs + b_x + b_y): rows of Yr (the Y rows whose
// regularizer this launch sums: all of Y on one device, a row shard's on a
// mesh). One partial per block, into obs_out, x_out or y_out by kind.
// A warp takes one segment at a time: its x row goes to shared memory,
// and UNROLL x 32 / G slots are scored at once, G lanes per slot reading
// the slot's y row as float4s (coalesced; the UNROLL rows' loads are in
// flight together) and summing the dot in a fixed butterfly; the group's
// first lane adds the slots' terms to its running sum in slot order.
template <bool BF16>
__global__ void __launch_bounds__(THREADS) objective_partial(
    const float* __restrict__ X, const float* __restrict__ Y,
    const int* __restrict__ seg_rows, const int* __restrict__ cols,
    const float* __restrict__ vals, const int* __restrict__ rem, int S,
    int L, int k, float alpha, int segs_per_block, int b_obs,
    const float* __restrict__ lam_x, int n_x, const float* __restrict__ Yr,
    const float* __restrict__ lam_y, int n_y, int rows_per_block, int b_x,
    float* __restrict__ obs_out, float* __restrict__ x_out,
    float* __restrict__ y_out) {
  extern __shared__ float4 xs4[];  // [OBJ_WARPS][kp]
  __shared__ float sh[THREADS];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int G = row_lanes(k);
  const int sub = lane % G;
  const int grp = lane / G;
  const int per_pass = 32 / G;  // rows (slots) a warp scores at once
  const int kp = (k + 3) & ~3;
  float acc = 0.f;
  if ((int)blockIdx.x < b_obs) {
    float* x = reinterpret_cast<float*>(xs4) + warp * kp;
    const int s0 = blockIdx.x * segs_per_block;
    const int s1 = min(S, s0 + segs_per_block);
    for (int s = s0 + warp; s < s1; s += OBJ_WARPS) {
      const int n = rem[s];
      if (n == 0) continue;
      const float* xr = X + (long long)seg_rows[s] * k;
      __syncwarp();
      for (int j = lane; j < k; j += 32) x[j] = in_cdt<BF16>(xr[j]);
      __syncwarp();
      const long long base = (long long)s * L;
      for (int l0 = 0; l0 < n; l0 += UNROLL * per_pass) {
        bool ok[UNROLL];
        int col[UNROLL];
        float v[UNROLL], d[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int l = l0 + u * per_pass + grp;
          ok[u] = l < n;
          col[u] = ok[u] ? cols[base + l] : 0;
          v[u] = ok[u] ? vals[base + l] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          d[u] = lane_dot<BF16>(x, Y + (long long)col[u] * k, ok[u], k, sub, G);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          for (int o = G >> 1; o > 0; o >>= 1) d[u] += __shfl_xor_sync(FULL, d[u], o);
          if (ok[u] && sub == 0) {
            const float sc = d[u];
            const float c = alpha * fabsf(v[u]);
            const float p = v[u] > 0.f ? 1.f : 0.f;
            acc += c * sc * sc - 2.f * (1.f + c) * p * sc + (1.f + c) * p * p;
          }
        }
      }
    }
  } else {
    const bool on_x = (int)blockIdx.x < b_obs + b_x;
    const int blk = blockIdx.x - b_obs - (on_x ? 0 : b_x);
    const float* F = on_x ? X : Yr;
    const float* lam = on_x ? lam_x : lam_y;
    const int n = on_x ? n_x : n_y;
    const int r0 = blk * rows_per_block;
    const int r1 = min(n, r0 + rows_per_block);
    // a row's squared norm by its lane group, as the slots' dots
    for (int q = r0 + warp * per_pass; q < r1; q += OBJ_WARPS * per_pass) {
      const int r = q + grp;
      const bool valid = r < r1;
      const float* fr = F + (long long)(valid ? r : r0) * k;
      float sq = 0.f;
      if (valid) {
        for (int j = sub; j < k; j += G) sq = fmaf(fr[j], fr[j], sq);
      }
      for (int o = G >> 1; o > 0; o >>= 1) sq += __shfl_xor_sync(FULL, sq, o);
      if (valid && sub == 0) acc = fmaf(lam[r], sq, acc);
    }
  }
  const float total = block_sum(acc, sh);
  if (tid == 0) {
    const int blk = blockIdx.x;
    if (blk < b_obs) obs_out[blk] = total;
    else if (blk < b_obs + b_x) x_out[blk - b_obs] = total;
    else y_out[blk - b_obs - b_x] = total;
  }
}

__global__ void __launch_bounds__(THREADS) objective_finish(
    const float* __restrict__ partials, int b_obs, int b_x, int b_y,
    const float* __restrict__ Gx, const float* __restrict__ Gy, int kk,
    float* __restrict__ out) {
  __shared__ float sh[THREADS];
  const int t = threadIdx.x;
  float v = 0.f;
  for (int e = t; e < kk; e += THREADS) v = fmaf(Gx[e], Gy[e], v);
  const float all_sq = block_sum(v, sh);
  v = 0.f;
  for (int p = t; p < b_obs; p += THREADS) v += partials[p];
  const float obs = block_sum(v, sh);
  v = 0.f;
  for (int p = t; p < b_x; p += THREADS) v += partials[b_obs + p];
  const float reg_x = block_sum(v, sh);
  v = 0.f;
  for (int p = t; p < b_y; p += THREADS) v += partials[b_obs + b_x + p];
  const float reg_y = block_sum(v, sh);
  if (t == 0) out[0] = (all_sq + obs) + (reg_x + reg_y);
}

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// Rows per K12a block: a multiple of GCH, at most MAX_PARTIAL_BLOCKS blocks.
inline int gramian_rows_per_block(int n) {
  const int per = ceil_div(n > 0 ? n : 1, MAX_PARTIAL_BLOCKS);
  return ceil_div(per, GCH) * GCH;
}

inline int objective_segs_per_block(int S) {
  const int per = ceil_div(S > 0 ? S : 1, OBJ_BLOCKS);
  return per < OBJ_WARPS ? OBJ_WARPS : per;
}

// The blocks of each kind K12b's partial launch runs.
inline void objective_grid(int S, int n_x, int n_y, int* spb, int* rpb,
                           int* b_obs, int* b_x, int* b_y) {
  *spb = objective_segs_per_block(S);
  *b_obs = ceil_div(S > 0 ? S : 1, *spb);
  *rpb = gramian_rows_per_block(n_x > n_y ? n_x : n_y);
  *b_x = ceil_div(n_x > 0 ? n_x : 1, *rpb);
  *b_y = ceil_div(n_y > 0 ? n_y : 1, *rpb);
}

template <bool BF16>
int objective_partials_launch(const float* X, int n_x, const float* Y,
                              const float* Yr, int n_y, const int* seg_rows,
                              const int* cols, const float* vals,
                              const int* rem, int S, int L, int k,
                              float alpha, const float* lam_x,
                              const float* lam_y, float* obs_out,
                              float* x_out, float* y_out,
                              cudaStream_t stream) {
  int spb, rpb, b_obs, b_x, b_y;
  objective_grid(S, n_x, n_y, &spb, &rpb, &b_obs, &b_x, &b_y);
  const size_t smem = (size_t)OBJ_WARPS * ((k + 3) & ~3) * sizeof(float);
  cudaError_t err;
  if (smem > DEFAULT_SMEM) {
    err = cudaFuncSetAttribute(objective_partial<BF16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  objective_partial<BF16><<<b_obs + b_x + b_y, THREADS, smem, stream>>>(
      X, Y, seg_rows, cols, vals, rem, S, L, k, alpha, spb, b_obs, lam_x, n_x,
      Yr, lam_y, n_y, rpb, b_x, obs_out, x_out, y_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Partials K12a needs for n rows: the wrapper allocates n_partials x k²
// floats.
int gramian_partials(int n) {
  return ceil_div(n > 0 ? n : 1, gramian_rows_per_block(n));
}

// G [k, k] = YᵀY for Y [n, k] row-major; launches both kernels on
// `stream` and returns cudaGetLastError(). The caller checks shapes,
// dtypes, devices and 1 <= k <= 1024.
int gramian_f32(const float* Y, int n, int k, float* partials, float* G,
                cudaStream_t stream) {
  const int rpb = gramian_rows_per_block(n);
  const int P = gramian_partials(n);
  const int T = (k + 3) / 4;
  const int NT = T * (T + 1) / 2;
  const int tpb = NT < THREADS ? NT : THREADS;
  const int SG = THREADS / tpb;
  const size_t smem = ((size_t)GCH * 4 * T + (size_t)(SG - 1) * tpb * RED) *
                      sizeof(float);
  cudaError_t err;
  if (smem > DEFAULT_SMEM) {
    err = cudaFuncSetAttribute(gramian_partial,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(P, ceil_div(NT, tpb));
  gramian_partial<<<grid, THREADS, smem, stream>>>(Y, n, k, rpb, partials, T,
                                                   tpb, SG);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gramian_combine<<<ceil_div((long long)k * k, THREADS), THREADS, 0, stream>>>(
      partials, P, k * k, G);
  return (int)cudaGetLastError();
}

// Partials K12b needs: one per block over S segments and the two sides'
// rows.
int objective_partials(int S, int n_x, int n_y) {
  int spb, rpb, b_obs, b_x, b_y;
  objective_grid(S, n_x, n_y, &spb, &rpb, &b_obs, &b_x, &b_y);
  return b_obs + b_x + b_y;
}

// The blocks of each kind K12b's partial launch runs for S segments and
// n_x, n_y rows, into blocks[0..2] (segments, rows of X, rows of Y).
void objective_blocks(int S, int n_x, int n_y, int* blocks) {
  int spb, rpb;
  objective_grid(S, n_x, n_y, &spb, &rpb, blocks, blocks + 1, blocks + 2);
}

// K12b's first launch alone, for one row shard of a mesh (K12b on a mesh:
// each shard's partials, then one implicit_objective_finish_f32 over them
// all): X [n_x, k] the shard's rows (seg_rows number them from 0), Y the
// whole counter side (cols are its global ids), Yr [n_y, k] the Y rows
// whose regularizer the shard sums, with lam_x and lam_y theirs. Writes
// objective_blocks' three counts of partials to obs_out, x_out and y_out.
int implicit_objective_partial_f32(const float* X, int n_x, const float* Y,
                                   const float* Yr, int n_y,
                                   const int* seg_rows, const int* cols,
                                   const float* vals, const int* rem, int S,
                                   int L, int k, float alpha,
                                   const float* lam_x, const float* lam_y,
                                   float* obs_out, float* x_out, float* y_out,
                                   int bf16, cudaStream_t stream) {
  return bf16 ? objective_partials_launch<true>(
                    X, n_x, Y, Yr, n_y, seg_rows, cols, vals, rem, S, L, k,
                    alpha, lam_x, lam_y, obs_out, x_out, y_out, stream)
              : objective_partials_launch<false>(
                    X, n_x, Y, Yr, n_y, seg_rows, cols, vals, rem, S, L, k,
                    alpha, lam_x, lam_y, obs_out, x_out, y_out, stream);
}

// K12b's finish: partials holds b_obs observed-term partials, then b_x of
// X's regularizer, then b_y of Y's, each kind summed in a fixed tree; out[0]
// = (⟨Gx, Gy⟩ + obs) + (reg_x + reg_y).
int implicit_objective_finish_f32(const float* partials, int b_obs, int b_x,
                                  int b_y, const float* Gx, const float* Gy,
                                  int k, float* out, cudaStream_t stream) {
  objective_finish<<<1, THREADS, 0, stream>>>(partials, b_obs, b_x, b_y, Gx,
                                              Gy, k * k, out);
  return (int)cudaGetLastError();
}

// The implicit objective into out[0]: X [n_x, k], Y [n_y, k], the user
// pack's S segments of L slots (seg_rows, cols, vals, rem), the per-row
// regularizers of both sides, and the two Gramians Gx = XᵀX, Gy = YᵀY.
// Launches both kernels on `stream` and returns cudaGetLastError(). The
// caller checks shapes, dtypes, devices, id ranges and 1 <= k <= 1024.
// bf16 != 0 runs K12b-bf16, with the scores in bfloat16 compute (see the
// header).
int implicit_objective_f32(const float* X, int n_x, const float* Y, int n_y,
                           const int* seg_rows, const int* cols,
                           const float* vals, const int* rem, int S, int L,
                           int k, float alpha, const float* lam_x,
                           const float* lam_y, const float* Gx,
                           const float* Gy, float* partials, float* out,
                           int bf16, cudaStream_t stream) {
  int b[3];
  objective_blocks(S, n_x, n_y, b);
  const int err = implicit_objective_partial_f32(
      X, n_x, Y, Y, n_y, seg_rows, cols, vals, rem, S, L, k, alpha, lam_x,
      lam_y, partials, partials + b[0], partials + b[0] + b[1], bf16, stream);
  if (err != 0) return err;
  return implicit_objective_finish_f32(partials, b[0], b[1], b[2], Gx, Gy, k,
                                       out, stream);
}

const char* gramian_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
