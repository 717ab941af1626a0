// K1's kernels (csrc/normal_eq.cu says what they compute, their bound and
// their design), with a variant axis: V factor matrices Y[v] against one
// shared packed side and group plan, each variant's systems summed in
// exactly K1's order. normal_eq.cu launches them with V = 1; grid.cu's
// K13a (the regularizer grid) with V variants. Three forms by rank:
// normal_eq_small (k <= 16: sized to the rank, a group's variants in one
// warp, lanes on the lower triangle and b only), normal_eq_groups32
// (k <= 32: padded to 32 x 32, a variant's group a warp) and
// normal_eq_groups (k > 32: a block a group). BF16 is the reference's
// bfloat16 compute (bf16.cuh): each gathered row is rounded as it lands in
// shared memory, and the weights where the reference casts them.
#pragma once

#include <cuda_runtime.h>

#include "bf16.cuh"
#include "tiling.cuh"

namespace k1 {

constexpr int THREADS = 256;
constexpr int CH = 64;  // gathered slots staged per round
constexpr int COMBINE_THREADS = 256;
constexpr int RED = 20;  // floats a thread hands over in the slot-group sum
constexpr int WARPS32 = 4;  // warps (= groups) per block of the k <= 32 form
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t DEFAULT_SMEM = 48 * 1024;

template <bool IMPLICIT, bool VARIANTS, bool BF16>
__global__ void __launch_bounds__(THREADS) normal_eq_groups(
    const float* __restrict__ Y, const int* __restrict__ cols,
    const float* __restrict__ vals, const int* __restrict__ rem,
    const int* __restrict__ groups, int n_groups,
    float* __restrict__ partials, float* __restrict__ A,
    float* __restrict__ b, int k, int L, int T, int tiles_per_block,
    int SG, float alpha, int V, long long y_stride, int R, int P) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int kp = 4 * T;               // staged row length, float4-aligned
  float* ys = smem;                   // [CH][kp]
  float* wb = ys + CH * kp;           // [CH] b's weights (explicit: ratings)
  float* wa = wb + CH;                // [CH] A's weights (implicit only)
  float* red = wa + CH;               // [(SG-1) * tiles_per_block * RED]

  // a group's V variants run in neighbouring blocks, so all but the
  // first read the group's planes from L2
  const int g = VARIANTS ? blockIdx.x / V : blockIdx.x;
  if constexpr (VARIANTS) {
    const int var = blockIdx.x % V;
    Y += var * y_stride;
    partials += (long long)var * P * (k * k + k);
    A += (long long)var * R * k * k;
    b += (long long)var * R * k;
  }
  const int row = groups[g];
  const int seg0 = groups[n_groups + g];
  const int nseg = groups[2 * n_groups + g];
  const int slot = groups[3 * n_groups + g];
  const int NT = T * (T + 1) / 2;
  const int tile0 = blockIdx.y * tiles_per_block;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tl = tid % tiles_per_block;
  const int sg = tid / tiles_per_block;
  const int tile = tile0 + tl;
  const bool active = sg < SG && tile < NT;
  int ti = 0, tj = 0;
  if (active) lower_tile(tile, ti, tj);

  float acc[4][4];
  float bacc[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    bacc[x] = 0.f;
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
  }

  for (int s = seg0; s < seg0 + nseg; ++s) {
    const int n = rem[s];
    const long long base = (long long)s * L;
    for (int l0 = 0; l0 < n; l0 += CH) {
      const int c = min(CH, n - l0);
      __syncthreads();  // the previous round's readers are done
      for (int r = warp; r < c; r += THREADS / 32) {
        const float* src = Y + (long long)cols[base + l0 + r] * k;
        for (int col = lane; col < kp; col += 32) {
          ys[r * kp + col] = col < k ? in_cdt<BF16>(src[col]) : 0.f;
        }
      }
      if (tid < c) {
        const float v = vals[base + l0 + tid];
        if constexpr (IMPLICIT) {
          const float cv = alpha * fabsf(v);
          wa[tid] = in_cdt<BF16>(cv);
          wb[tid] = in_cdt<BF16>(v > 0.f ? 1.f + cv : 0.f);
        } else {
          wb[tid] = in_cdt<BF16>(v);
        }
      }
      __syncthreads();
      if (active) {
        for (int cc = sg; cc < c; cc += SG) {
          const float4 a = *reinterpret_cast<const float4*>(ys + cc * kp + ti * 4);
          const float4 y = *reinterpret_cast<const float4*>(ys + cc * kp + tj * 4);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float yv[4] = {y.x, y.y, y.z, y.w};
          float aw[4] = {av[0], av[1], av[2], av[3]};  // w_a·y (explicit: y)
          if constexpr (IMPLICIT) {
            const float w = wa[cc];
#pragma unroll
            for (int x = 0; x < 4; ++x) aw[x] = av[x] * w;
          }
#pragma unroll
          for (int x = 0; x < 4; ++x) {
#pragma unroll
            for (int z = 0; z < 4; ++z) acc[x][z] = fmaf(aw[x], yv[z], acc[x][z]);
          }
          if (tj == 0) {
            const float w = wb[cc];
#pragma unroll
            for (int x = 0; x < 4; ++x) bacc[x] = fmaf(w, av[x], bacc[x]);
          }
        }
      }
    }
  }

  if (SG > 1) {  // sum the slot groups, in order, into slot group 0
    if (active && sg > 0) {
      float* r = red + ((sg - 1) * tiles_per_block + tl) * RED;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int z = 0; z < 4; ++z) r[x * 4 + z] = acc[x][z];
        r[16 + x] = bacc[x];
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
          bacc[x] += r[16 + x];
        }
      }
    }
  }

  if (active && sg == 0) {
    float* dA;
    float* db;
    if (slot < 0) {
      dA = A + (long long)row * k * k;
      db = b + (long long)row * k;
    } else {
      dA = partials + (long long)slot * (k * k + k);
      db = dA + k * k;
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = ti * 4 + x;
      if (i >= k) break;
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        const int j = tj * 4 + z;
        if (j < k) {
          dA[(long long)i * k + j] = acc[x][z];
          if (ti != tj) dA[(long long)j * k + i] = acc[x][z];
        }
      }
      if (tj == 0) db[i] = bacc[x];
    }
  }
}

// A chunk of up to 32 slots of one segment, as the k <= 32 form walks a
// group: lane l holds slot l's column id and b's weight (explicit: the
// rating), and in implicit mode A's weight, both in the compute type.
struct Chunk {
  int s, l0, c;  // segment, first slot, slot count (0: past the group)
  int col;
  float v;  // w_b
  float w;  // w_a (implicit only)
};

template <bool IMPLICIT, bool BF16>
__device__ __forceinline__ Chunk load_chunk(const int* __restrict__ cols,
                                            const float* __restrict__ vals,
                                            const int* __restrict__ rem,
                                            int s, int l0, int s_end, int L,
                                            int lane, float alpha) {
  Chunk ch{s, l0, 0, 0, 0.f, 0.f};
  if (s < s_end) {
    ch.c = min(32, rem[s] - l0);
    const long long at = (long long)s * L + l0 + lane;
    if (lane < ch.c) {
      ch.col = cols[at];
      const float v = vals[at];
      if constexpr (IMPLICIT) {
        const float cv = alpha * fabsf(v);
        ch.w = in_cdt<BF16>(cv);
        ch.v = in_cdt<BF16>(v > 0.f ? 1.f + cv : 0.f);
      } else {
        ch.v = in_cdt<BF16>(v);
      }
    }
  }
  return ch;
}

__device__ __forceinline__ void next_of(const Chunk& ch,
                                        const int* __restrict__ rem, int& s,
                                        int& l0) {
  s = ch.s;
  l0 = ch.l0 + 32;
  if (l0 >= rem[s]) {
    ++s;
    l0 = 0;
  }
}

// Gather a chunk's Y rows into a shared tile without staging them in
// registers (cp.async, 4 bytes a lane, zero-filled past k).
__device__ __forceinline__ void gather_async(float (*tile)[32],
                                             const float* __restrict__ Y,
                                             const Chunk& ch, int k,
                                             int lane) {
  for (int q = 0; q < ch.c; ++q) {
    const int col = __shfl_sync(FULL, ch.col, q);
    const float* src = Y + (long long)col * k + (lane < k ? lane : 0);
    const unsigned dst = (unsigned)__cvta_generic_to_shared(&tile[q][lane]);
    const int bytes = lane < k ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(bytes));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// k <= 32: one warp per group, no block barrier. Rows are padded to 32
// with zeros; lane l owns the 4x8 tile (rows 4·(l/4).., columns 8·(l%4)..)
// of the 32x32 square and row l of b. Two shared tiles per warp: while the
// warp multiplies one chunk, the next one's rows are in flight, and the
// column ids of the one after are loading.
template <bool IMPLICIT, bool VARIANTS, bool BF16>
__global__ void __launch_bounds__(32 * WARPS32) normal_eq_groups32(
    const float* __restrict__ Y, const int* __restrict__ cols,
    const float* __restrict__ vals, const int* __restrict__ rem,
    const int* __restrict__ groups, int n_groups,
    float* __restrict__ partials, float* __restrict__ A,
    float* __restrict__ b, int k, int L, float alpha, int V,
    long long y_stride, int R, int P) {
  __shared__ __align__(16) float ys[WARPS32][2][32][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // variants side by side, as in normal_eq_groups
  const int g = (VARIANTS ? blockIdx.x / V : blockIdx.x) * WARPS32 + warp;
  if (g >= n_groups) return;
  if constexpr (VARIANTS) {
    const int var = blockIdx.x % V;
    Y += var * y_stride;
    partials += (long long)var * P * (k * k + k);
    A += (long long)var * R * k * k;
    b += (long long)var * R * k;
  }
  const int row = groups[g];
  const int seg0 = groups[n_groups + g];
  const int s_end = seg0 + groups[2 * n_groups + g];
  const int slot = groups[3 * n_groups + g];
  const int ti = lane >> 2;
  const int tj = lane & 3;

  float acc[4][8];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
#pragma unroll
    for (int z = 0; z < 8; ++z) acc[x][z] = 0.f;
  }
  float bl = 0.f;

  int s = 0, l0 = 0;
  Chunk cur = load_chunk<IMPLICIT, BF16>(cols, vals, rem, seg0, 0, s_end, L, lane, alpha);
  if (cur.c) gather_async(ys[warp][0], Y, cur, k, lane);
  Chunk nxt{s_end, 0, 0, 0, 0.f, 0.f};
  if (cur.c) {
    next_of(cur, rem, s, l0);
    nxt = load_chunk<IMPLICIT, BF16>(cols, vals, rem, s, l0, s_end, L, lane, alpha);
  }
  for (int n = 0; cur.c; ++n) {
    Chunk after{s_end, 0, 0, 0, 0.f, 0.f};
    if (nxt.c) {
      gather_async(ys[warp][(n + 1) & 1], Y, nxt, k, lane);
      next_of(nxt, rem, s, l0);
      after = load_chunk<IMPLICIT, BF16>(cols, vals, rem, s, l0, s_end, L, lane, alpha);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    float(*sy)[32] = ys[warp][n & 1];
    if constexpr (BF16) {  // each lane rounds the column its own copies wrote
      for (int q = 0; q < cur.c; ++q) sy[q][lane] = round_bf16(sy[q][lane]);
    }
    __syncwarp();
    for (int q = 0; q < cur.c; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(&sy[q][ti * 4]);
      const float4 y0 = *reinterpret_cast<const float4*>(&sy[q][tj * 8]);
      const float4 y1 = *reinterpret_cast<const float4*>(&sy[q][tj * 8 + 4]);
      float av[4] = {a.x, a.y, a.z, a.w};  // w_a·y (explicit: y)
      if constexpr (IMPLICIT) {
        const float w = __shfl_sync(FULL, cur.w, q);
#pragma unroll
        for (int x = 0; x < 4; ++x) av[x] *= w;
      }
      const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
#pragma unroll
        for (int z = 0; z < 8; ++z) acc[x][z] = fmaf(av[x], yv[z], acc[x][z]);
      }
      bl = fmaf(__shfl_sync(FULL, cur.v, q), sy[q][lane], bl);
    }
    __syncwarp();  // this tile's readers are done before it is refilled
    cur = nxt;
    nxt = after;
  }

  float* dA;
  float* db;
  if (slot < 0) {
    dA = A + (long long)row * k * k;
    db = b + (long long)row * k;
  } else {
    dA = partials + (long long)slot * (k * k + k);
    db = dA + k * k;
  }
  // through a shared tile, so the stores to A are coalesced
  float(*sy)[32] = ys[warp][0];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    float4* dst = reinterpret_cast<float4*>(&sy[ti * 4 + x][tj * 8]);
    dst[0] = make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
    dst[1] = make_float4(acc[x][4], acc[x][5], acc[x][6], acc[x][7]);
  }
  __syncwarp();
  if (k == 32) {  // A's rows are the tile's rows: 256 float4, 8 a lane
    const float4* src = reinterpret_cast<const float4*>(&sy[0][0]);
    float4* out = reinterpret_cast<float4*>(dA);
#pragma unroll
    for (int q = 0; q < 8; ++q) out[q * 32 + lane] = src[q * 32 + lane];
  } else {
    for (int e = lane; e < k * k; e += 32) dA[e] = sy[e / k][e % k];
  }
  if (lane < k) db[lane] = bl;
}

// k <= 16: the form sized to the rank (normal_eq.cu's header gives its
// design). The host's plan (ops/normal_eq.py small_form_plan) hands each
// lane a run of units of one variant's row group ti (rows 4ti..4ti+3):
// unit j < min(k, 4ti+4) sums column j of those rows of A, unit
// j = min(k, 4ti+4) their entries of b.
constexpr int SMALL_WARPS = 2;  // warps (= (group, variant batch) pairs) per block
constexpr int SMALL_MAX_K = 16;

struct SmallPlan {
  int VW;        // variants a warp takes (VW·kp <= 32 floats a slot)
  int lane[32];  // v | ti << 8 | j0 << 16 | n << 24: units j0..j0+n-1 of variant v's row group ti
};

template <bool IMPLICIT, bool BF16, int U>
__global__ void __launch_bounds__(32 * SMALL_WARPS) normal_eq_small(
    const float* __restrict__ Y, const int* __restrict__ cols,
    const float* __restrict__ vals, const int* __restrict__ rem,
    const int* __restrict__ groups, int n_groups,
    float* __restrict__ partials, float* __restrict__ A,
    float* __restrict__ b, int k, int L, float alpha, int V,
    long long y_stride, int R, int P, const SmallPlan plan, int vec) {
  extern __shared__ float4 small4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int VW = plan.VW;
  const int kp = (k + 3) & ~3;
  const int row_floats = VW * kp;  // a slot's gathered rows, variant after variant
  float* tiles = reinterpret_cast<float*>(small4) + warp * 2 * 32 * row_floats;
  const int nb = (V + VW - 1) / VW;  // variant batches a group
  const long long w = (long long)blockIdx.x * SMALL_WARPS + warp;
  if (w >= (long long)n_groups * nb) return;
  const int g = (int)(w / nb);
  const int v0 = (int)(w % nb) * VW;
  const int nv = min(VW, V - v0);
  const int row = groups[g];
  const int seg0 = groups[n_groups + g];
  const int s_end = seg0 + groups[2 * n_groups + g];
  const int slot = groups[3 * n_groups + g];

  // the lane's units
  int code = 0;  // a static walk of the table: no indexed copy of the parameter
#pragma unroll
  for (int l = 0; l < 32; ++l)
    if (l == lane) code = plan.lane[l];
  const int lv = code & 0xff, ti = (code >> 8) & 0xff, j0 = (code >> 16) & 0xff;
  const int n_units = lv < nv ? code >> 24 : 0;
  const int cmax = min(k, 4 * ti + 4);
  // every lane runs U units a slot: one with fewer repeats its last (kept
  // only up to n_units), so the slot loop has no divergent branch
  const int jlast = j0 + max(n_units, 1) - 1;
  // the lane's share of a gather: piece r (pw floats) of a slot's
  // row_floats, for slot qq of every spi consecutive slots
  const int pw = vec ? 4 : 1;
  const int pps = row_floats / pw;
  int p2 = 1;
  while (p2 < pps) p2 <<= 1;  // <= 32
  const int spi = 32 / p2;
  const int r = lane & (p2 - 1), qq = lane / p2;
  const int gv = r * pw / kp, ge = r * pw - gv * kp;
  const bool copier = r < pps && gv < nv;
  const float* ysrc = Y + (long long)(v0 + (copier ? gv : 0)) * y_stride + (ge < k ? ge : 0);
  const int bytes = vec ? 16 : (ge < k ? 4 : 0);

  float acc[U][4];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[u][x] = 0.f;
  }

  auto gather = [&](float* tile, const Chunk& ch) {
    for (int q0 = 0; q0 < ch.c; q0 += spi) {
      const int q = q0 + qq;
      const int col = __shfl_sync(FULL, ch.col, q & 31);
      if (copier && q < ch.c) {
        const unsigned dst =
            (unsigned)__cvta_generic_to_shared(tile + q * row_floats + r * pw);
        const float* src = ysrc + (long long)col * k;
        if (vec) {
          asm volatile("cp.async.ca.shared.global [%0], [%1], 16, 16;\n" ::"r"(dst), "l"(src));
        } else {
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                       "r"(bytes));
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  int s = 0, l0 = 0;
  Chunk cur = load_chunk<IMPLICIT, BF16>(cols, vals, rem, seg0, 0, s_end, L, lane, alpha);
  if (cur.c) gather(tiles, cur);
  Chunk nxt{s_end, 0, 0, 0, 0.f, 0.f};
  if (cur.c) {
    next_of(cur, rem, s, l0);
    nxt = load_chunk<IMPLICIT, BF16>(cols, vals, rem, s, l0, s_end, L, lane, alpha);
  }
  for (int n = 0; cur.c; ++n) {
    Chunk after{s_end, 0, 0, 0, 0.f, 0.f};
    if (nxt.c) {
      gather(tiles + ((n + 1) & 1) * 32 * row_floats, nxt);
      next_of(nxt, rem, s, l0);
      after = load_chunk<IMPLICIT, BF16>(cols, vals, rem, s, l0, s_end, L, lane, alpha);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    float* tile = tiles + (n & 1) * 32 * row_floats;
    if constexpr (BF16) {  // each lane rounds the pieces its own copies wrote
      for (int q = qq; q < cur.c; q += spi) {
        if (copier) {
          for (int e = 0; e < pw; ++e) {
            float* at = tile + q * row_floats + r * pw + e;
            *at = round_bf16(*at);
          }
        }
      }
    }
    __syncwarp();
    // eight slots' loads in flight before their FMAs: the loop is bound by
    // shared-memory latency, not by the FMAs
#pragma unroll 8
    for (int q = 0; q < cur.c; ++q) {
      const float wb = __shfl_sync(FULL, cur.v, q);
      float wa = 1.f;
      if constexpr (IMPLICIT) wa = __shfl_sync(FULL, cur.w, q);
      const float* sy = tile + q * row_floats + lv * kp;
      const float4 a4 = *reinterpret_cast<const float4*>(sy + 4 * ti);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};  // y_i, rows 4ti..4ti+3
      float aw[4] = {av[0], av[1], av[2], av[3]};    // w_a·y_i (explicit: y_i)
      if constexpr (IMPLICIT) {
#pragma unroll
        for (int x = 0; x < 4; ++x) aw[x] = av[x] * wa;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = min(j0 + u, jlast);
        const bool isb = j == cmax;
        const float yj = sy[isb ? 0 : j];
        const float o = isb ? wb : yj;  // b: w_b·y_i; A: (w_a·y_i)·y_j
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[u][x] = fmaf(isb ? av[x] : aw[x], o, acc[u][x]);
      }
    }
    __syncwarp();  // this tile's readers are done before it is refilled
    cur = nxt;
    nxt = after;
  }

  // the lower triangle and its mirror, and b, through shared memory (the
  // tiles are idle: every copy has landed), then stored coalesced
  const int E = k * k + k;
  float* sq = tiles;  // [nv][E]: A row-major, then b
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u < n_units) {
      const int j = j0 + u;
      const bool isb = j == cmax;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = 4 * ti + x;
        if (i < k) {
          if (isb) {
            sq[lv * E + k * k + i] = acc[u][x];
          } else if (i >= j) {
            sq[lv * E + i * k + j] = acc[u][x];
            sq[lv * E + j * k + i] = acc[u][x];
          }
        }
      }
    }
  }
  __syncwarp();
  for (int v = 0; v < nv; ++v) {
    const int var = v0 + v;
    float* dA;
    float* db;
    if (slot < 0) {
      dA = A + ((long long)var * R + row) * k * k;
      db = b + ((long long)var * R + row) * k;
    } else {
      dA = partials + ((long long)var * P + slot) * E;
      db = dA + k * k;
    }
    for (int e = lane; e < k * k; e += 32) dA[e] = sq[v * E + e];
    for (int e = lane; e < k; e += 32) db[e] = sq[v * E + k * k + e];
  }
}

// The k <= 16 form's launch: `small` = {U, VW, lane[32]} from the host's
// plan, checked here so that no lane reads outside its warp's tiles.
template <bool IMPLICIT, bool BF16>
cudaError_t launch_small(const float* Y, const int* cols, const float* vals,
                         const int* rem, const int* groups, int n_groups,
                         float* partials, float* A, float* b, int k, int L,
                         float alpha, int V, long long y_stride, int R, int P,
                         const int* small, cudaStream_t stream) {
  if (small == nullptr || k < 1 || k > SMALL_MAX_K || V < 1) return cudaErrorInvalidValue;
  const int U = small[0];
  SmallPlan plan;
  plan.VW = small[1];
  const int kp = (k + 3) & ~3;
  if (plan.VW < 1 || plan.VW * kp > 32) return cudaErrorInvalidValue;
  for (int l = 0; l < 32; ++l) {
    const int c = small[2 + l];
    const int v = c & 0xff, ti = (c >> 8) & 0xff, j0 = (c >> 16) & 0xff, n = (c >> 24) & 0xff;
    if (n > U || (n > 0 && (v >= plan.VW || 4 * ti >= kp || j0 + n > (k < 4 * ti + 4 ? k : 4 * ti + 4) + 1)))
      return cudaErrorInvalidValue;
    plan.lane[l] = c;
  }
  const int vec = (k % 4 == 0) && (reinterpret_cast<unsigned long long>(Y) % 16 == 0) &&
                  (y_stride % 4 == 0);
  const long long warps = (long long)n_groups * ((V + plan.VW - 1) / plan.VW);
  if (warps == 0) return cudaSuccess;
  const long long blocks = (warps + SMALL_WARPS - 1) / SMALL_WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = (size_t)SMALL_WARPS * 2 * 32 * plan.VW * kp * sizeof(float);
#define K1_SMALL(UU)                                                                   \
  normal_eq_small<IMPLICIT, BF16, UU><<<(unsigned)blocks, 32 * SMALL_WARPS, smem, stream>>>( \
      Y, cols, vals, rem, groups, n_groups, partials, A, b, k, L, alpha, V, y_stride, R, P, \
      plan, vec)
  switch (U) {
    case 1: K1_SMALL(1); break;
    case 2: K1_SMALL(2); break;
    case 3: K1_SMALL(3); break;
    case 4: K1_SMALL(4); break;
    case 8: K1_SMALL(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef K1_SMALL
  return cudaGetLastError();
}

__global__ void __launch_bounds__(COMBINE_THREADS) normal_eq_combine(
    const float* __restrict__ partials, const int* __restrict__ c_rows,
    const int* __restrict__ c_start, float* __restrict__ A,
    float* __restrict__ b, int k, int R, int P) {
  const int m = blockIdx.x;
  const int E = k * k + k;
  const int var = blockIdx.z;
  partials += (long long)var * P * E;
  A += (long long)var * R * k * k;
  b += (long long)var * R * k;
  const int e = blockIdx.y * COMBINE_THREADS + threadIdx.x;
  if (e >= E) return;
  const int p1 = c_start[m + 1];
  float s = 0.f;
#pragma unroll 8
  for (int p = c_start[m]; p < p1; ++p) s += partials[(long long)p * E + e];
  const long long row = c_rows[m];
  if (e < k * k) {
    A[row * k * k + e] = s;
  } else {
    b[row * k + (e - k * k)] = s;
  }
}

template <bool IMPLICIT, bool VARIANTS, bool BF16>
cudaError_t launch_groups(const float* Y, const int* cols, const float* vals,
                          const int* rem, const int* groups, int n_groups,
                          float* partials, float* A, float* b, int k, int L,
                          float alpha, int V, long long y_stride, int R, int P,
                          const int* small, cudaStream_t stream) {
  if (k <= SMALL_MAX_K) {
    return launch_small<IMPLICIT, BF16>(Y, cols, vals, rem, groups, n_groups, partials, A, b,
                                        k, L, alpha, V, y_stride, R, P, small, stream);
  }
  if (k <= 32) {
    normal_eq_groups32<IMPLICIT, VARIANTS, BF16>
        <<<((n_groups + WARPS32 - 1) / WARPS32) * V, 32 * WARPS32, 0, stream>>>(
            Y, cols, vals, rem, groups, n_groups, partials, A, b, k, L, alpha,
            V, y_stride, R, P);
    return cudaGetLastError();
  }
  const int T = (k + 3) / 4;
  const int NT = T * (T + 1) / 2;
  const int tpb = NT < THREADS ? NT : THREADS;
  const int SG = THREADS / tpb;
  const size_t smem = (size_t)(CH * 4 * T + 2 * CH) * sizeof(float) +
                      (size_t)(SG - 1) * tpb * RED * sizeof(float);
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        normal_eq_groups<IMPLICIT, VARIANTS, BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(n_groups * V, (NT + tpb - 1) / tpb);
  normal_eq_groups<IMPLICIT, VARIANTS, BF16><<<grid, THREADS, smem, stream>>>(
      Y, cols, vals, rem, groups, n_groups, partials, A, b, k, L, T, tpb, SG,
      alpha, V, y_stride, R, P);
  return cudaGetLastError();
}

// Both kernels for V variants on `stream`; returns cudaGetLastError().
// Variant v reads Y + v·y_stride and writes A + v·R·k², b + v·R·k and
// its P partial slots at partials + v·P·(k²+k). The plan is shared;
// `small` is the k <= 16 form's lane plan ({U, VW, lane[32]}; unread
// above k = 16). VARIANTS = false (K1: V = 1) compiles the larger forms'
// group kernels without the variant arithmetic; BF16 computes in the
// reference's bfloat16.
template <bool VARIANTS, bool BF16>
cudaError_t launch(const float* Y, const int* cols, const float* vals,
                   const int* rem, const int* groups, int n_groups,
                   const int* c_rows, const int* c_start, int n_combine,
                   float* partials, float* A, float* b, int k, int L,
                   int implicit, float alpha, int V, long long y_stride, int R,
                   int P, const int* small, cudaStream_t stream) {
  cudaError_t err =
      implicit
          ? launch_groups<true, VARIANTS, BF16>(Y, cols, vals, rem, groups,
                                                n_groups, partials, A, b, k,
                                                L, alpha, V, y_stride, R, P,
                                                small, stream)
          : launch_groups<false, VARIANTS, BF16>(Y, cols, vals, rem, groups,
                                                 n_groups, partials, A, b, k,
                                                 L, alpha, V, y_stride, R, P,
                                                 small, stream);
  if (err != cudaSuccess || n_combine == 0) return err;
  dim3 grid2(n_combine, (k * k + k + COMBINE_THREADS - 1) / COMBINE_THREADS, V);
  normal_eq_combine<<<grid2, COMBINE_THREADS, 0, stream>>>(
      partials, c_rows, c_start, A, b, k, R, P);
  return cudaGetLastError();
}

}  // namespace k1

