// K1's kernels (csrc/normal_eq.cu says what they compute, their bound and
// their design), with a variant axis: V factor matrices Y[v] against one
// shared packed side and group plan, each variant's systems summed in
// exactly K1's order. normal_eq.cu launches them with V = 1; grid.cu's
// K13a (the regularizer grid) with V variants. Three forms by rank:
// normal_eq_small (k <= 16: sized to the rank, a group's variants in one
// warp, lanes on the lower triangle and b only), normal_eq_mma
// (17 <= k <= 32: A from warp MMAs on bfloat16-split operands, a variant's
// group a warp) and normal_eq_groups (k > 32: a block a group). BF16 is
// the reference's bfloat16 compute (bf16.cuh): the weights are rounded
// where the reference casts them, and the rows once: normal_eq_mma
// gathers the caller's bfloat16 copy of Y, the other forms round each
// gathered row as it lands in shared memory.
#pragma once

#include <cuda_runtime.h>

#include "bf16.cuh"
#include "tiling.cuh"

namespace k1 {

constexpr int THREADS = 256;
constexpr int CH = 64;  // gathered slots staged per round
constexpr int COMBINE_THREADS = 256;
constexpr int RED = 20;  // floats a thread hands over in the slot-group sum
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

// A chunk of up to 32 slots of one segment, as the k <= 16 form walks a
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

// 17 <= k <= 32: the warp-MMA form (normal_eq.cu's header gives its design
// and its exactness argument). A block of one warp per group, so a block
// ends with its group; rows staged in two shared tiles, one multiplied
// while the next lands.
constexpr int MMA_STAGES = 2;
constexpr int LDF = 36;  // floats between staged float32 rows (16-byte rows, conflict-free reads)
constexpr int LDH = 40;  // entries between staged bfloat16 rows (80 bytes)

// (x0, x1) rounded to bfloat16 (nearest, ties to even), packed x0 low: an
// MMA operand register holding two consecutive slots
__device__ __forceinline__ unsigned pack_bf16(float x0, float x1) {
  unsigned p;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(p) : "f"(x1), "f"(x0));
  return p;
}
__device__ __forceinline__ float bf16_lo(unsigned p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float bf16_hi(unsigned p) { return __uint_as_float(p & 0xffff0000u); }

// x = h + m + l exactly, each a packed bfloat16 pair (both subtractions are
// exact; normal_eq.cu states the range)
__device__ __forceinline__ void split3(float x0, float x1, unsigned& h, unsigned& m,
                                       unsigned& l) {
  h = pack_bf16(x0, x1);
  const float r0 = x0 - bf16_lo(h), r1 = x1 - bf16_hi(h);
  m = pack_bf16(r0, r1);
  l = pack_bf16(r0 - bf16_lo(m), r1 - bf16_hi(m));
}

// x = h + l exactly where x has at most 16 significant bits (the product
// of two bfloat16 values)
__device__ __forceinline__ void split2(float x0, float x1, unsigned& h, unsigned& l) {
  h = pack_bf16(x0, x1);
  l = pack_bf16(x0 - bf16_lo(h), x1 - bf16_hi(h));
}

// d += a·b over one m16n8k16 tile: a 16 x 16 and b 16 x 8 bfloat16, d float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The products of a chunk's sums, (part of w_a·y, part of y), small first.
// float32: y = h + m + l and w_a·y the same (explicit: the same parts),
// all but the three smallest products; bfloat16 explicit: y alone;
// implicit: w_a·y = hi + lo exactly.
template <bool IMPLICIT, bool BF16>
struct MmaParts {
  static constexpr int NB = BF16 ? 1 : 3;           // parts of y
  static constexpr int NA = BF16 ? (IMPLICIT ? 2 : 1) : 3;  // parts of w_a·y
  static constexpr int NP = BF16 ? NA : 6;          // products
  // one-warp blocks resident an SM, a register cap: the bfloat16 forms
  // run faster at 21 (<= 96 registers), float32 explicit at 18, float32
  // implicit uncapped (more blocks spill it)
  static constexpr int MIN_BLOCKS = BF16 ? 21 : IMPLICIT ? 1 : 18;
  __device__ static constexpr int a(int p) {
    return BF16 ? NA - 1 - p : (p == 0 ? 2 : p == 1 ? 0 : p == 2 ? 1 : p == 3 ? 1 : 0);
  }
  __device__ static constexpr int b(int p) {
    return BF16 ? 0 : (p == 0 ? 0 : p == 1 ? 2 : p == 2 ? 1 : p == 3 ? 0 : p == 4 ? 1 : 0);
  }
};

// A chunk of up to 32 slots of one segment as the warp-MMA form walks a
// group: s is the segment's index in the group; lane l holds slot l's
// column id and rating as loaded.
struct MmaChunk {
  int s, l0, c;  // segment, first slot, slot count (0: past the group)
  int col;
  float v;
};

// The m16n8 tiles that touch A's lower triangle in a 32 x 32 square: m-tile
// 0 against n-tiles 0-1, m-tile 1 against n-tiles 0-3 (tile 5 only past
// k = 24).
constexpr int MMA_TILES = 6;
__device__ __forceinline__ constexpr int tile_m(int t) { return t < 2 ? 0 : 1; }
__device__ __forceinline__ constexpr int tile_n(int t) { return t < 2 ? t : t - 2; }

template <bool IMPLICIT, bool VARIANTS, bool BF16>
__global__ void __launch_bounds__(32, MmaParts<IMPLICIT, BF16>::MIN_BLOCKS) normal_eq_mma(
    const float* __restrict__ Y, const unsigned short* __restrict__ Yh, int kh,
    long long yh_stride, const int* __restrict__ cols, const float* __restrict__ vals,
    const int* __restrict__ rem, const int* __restrict__ groups, int n_groups,
    float* __restrict__ partials, float* __restrict__ A, float* __restrict__ b, int k, int L,
    float alpha, int V, long long y_stride, int R, int P, int vec) {
  using Parts = MmaParts<IMPLICIT, BF16>;
  constexpr int S = MMA_STAGES;
  // a staged chunk: 32 rows of Y (float32) or of its bfloat16 copy
  constexpr int TILE = BF16 ? 32 * LDH * 2 : 32 * LDF * 4;
  static_assert(S * TILE >= 32 * LDF * 4, "the output square fits the staged tiles");
  __shared__ __align__(16) unsigned char tiles[S * TILE];
  __shared__ __align__(16) float wts[2][32];  // the chunk's w_b and w_a, read as broadcasts
  const int lane = threadIdx.x;
  // variants side by side, as in normal_eq_groups
  const int g = VARIANTS ? blockIdx.x / V : blockIdx.x;
  if constexpr (VARIANTS) {
    const int var = blockIdx.x % V;
    Y += var * y_stride;
    Yh += var * yh_stride;
    partials += (long long)var * P * (k * k + k);
    A += (long long)var * R * k * k;
    b += (long long)var * R * k;
  }
  const int row = groups[g];
  const int seg0 = groups[n_groups + g];
  const int nseg = groups[2 * n_groups + g];
  const int slot = groups[3 * n_groups + g];
  const int fr = lane >> 2;  // the lane's fragment row (an MMA "group")
  const int fc = lane & 3;   // and column pair

  // zeros past k: a row gather writes only its own entries
  {
    float4* z = reinterpret_cast<float4*>(tiles);
    for (int e = lane; e < S * TILE / 16; e += 32) z[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncwarp();
  }

  // the group's segment lengths, segment q's in lane q (a plan group has
  // GROUP_SEGMENTS = 8; past 32 the walk reads rem itself)
  const int my_rem = lane < nseg ? rem[seg0 + lane] : 0;
  auto rem_of = [&](int si) { return si < 32 ? __shfl_sync(FULL, my_rem, si) : rem[seg0 + si]; };
  // the chunk at (segment si of the group, slot l0): its slot count, and
  // lane l's slot's column id and rating as loaded (the weights are formed
  // where they are used, so nothing waits on these loads until then)
  auto load = [&](int si, int l0) {
    MmaChunk ch{si, l0, 0, 0, 0.f};
    if (si < nseg) {
      ch.c = min(32, rem_of(si) - l0);
      if (lane < ch.c) {
        const long long at = (long long)(seg0 + si) * L + l0 + lane;
        ch.col = cols[at];
        ch.v = vals[at];
      }
    }
    return ch;
  };
  // the position after a chunk with slots
  auto advance = [&](const MmaChunk& ch, int& si, int& l0) {
    si = ch.s;
    l0 = ch.l0 + 32;
    if (l0 >= rem_of(si)) {
      ++si;
      l0 = 0;
    }
  };

  // Y's entry (slot q, feature f) of a staged chunk, widened to float
  auto at = [&](const unsigned char* tile, int q, int f) -> float {
    if constexpr (BF16) {
      return __uint_as_float((unsigned)reinterpret_cast<const unsigned short*>(tile)[q * LDH + f]
                             << 16);
    } else {
      return reinterpret_cast<const float*>(tile)[q * LDF + f];
    }
  };

  // a chunk's rows into a tile with cp.async, as one commit group (empty
  // past the group's last chunk); the rows past the chunk's slots are
  // zero-filled, so a chunk's 32 rows are summed whole. 16 bytes a lane
  // (bfloat16 rows always, kh a multiple of 8; float32 rows where k is a
  // multiple of 4), else 4 bytes a lane, zero-filled past k.
  auto gather = [&](unsigned char* tile, const MmaChunk& ch) {
    if (ch.c) {
      if (BF16 || vec) {
        constexpr int LPR = BF16 ? 4 : 8;  // lanes a row, 16 bytes each
        constexpr int PER = BF16 ? 8 : 4;  // entries a piece
        const int piece = lane & (LPR - 1);
        const bool copier = piece * PER < (BF16 ? kh : k);
#pragma unroll
        for (int q0 = 0; q0 < 32; q0 += 32 / LPR) {
          const int q = q0 + lane / LPR;
          const int col = __shfl_sync(FULL, ch.col, q);
          if (copier) {
            const bool real = q < ch.c;
            const unsigned dst = (unsigned)__cvta_generic_to_shared(
                tile + (BF16 ? (q * LDH + piece * PER) * 2 : (q * LDF + piece * PER) * 4));
            const long long row = real ? col : 0;
            const void* src = BF16 ? (const void*)(Yh + row * kh + piece * PER)
                                   : (const void*)(Y + row * k + piece * PER);
            asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                         "r"(real ? 16 : 0));
          }
        }
      } else {
        for (int q = 0; q < 32; ++q) {
          const int col = __shfl_sync(FULL, ch.col, q);
          const bool real = q < ch.c && lane < k;
          const float* src = Y + (real ? (long long)col * k + lane : 0);
          const unsigned dst = (unsigned)__cvta_generic_to_shared(tile + (q * LDF + lane) * 4);
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                       "r"(real ? 4 : 0));
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[MMA_TILES][4];
#pragma unroll
  for (int t = 0; t < MMA_TILES; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  }
  float bl = 0.f;
  const int n_tiles = k > 24 ? MMA_TILES : MMA_TILES - 1;

  // q[0] is multiplied while the rows of q[1..S-1] land (q[S-1]'s asked for
  // at the top of the loop) and the ids and ratings of q[S] load
  MmaChunk q[S + 1];
  int si = 0, l0 = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    q[j] = load(si, l0);
    if (q[j].c) advance(q[j], si, l0);
  }
#pragma unroll
  for (int j = 0; j < S - 1; ++j) gather(tiles + j * TILE, q[j]);
  int put = S - 1, take = 0;  // the tiles the next gather fills and this chunk reads
  while (q[0].c) {
    gather(tiles + put * TILE, q[S - 1]);
    q[S] = load(si, l0);
    if (q[S].c) advance(q[S], si, l0);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 1));
    __syncwarp();
    const unsigned char* tile = tiles + take * TILE;
    const MmaChunk& cur = q[0];
    // the slots' weights in the compute type (0 past the chunk)
    {
      float wa = 0.f, wb = 0.f;
      if (lane < cur.c) {
        if constexpr (IMPLICIT) {
          const float cv = alpha * fabsf(cur.v);
          wa = in_cdt<BF16>(cv);
          wb = in_cdt<BF16>(cur.v > 0.f ? 1.f + cv : 0.f);
        } else {
          wb = in_cdt<BF16>(cur.v);
        }
      }
      wts[0][lane] = wb;
      wts[1][lane] = wa;
      __syncwarp();
    }

    // b on the CUDA cores: lane i sums w_b·y_i over the slots in order; a
    // zero-filled slot past the chunk adds fmaf(0, 0, b) = b, so the loop
    // has no branch and its loads run ahead of the chain
#pragma unroll
    for (int qq = 0; qq < 32; ++qq) bl = fmaf(wts[0][qq], at(tile, qq, lane), bl);

    // A: this chunk's products into fresh fragments (M = i, N = j, K = the
    // slots), then added to the running sums
    float d[MMA_TILES][4];
#pragma unroll
    for (int t = 0; t < MMA_TILES; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[t][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      if (16 * ks >= cur.c) break;
      // the lane's slots 16ks + 2fc + {0, 1} (r = 0) and + {8, 9} (r = 1),
      // at features fr + 8·nt (slots past the chunk are zero rows)
      unsigned yb[Parts::NB][4][2];  // y's parts, packed slot pairs
      unsigned wy[Parts::NA][4][2];  // w_a·y's parts (implicit)
      if constexpr (BF16) {
        // the staged bits are the operand's: each ldmatrix.trans hands the
        // warp four 8 x 8 blocks (slots x features) as packed slot pairs
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int m = lane >> 3;  // the block whose row this lane addresses
          const unsigned addr = (unsigned)__cvta_generic_to_shared(
              tile + ((16 * ks + 8 * (m & 1) + (lane & 7)) * LDH + 8 * (2 * p + (m >> 1))) * 2);
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(yb[0][2 * p][0]), "=r"(yb[0][2 * p][1]), "=r"(yb[0][2 * p + 1][0]),
                         "=r"(yb[0][2 * p + 1][1])
                       : "r"(addr));
        }
        if constexpr (IMPLICIT) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int qs = 16 * ks + 2 * fc + 8 * r;
            const float w0 = wts[1][qs], w1 = wts[1][qs + 1];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              split2(__fmul_rn(w0, bf16_lo(yb[0][nt][r])), __fmul_rn(w1, bf16_hi(yb[0][nt][r])),
                     wy[0][nt][r], wy[1][nt][r]);
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qs = 16 * ks + 2 * fc + 8 * r;
          float w0 = 1.f, w1 = 1.f;
          if constexpr (IMPLICIT) {
            w0 = wts[1][qs];
            w1 = wts[1][qs + 1];
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int f = fr + 8 * nt;
            const float y0 = at(tile, qs, f);
            const float y1 = at(tile, qs + 1, f);
            split3(y0, y1, yb[0][nt][r], yb[1][nt][r], yb[2][nt][r]);
            if constexpr (IMPLICIT) split3(__fmul_rn(w0, y0), __fmul_rn(w1, y1), wy[0][nt][r],
                                           wy[1][nt][r], wy[2][nt][r]);
          }
        }
      }
      // operand A's parts: w_a·y's, or y's own where w_a = 1
      auto a_part = [&](int pa) -> const unsigned(&)[4][2] {
        if constexpr (IMPLICIT) {
          return wy[pa];
        } else {
          return yb[pa];
        }
      };
      // product after product, each over the tiles: neighbouring MMAs
      // into different fragments
#pragma unroll
      for (int p = 0; p < Parts::NP; ++p) {
        const unsigned(&op)[4][2] = a_part(Parts::a(p));
        const int pb = Parts::b(p);
#pragma unroll
        for (int t = 0; t < MMA_TILES; ++t) {
          if (t < n_tiles) {
            // operand A's rows 16mt + fr (+ 8), its columns the slot pairs
            const int mt = tile_m(t), nt = tile_n(t);
            mma_bf16(d[t], op[2 * mt][0], op[2 * mt + 1][0], op[2 * mt][1], op[2 * mt + 1][1],
                     yb[pb][nt][0], yb[pb][nt][1]);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < MMA_TILES; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] += d[t][e];
    }
    __syncwarp();  // this tile's readers are done before it is refilled
#pragma unroll
    for (int j = 0; j < S; ++j) q[j] = q[j + 1];
    put = put + 1 == S ? 0 : put + 1;
    take = take + 1 == S ? 0 : take + 1;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);  // the empty groups past the last chunk

  float* dA;
  float* db;
  if (slot < 0) {
    dA = A + (long long)row * k * k;
    db = b + (long long)row * k;
  } else {
    dA = partials + (long long)slot * (k * k + k);
    db = dA + k * k;
  }
  // the lower triangle and its mirror through a shared square over the
  // tiles (every copy has landed), so the stores to A are coalesced
  __syncwarp();
  float* sq = reinterpret_cast<float*>(tiles);  // [32][LDF]
#pragma unroll
  for (int t = 0; t < MMA_TILES; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 16 * tile_m(t) + fr + 8 * (e >> 1);
      const int j = 8 * tile_n(t) + 2 * fc + (e & 1);
      if (i >= j) {
        sq[i * LDF + j] = acc[t][e];
        sq[j * LDF + i] = acc[t][e];
      }
    }
  }
  __syncwarp();
  if (k == 32) {  // A's rows are the square's rows: 256 float4, 8 a lane
    float4* out = reinterpret_cast<float4*>(dA);
#pragma unroll
    for (int e8 = 0; e8 < 8; ++e8) {
      const int e = e8 * 32 + lane;
      out[e] = *reinterpret_cast<const float4*>(sq + (e >> 3) * LDF + 4 * (e & 7));
    }
  } else {
    for (int e = lane; e < k * k; e += 32) dA[e] = sq[(e / k) * LDF + e % k];
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
cudaError_t launch_groups(const float* Y, const void* Yh, const int* cols, const float* vals,
                          const int* rem, const int* groups, int n_groups,
                          float* partials, float* A, float* b, int k, int L,
                          float alpha, int V, long long y_stride, int R, int P,
                          const int* small, cudaStream_t stream) {
  if (k <= SMALL_MAX_K) {
    return launch_small<IMPLICIT, BF16>(Y, cols, vals, rem, groups, n_groups, partials, A, b,
                                        k, L, alpha, V, y_stride, R, P, small, stream);
  }
  if (k <= 32) {
    // the bfloat16 rows: [V, n, kh], kh = k rounded up to 8, 16-byte aligned
    const int kh = (k + 7) & ~7;
    long long yh_stride = 0;
    if constexpr (BF16) {
      if (Yh == nullptr || reinterpret_cast<unsigned long long>(Yh) % 16 != 0 || y_stride % k != 0)
        return cudaErrorInvalidValue;
      yh_stride = y_stride / k * kh;
    }
    const int vec = (k % 4 == 0) && (reinterpret_cast<unsigned long long>(Y) % 16 == 0) &&
                    (y_stride % 4 == 0);
    const long long blocks = (long long)n_groups * V;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    normal_eq_mma<IMPLICIT, VARIANTS, BF16><<<(unsigned)blocks, 32, 0, stream>>>(
        Y, static_cast<const unsigned short*>(Yh), kh, yh_stride, cols, vals, rem, groups,
        n_groups, partials, A, b, k, L, alpha, V, y_stride, R, P, vec);
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
// above k = 16). Yh is Y rounded to bfloat16 with rows padded with zeros
// to kh = k rounded up to 8 entries, variant v at Yh + v·(y_stride/k)·kh,
// 16-byte aligned: read (and required) only where BF16 and
// 17 <= k <= 32. VARIANTS = false (K1: V = 1) compiles the larger forms'
// group kernels without the variant arithmetic; BF16 computes in the
// reference's bfloat16.
template <bool VARIANTS, bool BF16>
cudaError_t launch(const float* Y, const void* Yh, const int* cols, const float* vals,
                   const int* rem, const int* groups, int n_groups,
                   const int* c_rows, const int* c_start, int n_combine,
                   float* partials, float* A, float* b, int k, int L,
                   int implicit, float alpha, int V, long long y_stride, int R,
                   int P, const int* small, cudaStream_t stream) {
  cudaError_t err =
      implicit
          ? launch_groups<true, VARIANTS, BF16>(Y, Yh, cols, vals, rem, groups,
                                                n_groups, partials, A, b, k,
                                                L, alpha, V, y_stride, R, P,
                                                small, stream)
          : launch_groups<false, VARIANTS, BF16>(Y, Yh, cols, vals, rem, groups,
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

