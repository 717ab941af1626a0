// The tile pass shared by the serving top-n kernels (K3, csrc/topn.cu, and
// the retriever's stage 1, csrc/masked_topn.cu): score one tile of TILE
// items for a group of WARPS query rows and write each row's best m of the
// tile, sorted, as a candidate list for the merge pass (topn_select.cuh).
//
// masked_tile_topm<PREC>: one block per (item tile of 256, group of 8 query
// rows), Y's tile staged through shared memory KC rank columns at a time
// with coalesced loads, so each Y byte is read from device memory once per
// query group; a warp per query row, 8 items per lane, the query element
// broadcast by shuffle. The score producer is templated:
//   PREC_F32:  fp32 FMAs on the CUDA cores, never TF32, over the rank in
//              order (float4 reads of the staged rows).
//   PREC_BF16: the query rounded to bf16 (round to nearest even); the bf16
//              rows widened exactly; the same fp32 FMAs.
//   PREC_I8:   per query row qs = max|q|/127 (1.0 when that is 0; IEEE
//              division: the libraries are built without --use_fast_math),
//              qi = clamp(rint(q/qs), -127, 127) (half to even), int8 x int8
//              products summed in int32 with __dp4a (exact), then
//              (float)acc * qs * scale[j], in that order.
// Then the epilogue (* rn[j] when normalize; the candidacy bit of the row's
// [ceil(N/32)] mask words, every item a candidate when bits is null;
// positive_only as s > 0; -inf with the real id for a masked item) and the
// tile's best m by warp_take_topm. No block barrier follows the scoring.
// K3 launches PREC_F32 with bits null and both flags 0. With QOFF (K3c's
// chained passes, PREC_F32 only) every query element is q + q_off as it is
// loaded, rounded once (__fadd_rn: never contracted into the products).

#pragma once

#include <cuda_bf16.h>

#include "topn_select.cuh"

namespace topn_select {

constexpr int PREC_F32 = 0, PREC_BF16 = 1, PREC_I8 = 2;
constexpr int KC = 32;       // rank columns staged per chunk
constexpr int KS = KC + 4;   // staged float row stride (float4-aligned)
constexpr int KW = KC / 4;   // int8: packed 4-byte words per chunk row
constexpr int KSW = KW + 1;  // int8: staged word row stride (odd: no bank
                             // conflicts across a warp's 32 rows)

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int PREC, bool QOFF = false>
__global__ void __launch_bounds__(THREADS)
masked_tile_topm(const float* __restrict__ q, const void* __restrict__ Yv,
                 const float* __restrict__ scale, const float* __restrict__ rn,
                 const unsigned* __restrict__ bits, int W32,
                 float* __restrict__ cand_s, int* __restrict__ cand_i,
                 int B, int N, int k, int m, long long list_stride,
                 int normalize, int positive_only, float q_off) {
  static_assert(!QOFF || PREC == PREC_F32, "a query offset is K3c's, f32 only");
  __shared__ __align__(16) float ys[TILE * KS];  // int8: packed words
  const int tid = threadIdx.x, lane = tid & 31;
  const int row = blockIdx.y * WARPS + (tid >> 5);
  const bool row_live = row < B;
  const long long item0 = (long long)blockIdx.x * TILE;
  const float* qrow = q + (long long)row * k;
  const long long base = (long long)row * list_stride + (long long)blockIdx.x * m;
  if (sentinel_tile(item0, N, row_live, lane, m, cand_s, cand_i, base)) return;

  float s[PER_LANE];  // scores of items item0 + lane + 32·t
  int id[PER_LANE];
  if constexpr (PREC == PREC_I8) {
    const int8_t* Y = static_cast<const int8_t*>(Yv);
    int* yw = reinterpret_cast<int*>(ys);
    // the row's quantization scale: max|q| over the rank, by the warp
    float amax = 0.f;
    if (row_live)
      for (int c = lane; c < k; c += 32) amax = fmaxf(amax, fabsf(qrow[c]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, off));
    float qs = amax / 127.0f;
    if (!(qs > 0.f)) qs = 1.0f;
    int acc[PER_LANE];
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) acc[t] = 0;
    // whole 4-byte loads when every chunk row starts 4-byte aligned
    const bool whole_words = (k & 3) == 0 && ((uintptr_t)Yv & 3) == 0;
    for (int c0 = 0; c0 < k; c0 += KC) {
      const int kc = min(KC, k - c0);
      const int nw = (kc + 3) >> 2;
      __syncthreads();  // the previous chunk's readers are done
      for (int e = tid; e < TILE * nw; e += THREADS) {
        const int r = e / nw, w = e - r * nw;
        const long long it = item0 + r;
        int word = 0;
        if (it < N) {
          const int8_t* src = Y + it * k + c0 + 4 * w;
          if (whole_words) {
            word = *reinterpret_cast<const int*>(src);
          } else {
            for (int b = 0; b < 4 && 4 * w + b < kc; ++b)
              word |= (int)(uint8_t)src[b] << (8 * b);
          }
        }
        yw[r * KSW + w] = word;
      }
      // lane w holds the quantized query's word for columns c0+4w..c0+4w+3
      int qw = 0;
      if (row_live && lane < nw) {
        for (int b = 0; b < 4 && 4 * lane + b < kc; ++b) {
          const float v = rintf(qrow[c0 + 4 * lane + b] / qs);
          const int qi = (int)fminf(fmaxf(v, -127.f), 127.f);
          qw |= (qi & 0xff) << (8 * b);
        }
      }
      __syncthreads();
      for (int w = 0; w < nw; ++w) {
        const int qword = __shfl_sync(FULL, qw, w);
#pragma unroll
        for (int t = 0; t < PER_LANE; ++t)
          acc[t] = __dp4a(yw[(lane + 32 * t) * KSW + w], qword, acc[t]);
      }
    }
    if (!row_live) return;  // no block barrier follows
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const long long it = item0 + lane + 32 * t;
      s[t] = it < N ? (float)acc[t] * qs * scale[it] : 0.f;
    }
  } else {
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) s[t] = 0.f;
    for (int c0 = 0; c0 < k; c0 += KC) {
      const int kc = min(KC, k - c0);
      const int kc4 = (kc + 3) & ~3;  // zero-padded to whole float4s
      __syncthreads();  // the previous chunk's readers are done
      for (int e = tid; e < TILE * kc4; e += THREADS) {
        const int r = e / kc4, c = e - r * kc4;
        const long long it = item0 + r;
        float v = 0.f;
        if (c < kc && it < N) {
          if constexpr (PREC == PREC_F32) {
            v = static_cast<const float*>(Yv)[it * k + c0 + c];
          } else {  // bf16 -> f32 is exact: the bits shifted up
            const unsigned short u =
                static_cast<const unsigned short*>(Yv)[it * k + c0 + c];
            v = __uint_as_float((unsigned)u << 16);
          }
        }
        ys[r * KS + c] = v;
      }
      // lane c holds q[row, c0 + c], zero past the chunk and for rows past B
      float qc = (row_live && lane < kc) ? qrow[c0 + lane] : 0.f;
      if constexpr (QOFF) {
        if (row_live && lane < kc) qc = __fadd_rn(qc, q_off);
      }
      if constexpr (PREC == PREC_BF16) qc = bf16_round(qc);
      __syncthreads();
      for (int c = 0; c < kc4; c += 4) {
        const float q0 = __shfl_sync(FULL, qc, c);
        const float q1 = __shfl_sync(FULL, qc, c + 1);
        const float q2 = __shfl_sync(FULL, qc, c + 2);
        const float q3 = __shfl_sync(FULL, qc, c + 3);
#pragma unroll
        for (int t = 0; t < PER_LANE; ++t) {
          const float4 y =
              *reinterpret_cast<const float4*>(&ys[(lane + 32 * t) * KS + c]);
          s[t] = fmaf(q0, y.x, s[t]);
          s[t] = fmaf(q1, y.y, s[t]);
          s[t] = fmaf(q2, y.z, s[t]);
          s[t] = fmaf(q3, y.w, s[t]);
        }
      }
    }
    if (!row_live) return;  // no block barrier follows
  }

  // epilogue: cosine scaling, the candidacy bit (every item a candidate
  // when bits is null), positive_only, -inf with the real id for a masked
  // item, (-inf, SENTINEL_ID) past the catalog
  const unsigned* rbits = bits ? bits + (long long)row * W32 : nullptr;
#pragma unroll
  for (int t = 0; t < PER_LANE; ++t) {
    const long long it = item0 + lane + 32 * t;
    if (it < N) {
      float v = s[t];
      if (normalize) v = v * rn[it];
      bool ok = !rbits || ((rbits[it >> 5] >> (it & 31)) & 1u);
      if (positive_only) ok = ok && v > 0.f;
      s[t] = ok ? v : -INFINITY;
      id[t] = (int)it;
    } else {
      s[t] = -INFINITY;
      id[t] = SENTINEL_ID;
    }
  }
  warp_take_topm(s, id, m, lane, cand_s, cand_i, base);
}

}  // namespace topn_select
