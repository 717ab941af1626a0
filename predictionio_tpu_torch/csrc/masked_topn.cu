// Kernel A: the retriever's masked score + top-m, packed — the hand-written
// Hopper kernels that replace the reference's jitted programs
// predictionio_tpu/ops/retrieval.py:280 _fused_topn_single (K9, with
// _mask_scores :164) and the stage-1 half of :343 _fused_topn_single_2s
// (K10: :295 _approx_scores, the mask, the top-(shortlist) selection).
//
// What it computes. q [B,k] f32 and the resident rows Y [N,k] (f32, bf16,
// or int8 with one f32 scale per row); per query row the best m items by
//   score = producer(q, y_j)  [* rn[j] when normalize]
// over the items the candidacy mask allows, ordered by (score descending,
// item id ascending) — lax.top_k's order — packed into out [B, 2m] f32: the
// m scores, then the m int32 ids as raw bits. A masked item scores -inf
// and keeps its real id, so when fewer than m items are live the -inf
// slots carry the lowest masked ids, as lax.top_k gives them.
//
// Score producers (one code path, templated):
//   f32:  fp32 FMAs on the CUDA cores, never TF32.
//   bf16: the query rounded to bf16 (round to nearest even); the bf16
//         rows widened exactly; fp32 FMAs (every product is exact in f32).
//   int8: per query row qs = max|q|/127 (1.0 when that is 0; IEEE
//         division: the library is built without --use_fast_math),
//         qi = clamp(rint(q/qs), -127, 127) (half to even, as jnp.round),
//         int8 x int8 products summed in int32 with __dp4a (exact), then the
//         epilogue (float)acc * qs * scale[j], in that order. The int32
//         sums are exact, so these scores equal the plain twin's bit for
//         bit.
//
// Two kernels:
//   candidate_mask: one block per (query row, 8,192 items) builds that
//     stretch of the row's [ceil(N/32)] bit mask in shared memory: the
//     resident allow0 bytes packed by warp ballots (all clear for a row
//     with an include list), then the row's include ids in its stretch set
//     (where allow0 allows them), then its exclude ids cleared, then the
//     words written out. Ids outside [0, N) are dropped, as the
//     reference's mode="drop" scatter drops its sentinel n_pad.
//   masked_tile_topm (tile_topm.cuh, the tile pass K3 launches too), the
//     producer templated: one block per (item tile of 256, group of 8 query rows),
//     Y's tile staged through shared memory 32 rank columns at a time, a
//     warp per query row, 8 items per lane; then the epilogue (* rn, the
//     mask bit, positive_only as s > 0 on the stage-1 score, -inf with the
//     real id) and the tile's best m: extracted one by one for m <= 32,
//     else the whole tile sorted by a warp bitonic network. Then K3's merge
//     pass (topn_select.cuh), in levels where a row's lists do not fit one
//     block's shared memory: a shortlist of m=256 over 50,000 items is 256
//     lists of 256 per row, so groups of 32 lists merge on chip, a block
//     per group, before one block per row merges the rest.
//
// Bound on an H100 SXM at the quantized catalog's shape (N=50,000, k=64,
// B=64, m=64): the int8 rows are 3.2 MB, ≈1 µs at 3.35 TB/s, and the
// products are 2·B·N·k = 410 M integer operations, ≈0.2 µs at the int8
// tensor-core rate; the f32 tier's 2·B·N·k FLOPs on the CUDA cores
// (67 TFLOP/s) take ≈6 µs. This first form does the products on the CUDA
// cores (__dp4a for int8) and re-reads each Y tile once per group of 8
// query rows; wgmma (int8 and bf16 tensor cores) and a selection that
// prunes by a running threshold are later work.
//
// Traps (the retriever, ops/retrieval.py, passes these widths):
//   - Two shortlist widths. ItemRetriever.topn asks for
//     n_dev = _shortlist_width(n, n_items) and runs this kernel with
//     m = _shortlist_width(n_dev, n_pad): for n=16 and c=4, 64 then 256.
//     Both clamp to the catalog. The widths decide which items survive,
//     so they must be the reference's exactly.
//   - Query rows of zeros give every item score 0 in every tier (qs = 1,
//     qi = 0), so the answer is items 0..m-1, as K3 gives.
// Correct for every 1 <= m <= N, any N, any k, and exact ties.
//
// Row shards (the reference's mesh path, :397 _shard_topk_kernel and the
// stage 1 of :366 _shard_topk_kernel_2s). A shard holds the catalog rows
// [off, off + N) and sees the query's GLOBAL id lists: candidate_mask
// takes id_offset = off and keeps an id g only where g - off lies in
// [0, N) (computed in unsigned arithmetic, so ids of other shards and
// negative ids wrap out of range), as the reference's `localize` maps every
// other id to the dropped sentinel rows_l; masked_topn_launch adds its
// id_offset to the ids it writes, in the merge's last write. The shard's
// list stays sorted (score descending, id ascending): a constant offset
// keeps the id order. With id_offset = 0 both are the single-device kernels.

#include "tile_topm.cuh"

namespace {

using namespace topn_select;

constexpr int MASK_WORDS = 256;  // mask words (8,192 items) per mask block

__global__ void __launch_bounds__(THREADS)
candidate_mask(const uint8_t* __restrict__ allow0, const int* __restrict__ excl,
               int We, const int* __restrict__ incl, int Wi,
               const uint8_t* __restrict__ has_incl,
               unsigned* __restrict__ bits, int N, int W32, unsigned id_offset) {
  __shared__ unsigned sw[MASK_WORDS];
  const int row = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int w0 = blockIdx.y * MASK_WORDS;
  const int nw = min(MASK_WORDS, W32 - w0);
  const bool has = has_incl[row] != 0;
  for (int w = tid >> 5; w < nw; w += WARPS) {
    const long long it = 32LL * (w0 + w) + lane;
    const bool ok = !has && it < N && allow0[it] != 0;
    const unsigned ball = __ballot_sync(FULL, ok);
    if (lane == 0) sw[w] = ball;
  }
  __syncthreads();  // the words are written before the scatters
  // this block's items: [lo, hi)
  const unsigned lo = 32u * w0, hi = min((unsigned)N, lo + 32u * nw);
  if (has) {
    for (int j = tid; j < Wi; j += THREADS) {
      const unsigned id = (unsigned)incl[(long long)row * Wi + j] - id_offset;
      if (id >= lo && id < hi && allow0[id] != 0)
        atomicOr(&sw[(id - lo) >> 5], 1u << (id & 31));
    }
  }
  __syncthreads();  // includes set before excludes clear
  for (int j = tid; j < We; j += THREADS) {
    const unsigned id = (unsigned)excl[(long long)row * We + j] - id_offset;
    if (id >= lo && id < hi) atomicAnd(&sw[(id - lo) >> 5], ~(1u << (id & 31)));
  }
  __syncthreads();
  for (int w = tid; w < nw; w += THREADS) bits[(long long)row * W32 + w0 + w] = sw[w];
}

}  // namespace

extern "C" {

// Floats of scratch the caller allocates for masked_topn.
long long masked_topn_scratch_floats(int B, int N, int m) {
  return scratch_floats(B, N, m);
}

// Builds bits [B, ceil(N/32)] on `stream`; returns cudaGetLastError().
// excl [B, We] and incl [B, Wi] are int32 id lists (We, Wi >= 1), has_incl
// [B] and allow0 [N] bytes (0 or 1); an id g names local row g - id_offset
// (a row shard's first global row; 0 on one device).
int candidate_mask_launch(const uint8_t* allow0, const int* excl, int We,
                          const int* incl, int Wi, const uint8_t* has_incl,
                          unsigned* bits, int B, int N, int id_offset,
                          cudaStream_t stream) {
  const int W32 = (N + 31) / 32;
  dim3 grid(B, (W32 + MASK_WORDS - 1) / MASK_WORDS);
  candidate_mask<<<grid, THREADS, 0, stream>>>(allow0, excl, We, incl, Wi,
                                               has_incl, bits, N, W32,
                                               (unsigned)id_offset);
  return (int)cudaGetLastError();
}

// Launches the tile pass and the merge on `stream`; returns
// cudaGetLastError(). precision: 0 f32, 1 bf16 (Y as raw bf16 bits), 2
// int8 (scale [N] read); rn [N] is read only when normalize; the written
// ids are local ids plus id_offset. The caller checks 1 <= m <= N, B >= 1,
// k >= 1, 0 <= id_offset <= 2^31 - 1 - N, dtypes, devices and contiguity.
int masked_topn_launch(const float* q, const void* Y, const float* scale,
                       const float* rn, const unsigned* bits, float* out,
                       float* scratch, int B, int N, int k, int m,
                       int precision, int normalize, int positive_only,
                       int id_offset, cudaStream_t stream) {
  const long long stride = list_stride_of(N, m);
  const int mt = m < TILE ? m : TILE;
  const int W32 = (N + 31) / 32;
  float* s0 = scratch;
  int* i0 = reinterpret_cast<int*>(scratch + (long long)B * stride);
  dim3 grid(tile_blocks(N, m), (B + WARPS - 1) / WARPS);
  if (precision == PREC_F32) {
    masked_tile_topm<PREC_F32><<<grid, THREADS, 0, stream>>>(
        q, Y, scale, rn, bits, W32, s0, i0, B, N, k, mt, stride, normalize,
        positive_only, 0.f);
  } else if (precision == PREC_BF16) {
    masked_tile_topm<PREC_BF16><<<grid, THREADS, 0, stream>>>(
        q, Y, scale, rn, bits, W32, s0, i0, B, N, k, mt, stride, normalize,
        positive_only, 0.f);
  } else if (precision == PREC_I8) {
    masked_tile_topm<PREC_I8><<<grid, THREADS, 0, stream>>>(
        q, Y, scale, rn, bits, W32, s0, i0, B, N, k, mt, stride, normalize,
        positive_only, 0.f);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(scratch, out, B, N, m, stream, id_offset);
}

const char* masked_topn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
