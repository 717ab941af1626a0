// Kernel B: the retriever's stage-2 exact rescore + top-n_out, packed — the
// hand-written Hopper kernel that replaces the reference's jitted
// predictionio_tpu/ops/retrieval.py:316 _rescore_exact and the tail of
// :343 _fused_topn_single_2s (:359-363), stage 2 of K10.
//
// What it computes. q [B,k] f32, the resident quantized rows Y [N,k]
// (bf16, or int8 with one f32 scale per row), and stage 1's packed
// shortlist s1 [B, 2S] (S scores, then S int32 ids as raw bits, from
// csrc/masked_topn.cu). Per query row:
//   1. gather each shortlisted row and dequantize it to f32 (int8:
//      (float)y * scale[id], one f32 product per element; bf16: widened);
//   2. r = the f32 dot with the f32 query [* rn[id] when normalize];
//   3. positive_only on the EXACT score: r > 0, else -inf;
//   4. -inf wherever stage 1's score was -inf (masked or dead slots stay
//      dead whatever their placeholder id rescores to);
//   5. the top n_out by (score descending, shortlist POSITION ascending):
//      lax.top_k over the shortlist breaks ties by position, not by id;
//   6. out [B, 2·n_out]: the scores, then the ids taken from the shortlist
//      plus id_offset.
//
// Row shards (the reference's :366 _shard_topk_kernel_2s): a shard's stage 1
// shortlists LOCAL ids, which index its own rows here, and this kernel adds
// the shard's first global row (id_offset) as it writes them, keeping the
// shard's n_local best (n_out = n_local). With id_offset = 0 it is the
// single-device kernel.
//
// Design, simple and correct first: one block per query row. Its warps
// take shortlist entries in turn, the lanes split the rank (coalesced row
// reads) and a butterfly sums them; then a block-wide bitonic sort of the
// (score, position) keys, padded to a power of two P with (-inf, INT_MAX),
// which sort after every real entry. The keys sit in shared memory when
// they fit (P up to 16,384 at small k: every shortlist the retriever asks
// for at the serving widths); a wider list — _shortlist_width can give up
// to N — runs the same kernel with the keys in a device-memory scratch
// the wrapper allocates, so every width is served by the kernel.
//
// Bound on an H100 SXM at the quantized serving shape (B=64, S=256, k=64,
// int8): the gathered rows are B·S·k = 1 MB, ≈0.3 µs at 3.35 TB/s, and
// the dots 2·B·S·k = 2.1 MFLOP: bytes-bound, and the kernel is dominated
// by the sort's log²P barrier stages. A partial selection (only n_out of
// S are needed) is later work.
//
// Trap: the exact refinement the retriever then runs on the host
// (ItemRetriever._refine_exact) rescores this kernel's n_out candidates
// against the ORIGINAL f32 rows and their norms, not the dequantized ones,
// and orders by (score desc, id asc); this kernel's scores are the
// dequantized rows', as the reference's device stage 2 gives them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PREC_BF16 = 1, PREC_I8 = 2;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int PAD_POS = 0x7fffffff;
constexpr long long MAX_SMEM = 227 * 1024;

__device__ __forceinline__ bool before(float sa, int pa, float sb, int pb) {
  return sa > sb || (sa == sb && pa < pb);
}

template <int PREC>
__global__ void __launch_bounds__(THREADS)
rescore_topn(const float* __restrict__ q, const void* __restrict__ Yv,
             const float* __restrict__ scale, const float* __restrict__ rn,
             const float* __restrict__ s1, int S, float* __restrict__ out,
             int n_out, int N, int k, int P, int normalize, int positive_only,
             float* __restrict__ g_key, int* __restrict__ g_pos, int id_offset) {
  extern __shared__ __align__(16) float smem[];
  const int row = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const float* srow = s1 + (long long)row * 2 * S;
  const int* irow = reinterpret_cast<const int*>(srow + S);
  float* qs = smem;  // the query row, k floats
  const int k4 = (k + 3) & ~3;
  float* key;
  int* pos;
  if (g_key == nullptr) {
    key = smem + k4;
    pos = reinterpret_cast<int*>(key + P);
  } else {
    key = g_key + (long long)row * P;
    pos = g_pos + (long long)row * P;
  }
  for (int c = tid; c < k; c += THREADS) qs[c] = q[(long long)row * k + c];
  __syncthreads();

  for (int j = tid >> 5; j < S; j += WARPS) {
    const int id = irow[j];
    const bool live = srow[j] != -INFINITY && (unsigned)id < (unsigned)N;
    float acc = 0.f;
    if (live) {
      const long long off = (long long)id * k;
      if constexpr (PREC == PREC_I8) {
        const int8_t* Y = static_cast<const int8_t*>(Yv);
        const float sc = scale[id];
        for (int c = lane; c < k; c += 32)
          acc = fmaf(qs[c], (float)Y[off + c] * sc, acc);
      } else {
        const unsigned short* Y = static_cast<const unsigned short*>(Yv);
        for (int c = lane; c < k; c += 32)
          acc = fmaf(qs[c], __uint_as_float((unsigned)Y[off + c] << 16), acc);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
    if (lane == 0) {
      float r = -INFINITY;
      if (live) {
        r = normalize ? acc * rn[id] : acc;
        if (positive_only && !(r > 0.f)) r = -INFINITY;
      }
      key[j] = r;
      pos[j] = j;
    }
  }
  for (int j = S + tid; j < P; j += THREADS) {
    key[j] = -INFINITY;
    pos[j] = PAD_POS;
  }
  __syncthreads();

  // bitonic sort of the P keys, best first
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < P; i += THREADS) {
        const int j = i ^ stride;
        if (j > i) {
          const bool best_first = (i & size) == 0;
          const float ki = key[i], kj = key[j];
          const int pi = pos[i], pj = pos[j];
          const bool swap =
              best_first ? before(kj, pj, ki, pi) : before(ki, pi, kj, pj);
          if (swap) {
            key[i] = kj; key[j] = ki;
            pos[i] = pj; pos[j] = pi;
          }
        }
      }
      __syncthreads();
    }
  }
  float* orow = out + (long long)row * 2 * n_out;
  for (int p = tid; p < n_out; p += THREADS) {
    orow[p] = key[p];
    orow[n_out + p] = __int_as_float(irow[pos[p]] + id_offset);
  }
}

int pow2_at_least(int S) {
  int P = 1;
  while (P < S) P <<= 1;
  return P;
}

long long smem_bytes(int k, int P) {
  return 4LL * ((k + 3) & ~3) + 8LL * P;
}

}  // namespace

extern "C" {

// Floats of device-memory scratch rescore_topn_launch needs: 0 when the
// row's keys fit in shared memory, else 2·B·P (keys and positions).
long long rescore_scratch_floats(int B, int S, int k) {
  const int P = pow2_at_least(S);
  return smem_bytes(k, P) <= MAX_SMEM ? 0 : 2LL * B * P;
}

// Launches on `stream`; returns cudaGetLastError(). precision: 1 bf16 (Y
// as raw bf16 bits), 2 int8 (scale [N] read); rn [N] is read only when
// normalize; the written ids are the shortlist's plus id_offset. The caller
// checks 1 <= n_out <= S, 0 <= id_offset <= 2^31 - 1 - N, dtypes, devices,
// contiguity, and allocates `scratch` as rescore_scratch_floats says.
int rescore_topn_launch(const float* q, const void* Y, const float* scale,
                        const float* rn, const float* s1, int S, float* out,
                        int n_out, float* scratch, int B, int N, int k,
                        int precision, int normalize, int positive_only,
                        int id_offset, cudaStream_t stream) {
  const int P = pow2_at_least(S);
  const long long full = smem_bytes(k, P);
  float* g_key = nullptr;
  int* g_pos = nullptr;
  long long smem = full;
  if (full > MAX_SMEM) {
    g_key = scratch;
    g_pos = reinterpret_cast<int*>(scratch + (long long)B * P);
    smem = 4LL * ((k + 3) & ~3);
  }
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (precision == PREC_I8) {
    err = cudaFuncSetAttribute(rescore_topn<PREC_I8>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    rescore_topn<PREC_I8><<<B, THREADS, (size_t)smem, stream>>>(
        q, Y, scale, rn, s1, S, out, n_out, N, k, P, normalize,
        positive_only, g_key, g_pos, id_offset);
  } else if (precision == PREC_BF16) {
    err = cudaFuncSetAttribute(rescore_topn<PREC_BF16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    rescore_topn<PREC_BF16><<<B, THREADS, (size_t)smem, stream>>>(
        q, Y, scale, rn, s1, S, out, n_out, N, k, P, normalize,
        positive_only, g_key, g_pos, id_offset);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* rescore_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
