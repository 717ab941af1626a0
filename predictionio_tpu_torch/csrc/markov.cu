// K16: one step of a Markov chain — the hand-written Hopper kernel that
// replaces the reference's device program
// predictionio_tpu/e2/markov_chain.py:127 _step (called by predict, :90):
//   next[j] = Σ_i cur[i]·probs[i, k]  over the kept transitions targets[i, k] = j,
// a float32 scatter-add there (out-of-range targets dropped), whose order
// of adds is not fixed.
//
// Bound on an H100 SXM. The step reads cur [n], the kept transitions (a
// source index and a probability each) and writes next [n]: at 100,000
// states x top-10, 8.8 MB, ≈0.0026 ms at 3.35 TB/s. The adds are a few
// million: the bytes bound it, and at this size one launch's overhead.
//
// Design. A float atomic scatter-add gives other bits on every launch, so
// the kernel gathers instead. At placement the host builds a target-major
// CSR of the kept transitions (ops/markov.py place_transitions): for each
// target its sources and probabilities in source order, cut into chunks of
// at most CHUNK entries that never span two targets (a hot target of a
// skewed chain has tens of thousands of sources; one warp for all of them
// would be a serial tail).
//   markov_chunks (pass 1): a warp per chunk. Lane l takes entries l,
//     l + 32, ... of the chunk; each product cur[src]·p is rounded to
//     float32, as the reference forms probs·cur, and summed in float64;
//     a butterfly over the warp gives the chunk's sum (float adds commute,
//     so every lane holds the same bits).
//   markov_gather (pass 2): a thread per target adds its chunks' sums in
//     chunk order, in float64, and rounds once to float32.
// Every sum has a fixed order, so every launch gives the same bits; in
// float64 the order moves the float32 result only where the exact sum lies
// on a rounding boundary. Entries of zero probability (the reference's
// padding) and targets outside [-n, n) are left out of the CSR: they add
// nothing in the reference (a negative target counts from the end there,
// and in the CSR).
//
// K16s, the step on a 1-D `data` mesh (the reference's predict :70-91 with
// _step :126-135: source states and the state vector sharded, each
// device's partial next-state vector all-reduced). Each shard holds the
// CSR of its own sources' kept transitions (sources local to the shard)
// and its slice of the state vector. markov_step_partial_f64 runs
// markov_chunks on it and markov_gather64, which is markov_gather with the
// float64 sum left unrounded, into the shard's row of one [S, n] float64
// array on the first device; markov_sum_shards then adds the S rows in
// shard order and rounds once to float32. A shard's chunks hold other
// entries than one device's, so the float64 sums run in another order and
// the float32 answer may differ from one device's by one step where the
// exact sum lies on a rounding boundary.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK_WARPS = 8;
constexpr int GATHER_THREADS = 256;

__global__ void __launch_bounds__(CHUNK_WARPS * 32) markov_chunks(
    const float* __restrict__ cur, const int* __restrict__ src,
    const float* __restrict__ prob, const int* __restrict__ chunk_start,
    int n_chunks, double* __restrict__ partial) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * CHUNK_WARPS + (threadIdx.x >> 5);
  if (c >= n_chunks) return;
  const int e1 = chunk_start[c + 1];
  double acc = 0.0;
  for (int e = chunk_start[c] + lane; e < e1; e += 32)
    acc += (double)__fmul_rn(prob[e], cur[src[e]]);
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) partial[c] = acc;
}

__global__ void __launch_bounds__(GATHER_THREADS) markov_gather(
    const double* __restrict__ partial, const int* __restrict__ target_chunk,
    int n, float* __restrict__ out) {
  const int t = blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (t >= n) return;
  double s = 0.0;
  for (int c = target_chunk[t]; c < target_chunk[t + 1]; ++c) s += partial[c];
  out[t] = __double2float_rn(s);
}

// markov_gather's float64 form: the target's chunk sums in chunk order,
// unrounded (a shard's partial next-state vector)
__global__ void __launch_bounds__(GATHER_THREADS) markov_gather64(
    const double* __restrict__ partial, const int* __restrict__ target_chunk,
    int n, double* __restrict__ out) {
  const int t = blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (t >= n) return;
  double s = 0.0;
  for (int c = target_chunk[t]; c < target_chunk[t + 1]; ++c) s += partial[c];
  out[t] = s;
}

// a thread per target adds the shards' partials [S, n] in shard order, in
// float64, and rounds once
__global__ void __launch_bounds__(GATHER_THREADS) markov_sum_shards(
    const double* __restrict__ parts, int S, int n, float* __restrict__ out) {
  const int t = blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (t >= n) return;
  double s = 0.0;
  for (int k = 0; k < S; ++k) s += parts[(long long)k * n + t];
  out[t] = __double2float_rn(s);
}

}  // namespace

extern "C" {

// K16 on `stream`: out [n] float32, the next-state vector of cur [n]
// float32 under the target-major CSR (src [E] int32 source of each kept
// transition, prob [E] float32 its probability; chunk_start [n_chunks + 1]
// the entry offsets of the chunks, target_chunk [n + 1] the chunk offsets
// of the targets). partial [n_chunks] float64 is the caller's scratch.
// Returns cudaGetLastError(); no launch when n is 0.
int markov_step_f32(const float* cur, const int* src, const float* prob,
                    const int* chunk_start, const int* target_chunk, int n,
                    int n_chunks, double* partial, float* out,
                    cudaStream_t stream) {
  if (n == 0) return (int)cudaSuccess;
  if (n < 0 || n_chunks < 0) return (int)cudaErrorInvalidValue;
  if (n_chunks > 0) {
    const int blocks = (n_chunks + CHUNK_WARPS - 1) / CHUNK_WARPS;
    markov_chunks<<<blocks, CHUNK_WARPS * 32, 0, stream>>>(
        cur, src, prob, chunk_start, n_chunks, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  markov_gather<<<(n + GATHER_THREADS - 1) / GATHER_THREADS, GATHER_THREADS, 0,
                  stream>>>(partial, target_chunk, n, out);
  return (int)cudaGetLastError();
}

// K16s, a shard's step on `stream`: out [n] float64, the unrounded partial
// next-state vector of the shard's state slice cur [rows] float32 under its
// CSR (src local to the shard; the rest as for markov_step_f32). Returns
// cudaGetLastError(); no launch when n is 0.
int markov_step_partial_f64(const float* cur, const int* src, const float* prob,
                            const int* chunk_start, const int* target_chunk,
                            int n, int n_chunks, double* partial, double* out,
                            cudaStream_t stream) {
  if (n == 0) return (int)cudaSuccess;
  if (n < 0 || n_chunks < 0) return (int)cudaErrorInvalidValue;
  if (n_chunks > 0) {
    const int blocks = (n_chunks + CHUNK_WARPS - 1) / CHUNK_WARPS;
    markov_chunks<<<blocks, CHUNK_WARPS * 32, 0, stream>>>(
        cur, src, prob, chunk_start, n_chunks, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  markov_gather64<<<(n + GATHER_THREADS - 1) / GATHER_THREADS, GATHER_THREADS,
                    0, stream>>>(partial, target_chunk, n, out);
  return (int)cudaGetLastError();
}

// K16s's sum on `stream`: out [n] float32, the S shards' partials parts
// [S, n] float64 added in shard order and rounded once. Returns
// cudaGetLastError(); no launch when n is 0.
int markov_sum_shards_f32(const double* parts, int S, int n, float* out,
                          cudaStream_t stream) {
  if (n == 0) return (int)cudaSuccess;
  if (n < 0 || S < 1) return (int)cudaErrorInvalidValue;
  markov_sum_shards<<<(n + GATHER_THREADS - 1) / GATHER_THREADS, GATHER_THREADS,
                      0, stream>>>(parts, S, n, out);
  return (int)cudaGetLastError();
}

const char* markov_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
