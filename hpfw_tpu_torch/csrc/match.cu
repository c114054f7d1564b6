// K3: dense Hamming offset scan (the matcher's hot loop), sm_90a.
//
// Replaces hpfw_tpu/ops/pallas_match.py::_scan_kernel (driven by
// pallas_score_tracks). For every track t and offset o:
//   kcut = clamp(len - o, 0, N)
//   sim  = 64 * kcut - sum_{n < kcut} popc(q[n].x ^ d[o+n].x) + popc(q[n].y ^ d[o+n].y)
// over the offsets the oracle scans, o <= max(len - N, 0) (and o <= L - N);
// the result is the best sim and the first offset that reaches it. Every
// other offset scores -1 in the reference and can never win, because offset
// 0 is always scanned and scores >= 0, so the kernel does not visit them.
//
// Bound: integer issue and L1/L2. Each (offset, n) pair costs two XORs, two
// popcounts and an 8-byte load (2.8 G pairs for 1,000 tracks x 7,701 prints
// against a 380-print query); the DB itself (8 bytes a print) is read from
// device memory once and reused from L1/L2 across the N shifts.
// Design: one block per track with the query in shared memory (a broadcast
// per n). Threads run over offsets, so the 32 lanes of a warp read 32
// neighbouring prints (coalesced 256 B). Each thread keeps its best as one
// 64-bit key (sim << 32 | ~offset): the maximum key is the highest score at
// the lowest offset, reduced by warp shuffles and then across warps.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ long long pack_key(int sim, int offset) {
  // sim * 2^32 + (2^32 - 1 - offset): ordered by sim, then by lower offset.
  return (long long)sim * 4294967296LL + (long long)(~(unsigned)offset);
}

__global__ void __launch_bounds__(THREADS)
scan_kernel(const uint2* __restrict__ query, int n_query,
            const uint2* __restrict__ prints, int track_len,
            const int* __restrict__ lengths, int* __restrict__ scores,
            int* __restrict__ offsets) {
  extern __shared__ uint2 s_q[];
  for (int i = threadIdx.x; i < n_query; i += THREADS) s_q[i] = query[i];
  __syncthreads();

  const int t = blockIdx.x;
  const int len = min(max(lengths[t], 0), track_len);
  const uint2* d = prints + (long long)t * track_len;
  const int o_max = min(max(len - n_query, 0), track_len - n_query);

  long long best = pack_key(-2, 0);
  for (int o = threadIdx.x; o <= o_max; o += THREADS) {
    const int kcut = min(len - o, n_query);
    int dist = 0;
    for (int n = 0; n < kcut; ++n) {
      const uint2 a = s_q[n];
      const uint2 b = d[o + n];
      dist += __popc(a.x ^ b.x) + __popc(a.y ^ b.y);
    }
    best = max(best, pack_key(64 * kcut - dist, o));
  }

#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    best = max(best, __shfl_xor_sync(0xffffffffu, best, s));
  __shared__ long long s_best[THREADS / 32];
  if (threadIdx.x % 32 == 0) s_best[threadIdx.x / 32] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w) best = max(best, s_best[w]);
    scores[t] = (int)(best >> 32);
    offsets[t] = (int)(~(unsigned)(best & 0xffffffffLL));
  }
}

}  // namespace

// query: (n_query, 2) words; prints: (n_tracks, track_len, 2) words,
// zero-padded; lengths: (n_tracks,). scores, offsets: (n_tracks,).
extern "C" int hpfw_score_tracks(const int* query, int n_query, const int* prints,
                                 int n_tracks, int track_len, const int* lengths,
                                 int* scores, int* offsets, cudaStream_t stream) {
  if (n_tracks <= 0 || n_query < 0 || track_len < n_query)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint2) * (size_t)n_query;
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<n_tracks, THREADS, smem, stream>>>(
      reinterpret_cast<const uint2*>(query), n_query,
      reinterpret_cast<const uint2*>(prints), track_len, lengths, scores, offsets);
  return (int)cudaGetLastError();
}
