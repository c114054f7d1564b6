// K5: exact fine rescan of pooled (track, start) candidates, sm_90a.
//
// Replaces hpfw_tpu/ops/pallas_fine.py::_fine_kernel (driven by
// pallas_fine_rescan_batch and pallas_fine_rescan). For query b and candidate
// k (track t, band start s), at each offset o = s + r of the band, r < n_fine:
//   kcut = clamp(len_t - o, 0, N)
//   sim  = 64 * kcut - sum_{n < kcut} popc(q[n].x ^ d[o+n].x) + popc(q[n].y ^ d[o+n].y)
// An offset is valid when 0 <= o <= max(len_t - N, 0) and scores -1 otherwise.
// The result is the best sim of the band and the first offset reaching it,
// (-1, s) when no offset of the band is valid.
//
// Bound: latency of data-dependent loads. The work is small (B x K x n_fine x
// N print pairs: 8 x 1,024 x 33 x 430 = 116 M for a batch of 8 at catalog
// scale) and each candidate's window, N + n_fine - 1 prints (3.7 KB), sits
// at an address only the coarse stage knows. The TPU kernel DMAs a 2,048-word
// window at a 1,024-aligned start, rotates it into place in 11 steps and
// scores the band as a +-1 GEMM on the MXU; none of that is needed here.
// Design: one warp per candidate, lanes over the band's offsets, so each step
// n reads 32 neighbouring prints straight from the (T, L, 2) print array
// (coalesced, and mostly from L1, since step n + 1 reads what the next lane
// read at step n). The query sits in shared memory, a broadcast per step.
// Ties use the 64-bit key of csrc/match.cu, on the offset within the band.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ long long pack_key(int sim, int r) {
  // sim * 2^32 + (2^32 - 1 - r): ordered by sim, then by lower r.
  return (long long)sim * 4294967296LL + (long long)(~(unsigned)r);
}

__global__ void __launch_bounds__(THREADS)
fine_kernel(const uint2* __restrict__ queries, int n_query,
            const uint2* __restrict__ prints, int n_tracks, int track_len,
            const int* __restrict__ lengths, const int* __restrict__ cand_tracks,
            const int* __restrict__ cand_starts, int n_cand, int n_fine,
            int* __restrict__ scores, int* __restrict__ offsets) {
  extern __shared__ uint2 s_q[];
  const uint2* q = queries + (long long)blockIdx.y * n_query;
  for (int i = threadIdx.x; i < n_query; i += THREADS) s_q[i] = q[i];
  __syncthreads();

  const int k = blockIdx.x * WARPS + threadIdx.x / 32;
  if (k >= n_cand) return;
  const int lane = threadIdx.x % 32;
  const long long c = (long long)blockIdx.y * n_cand + k;
  const int t = cand_tracks[c], s = cand_starts[c];
  // A track index out of range reads nothing and scores as an empty track.
  const bool in_range = t >= 0 && t < n_tracks;
  const int len = in_range ? min(max(lengths[t], 0), track_len) : 0;
  const int o_max = max(len - n_query, 0);
  const uint2* d = prints + (long long)(in_range ? t : 0) * track_len;

  long long best = LLONG_MIN;
  for (int r = lane; r < n_fine; r += 32) {
    const int o = s + r;
    int sim = -1;
    if (o >= 0 && o <= o_max) {
      const int kcut = min(len - o, n_query);
      int dist = 0;
      for (int n = 0; n < kcut; ++n) {
        const uint2 a = s_q[n];
        const uint2 b = d[o + n];
        dist += __popc(a.x ^ b.x) + __popc(a.y ^ b.y);
      }
      sim = 64 * kcut - dist;
    }
    best = max(best, pack_key(sim, r));
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) best = max(best, __shfl_xor_sync(0xffffffffu, best, m));
  if (lane == 0) {
    scores[c] = (int)(best >> 32);
    offsets[c] = s + (int)(~(unsigned)(best & 0xffffffffLL));
  }
}

}  // namespace

// queries: (n_batch, n_query, 2) words; prints: (n_tracks, track_len, 2)
// words; lengths: (n_tracks,); cand_tracks, cand_starts, scores, offsets:
// (n_batch, n_cand).
extern "C" int hpfw_fine_rescan(const int* queries, int n_batch, int n_query,
                                const int* prints, int n_tracks, int track_len,
                                const int* lengths, const int* cand_tracks,
                                const int* cand_starts, int n_cand, int n_fine,
                                int* scores, int* offsets, cudaStream_t stream) {
  if (n_batch <= 0 || n_batch > 65535 || n_cand <= 0 || n_query < 0 || n_fine < 1 ||
      n_tracks < 0 || track_len < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint2) * (size_t)n_query;
  cudaError_t err = cudaFuncSetAttribute(
      fine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_cand + WARPS - 1) / WARPS, n_batch);
  fine_kernel<<<grid, THREADS, smem, stream>>>(
      reinterpret_cast<const uint2*>(queries), n_query,
      reinterpret_cast<const uint2*>(prints), n_tracks, track_len, lengths, cand_tracks,
      cand_starts, n_cand, n_fine, scores, offsets);
  return (int)cudaGetLastError();
}
