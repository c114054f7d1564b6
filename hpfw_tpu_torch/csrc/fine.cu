// K5: exact fine rescan of pooled (track, start) candidates, sm_90a.
//
// Replaces hpfw_tpu/ops/pallas_fine.py::_fine_kernel (driven by
// pallas_fine_rescan_batch and pallas_fine_rescan). For query b and candidate
// k (track t, band start s), at each offset o = s + r of the band, r < n_fine:
//   kcut = clamp(len_t - o, 0, N)
//   sim  = 64 * kcut - Hamming(q[0 : kcut], d[o : o + kcut])
// An offset is valid when 0 <= o <= max(len_t - N, 0) and scores -1 otherwise.
// The result is the best sim of the band and the first offset reaching it,
// (-1, s) when no offset of the band is valid. A track index out of range
// scores as an empty track.
//
// Formulation: the TPU kernel's GEMM. With the query as +-1 vectors of 64
// channels and the window as 0/1 bytes (its bits),
//   corr01 = sum_n sum_c q[n][c] * w[o + n][c],
//   sim    = corr01 + 64 * kcut - popcount(q[0 : kcut]),
// which is the TPU kernel's (corr + 64 * kcut) / 2 with both sides +-1
// (q . w_pm1 = 2 q . w01 - sum q, and sum q = 2 popcount - 64 a print). w is
// the candidate's window with every position at or past len_t (or before the
// track's start) zero, so that corr01 runs over n < kcut by itself; a valid
// offset has kcut = min(len_t, N), so one popcount a candidate serves its
// band. For one query the band is a GEMM: C[r, k] = sum_{p, c} A[r, (p, c)] *
// B[(p, c), k], with A[r, (p, c)] = q[p - r][c] (the query as a Toeplitz
// matrix, zero outside [0, N)) and B the candidates' windows, p < N + n_fine
// - 1. Both are int8 and C is exact in int32.
//
// Bound: int8 tensor-core operations, or the bytes of the windows. At the
// catalog's shape (8 queries x 1,024 candidates, N = 430, band 33) the band
// is 116 M print pairs, 15 G int8 operations, and the windows are 30 MB. A
// __popc loop with a warp's lanes over the band's offsets would run a band
// of 33 in two passes, the second with one lane busy; the GEMM has no such
// remainder.
// Design: mma.sync m16n8k32 s8 -> s32, as in K4 (csrc/coarse.cu): a k-step is
// 32 channels (half a print) of one window position, a band of up to 48
// offsets is three m16 tiles (wider bands take further passes of 48 rows),
// and a block of 8 warps takes one query and 32 candidates (four n8 tiles,
// the columns of B). The block streams the candidates' windows through
// shared memory in chunks of 64 positions, two chunks deep (cp.async of the
// packed prints, zero-filled outside the track; each thread keeps its
// copies' addresses and limits in registers, and the first chunk's copies
// go out before the query work). The query is unpacked into +-1 bytes at an
// odd 16-byte stride (80 bytes), so ldmatrix reads A at per-row addresses
// (a one-print shift is 80 bytes) free of bank conflicts: once a block when
// the whole query fits RESIDENT_BYTES, else the 111 prints a chunk's rows
// reach, chunk by chunk, so any query length streams. Each warp takes 8
// positions of a chunk against all 32 candidates, so an A fragment serves
// four n-tiles; B fragments are made in registers from the packed words,
// four bits to four 0/1 bytes (a multiply and a mask; a position outside
// [0, len_t) was staged as zero words). The warps' partial C meet by
// shared-memory atomic adds (exact, in any order), and one thread a
// candidate scores its band with a 64-bit key (sim * 2^32 + 2^32 - 1 - r):
// the highest sim at the lowest offset.

#include <climits>
#include <cuda_runtime.h>

#include "mma_s8.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int NT = 4;                        // n8 tiles: candidates a block / 8
constexpr int CANDS = 8 * NT;
constexpr int MT = 3;                        // m16 tiles: band offsets a group / 16
constexpr int GROUP_ROWS = 16 * MT;
constexpr int CP = 64;                       // window positions a chunk
constexpr int PW = CP / WARPS;               // positions a warp takes of a chunk
constexpr int WS = CP + 1;                   // uint2 a candidate's staged chunk
constexpr int QROWS = CP + GROUP_ROWS;       // query prints a chunk's A reaches (111), + 1
constexpr int QS = 80;                       // bytes a staged query print: 64 + 16
constexpr int C_LD = CANDS + 1;              // ints a row of the band's C
constexpr int RESIDENT_BYTES = 96 * 1024;    // the whole unpacked query, when it fits

// Staged query prints: the whole query once (its 47 leading zero prints,
// every chunk's reach, rounded) when that fits RESIDENT_BYTES, else one
// chunk's reach at a time.
__host__ __device__ inline int resident_rows(int n_query) {
  const int rows = (n_query + GROUP_ROWS - 1 + CP - 1) / CP * CP + GROUP_ROWS;
  return rows * QS <= RESIDENT_BYTES ? rows : 0;
}

__host__ __device__ inline size_t smem_bytes(int n_query) {
  const int q_rows = resident_rows(n_query) ? resident_rows(n_query) : QROWS;
  return 2 * CANDS * WS * sizeof(uint2) + (size_t)q_rows * QS +
         GROUP_ROWS * C_LD * sizeof(int) + (4 * CANDS + 1) * sizeof(int);
}

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
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* const s_win = reinterpret_cast<uint2*>(smem);                  // [2][CANDS][WS]
  unsigned char* const s_q = smem + 2 * CANDS * WS * sizeof(uint2);     // [q_rows][QS]
  const int q_rows = resident_rows(n_query);                            // 0: streamed
  int* const s_corr = reinterpret_cast<int*>(s_q + (q_rows ? q_rows : QROWS) * QS);
  int* const s_track = s_corr + GROUP_ROWS * C_LD;                      // -1: read nothing
  int* const s_start = s_track + CANDS;
  int* const s_len = s_start + CANDS;
  int* const s_pc = s_len + CANDS;        // popcount(q[0 : min(len, N)])
  int* const s_total = s_pc + CANDS;      // popcount(q)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * CANDS;
  const uint2* q = queries + (long long)blockIdx.y * n_query;
  const int span = n_query + n_fine - 1;       // window positions a band reads

  if (tid < CANDS) {
    const int k = k0 + tid;
    int tr = -1, s = 0, len = 0;
    if (k < n_cand) {
      const long long c = (long long)blockIdx.y * n_cand + k;
      s = cand_starts[c];
      tr = cand_tracks[c];
      // A track index out of range reads nothing and scores as an empty track.
      if (tr >= 0 && tr < n_tracks) len = min(max(lengths[tr], 0), track_len);
      else tr = -1;
    }
    s_track[tid] = tr;
    s_start[tid] = s;
    s_len[tid] = len;
    s_pc[tid] = 0;
  }
  if (tid == 0) *s_total = 0;
  __syncthreads();

  // Window positions [pos0, pos0 + CP) of the 32 candidates into buffer buf,
  // the packed prints as stored, zero outside [0, len). Thread tid copies
  // position tid % CP of candidates tid / CP + e * (THREADS / CP).
  constexpr int SE = CANDS * CP / THREADS;
  const int qq = tid % CP;
  const uint2* src_e[SE];
  int lo_e[SE], hi_e[SE];                      // valid chunk positions: [lo, hi)
#pragma unroll
  for (int e = 0; e < SE; ++e) {
    const int cand = tid / CP + e * (THREADS / CP);
    const int tr = s_track[cand], st = s_start[cand];
    src_e[e] = tr >= 0 ? prints + (long long)tr * track_len + st : prints;
    lo_e[e] = tr >= 0 ? -st : 0;
    hi_e[e] = tr >= 0 ? s_len[cand] - st : 0;
  }
  auto stage = [&](int pos0, int buf) {
    uint2* dst = s_win + buf * CANDS * WS + qq;
    const int p = pos0 + qq;
#pragma unroll
    for (int e = 0; e < SE; ++e) {
      const bool ok = p >= lo_e[e] && p < hi_e[e];
      cp_async8(dst + (tid / CP + e * (THREADS / CP)) * WS, ok ? src_e[e] + p : prints, ok);
    }
  };
  // The first chunk's copies go out before the query work below.
  if (span > 0) stage(0, 0);
  cp_async_commit();

  // popcount(q[0 : min(len, N)]) of each candidate: the whole query's once,
  // a shorter prefix only for the candidates whose track is shorter than N.
  {
    int total = 0;
    for (int n = tid; n < n_query; n += THREADS) total += __popc(q[n].x) + __popc(q[n].y);
    total = __reduce_add_sync(0xffffffffu, total);
    if (lane == 0) atomicAdd(s_total, total);
    for (int c = 0; c < CANDS; ++c) {
      const int k = min(s_len[c], n_query);
      if (k < n_query) {                       // the same for the whole block
        int sum = 0;
        for (int n = tid; n < k; n += THREADS) sum += __popc(q[n].x) + __popc(q[n].y);
        sum = __reduce_add_sync(0xffffffffu, sum);
        if (lane == 0) atomicAdd(s_pc + c, sum);
      }
    }
  }

  // Query prints [first, first + rows) into staged rows [0, rows) as +-1
  // bytes, zero outside [0, N); 16 channels a store.
  auto unpack_query = [&](int first, int rows) {
    constexpr int U = 4;                       // loads in flight a thread
    for (int i0 = tid; i0 < rows * 4; i0 += U * THREADS) {
      unsigned bits[U];
      bool in[U];
#pragma unroll
      for (int x = 0; x < U; ++x) {
        const int i = i0 + x * THREADS, qi = first + i / 4, quarter = i % 4;
        in[x] = i < rows * 4 && qi >= 0 && qi < n_query;
        bits[x] = in[x] ? reinterpret_cast<const unsigned*>(q + qi)[quarter / 2] >>
                              (16 * (quarter % 2))
                        : 0u;
      }
#pragma unroll
      for (int x = 0; x < U; ++x) {
        const int i = i0 + x * THREADS;
        if (i < rows * 4)
          *reinterpret_cast<uint4*>(s_q + (i / 4) * QS + 16 * (i % 4)) =
              in[x] ? make_uint4(pm1_nibble(bits[x]), pm1_nibble(bits[x] >> 4),
                                 pm1_nibble(bits[x] >> 8), pm1_nibble(bits[x] >> 12))
                    : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  // Staged row u of chunk c holds query print c * CP - (GROUP_ROWS - 1) + u
  // (the same for every row group): resident, the whole query at once.
  if (q_rows) unpack_query(-(GROUP_ROWS - 1), q_rows);

  // ldmatrix row addresses of this thread: matrix lane / 8, row lane % 8. A
  // (16 offsets x 32 bytes): matrices (rows 0-7, bytes 0-15), (rows 8-15,
  // bytes 0-15), (rows 0-7, bytes 16-31), (rows 8-15, bytes 16-31). Row r of
  // a tile at local position pl reads staged query print pl + GROUP_ROWS - 1
  // - r, one print lower a row.
  const int a_row = ((lane / 8) & 1) * 8 + lane % 8;
  const unsigned char* const a_base = s_q + (GROUP_ROWS - 1 - a_row) * QS + (lane / 16) * 16;

  long long best = LLONG_MIN;                  // candidate tid's key (tid < CANDS)
  for (int r0 = 0; r0 < n_fine; r0 += GROUP_ROWS) {
    // Rows r0 .. r0 + 47 reach window positions [r0, r0 + 47 + N) of the band.
    const int p_lo = r0, p_hi = min(span, r0 + GROUP_ROWS - 1 + n_query);
    const int n_chunks = p_hi > p_lo ? (p_hi - p_lo + CP - 1) / CP : 0;
    for (int i = tid; i < GROUP_ROWS * C_LD; i += THREADS) s_corr[i] = 0;
    int acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = 0;

    if (r0 > 0) {                      // the first row group's went out above
      if (n_chunks > 0) stage(p_lo, 0);
      cp_async_commit();
    }
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) stage(p_lo + (c + 1) * CP, (c + 1) & 1);
      cp_async_commit();
      if (!q_rows) unpack_query(c * CP - (GROUP_ROWS - 1), QROWS);
      cp_async_wait1();
      __syncthreads();

      const uint2* win = s_win + (c & 1) * CANDS * WS;
      const unsigned char* a_chunk = a_base + (q_rows ? c * CP * QS : 0);
#pragma unroll
      for (int pi = 0; pi < PW; ++pi) {
        const int pl = warp * PW + pi;
        uint2 w[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          w[nt] = win[(nt * 8 + g) * WS + pl];
          w[nt].x >>= 4 * t;
          w[nt].y >>= 4 * t;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned a[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i) ldmatrix_x4(a[i], a_chunk + (pl - 16 * i) * QS + 32 * h);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            // Channels 32 h + 4 t .. + 3 and 32 h + 16 + 4 t .. + 3: bits of word h.
            const unsigned word = h ? w[nt].y : w[nt].x;
            const unsigned b0 = bits01_nibble(word);
            const unsigned b1 = bits01_nibble(word >> 16);
#pragma unroll
            for (int i = 0; i < MT; ++i) mma_s8(acc[i][nt], a[i], b0, b1);
          }
        }
      }
      __syncthreads();
    }

    // Thread (g, t) holds rows 16 i + g (+ 8) for candidates nt * 8 + 2 t (+ 1).
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        int* row = s_corr + (16 * i + g) * C_LD + nt * 8 + 2 * t;
        atomicAdd(row, acc[i][nt][0]);
        atomicAdd(row + 1, acc[i][nt][1]);
        atomicAdd(row + 8 * C_LD, acc[i][nt][2]);
        atomicAdd(row + 8 * C_LD + 1, acc[i][nt][3]);
      }
    __syncthreads();
    if (tid < CANDS) {
      const int s = s_start[tid], len = s_len[tid];
      const int o_max = max(len - n_query, 0);
      for (int r = r0; r < min(n_fine, r0 + GROUP_ROWS); ++r) {
        const int o = s + r;
        int sim = -1;
        if (o >= 0 && o <= o_max) {
          const int kcut = min(len - o, n_query);    // min(len, N) at a valid offset
          sim = s_corr[(r - r0) * C_LD + tid] + 64 * kcut -
                (len < n_query ? s_pc[tid] : *s_total);
        }
        best = max(best, pack_key(sim, r));
      }
    }
    __syncthreads();
  }

  if (tid < CANDS && k0 + tid < n_cand) {
    const long long c = (long long)blockIdx.y * n_cand + k0 + tid;
    scores[c] = (int)(best >> 32);
    offsets[c] = s_start[tid] + (int)(~(unsigned)(best & 0xffffffffLL));
  }
}

}  // namespace

// queries: (n_batch, n_query, 2) words; prints: (n_tracks, track_len, 2)
// words; lengths: (n_tracks,); cand_tracks, cand_starts, scores, offsets:
// (n_batch, n_cand). Any query length and band width.
extern "C" int hpfw_fine_rescan(const int* queries, int n_batch, int n_query,
                                const int* prints, int n_tracks, int track_len,
                                const int* lengths, const int* cand_tracks,
                                const int* cand_starts, int n_cand, int n_fine,
                                int* scores, int* offsets, cudaStream_t stream) {
  if (n_batch <= 0 || n_batch > 65535 || n_cand <= 0 || n_query < 0 || n_fine < 1 ||
      n_tracks < 0 || track_len < 0 || (long long)n_query + n_fine > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n_query);
  cudaError_t err = cudaFuncSetAttribute(
      fine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_cand + CANDS - 1) / CANDS, n_batch);
  fine_kernel<<<grid, THREADS, smem, stream>>>(
      reinterpret_cast<const uint2*>(queries), n_query,
      reinterpret_cast<const uint2*>(prints), n_tracks, track_len, lengths, cand_tracks,
      cand_starts, n_cand, n_fine, scores, offsets);
  return (int)cudaGetLastError();
}
