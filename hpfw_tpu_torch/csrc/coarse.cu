// K4: coarse correlation scan with a max / first-best-offset epilogue, sm_90a.
//
// Replaces hpfw_tpu/ops/pallas_coarse.py::_tile_best (driven by
// pallas_coarse_scan) and ::_stacked_kernel (driven by
// pallas_coarse_scan_batch_stacked, with and without packed4, and
// pallas_coarse_rescan_stacked): one body, four host surfaces. For query lane g of group b and DB row r:
//   corr(o) = sum_{j < Nc} sum_{c < C} q[g][j][c] * d[row][o + j][c]
//   for o < n_off = n_win - Nc + 1, then best = max_o corr(o) and
//   first = min {o : corr(o) = best},
// in exact int32 over int8 values (+-1, 0 past a track's end, or window sums).
// Group b owns lanes b*lanes .. b*lanes + lanes - 1 and the rows
// rows[b*n_rows + r] (or r itself with no index array): the dense scan is one
// group, the block-diagonal pass-2 rescan one group per query, which reads its
// pooled rows through the index array instead of a gathered copy.
//
// Bound: integer issue and shared-memory bandwidth. One 10 s query against
// 100,000 x 60 s tracks is 22.6 G int8 products (136 offsets x 26 windows x 64
// channels a track) over ~1 GB of coarse rows, each read from device memory
// once. The TPU kernel runs the products as a bf16 phase GEMM on the MXU.
// Design: a block stages a tile of rows and a chunk of query lanes in shared
// memory as 16-byte chunks, a window in ceil(C/16) chunks (zero-filled past
// C) at an odd chunk stride, so that the 16-byte loads of 8 lanes on 8
// offsets hit 8 different bank groups while the query chunk is a broadcast.
// One warp takes one (row, lane) pair at a time; each thread accumulates K
// offsets 32 apart with __dp4a (four int8 products an instruction, four of
// them a chunk), and keeps its best as one 64-bit key
// (corr * 2^32 + 2^32 - 1 - offset) whose maximum is the highest correlation
// at the lowest offset; scores may be negative.
//
// PACKED rows (pass 1 of the two-pass matcher under prefilter_pack4) hold two
// features a byte, feature 2j in the low nibble of byte j: a window of C
// channels is C/2 contiguous bytes, whole words since C % 8 == 0. Staging
// reads half the global bytes, sign-extends both nibbles of each byte with
// word-wide bit ops and stores the same int8 chunks the unpacked path
// stores, so shared memory, the dp4a loop and the results are those of the
// int8 rows.
// The bound stays instruction issue, so the saving is global bytes only.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 8;      // offsets a thread accumulates in one pass
constexpr int MAX_ROWS = 8;   // rows a block stages
constexpr int UNROLL = 4;     // staging loads a thread keeps in flight

__device__ __forceinline__ long long pack_key(int corr, int offset) {
  return (long long)corr * 4294967296LL + (long long)(~(unsigned)offset);
}

__device__ __forceinline__ int dot16(int4 a, int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

// Chunk c (words 4c .. 4c + 3) of the window whose first word is w0,
// zero past `words`. A window is 16-byte aligned when words % 4 == 0.
__device__ __forceinline__ int4 load_chunk(const int* __restrict__ w0, int c, int words) {
  if ((words & 3) == 0) return __ldg(reinterpret_cast<const int4*>(w0) + c);
  const int w = 4 * c;
  return make_int4(w < words ? __ldg(w0 + w) : 0, w + 1 < words ? __ldg(w0 + w + 1) : 0,
                   w + 2 < words ? __ldg(w0 + w + 2) : 0,
                   w + 3 < words ? __ldg(w0 + w + 3) : 0);
}

// One packed word -> 8 features: each byte's low nibble, then its high
// nibble, sign-extended by OR-ing 0xf0 into each byte whose nibble has bit 3
// set (bit 3 of every byte times 0x1e is 0xf0 there; no byte carries).
__device__ __forceinline__ void unpack_word(unsigned p, int& w0, int& w1) {
  const unsigned lo = (p & 0x0f0f0f0fu) | ((p & 0x08080808u) * 0x1eu);
  const unsigned q = p >> 4;
  const unsigned hi = (q & 0x0f0f0f0fu) | ((q & 0x08080808u) * 0x1eu);
  w0 = (int)__byte_perm(lo, hi, 0x5140);   // lo.b0 hi.b0 lo.b1 hi.b1
  w1 = (int)__byte_perm(lo, hi, 0x7362);   // lo.b2 hi.b2 lo.b3 hi.b3
}

// Chunk c (features 16c .. 16c + 15) of the packed window whose first word
// is p0: packed words 2c and 2c + 1, zero past `pwords`. A packed window is
// 8-byte aligned when pwords is even (rows are a multiple of 16 bytes).
__device__ __forceinline__ int4 load_chunk_packed(const int* __restrict__ p0, int c,
                                                  int pwords) {
  int a, b;
  if ((pwords & 1) == 0) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(p0) + c);
    a = v.x;
    b = v.y;
  } else {
    const int w = 2 * c;
    a = w < pwords ? __ldg(p0 + w) : 0;
    b = w + 1 < pwords ? __ldg(p0 + w + 1) : 0;
  }
  int4 out;
  unpack_word((unsigned)a, out.x, out.y);
  unpack_word((unsigned)b, out.z, out.w);
  return out;
}

template <int K, bool PACKED>
__global__ void __launch_bounds__(THREADS)
coarse_kernel(const int* __restrict__ queries, int lanes, int lane_chunk, int n_chunks,
              int nc, int words, const int* __restrict__ db, long long row_words,
              int n_win, const int* __restrict__ rows, int n_rows, int rows_per_block,
              int* __restrict__ best_out, int* __restrict__ first_out) {
  extern __shared__ int4 smem[];
  __shared__ long long s_row[MAX_ROWS];
  const int group = blockIdx.y / n_chunks;
  const int lane0 = (blockIdx.y % n_chunks) * lane_chunk;
  const int n_lanes = min(lane_chunk, lanes - lane0);
  const int r0 = blockIdx.x * rows_per_block;
  const int n_r = min(rows_per_block, n_rows - r0);
  const int n_ch = (words + 3) / 4;   // 16-byte chunks a window
  const int stride = n_ch | 1;        // odd chunk stride of a staged DB window
  const int n_off = n_win - nc + 1;
  int4* s_q = smem;                               // [lane][j][chunk]
  int4* s_d = smem + lane_chunk * nc * n_ch;      // [row][window * stride + chunk]

  if (threadIdx.x < n_r)
    s_row[threadIdx.x] = rows ? rows[(long long)group * n_rows + r0 + threadIdx.x]
                              : r0 + threadIdx.x;
  const int* q_src = queries + (long long)(group * lanes + lane0) * nc * words;
  for (int i = threadIdx.x; i < n_lanes * nc * n_ch; i += THREADS) {
    const int win = i / n_ch;          // lane * nc + j: a lane's windows follow its last
    s_q[i] = load_chunk(q_src + (long long)win * words, i - win * n_ch, words);
  }
  __syncthreads();
  const int row_chunks = n_win * n_ch;
  for (int i0 = threadIdx.x; i0 < n_r * row_chunks; i0 += UNROLL * THREADS) {
    int4 v[UNROLL];
    int dst[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < n_r * row_chunks) {
        const int rr = i / row_chunks, rem = i - rr * row_chunks;
        const int win = rem / n_ch, c = rem - win * n_ch;
        if (PACKED)
          v[u] = load_chunk_packed(db + s_row[rr] * row_words + (long long)win * (words / 2),
                                   c, words / 2);
        else
          v[u] = load_chunk(db + s_row[rr] * row_words + (long long)win * words, c, words);
        dst[u] = (rr * n_win + win) * stride + c;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (i0 + u * THREADS < n_r * row_chunks) s_d[dst[u]] = v[u];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = warp; p < n_r * n_lanes; p += WARPS) {
    const int rr = p / n_lanes, v = p % n_lanes;
    const int4* d = s_d + rr * n_win * stride;
    const int4* q = s_q + v * nc * n_ch;
    long long best = LLONG_MIN;
    for (int o0 = 0; o0 < n_off; o0 += 32 * K) {
      int acc[K];
      bool valid[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        acc[k] = 0;
        valid[k] = o0 + lane + 32 * k < n_off;
      }
      for (int j = 0; j < nc; ++j) {
        const int4* dj = d + (o0 + lane + j) * stride;
        const int4* qj = q + j * n_ch;
#pragma unroll 4
        for (int c = 0; c < n_ch; ++c) {
          const int4 qv = qj[c];
#pragma unroll
          for (int k = 0; k < K; ++k)
            if (valid[k]) acc[k] = dot16(dj[32 * k * stride + c], qv, acc[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (valid[k]) best = max(best, pack_key(acc[k], o0 + lane + 32 * k));
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) best = max(best, __shfl_xor_sync(0xffffffffu, best, s));
    if (lane == 0) {
      const long long out = (long long)(group * lanes + lane0 + v) * n_rows + r0 + rr;
      best_out[out] = (int)(best >> 32);
      first_out[out] = (int)(~(unsigned)(best & 0xffffffffLL));
    }
  }
}

template <int K, bool PACKED>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream, const int* queries,
                   int lanes, int lane_chunk, int n_chunks, int nc, int words,
                   const int* db, long long row_words, int n_win, const int* rows,
                   int n_rows, int rows_per_block, int* best, int* first) {
  cudaError_t err = cudaFuncSetAttribute(
      coarse_kernel<K, PACKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  coarse_kernel<K, PACKED><<<grid, THREADS, smem, stream>>>(
      queries, lanes, lane_chunk, n_chunks, nc, words, db, row_words, n_win, rows,
      n_rows, rows_per_block, best, first);
  return cudaGetLastError();
}

}  // namespace

// queries: (n_groups * lanes, nc, channels) int8; db: rows of row_bytes int8,
// the first n_win * channels of which are scanned (n_win * channels / 2 when
// packed: nibble-packed rows, row_bytes a multiple of 16); both 16-byte
// aligned.
// rows: (n_groups, n_rows) row indices or null (rows 0 .. n_rows - 1, one
// group). best, first: (n_groups * lanes, n_rows). A block stages
// rows_per_block rows and lane_chunk lanes, in
// 16 * (lane_chunk * nc * ceil(C/16) + rows_per_block * n_win * (ceil(C/16) | 1))
// bytes of shared memory.
extern "C" int hpfw_coarse_scan(const signed char* queries, int n_groups, int lanes,
                                int nc, int channels, const signed char* db,
                                long long row_bytes, int n_win, const int* rows,
                                int n_rows, int rows_per_block, int lane_chunk,
                                int packed, int* best, int* first,
                                cudaStream_t stream) {
  if (n_groups <= 0 || lanes <= 0 || n_rows <= 0 || nc < 0 || n_win - nc + 1 < 1 ||
      channels % 8 || channels < 8 || channels > 64 || row_bytes % (packed ? 16 : 4) ||
      row_bytes < (long long)n_win * channels / (packed ? 2 : 1) || rows_per_block <= 0 ||
      rows_per_block > MAX_ROWS || lane_chunk <= 0 || (rows == nullptr && n_groups != 1) ||
      (reinterpret_cast<size_t>(queries) | reinterpret_cast<size_t>(db)) % 16)
    return (int)cudaErrorInvalidValue;
  const int words = channels / 4;
  const int n_ch = (words + 3) / 4;
  const int n_chunks = (lanes + lane_chunk - 1) / lane_chunk;
  const int n_off = n_win - nc + 1;
  const int k = min(MAX_K, (n_off + 31) / 32);
  const size_t smem = sizeof(int4) * ((size_t)lane_chunk * nc * n_ch +
                                      (size_t)rows_per_block * n_win * (n_ch | 1));
  const dim3 grid((n_rows + rows_per_block - 1) / rows_per_block, n_groups * n_chunks);
  const int* q = reinterpret_cast<const int*>(queries);
  const int* d = reinterpret_cast<const int*>(db);
  const long long row_words = row_bytes / 4;
  cudaError_t err;
  switch (k) {
#define HPFW_COARSE_CASE(K)                                                          \
  case K:                                                                            \
    err = packed ? launch<K, true>(grid, smem, stream, q, lanes, lane_chunk, n_chunks, \
                                   nc, words, d, row_words, n_win, rows, n_rows,      \
                                   rows_per_block, best, first)                       \
                 : launch<K, false>(grid, smem, stream, q, lanes, lane_chunk, n_chunks, \
                                    nc, words, d, row_words, n_win, rows, n_rows,     \
                                    rows_per_block, best, first);                     \
    break;
    HPFW_COARSE_CASE(1)
    HPFW_COARSE_CASE(2)
    HPFW_COARSE_CASE(3)
    HPFW_COARSE_CASE(4)
    HPFW_COARSE_CASE(5)
    HPFW_COARSE_CASE(6)
    HPFW_COARSE_CASE(7)
    HPFW_COARSE_CASE(8)
#undef HPFW_COARSE_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}
