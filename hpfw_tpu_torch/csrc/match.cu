// K3: dense Hamming offset scan (the matcher's hot loop), sm_90a.
//
// Replaces hpfw_tpu/ops/pallas_match.py::_scan_kernel (driven by
// pallas_score_tracks). For every track t and offset o:
//   kcut = clamp(len - o, 0, N)
//   sim  = 64 * kcut - Hamming(q[0 : kcut], d[o : o + kcut])
// over the offsets the oracle scans, o <= max(len - N, 0) (and o <= L - N);
// the result is the best sim and the first offset that reaches it. Every
// other offset scores -1 in the reference and can never win, because offset
// 0 is always scanned and scores >= 0, so the kernel does not visit them.
//
// Formulation: K5's identity (csrc/fine.cu). With the query as +-1 vectors of
// 64 channels and the track's prints as 0/1 bytes (its bits), every position
// at or past len zeroed,
//   corr01(o) = sum_n sum_c q[n][c] * d[o + n][c],
//   sim(o)    = corr01(o) + 64 * kcut - popcount(q[0 : kcut]),
// and a visited offset has kcut = min(len, N), so one prefix popcount a track
// serves all its offsets. corr01 is an exact int8 GEMM (|corr01| <= 64 N).
// One work item scores OB = M * NCOL consecutive offsets o0 + k * M + r of
// one track (M = 16 * MT rows r, NCOL = 8 * NT columns k) as
//   C[r, k] = sum_{p, c} A[r, (p, c)] * B[(p, c), k],
//   A[r, (p, c)] = q[p - r][c]   (the query as a Toeplitz matrix, 0 outside [0, N)),
//   B[(p, c), k] = d[o0 + k M + p][c],   p < P = N + M - 1,
// so that C[r, k] = corr01(o0 + k M + r). A's Toeplitz zeros waste (M - 1) / P
// of the products: 7.5% at N = 380 (M = 32).
//
// Bound: int8 tensor-core operations (2 x 64 a print pair), or the bytes of
// the prints. 1,000 tracks x 7,701 prints against a 380-print query is 2.8 G
// print pairs, 3.6 x 10^11 int8 operations (0.18 ms at 1,979 TOP/s) over
// 62 MB; the CUDA-core popcount loop this replaces ran xor, popcount and add
// a 32-bit word, 16.7 TOP/s.
// Design: mma.sync m16n8k32 s8 -> s32, both operands by ldmatrix from shared
// memory at per-row addresses, with no per-step conversions. An item's
// query rows are unpacked into +-1 bytes (M - 1 zero prints on each side, an
// 80-byte row: an odd number of 16 bytes, so the 8 rows of an ldmatrix
// matrix, one print apart, fall in different banks) and its track segment
// [o0, o0 + OB + N - 1) into 0/1 bytes, zero at or past len (64-byte rows
// with 16 bytes of padding after every M rows, so that columns k and k + 1,
// M rows apart, are 64 M + 16 bytes apart: again free of bank conflicts).
// The 8 warps split the positions p and each computes the item's whole M x
// NCOL tile, so a B fragment serves MT m-tiles and an A fragment NT n-tiles.
// A warp walks the positions of a residue class mod 16: m-tile i's A
// fragment at p is m-tile 0's at p - 16 i, so it loads one A fragment a
// position and keeps the last MT in registers. The warps' partial tiles
// meet in shared memory (the segment's bytes, once read), and one thread an
// offset forms the 64-bit key sim * 2^32 + (2^32 - 1 - o); the item's
// maximum goes to a key buffer, one key an item, and a last small kernel
// takes each track's maximum and splits it into (score, offset): visited
// offsets have sim >= 0, so the maximum is the highest score at the lowest
// offset, in any order. Blocks are persistent (as many as are resident) and
// walk the items in steps of the grid; each copies the packed prints of its
// next item with cp.async while it computes the current one, and stages the
// query once. A query too long for shared memory streams in chunks of
// positions (an item's stages; each restages its query rows and the segment
// rows its columns reach), so any length scans. Two tiles: MT = NT = 2 (OB =
// 512 offsets) for short tracks, which must still spread over the SMs (two
// blocks an SM), and MT = 2, NT = 8 (OB = 2,048, four times the products a B
// fragment serves, a segment staged once for 2,048 offsets; one block an SM)
// for tracks of at least the caller's large_from offsets (2,048 in
// match/matcher.py). The launch's geometry is decided in geometry() below.

#include <climits>
#include <cuda_runtime.h>

#include "mma_s8.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int QS = 80;            // bytes a staged query print: 64 + 16
// The two tiles (MT, NT) and the dynamic shared memory a block of each may
// take: two blocks an SM for the small one, one (the card's limit beside the
// static bytes) for the large one.
constexpr int TILE_MT = 2;
constexpr int TILE_NT[2] = {2, 8};
constexpr long long SMEM_BUDGET[2] = {112 * 1024, 226 * 1024};

// Shared memory of a block: the unpacked query rows of a chunk of cpos
// positions (cpos + M - 1 rows of QS bytes); the segment rows its columns
// reach (OB - M + cpos rows of 64 bytes, 16 more after every M rows), whose
// bytes the warps' partial C tiles (M rows of NCOL + 8 ints each) reuse once
// the products are done; and the packed prints (8 bytes a row) of the next
// stage's query and segment rows, copied while this one computes.
__host__ __device__ inline long long seg_area(int mt, int nt, int cpos) {
  const long long m = 16 * mt, ncol = 8 * nt, seg = m * ncol - m + cpos;
  const long long seg_bytes = 64 * seg + 16 * (seg / m + 1);
  const long long part_bytes = 4LL * WARPS * m * (ncol + 8);
  return seg_bytes > part_bytes ? seg_bytes : part_bytes;
}

__host__ __device__ inline long long scan_smem(int mt, int nt, int cpos) {
  const long long m = 16 * mt, ob = m * 8 * nt;
  return (cpos + m - 1) * QS + seg_area(mt, nt, cpos) + 8 * (ob + 2LL * cpos - 1);
}

// The launch, decided here alone: the tile by the offsets a track (the large
// one from large_from offsets on), the positions a chunk (all n_query + M - 1
// when they fit the tile's budget, else as many as fit), a block's shared
// memory and the items (offset blocks of OB) a track. False for a shape the
// kernel does not take.
struct Geometry {
  int tile, cpos;
  long long smem, n_blocks;
};

bool geometry(int n_query, int track_len, int large_from, Geometry* g) {
  if (n_query < 0 || track_len < n_query || n_query > INT_MAX / 128) return false;
  const long long offsets = (long long)track_len - n_query + 1;
  const int tile = offsets >= large_from, nt = TILE_NT[tile];
  const long long budget = SMEM_BUDGET[tile];
  int cpos = n_query + 16 * TILE_MT - 1;
  if (scan_smem(TILE_MT, nt, cpos) > budget) {
    // About 161 bytes a position; then the longest chunk that fits.
    cpos = (int)((budget - scan_smem(TILE_MT, nt, 0)) / (QS + 64 + 8 * 2 + 1));
    while (cpos > 0 && scan_smem(TILE_MT, nt, cpos) > budget) --cpos;
    while (scan_smem(TILE_MT, nt, cpos + 1) <= budget) ++cpos;
    if (cpos < 1) return false;
  }
  const long long ob = 16LL * TILE_MT * 8 * nt;
  *g = Geometry{tile, cpos, scan_smem(TILE_MT, nt, cpos), (offsets + ob - 1) / ob};
  return true;
}

// 16 channels (bits of one 16-bit half word) as 16 bytes: +-1 or 0/1.
template <bool PM1>
__device__ __forceinline__ uint4 spread16(unsigned bits) {
  if (PM1)
    return make_uint4(pm1_nibble(bits), pm1_nibble(bits >> 4), pm1_nibble(bits >> 8),
                      pm1_nibble(bits >> 12));
  return make_uint4(bits01_nibble(bits), bits01_nibble(bits >> 4), bits01_nibble(bits >> 8),
                    bits01_nibble(bits >> 12));
}

template <int MT, int NT>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const unsigned* __restrict__ query, int n_query,
            const unsigned* __restrict__ prints, int track_len,
            const int* __restrict__ lengths, int n_tracks, int n_blocks, int cpos,
            unsigned long long* __restrict__ keys) {
  constexpr int M = 16 * MT;
  constexpr int OB = M * 8 * NT;
  constexpr int CS = 8 * NT + 8;                                 // ints a row of a partial C
  extern __shared__ __align__(16) unsigned char smem[];
  const int q_rows_max = cpos + M - 1;
  unsigned char* const s_q = smem;                               // [cpos + M - 1][QS]
  unsigned char* const s_seg = s_q + q_rows_max * QS;            // [OB - M + cpos] rows
  int* const s_part = reinterpret_cast<int*>(s_seg);             // [WARPS][M][CS], after
  uint2* const s_raw_q = reinterpret_cast<uint2*>(s_seg + seg_area(MT, NT, cpos));
  uint2* const s_raw_s = s_raw_q + q_rows_max;                   // [OB - M + cpos]
  __shared__ int s_pc_all, s_pc_warp[WARPS];
  __shared__ unsigned long long s_best[WARPS];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint2* const q2 = reinterpret_cast<const uint2*>(query);
  const uint2* const p2 = reinterpret_cast<const uint2*>(prints);
  const int n_items = n_tracks * n_blocks;                       // (track, offset block)
  const int n_pos = n_query + M - 1;
  const int n_chunks = (n_pos + cpos - 1) / cpos;

  // An item's track, first offset, length and last visited offset.
  struct Item {
    int t, o0, len, o_max;
  };
  auto item = [&](int w) {
    Item it;
    it.t = w / n_blocks;
    it.o0 = (w % n_blocks) * OB;
    it.len = min(max(__ldg(lengths + it.t), 0), track_len);
    it.o_max = min(max(it.len - n_query, 0), track_len - n_query);
    return it;
  };
  // The first item at or after w (in steps of the grid) with an offset to
  // visit; the items skipped score key 0.
  const int stride = gridDim.x;
  auto first_item = [&](int w) {
    for (; w < n_items; w += stride) {
      if (item(w).o0 <= item(w).o_max) break;
      if (tid == 0) keys[w] = 0;
    }
    return w;
  };
  // Copy stage (w, c)'s packed prints: query prints p0 - (M - 1) + u for u <
  // cnt + M - 1 (zero outside [0, N); with_q) and track positions o0 + p0 + x
  // for x < OB - M + cnt (zero at or past len).
  auto prefetch = [&](int w, int c, bool with_q) {
    const Item it = item(w);
    const int p0 = c * cpos, cnt = min(cpos, n_pos - p0);
    if (with_q)
      for (int u = tid; u < cnt + M - 1; u += THREADS) {
        const int src = p0 - (M - 1) + u;
        const bool in = src >= 0 && src < n_query;
        cp_async8(s_raw_q + u, in ? q2 + src : q2, in);
      }
    const uint2* d = p2 + (long long)it.t * track_len;
    for (int x = tid; x < OB - M + cnt; x += THREADS) {
      const int pos = it.o0 + p0 + x;
      cp_async8(s_raw_s + x, pos < it.len ? d + pos : p2, pos < it.len);
    }
    cp_async_commit();
  };

  // ldmatrix row addresses of this thread: matrix mi = lane / 8, row lane % 8.
  // A (16 offsets x 32 bytes): matrices (rows 0-7, bytes 0-15), (rows 8-15,
  // bytes 0-15), (rows 0-7, bytes 16-31), (rows 8-15, bytes 16-31). Row r of
  // m-tile i at chunk position pl reads staged query row pl - r + M - 1.
  // B (32 bytes x 8 columns, columns as rows) for two n-tiles: matrices
  // (tile 0, bytes 0-15), (tile 0, bytes 16-31), (tile 1, ...). Column k at
  // pl reads segment row k M + pl, at byte 64 (k M + pl) + 16 (k + pl / M).
  const int mi = lane / 8;
  const int a_row = (mi & 1) * 8 + lane % 8;
  const unsigned char* const a_lane = s_q + (M - 1 - a_row) * QS + (mi >> 1) * 16;
  const int b_col = (mi >> 1) * 8 + lane % 8;                    // column within a pair
  const unsigned char* const b_lane = s_seg + (64 * M + 16) * b_col + (mi & 1) * 16;

  // Stages (item, chunk) in order; each one's packed prints are copied while
  // the one before computes. One chunk: the query is staged once a block.
  int w = first_item(blockIdx.x);
  int c = 0;
  if (w < n_items) prefetch(w, 0, true);
  // popcount(q), while the first copies fly: the score of every offset whose
  // track is at least N long.
  if (tid == 0) s_pc_all = 0;
  __syncthreads();
  {
    int pc = 0;
    for (int n = tid; n < n_query; n += THREADS) pc += __popc(q2[n].x) + __popc(q2[n].y);
    pc = __reduce_add_sync(0xffffffffu, pc);
    if (lane == 0) atomicAdd(&s_pc_all, pc);
  }
  bool q_staged = false;
  int acc[MT][NT][4];
  while (w < n_items) {
    const Item it = item(w);
    const int p0 = c * cpos, cnt = min(cpos, n_pos - p0);
    const bool stage_q = n_chunks > 1 || !q_staged;
    cp_async_wait_all();
    __syncthreads();                      // this stage's prints are in; the last one is read
    // Unpack: query rows as +-1 bytes (zero rows outside [0, N)), segment
    // rows as 0/1 bytes; 16 channels a 16-byte store.
    const int q_rows = stage_q ? cnt + M - 1 : 0, total = q_rows + OB - M + cnt;
    for (int i = tid; i < total; i += THREADS) {
      auto half = [&](uint2 v, int h) { return (h & 2 ? v.y : v.x) >> (16 * (h & 1)); };
      if (i < q_rows) {
        const uint2 v = s_raw_q[i];
        const int src = p0 - (M - 1) + i;
        const bool in = src >= 0 && src < n_query;
        uint4* dst = reinterpret_cast<uint4*>(s_q + i * QS);
#pragma unroll
        for (int h = 0; h < 4; ++h)
          dst[h] = in ? spread16<true>(half(v, h)) : make_uint4(0u, 0u, 0u, 0u);
      } else {
        // Lanes take the four 16-byte stores of their rows in turns, so
        // that the 8 lanes of each store phase hit 8 bank groups.
        const int row = i - q_rows;
        const uint2 v = s_raw_s[row];
        uint4* dst = reinterpret_cast<uint4*>(s_seg + 64 * row + 16 * (row / M));
#pragma unroll
        for (int s4 = 0; s4 < 4; ++s4) {
          const int h = (s4 + lane / 2) & 3;
          dst[h] = spread16<false>(half(v, h));
        }
      }
    }
    q_staged = true;
    __syncthreads();                      // the tiles are staged, the copy buffer is free
    int wn = w, cn = c + 1;
    if (cn == n_chunks) {
      wn = first_item(w + stride);
      cn = 0;
    }
    if (wn < n_items) prefetch(wn, cn, n_chunks > 1);

    if (c == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n][e] = 0;
    }
    // Tile i's A fragment at position pl is tile 0's at pl - 16 i, so a warp
    // walks the positions of a residue class mod 16, loads tile 0's fragment
    // once a position and keeps the last MT of them in registers.
    for (int cls = warp; cls < 16 && cls < cnt; cls += WARPS) {
      unsigned ring[MT][2][4];
#pragma unroll
      for (int i = 1; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) ldmatrix_x4(ring[i][h], a_lane + (cls - 16 * i) * QS + 32 * h);
      for (int pl = cls; pl < cnt; pl += 16) {
        const unsigned char* bp = b_lane + 64 * pl + 16 * (pl / M);
        unsigned b[2][NT / 2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ldmatrix_x4(ring[0][h], a_lane + pl * QS + 32 * h);
#pragma unroll
          for (int j = 0; j < NT / 2; ++j)
            ldmatrix_x4(b[h][j], bp + j * 16 * (64 * M + 16) + 32 * h);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int n = 0; n < NT; ++n)
              mma_s8(acc[i][n], ring[i][h], b[h][n / 2][2 * (n % 2)], b[h][n / 2][2 * (n % 2) + 1]);
#pragma unroll
        for (int i = MT - 1; i > 0; --i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) ring[i][h][e] = ring[i - 1][h][e];
      }
    }

    if (c == n_chunks - 1) {
      // popcount(q[0 : kcut]), kcut = min(len, N): the whole query's unless
      // the track is shorter.
      const int kcut = min(it.len, n_query);
      int pc = 0;
      if (kcut < n_query)
        for (int n = tid; n < kcut; n += THREADS) pc += __popc(q2[n].x) + __popc(q2[n].y);
      pc = __reduce_add_sync(0xffffffffu, pc);
      if (lane == 0) s_pc_warp[warp] = pc;
      // Thread (g, t4) holds rows 16 i + g (+ 8) of columns 8 n + 2 t4 (+ 1).
      // The warps store their partial tiles row-major at a row stride of
      // NCOL + 8 ints (the 8 rows of a store phase in different banks), then
      // one thread an entry sums the 8 partials: entry (r, k) is offset
      // o0 + k M + r.
      __syncthreads();                    // the segment is read
      const int g = lane / 4, t4 = lane % 4;
      int* const part = s_part + warp * M * CS;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          int* cp = part + (16 * i + g) * CS + 8 * n + 2 * t4;
          *reinterpret_cast<int2*>(cp) = make_int2(acc[i][n][0], acc[i][n][1]);
          *reinterpret_cast<int2*>(cp + 8 * CS) = make_int2(acc[i][n][2], acc[i][n][3]);
        }
      __syncthreads();
      int pc_k = s_pc_all;
      if (kcut < n_query) {
        pc_k = 0;
        for (int x = 0; x < WARPS; ++x) pc_k += s_pc_warp[x];
      }
      const int base = 64 * kcut - pc_k;
      unsigned long long best = 0;
      for (int x = tid; x < OB; x += THREADS) {
        const int r = x / (8 * NT), k = x % (8 * NT), o = it.o0 + k * M + r;
        if (o > it.o_max) continue;
        int corr = 0;
#pragma unroll
        for (int v = 0; v < WARPS; ++v) corr += s_part[v * M * CS + r * CS + k];
        best = max(best, ((unsigned long long)(unsigned)(corr + base) << 32) |
                             (unsigned)(~(unsigned)o));
      }
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) best = max(best, __shfl_xor_sync(0xffffffffu, best, sh));
      if (lane == 0) s_best[warp] = best;
      __syncthreads();
      if (tid == 0) {
        for (int v = 1; v < WARPS; ++v) best = max(best, s_best[v]);
        keys[w] = best;
      }
    }
    w = wn;
    c = cn;
  }
  cp_async_wait_all();
}

// The best of a track's block keys, split into (score, offset).
__global__ void merge_keys(const unsigned long long* __restrict__ keys, int n_tracks,
                           int n_blocks, int* __restrict__ scores, int* __restrict__ offsets) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n_tracks) {
    unsigned long long best = 0;
    for (int b = 0; b < n_blocks; ++b) best = max(best, keys[(long long)t * n_blocks + b]);
    scores[t] = (int)(best >> 32);
    offsets[t] = (int)(~(unsigned)(best & 0xffffffffull));
  }
}

template <int MT, int NT>
cudaError_t launch(int n_tracks, int n_blocks, int cpos, size_t smem, cudaStream_t stream,
                   const unsigned* query, int n_query, const unsigned* prints, int track_len,
                   const int* lengths, unsigned long long* keys) {
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<MT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // Persistent blocks: as many as are resident at once, each walking the
  // items (track, offset block) in steps of the grid.
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scan_kernel<MT, NT>, THREADS,
                                                           smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long items = (long long)n_tracks * n_blocks;
  const int grid = (int)(items < (long long)sms * per_sm ? items : (long long)sms * per_sm);
  if (grid < 1) return cudaErrorInvalidConfiguration;
  scan_kernel<MT, NT><<<grid, THREADS, smem, stream>>>(query, n_query, prints, track_len, lengths,
                                                       n_tracks, n_blocks, cpos, keys);
  return cudaGetLastError();
}

}  // namespace

// K3's launch for a query of n_query prints over tracks padded to track_len:
// the items a track (the keys a track the scan needs), or -1 for a shape it
// does not take. tile (0: MT = NT = 2, OB = 512; 1: MT = 2, NT = 8, OB =
// 2,048), cpos and smem, where not null, receive the rest.
extern "C" long long hpfw_score_tracks_geometry(int n_query, int track_len, int large_from,
                                                int* tile, int* cpos, long long* smem) {
  Geometry g;
  if (!geometry(n_query, track_len, large_from, &g)) return -1;
  if (tile) *tile = g.tile;
  if (cpos) *cpos = g.cpos;
  if (smem) *smem = g.smem;
  return g.n_blocks;
}

// query: (n_query, 2) words; prints: (n_tracks, track_len, 2) words, 8-byte
// aligned; lengths: (n_tracks,); large_from: offsets a track from which the
// large tile is used; keys: (n_tracks, hpfw_score_tracks_geometry(...))
// scratch, one key an item; scores, offsets: (n_tracks,).
extern "C" int hpfw_score_tracks(const int* query, int n_query, const int* prints,
                                 int n_tracks, int track_len, const int* lengths, int large_from,
                                 long long* keys, int* scores, int* offsets,
                                 cudaStream_t stream) {
  Geometry g;
  if (n_tracks <= 0 || !geometry(n_query, track_len, large_from, &g) ||
      g.n_blocks * n_tracks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  auto* k = reinterpret_cast<unsigned long long*>(keys);
  const auto* q = reinterpret_cast<const unsigned*>(query);
  const auto* p = reinterpret_cast<const unsigned*>(prints);
  const int n_blocks = (int)g.n_blocks;
  const cudaError_t err =
      g.tile ? launch<TILE_MT, TILE_NT[1]>(n_tracks, n_blocks, g.cpos, (size_t)g.smem, stream, q,
                                           n_query, p, track_len, lengths, k)
             : launch<TILE_MT, TILE_NT[0]>(n_tracks, n_blocks, g.cpos, (size_t)g.smem, stream, q,
                                           n_query, p, track_len, lengths, k);
  if (err != cudaSuccess) return (int)err;
  merge_keys<<<(n_tracks + 255) / 256, 256, 0, stream>>>(k, n_tracks, n_blocks, scores, offsets);
  return (int)cudaGetLastError();
}
