// K4: coarse correlation scan with a max / first-best-offset epilogue, sm_90a.
//
// Replaces hpfw_tpu/ops/pallas_coarse.py::_tile_best (driven by
// pallas_coarse_scan) and ::_stacked_kernel (driven by
// pallas_coarse_scan_batch_stacked, with and without packed4, and
// pallas_coarse_rescan_stacked): one body, four host surfaces. For query lane
// g of group b and DB row r:
//   corr(o) = sum_{j < Nc} sum_{c < C} q[g][j][c] * d[row][o + j][c]
//   for o < n_off = n_win - Nc + 1, then best = max_o corr(o) and
//   first = min {o : corr(o) = best},
// in exact int32 over int8 values (+-1, 0 past a track's end, or window sums).
// Group b owns lanes b*lanes .. b*lanes + lanes - 1 and the rows
// rows[b*n_rows + r] (or r itself with no index array): the dense scan is one
// group, the block-diagonal pass-2 rescan one group per query, which reads its
// pooled rows through the index array instead of a gathered copy.
//
// Bound: int8 tensor-core operations, or the bytes of the rows. One 10 s
// query's pass 1 against 100,000 x 60 s tracks is 2 x 5.6 G int8 products
// over 0.5 GB of rows; the TPU kernel runs them as a GEMM on its matrix unit.
// Design: the scan of a row is a GEMM, corr[o, g] = sum_k A[o, k] * B[k, g]
// with K = Nc * C: row o of A is the run of the row's windows that starts at
// window o (a Toeplitz view of the staged row: no copy, no zeros), and the
// query lanes are the columns of B. A window is padded to Cp = 32 or 64 bytes
// in shared memory, with zero query columns past C, so a k-step of 32 bytes
// never spans two windows.
//
// The int8 body: mma.sync m16n8k32 s8 -> s32 takes 16 offsets x 8 lanes x 32
// bytes. Staged windows sit at an odd 16-byte stride (Cp + 16 bytes), and
// query lanes too, so ldmatrix over 8 consecutive windows or 8 lanes is free
// of bank conflicts. A block of 4 warps stages up to 16 query lanes once;
// each warp then scans its own rows: it streams a row through shared memory
// in chunks of offsets whose windows overlap by Nc - 1, two buffers deep
// (cp.async), and carries each lane's best key across the chunks, so a row
// may have any length.
// Within a chunk a warp takes 3 offset tiles at a time (a chunk is a whole
// number of such groups; the buffer holds their windows) against the 1 or 2
// lane tiles, loading each query fragment once for the 3 tiles, and loads
// the fragments of each k-step while the products of the one before run. A best is one
// 64-bit key (corr * 2^32 + 2^32 - 1 - offset) whose maximum is the highest
// correlation at the lowest offset; scores may be negative. The keys of the 8
// threads that share a lane meet by shuffles.
//
// PACKED rows (pass 1 of the two-pass matcher under prefilter_pack4) take a
// body of their own, on wgmma: see "The packed body" below.

#include <climits>
#include <cuda_runtime.h>

#include "mma_s8.cuh"
#include "wgmma.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MT = 3;          // offset tiles of 16 a warp takes at a time
constexpr long long NO_KEY = LLONG_MIN;

__device__ __forceinline__ long long pack_key(int corr, int offset) {
  return (long long)corr * 4294967296LL + (long long)(~(unsigned)offset);
}

// 16 bytes from global to shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x2(unsigned& r0, unsigned& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
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

// q / d for q >= 0 and q * d < 2^32: the high word of q * ceil(2^32 / d).
struct DivBy {
  unsigned m;
  int d;
  __device__ explicit DivBy(int d_) : m(d_ > 1 ? 0xffffffffu / d_ + 1 : 0u), d(d_) {}
  __device__ int operator()(int q) const { return d > 1 ? (int)__umulhi((unsigned)q, m) : q; }
};

// ---- The packed body -------------------------------------------------------
//
// Pass 1 of the two-pass matcher under prefilter_pack4: replaces the packed4
// branch of hpfw_tpu/ops/pallas_coarse.py:299 pallas_coarse_scan_batch_stacked
// (packed4=True) -> _stacked_kernel :201. Rows hold two features a byte,
// feature 2j in the low nibble of byte j: a window of C channels is C/2
// contiguous bytes, whole words since C % 8 == 0. One group, no index array.
//
// Bound: int8 tensor-core operations, 2 lanes Nc C n_off a row: 7.24e12 for a
// call of 16 queries x 2 phases x 26 windows x 32 channels x 136 offsets over
// 10^6 rows, 3.66 ms at 1,979 TOP/s, against 0.80 ms for its 2.69 GB of
// packed rows at 3.35 TB/s.
//
// Design. The products are wgmma m64n96k32 s8 -> s32, with the window
// positions as N and 64 rows as M: 32 lanes (a block's; wider groups go over
// grid.y) times two halves of each query. Rows 16 w + 8 h + g hold lane 8 w +
// g's half h: half 0 the query windows j with j % 32 < 16, half 1 the others,
// each block of 32 windows 16 k-steps (32 at Cp = 64) that read windows t0 +
// 32 b + i (i < 16) of the positions. Half 1 is then half 0's product 16
// positions on: corr(t0 + n) = D[h = 0][n] + D[h = 1][n + 16], two registers
// of one thread. The products are this shape because of their cost on this
// card. With the lanes as N (m64n32k32, the shape a first design took) a
// product takes ~39 clk, ~14 fixed and the rest its 3 KB of shared reads, and
// a chain of dependent products ~350 clk a step. So a tile is two
// independent chains of 96 positions (192, 176 of them yielded), and three
// blocks share an SM.
// The lanes' halves are staged once as the K-major A operand, [K / 16][64
// rows][16 bytes], zero past C, past nc and past the lanes. A query longer
// than shared memory holds is staged a_blocks blocks of 32 windows at a
// time, again for each tile. Rows are cut into segments of seg_off offsets (a
// whole row where one fits, as at catalog shapes) and streamed through
// shared memory chunk_segs segments at a time: the cp.async of the next
// chunk's packed bytes runs while a chunk is scanned. The block then
// sign-extends a chunk (unpack_word) into Cp / 16 planes: plane p holds
// bytes 16p .. 16p + 15 of each window at a 16-byte stride, the chunk's
// segments back to back. The B operand of 96 positions from t0 at window
// offset i is then the no-swizzle K-major operand at window t0 + i of the
// planes: a core matrix is 8 positions, 128 contiguous bytes (SBO), and the
// next 16 bytes of K are the next plane (LBO): a Toeplitz view, no copy. Each
// packed row is read from device memory and unpacked once a launch for up to
// 32 lanes. Every position is scanned; those past a segment's valid offsets
// (they straddle into the next segment) or past its last segment are masked.
// Past the bound the kernel pays for 32 ceil(nc / 32) / nc query windows
// (32 / 26), 192 / 176 positions a tile, n_win / n_off (161 / 136) and each
// chunk's last tile.
//
// Epilogue: after a tile's products, each thread adds its 2 x 22 sums in
// place and keeps lane 8 w + g's best (corr, position) of the segment the
// tile is in (its positions come in rising order, so a strictly greater corr
// wins); the other blocks' products run meanwhile. At a segment's end the 4
// threads of a lane meet by shuffles, and the 64-bit key goes into the lane's
// slot of the segment in shared memory (by max: a long row's slot carries its
// key from segment to segment). After a chunk, the slots of rows whose last
// segment it held are written out. The grid is persistent (the blocks that
// fit on the card at once), each block taking every gridDim.x-th unit of
// work: a chunk of whole rows, or a long row.
//
// The short body (coarse_kernel<8, true>) takes queries of nc <= HALF
// windows, such as a stream's 128-print ring (nc = 7), for which the halves
// would multiply zeros: half 1 is empty and half 0 runs 16 k-steps for nc
// windows. Its 64 rows are 64 lanes, row m lane lane0 + m holding its
// windows 0 .. nc - 1, so A is [nc Cp / 16][64 rows][16 bytes] and a chain
// runs nc Cp / 32 k-steps, k-step i (at Cp = 32) reading the planes at window
// t0 + i. A tile yields all its TILE_N positions, and the last one reads nc -
// 1 windows past them. Each thread keeps a best for each of its two lanes, the
// accumulator rows 16 w + g and 16 w + 8 + g; a segment walk takes a chain's
// columns in groups of 32, only those that meet the segment, masked only where
// they are not inside its valid columns. The slots are [chunk_segs][64]. A
// launch takes ceil(lanes / 64) blocks on grid.y, so each packed row is read
// and unpacked once for up to 64 lanes. The wrapper picks the body from nc
// alone (ops/coarse_scan.py packed_lanes) and passes its lanes a block. Past
// the bound it pays for the lanes a block lacks of 64, n_win / n_off (161 /
// 155 at nc = 7) and each chunk's last tile.

constexpr int CHAIN_N = 96;             // positions a chain of products covers: N
constexpr int CHAIN_B = CHAIN_N / 8;    // its n-blocks of 8 positions
constexpr int TILE_N = 2 * CHAIN_N;     // positions a tile's two chains cover
constexpr int HALF = 16;                // windows of a half in each block of 32
constexpr int TILE_STEP = TILE_N - HALF;  // positions a tile yields
constexpr int N_MAX = 32;               // lanes a packed block stages: 64 rows / 2 halves
constexpr int SHORT_LANES = 64;         // lanes a block of the short body: a row each

// The bytes of shared memory the packed body takes: a_blocks blocks of 32
// query windows of the 64 rows (HALF windows of Cp bytes each), the planes
// (Cp bytes a window, for the chunk's tiles and the windows the last one
// reads past its TILE_STEP positions), the chunk's packed bytes (each
// segment's rounded up to 16) and the slots (8 bytes a segment and lane).
// The short body (block_lanes SHORT_LANES; a_blocks 1): the query's nc
// windows of the 64 rows, the planes of whole tiles and nc - 1 windows past
// them, the packed bytes, and 64 slots a segment.
long long packed_smem(int block_lanes, int nc, int channels, int seg_win, int chunk_segs,
                      int a_blocks) {
  const long long cp = channels <= 32 ? 32 : 64;
  if (block_lanes == SHORT_LANES) {
    const long long tiles = ((long long)chunk_segs * seg_win + TILE_N - 1) / TILE_N;
    return 64LL * nc * cp + cp * (tiles * TILE_N + nc - 1) +
           chunk_segs * (((long long)seg_win * channels / 2 + 15) / 16 * 16) +
           8LL * SHORT_LANES * chunk_segs;
  }
  const long long tiles = ((long long)chunk_segs * seg_win + TILE_STEP - 1) / TILE_STEP;
  const long long n_blocks = (nc + 2 * HALF - 1) / (2 * HALF);
  return 64LL * HALF * cp * a_blocks +
         cp * ((tiles - 1) * TILE_STEP + TILE_N + 2 * HALF * (n_blocks - 1) + HALF - 1) +
         chunk_segs * (((long long)seg_win * channels / 2 + 15) / 16 * 16) +
         8LL * N_MAX * chunk_segs;
}

// NT = 4: the body above, 32 lanes of two halves; NT = 8: the short body.
template <int NT>
__device__ __forceinline__ void packed_scan(unsigned char* smem,
                                            const signed char* __restrict__ queries, int lanes,
                                            int nc, int channels,
                                            const signed char* __restrict__ db,
                                            long long row_bytes, int n_win, int n_rows,
                                            int seg_off, int chunk_segs, int a_blocks,
                                            int* __restrict__ best_out,
                                            int* __restrict__ first_out) {
  constexpr bool SHORT = NT == SHORT_LANES / 8;
  constexpr int LANES = SHORT ? SHORT_LANES : N_MAX;     // lanes a block
  constexpr int STEP = SHORT ? TILE_N : TILE_STEP;       // positions a tile yields
  constexpr int NV = TILE_STEP / 8;          // n-blocks of 8 positions a tile yields
  const int cp = channels <= 32 ? 32 : 64;
  const int n_off = n_win - nc + 1;
  const int seg_win = seg_off + nc - 1;      // windows a segment holds
  const int pieces = (n_off + seg_off - 1) / seg_off;
  const int n_blocks = (nc + 2 * HALF - 1) / (2 * HALF);   // blocks of 32 query windows
  const int tiles_max = (chunk_segs * seg_win + STEP - 1) / STEP;
  // The last tile reads windows up to its last position + 32 (n_blocks - 1) + HALF - 1
  // (the short body: + nc - 1).
  const int plane_win =
      SHORT ? tiles_max * TILE_N + nc - 1
            : (tiles_max - 1) * TILE_STEP + TILE_N + 2 * HALF * (n_blocks - 1) + HALF - 1;
  const int plane = 16 * plane_win;          // bytes from one plane to the next
  const int seg_bytes = (seg_win * channels / 2 + 15) / 16 * 16;
  // A block of 32 query windows, 64 rows (the short body: the query's nc windows).
  const int a_bytes = 64 * (SHORT ? nc : HALF) * cp;
  // s_a: [a_blocks][HALF Cp / 16][64 rows][16] (the short body: [nc Cp / 16][64 rows][16]).
  unsigned char* s_a = smem;
  unsigned char* s_b = s_a + a_blocks * a_bytes;   // [Cp / 16][plane_win][16]
  unsigned char* s_p = s_b + cp * plane_win;       // [chunk_segs][seg_bytes]
  long long* s_key = reinterpret_cast<long long*>(s_p + chunk_segs * seg_bytes);  // [seg][LANES]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int lane0 = blockIdx.y * LANES;
  const int n_lanes = min(LANES, lanes - lane0);
  // The lane of this thread's rows (the short body: of row 16 w + g; row 16 w
  // + 8 + g holds lane my_lane + 8).
  const int my_lane = (SHORT ? 16 : 8) * warp + g;
  const DivBy by_seg(seg_win);

  // Unit u of the launch: rows u * chunk_segs on, one chunk of a segment each
  // (whole rows), or row u, a chunk for each of its pieces. Block b takes
  // units b, b + gridDim.x, ...: every row is scanned by one block.
  struct Chunk {
    long long row0;
    int ns, o0, n_valid;   // segments; first offset and valid offsets of each
    bool last;             // it holds its rows' last segments
  };
  auto chunk_at = [&](long long u, int piece) {
    Chunk k;
    k.row0 = u * (pieces == 1 ? chunk_segs : 1);
    k.ns = (int)min((long long)(pieces == 1 ? chunk_segs : 1), n_rows - k.row0);
    k.o0 = piece * seg_off;
    k.n_valid = min(seg_off, n_off - k.o0);
    k.last = piece == pieces - 1;
    return k;
  };
  const long long units = pieces == 1 ? (n_rows + chunk_segs - 1) / chunk_segs : n_rows;

  // A chunk's packed segments into s_p, each from its first window (16-byte
  // aligned: o0 is a multiple of 8) for the windows the row has, rounded up
  // to 16 bytes (still inside the row: row_bytes is a multiple of 16).
  auto stage = [&](const Chunk& k) {
    const int n16 = (min(seg_win, n_win - k.o0) * channels / 2 + 15) / 16;
    const DivBy by_n16(n16);
    for (int i = threadIdx.x; i < k.ns * n16; i += THREADS) {
      const int s = by_n16(i), u = i - s * n16;
      cp_async16(s_p + s * seg_bytes + 16 * u,
                 db + (k.row0 + s) * row_bytes + (long long)k.o0 * channels / 2 + 16 * u, true);
    }
    cp_async_commit();
  };

  // A chunk's windows into the planes that hold features. Windows past a
  // row's end take stale bytes: only masked positions read them.
  auto unpack = [&](const Chunk& k) {
    const int words = channels / 8;          // packed words a window
    const int n_q = k.ns * seg_win;
    if constexpr (SHORT) {
      // C a multiple of 32: a window's packed bytes are whole 16-byte loads,
      // each unpacked into two planes (conflict-free, one division a window).
      if (channels % 32 == 0) {
        for (int q = threadIdx.x; q < n_q; q += THREADS) {
          const int s = by_seg(q), w = q - s * seg_win;
          const uint4* src = reinterpret_cast<const uint4*>(s_p + s * seg_bytes) + w * words / 4;
          for (int u = 0; u < words / 4; ++u) {
            const uint4 p4 = src[u];
            int4 v0, v1;
            unpack_word(p4.x, v0.x, v0.y);
            unpack_word(p4.y, v0.z, v0.w);
            unpack_word(p4.z, v1.x, v1.y);
            unpack_word(p4.w, v1.z, v1.w);
            *reinterpret_cast<int4*>(s_b + 2 * u * plane + 16 * q) = v0;
            *reinterpret_cast<int4*>(s_b + (2 * u + 1) * plane + 16 * q) = v1;
          }
        }
        return;
      }
    }
    for (int p = 0; 16 * p < channels; ++p)
      for (int q = threadIdx.x; q < n_q; q += THREADS) {
        const int s = by_seg(q), w = q - s * seg_win;
        const unsigned* src =
            reinterpret_cast<const unsigned*>(s_p + s * seg_bytes) + w * words + 2 * p;
        int4 v;
        unpack_word(src[0], v.x, v.y);
        unpack_word(2 * p + 1 < words ? src[1] : 0u, v.z, v.w);
        *reinterpret_cast<int4*>(s_b + p * plane + 16 * q) = v;
      }
  };

  // Query blocks b0 .. b0 + a_blocks - 1 of the 64 rows into s_a: row m =
  // 16 w + 8 h + g is lane 8 w + g's windows 32 b + 16 h + i, zero past nc,
  // past C and past n_lanes. The short body: row m is lane m's windows 0 ..
  // nc - 1, zero past C and past n_lanes.
  const signed char* q_src = queries + (long long)lane0 * nc * channels;
  const int kq = cp / 16;                    // 16-byte columns of K a window
  auto stage_a = [&](int b0) {
    if constexpr (SHORT) {
      for (int i = threadIdx.x; i < nc * kq * 64; i += THREADS) {
        const int m = i % 64, kc = i / 64;
        const int u = kc % kq, j = kc / kq;
        long long lo = 0, hi = 0;
        if (m < n_lanes) {
          const signed char* src = q_src + ((long long)m * nc + j) * channels + 16 * u;
          if (16 * u < channels) lo = *reinterpret_cast<const long long*>(src);
          if (16 * u + 8 < channels) hi = *reinterpret_cast<const long long*>(src + 8);
        }
        *reinterpret_cast<longlong2*>(s_a + 16 * i) = make_longlong2(lo, hi);
      }
      return;
    }
    for (int i = threadIdx.x; i < a_blocks * HALF * kq * 64; i += THREADS) {
      const int m = i % 64, kc = i / 64;
      const int u = kc % kq, bi = kc / kq;   // bi: block and window of the half
      const int b = b0 + bi / HALF, j = 32 * b + HALF * ((m / 8) % 2) + bi % HALF;
      const int v = 8 * (m / 16) + m % 8;
      long long lo = 0, hi = 0;
      if (v < n_lanes && j < nc) {
        const signed char* src = q_src + ((long long)v * nc + j) * channels + 16 * u;
        if (16 * u < channels) lo = *reinterpret_cast<const long long*>(src);
        if (16 * u + 8 < channels) hi = *reinterpret_cast<const long long*>(src + 8);
      }
      *reinterpret_cast<longlong2*>(s_a + 16 * i) = make_longlong2(lo, hi);
    }
  };

  if (blockIdx.x < units) stage(chunk_at(blockIdx.x, 0));

  // The planes past C, which no window writes, zero; the slots empty; the
  // query blocks, once if they all fit.
  for (int p = (channels + 15) / 16; p < kq; ++p)
    for (int q = threadIdx.x; q < plane_win; q += THREADS)
      *reinterpret_cast<int4*>(s_b + p * plane + 16 * q) = make_int4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < chunk_segs * LANES; i += THREADS) s_key[i] = NO_KEY;
  if (a_blocks >= n_blocks) stage_a(0);

  // The products of positions t0 .. t0 + TILE_N - 1 into d0 and d1: k-step s
  // of block b reads window i = s / (Cp / 32) of each half, bytes 32 (s % (Cp
  // / 32)) on, and the planes at window t0 + 32 b + i (the short body: window
  // i of the query, and the planes at window t0 + i).
  const int a_steps = HALF * cp / 32;        // k-steps a block of 32 windows
  const unsigned long long da0 = wgmma_desc(s_a, 64 * 16, 128);
  const unsigned long long db0 = wgmma_desc(s_b, plane, 128);
  const int upper = 2 * plane / 16;          // descriptor units to planes 2 and 3
  int d0[CHAIN_N / 2], d1[CHAIN_N / 2];      // positions t0 on, t0 + CHAIN_N on
  auto issue = [&](int t0) {
    for (int b0 = 0; b0 < n_blocks; b0 += a_blocks) {
      if (a_blocks < n_blocks) {             // restage the query blocks
        wgmma_wait_all();
        __syncthreads();
        stage_a(b0);
        fence_async_shared();
        __syncthreads();
      }
      wgmma_fence();
      fence_operand(d0);
      fence_operand(d1);
      for (int bs = 0; bs < min(a_blocks, n_blocks - b0) * a_steps; ++bs) {
        const int bi = bs / a_steps, s = bs % a_steps;
        const int i = cp == 32 ? s : s >> 1;
        const int bw = t0 + 32 * (b0 + bi) + i + (cp == 32 ? 0 : (s & 1) * upper);
        wgmma_m64n96k32_s8(d0, da0 + 2 * 64 * bs, db0 + bw, b0 + bs);
        wgmma_m64n96k32_s8(d1, da0 + 2 * 64 * bs, db0 + bw + CHAIN_N, b0 + bs);
      }
      wgmma_commit();
    }
  };

  // This thread's best of segment `cur` of the chunk, for lane my_lane (the
  // short body: best_c1, best_p1 for lane my_lane + 8, too).
  int best_c = INT_MIN, best_p = 0, cur = -1;
  int best_c1 = INT_MIN, best_p1 = 0;
  auto flush = [&](const Chunk& k) {
    long long key = best_c == INT_MIN ? NO_KEY
                                      : pack_key(best_c, k.o0 + best_p - cur * seg_win);
    key = max(key, __shfl_xor_sync(0xffffffffu, key, 1));
    key = max(key, __shfl_xor_sync(0xffffffffu, key, 2));
    long long* slot = s_key + cur * LANES + my_lane;
    if (t == 0) *slot = max(*slot, key);
    if constexpr (SHORT) {
      long long key1 = best_c1 == INT_MIN ? NO_KEY
                                          : pack_key(best_c1, k.o0 + best_p1 - cur * seg_win);
      key1 = max(key1, __shfl_xor_sync(0xffffffffu, key1, 1));
      key1 = max(key1, __shfl_xor_sync(0xffffffffu, key1, 2));
      if (t == 0) slot[8] = max(slot[8], key1);
    }
  };
  // Column n = 8 nb + 2 t + e of the tile holds its sum in the register of
  // half 0 (d0 for nb < CHAIN_B, d1 after).
  auto sum = [&](int nb, int e) -> int& {
    return nb < CHAIN_B ? d0[4 * nb + e] : d1[4 * (nb - CHAIN_B) + e];
  };
  // The warp walks the segments the tile's positions meet, in order, each
  // over its valid columns [va, vb).
  auto take = [&](int t0, const Chunk& k) {
    const int s_lo = by_seg(t0), s_hi = min(by_seg(t0 + TILE_STEP - 1), k.ns - 1);
    for (int s = s_lo; s <= s_hi; ++s) {
      if (s != cur) {
        if (cur >= 0) flush(k);
        cur = s;
        best_c = INT_MIN;
      }
      const int va = max(s * seg_win - t0, 0) - 2 * t;
      const int vb = min(s * seg_win + k.n_valid - t0, TILE_STEP) - 2 * t;
#pragma unroll
      for (int nb = 0; nb < NV; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * nb + e;          // the column less 2 t
          const bool up = c >= va && c < vb && sum(nb, e) > best_c;
          best_c = up ? sum(nb, e) : best_c;
          best_p = up ? t0 + 2 * t + c : best_p;
        }
    }
  };

  // The short body's products of positions t0 .. t0 + TILE_N - 1 into d0
  // and d1: k-step s reads the query's window i = s / (Cp / 32), bytes 32 (s %
  // (Cp / 32)) on, and the planes at window t0 + i.
  auto issue_short = [&](int t0) {
    wgmma_fence();
    fence_operand(d0);
    fence_operand(d1);
    for (int s = 0; s < nc * cp / 32; ++s) {
      const int bw = t0 + (cp == 32 ? s : (s >> 1) + (s & 1) * upper);
      wgmma_m64n96k32_s8(d0, da0 + 2 * 64 * s, db0 + bw, s);
      wgmma_m64n96k32_s8(d1, da0 + 2 * 64 * s, db0 + bw + CHAIN_N, s);
    }
    wgmma_commit();
  };
  // Its walk over the segments a chain's positions meet: rows 16 w + g
  // (d[4 nb + e]) and 16 w + 8 + g (d[4 nb + 2 + e]), column 8 nb + 2 t + e,
  // in groups of 4 n-blocks (32 columns), a group only where it meets the
  // segment's valid columns [ua, ub), masked only where it is not inside them.
  // A visit keeps each row's best and its column (__vibmax_s32: the max, and
  // whether the earlier one holds, so ties keep the first), then merges it.
  auto take_chain = [&](const int (&d)[CHAIN_N / 2], int t0, const Chunk& k) {
    const int s_lo = by_seg(t0), s_hi = min(by_seg(t0 + CHAIN_N - 1), k.ns - 1);
    for (int s = s_lo; s <= s_hi; ++s) {
      if (s != cur) {
        if (cur >= 0) flush(k);
        cur = s;
        best_c = best_c1 = INT_MIN;
      }
      const int ua = max(s * seg_win - t0, 0);
      const int ub = min(s * seg_win + k.n_valid - t0, CHAIN_N);
      int m0 = INT_MIN, c0 = 0, m1 = INT_MIN, c1 = 0;   // columns less 2 t
      auto keep = [&](int nb, int e, bool in) {
        bool held;
        m0 = __vibmax_s32(m0, in ? d[4 * nb + e] : INT_MIN, &held);
        c0 = held ? c0 : 8 * nb + e;
        m1 = __vibmax_s32(m1, in ? d[4 * nb + 2 + e] : INT_MIN, &held);
        c1 = held ? c1 : 8 * nb + e;
      };
#pragma unroll
      for (int nb0 = 0; nb0 < CHAIN_B; nb0 += 4) {
        if (8 * nb0 + 32 <= ua || 8 * nb0 >= ub) continue;
        if (ua <= 8 * nb0 && 8 * nb0 + 32 <= ub) {
#pragma unroll
          for (int nb = nb0; nb < nb0 + 4; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) keep(nb, e, true);
        } else {
#pragma unroll
          for (int nb = nb0; nb < nb0 + 4; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * nb + 2 * t + e;
              keep(nb, e, c >= ua && c < ub);
            }
        }
      }
      if (m0 > best_c) {
        best_c = m0;
        best_p = t0 + 2 * t + c0;
      }
      if (m1 > best_c1) {
        best_c1 = m1;
        best_p1 = t0 + 2 * t + c1;
      }
    }
  };

  for (long long u = blockIdx.x; u < units; u += gridDim.x)
    for (int piece = 0; piece < pieces; ++piece) {
      const Chunk k = chunk_at(u, piece);
      cp_async_wait_all();
      __syncthreads();
      unpack(k);
      fence_async_shared();
      __syncthreads();
      if (piece + 1 < pieces)
        stage(chunk_at(u, piece + 1));
      else if (u + gridDim.x < units)
        stage(chunk_at(u + gridDim.x, 0));

      if constexpr (SHORT) {
        const int tiles = (k.ns * seg_win + TILE_N - 1) / TILE_N;
        for (int tl = 0; tl < tiles; ++tl) {
          const int t0 = tl * TILE_N;
          issue_short(t0);
          wgmma_wait_all();
          fence_operand(d0);
          fence_operand(d1);
          take_chain(d0, t0, k);
          take_chain(d1, t0 + CHAIN_N, k);
        }
      } else {
        const int tiles = (k.ns * seg_win + TILE_STEP - 1) / TILE_STEP;
        for (int tl = 0; tl < tiles; ++tl) {
          const int t0 = tl * TILE_STEP;
          issue(t0);
          wgmma_wait_all();
          fence_operand(d0);
          fence_operand(d1);
#pragma unroll
          for (int nb = 0; nb < NV; ++nb)    // corr(n) = D[h = 0][n] + D[h = 1][n + 16]
#pragma unroll
            for (int e = 0; e < 2; ++e)
              sum(nb, e) += nb + 2 < CHAIN_B ? d0[4 * (nb + 2) + 2 + e]
                                             : d1[4 * (nb + 2 - CHAIN_B) + 2 + e];
          take(t0, k);
        }
      }
      if (cur >= 0) flush(k);
      cur = -1;
      __syncthreads();

      if (k.last)
        for (int i = threadIdx.x; i < k.ns * n_lanes; i += THREADS) {
          const int s = i % k.ns, l = i / k.ns;
          long long* slot = s_key + s * LANES + l;
          const long long key = *slot;
          *slot = NO_KEY;
          const long long out = (long long)(lane0 + l) * n_rows + k.row0 + s;
          best_out[out] = (int)(key >> 32);
          first_out[out] = (int)(~(unsigned)(key & 0xffffffffLL));
        }
    }
}

// NT lane tiles of 8 (the int8 body); PACKED rows (the packed body, above,
// with NT = 4: its 32 lanes; the short body, specialized below, with NT = 8).
template <int NT, bool PACKED>
__global__ void __launch_bounds__(THREADS)
coarse_kernel(const signed char* __restrict__ queries, int lanes, int n_lchunks, int nc,
              int channels, const signed char* __restrict__ db, long long row_bytes, int n_win,
              const int* __restrict__ rows, int n_rows, int rows_per_block, int chunk_off,
              int chunk_segs, int a_blocks, int* __restrict__ best_out,
              int* __restrict__ first_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (PACKED) {
    packed_scan<NT>(smem, queries, lanes, nc, channels, db, row_bytes, n_win, n_rows, chunk_off,
                    chunk_segs, a_blocks, best_out, first_out);
  } else {
    constexpr int LC = 8 * NT;                  // lanes a block stages
    const int cp = channels <= 32 ? 32 : 64;    // bytes a staged window holds (zeros past C)
    const int ws = cp + 16;                     // window stride: an odd number of 16 B
    const int qs = nc * cp + 16;                // lane stride: an odd number of 16 B
    const int ksteps = cp / 32;                 // k-steps of 32 bytes a window
    const int group = blockIdx.y / n_lchunks;
    const int lane0 = (blockIdx.y % n_lchunks) * LC;
    const int n_lanes = min(LC, lanes - lane0);
    const int r0 = blockIdx.x * rows_per_block;
    const int n_r = min(rows_per_block, n_rows - r0);
    const int n_off = n_win - nc + 1;
    const int n_chunks = (n_off + chunk_off - 1) / chunk_off;
    const int cw = chunk_off + nc - 1;          // windows a chunk buffer holds
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int buf = cw * ws;                    // bytes of a chunk's staged windows
    unsigned char* s_q = smem;                  // [lane][j][cp]
    // This warp's two buffers of a chunk's windows.
    unsigned char* s_buf = smem + LC * qs + warp * 2 * buf;
    auto slot = [&](int it) { return s_buf + (it & 1) * buf; };

    // Item it of this warp: chunk it % n_chunks of its row it / n_chunks.
    const int my_rows = n_r > warp ? (n_r - warp + WARPS - 1) / WARPS : 0;
    const int n_items = my_rows * n_chunks;
    auto row_of = [&](int it) { return warp + WARPS * (it / n_chunks); };

    // Stage the windows [w0, w0 + cw) of item it's row into slot(it), zero
    // past n_win and past C in each window.
    auto stage = [&](int it) {
      unsigned char* dst = slot(it);
      const int rr = row_of(it);
      const long long row = rows ? rows[(long long)group * n_rows + r0 + rr] : r0 + rr;
      const int w0 = (it % n_chunks) * chunk_off;
      const int nw = min(cw, n_win - w0);
      const signed char* src = db + row * row_bytes;
      if (channels % 16 == 0) {
        for (int i = lane; i < cw * (cp / 16); i += 32) {
          const int w = i / (cp / 16), u = i % (cp / 16);
          const bool ok = w < nw && 16 * u < channels;
          cp_async16(dst + w * ws + 16 * u,
                     ok ? src + (long long)(w0 + w) * channels + 16 * u : src, ok);
        }
      } else {
        for (int i = lane; i < cw * (cp / 8); i += 32) {
          const int w = i / (cp / 8), u = i % (cp / 8);
          const bool ok = w < nw && 8 * u < channels;
          cp_async8(dst + w * ws + 8 * u,
                    ok ? src + (long long)(w0 + w) * channels + 8 * u : src, ok);
        }
      }
    };
    if (n_items > 0) stage(0);
    cp_async_commit();

    // The block's query lanes, zero past n_lanes and past C in each window.
    const signed char* q_src = queries + (long long)(group * lanes + lane0) * nc * channels;
    for (int i = threadIdx.x; i < LC * nc * (cp / 8); i += THREADS) {
      const int u = i % (cp / 8), vj = i / (cp / 8);
      const int j = vj % nc, v = vj / nc;
      long long val = 0;
      if (v < n_lanes && 8 * u < channels)
        val = *reinterpret_cast<const long long*>(q_src + ((long long)v * nc + j) * channels +
                                                  8 * u);
      *reinterpret_cast<long long*>(s_q + v * qs + j * cp + 8 * u) = val;
    }
    __syncthreads();

    // ldmatrix row addresses of this thread: matrix lane / 8, row lane % 8.
    // A (16 offsets x 32 bytes): matrices (rows 0-7, bytes 0-15), (rows 8-15,
    // bytes 0-15), (rows 0-7, bytes 16-31), (rows 8-15, bytes 16-31).
    const int mi = lane / 8;
    const int a_off = ((mi & 1) * 8 + lane % 8) * ws + (mi >> 1) * 16;
    // B (32 bytes x 8 lanes, lanes as rows): matrices (tile 0, bytes 0-15),
    // (tile 0, bytes 16-31), (tile 1, ...). With one tile only lanes 0-15's
    // addresses are read.
    const int b_off = ((NT == 2 ? mi >> 1 : 0) * 8 + lane % 8) * qs + (mi & 1) * 16;

    long long best[NT][2];
    for (int it = 0; it < n_items; ++it) {
      if (it + 1 < n_items) stage(it + 1);
      cp_async_commit();
      cp_async_wait1();
      __syncwarp();
      unsigned char* cur = slot(it);

      const int chunk = it % n_chunks;
      if (chunk == 0) {
  #pragma unroll
        for (int n = 0; n < NT; ++n) best[n][0] = best[n][1] = NO_KEY;
      }
      const int w0 = chunk * chunk_off;
      const int o_cnt = min(chunk_off, n_off - w0);
      const int tiles = (o_cnt + 15) / 16;
      const int n_steps = nc * ksteps;
      for (int tg = 0; tg < tiles; tg += MT) {
        int acc[MT][NT][4];
  #pragma unroll
        for (int i = 0; i < MT; ++i)
  #pragma unroll
          for (int n = 0; n < NT; ++n)
  #pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][n][e] = 0;
        const unsigned char* a_base = cur + tg * 16 * ws + a_off;
        // The fragments of k-step s (window j = s / ksteps, its bytes 32 * (s %
        // ksteps) on): each lane's query bytes 32 s on, and for each offset
        // tile the row bytes 32 s + 16 j past its first window.
        auto load = [&](int s, unsigned (&b)[4], unsigned (&a)[MT][4]) {
          const int j = ksteps == 2 ? s >> 1 : s;
          if constexpr (NT == 2)
            ldmatrix_x4(b, s_q + b_off + 32 * s);
          else
            ldmatrix_x2(b[0], b[1], s_q + b_off + 32 * s);
          const unsigned char* ap = a_base + 32 * s + 16 * j;
  #pragma unroll
          for (int i = 0; i < MT; ++i) ldmatrix_x4(a[i], ap + i * 16 * ws);
        };
        auto mma_all = [&](const unsigned (&b)[4], const unsigned (&a)[MT][4]) {
  #pragma unroll
          for (int i = 0; i < MT; ++i)
  #pragma unroll
            for (int n = 0; n < NT; ++n) mma_s8(acc[i][n], a[i], b[2 * n], b[2 * n + 1]);
        };
        // Two steps a turn, each step's fragments loaded during the one before;
        // an odd last step runs against a zero query fragment.
        unsigned b0[4] = {0, 0, 0, 0}, b1[4] = {0, 0, 0, 0}, a0[MT][4], a1[MT][4];
        if (n_steps > 0) load(0, b0, a0);
        for (int s = 0; s < n_steps; s += 2) {
          load(min(s + 1, n_steps - 1), b1, a1);
          if (s + 1 >= n_steps) b1[0] = b1[1] = b1[2] = b1[3] = 0;
          mma_all(b0, a0);
          load(min(s + 2, n_steps - 1), b0, a0);
          mma_all(b1, a1);
        }
        // Thread (g, t) holds offsets (tg + i) * 16 + g (+ 8) for lanes 2t, 2t + 1;
        // offsets past the chunk's (and the row's) last are masked.
  #pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int o = (tg + i) * 16 + g;
  #pragma unroll
          for (int n = 0; n < NT; ++n) {
            if (o < o_cnt) {
              best[n][0] = max(best[n][0], pack_key(acc[i][n][0], w0 + o));
              best[n][1] = max(best[n][1], pack_key(acc[i][n][1], w0 + o));
            }
            if (o + 8 < o_cnt) {
              best[n][0] = max(best[n][0], pack_key(acc[i][n][2], w0 + o + 8));
              best[n][1] = max(best[n][1], pack_key(acc[i][n][3], w0 + o + 8));
            }
          }
        }
      }
      __syncwarp();

      if (chunk == n_chunks - 1) {
  #pragma unroll
        for (int n = 0; n < NT; ++n)
  #pragma unroll
          for (int e = 0; e < 2; ++e) {
            long long k = best[n][e];
            k = max(k, __shfl_xor_sync(0xffffffffu, k, 4));
            k = max(k, __shfl_xor_sync(0xffffffffu, k, 8));
            k = max(k, __shfl_xor_sync(0xffffffffu, k, 16));
            const int v = n * 8 + 2 * t + e;
            if (g == 0 && v < n_lanes) {
              const long long out =
                  (long long)(group * lanes + lane0 + v) * n_rows + r0 + row_of(it);
              best_out[out] = (int)(k >> 32);
              first_out[out] = (int)(~(unsigned)(k & 0xffffffffLL));
            }
          }
      }
    }
  }
}

// The short body: its 64 lanes, held to the registers of three blocks an SM.
template <>
__global__ void __launch_bounds__(THREADS, 3)
coarse_kernel<SHORT_LANES / 8, true>(const signed char* __restrict__ queries, int lanes,
                                     int n_lchunks, int nc, int channels,
                                     const signed char* __restrict__ db, long long row_bytes,
                                     int n_win, const int* __restrict__ rows, int n_rows,
                                     int rows_per_block, int chunk_off, int chunk_segs,
                                     int a_blocks, int* __restrict__ best_out,
                                     int* __restrict__ first_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  packed_scan<SHORT_LANES / 8>(smem, queries, lanes, nc, channels, db, row_bytes, n_win, n_rows,
                               chunk_off, chunk_segs, a_blocks, best_out, first_out);
}

template <int NT, bool PACKED>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream, const signed char* queries,
                   int lanes, int n_lchunks, int nc, int channels, const signed char* db,
                   long long row_bytes, int n_win, const int* rows, int n_rows,
                   int rows_per_block, int chunk_off, int chunk_segs, int a_blocks, int* best,
                   int* first) {
  cudaError_t err = cudaFuncSetAttribute(
      coarse_kernel<NT, PACKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (PACKED) {
    // Persistent: the blocks that fit on the card at once, at most one a unit
    // of work (grid.x on entry).
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, coarse_kernel<NT, PACKED>,
                                                             THREADS, smem)) != cudaSuccess)
      return err;
    grid.x = min(grid.x, (unsigned)(max(per_sm, 1) * sms));
  }
  coarse_kernel<NT, PACKED><<<grid, THREADS, smem, stream>>>(
      queries, lanes, n_lchunks, nc, channels, db, row_bytes, n_win, rows, n_rows,
      rows_per_block, chunk_off, chunk_segs, a_blocks, best, first);
  return cudaGetLastError();
}

// The bytes of shared memory the int8 body takes for these shapes: the
// block's query lanes (8 for lanes <= 8, else 16) at nc * Cp + 16 bytes each
// (Cp = 32 for channels <= 32, else 64) and, a warp, two buffers of cw =
// chunk_off + nc - 1 windows at Cp + 16 bytes.
long long coarse_smem(int lanes, int nc, int channels, int chunk_off) {
  const long long cp = channels <= 32 ? 32 : 64;
  const long long lc = lanes <= 8 ? 8 : 16;
  const long long cw = chunk_off + nc - 1, buf = cw * (cp + 16);
  return lc * (nc * cp + 16) + WARPS * 2 * buf;
}

// The packed body: lanes in chunks of N_MAX over grid.y; rows in segments of
// chunk_off offsets (a multiple of 8, or n_off or more: whole rows),
// chunk_segs segments a chunk (1 for segments shorter than a row); a_blocks
// blocks of 32 query windows staged at a time. block_lanes, as the wrapper
// chose it, names the body: N_MAX, or SHORT_LANES for the short body, which
// takes queries of nc <= HALF windows only, and a_blocks 1.
int packed_launch(const signed char* queries, int n_groups, int lanes, int nc, int channels,
                  const signed char* db, long long row_bytes, int n_win, const int* rows,
                  int n_rows, int rows_per_block, int chunk_off, int block_lanes,
                  int chunk_segs, int a_blocks, int* best, int* first, cudaStream_t stream) {
  const int n_off = n_win - nc + 1;
  const int seg_off = min(chunk_off, n_off);
  const bool short_body = block_lanes == SHORT_LANES;
  if (!short_body && block_lanes != N_MAX) return (int)cudaErrorInvalidValue;
  const int n_lchunks = (lanes + block_lanes - 1) / block_lanes;
  if (rows != nullptr || n_groups != 1 || nc < 1 || row_bytes % 16 ||
      row_bytes < (long long)n_win * channels / 2 || seg_off < 1 || chunk_segs < 1 ||
      a_blocks < 1 || (short_body && (a_blocks != 1 || nc > HALF)) ||
      (seg_off < n_off && (seg_off % 8 || chunk_segs != 1)) || n_lchunks > 65535)
    return (int)cudaErrorInvalidValue;
  const int seg_win = seg_off + nc - 1;
  const long long smem = packed_smem(block_lanes, nc, channels, seg_win, chunk_segs, a_blocks);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int pieces = (n_off + seg_off - 1) / seg_off;
  const long long units = pieces == 1 ? (n_rows + chunk_segs - 1) / chunk_segs : n_rows;
  const dim3 grid((unsigned)units, n_lchunks);
#define HPFW_PACKED_LAUNCH(LANES)                                                           \
  launch<LANES / 8, true>(grid, (size_t)smem, stream, queries, lanes, n_lchunks, nc, channels, \
                          db, row_bytes, n_win, rows, n_rows, rows_per_block, seg_off,         \
                          chunk_segs, a_blocks, best, first)
  const cudaError_t err =
      short_body ? HPFW_PACKED_LAUNCH(SHORT_LANES) : HPFW_PACKED_LAUNCH(N_MAX);
#undef HPFW_PACKED_LAUNCH
  return (int)err;
}

}  // namespace

// queries: (n_groups * lanes, nc, channels) int8; db: rows of row_bytes int8,
// the first n_win * channels of which are scanned (n_win * channels / 2 when
// packed: nibble-packed rows, row_bytes a multiple of 16); both 16-byte
// aligned. rows: (n_groups, n_rows) row indices or null (rows 0 .. n_rows -
// 1, one group; always so when packed). best, first: (n_groups * lanes,
// n_rows). The int8 body: a block scans rows_per_block rows, each in chunks
// of chunk_off offsets (a multiple of 48); chunk_segs and a_blocks are not
// read. packed: 0 for the int8 body, else the packed body's lanes a block
// (see packed_launch); rows_per_block is not read there.
extern "C" int hpfw_coarse_scan(const signed char* queries, int n_groups, int lanes,
                                int nc, int channels, const signed char* db,
                                long long row_bytes, int n_win, const int* rows,
                                int n_rows, int rows_per_block, int chunk_off,
                                int packed, int chunk_segs, int a_blocks, int* best,
                                int* first, cudaStream_t stream) {
  if (n_groups <= 0 || lanes <= 0 || n_rows <= 0 || nc < 0 || n_win - nc + 1 < 1 ||
      channels % 8 || channels < 8 || channels > 64 ||
      (reinterpret_cast<size_t>(queries) | reinterpret_cast<size_t>(db)) % 16)
    return (int)cudaErrorInvalidValue;
  if (packed)
    return packed_launch(queries, n_groups, lanes, nc, channels, db, row_bytes, n_win, rows,
                         n_rows, rows_per_block, chunk_off, packed, chunk_segs, a_blocks, best,
                         first, stream);
  const int nt = lanes <= 8 ? 1 : 2;
  const int n_lchunks = (lanes + 8 * nt - 1) / (8 * nt);
  if (row_bytes % 4 || row_bytes < (long long)n_win * channels || rows_per_block <= 0 ||
      chunk_off <= 0 || chunk_off % (16 * MT) || (rows == nullptr && n_groups != 1) ||
      (long long)n_groups * n_lchunks > 65535)
    return (int)cudaErrorInvalidValue;
  const long long smem = coarse_smem(lanes, nc, channels, chunk_off);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_rows + rows_per_block - 1) / rows_per_block, n_groups * n_lchunks);
  cudaError_t err;
#define HPFW_COARSE_LAUNCH(NT)                                                              \
  launch<NT, false>(grid, (size_t)smem, stream, queries, lanes, n_lchunks, nc, channels, db, \
                    row_bytes, n_win, rows, n_rows, rows_per_block, chunk_off, 0, 0, best,   \
                    first)
  err = nt == 1 ? HPFW_COARSE_LAUNCH(1) : HPFW_COARSE_LAUNCH(2);
#undef HPFW_COARSE_LAUNCH
  return (int)err;
}
