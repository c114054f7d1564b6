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
// query lanes are the columns of B. mma.sync m16n8k32 s8 -> s32 takes 16
// offsets x 8 lanes x 32 bytes; a window is padded to Cp = 32 or 64 bytes in
// shared memory, with zero query columns past C, so a k-step never spans two
// windows. Staged windows sit at an odd 16-byte stride (Cp + 16 bytes), and
// query lanes too, so ldmatrix over 8 consecutive windows or 8 lanes is free
// of bank conflicts. A block of 4 warps stages up to 16 query lanes once;
// each warp then scans its own rows: it streams a row through shared memory
// in chunks of offsets whose windows overlap by Nc - 1, two buffers deep
// (cp.async; packed rows are unpacked by the loads, as before), and carries
// each lane's best key across the chunks, so a row may have any length.
// Within a chunk a warp takes 3 offset tiles at a time (a chunk is a whole
// number of such groups; the buffer holds their windows) against the 1 or 2
// lane tiles, loading each query fragment once for the 3 tiles, and loads
// the fragments of each k-step while the products of the one before run. A best is one
// 64-bit key (corr * 2^32 + 2^32 - 1 - offset) whose maximum is the highest
// correlation at the lowest offset; scores may be negative. The keys of the 8
// threads that share a lane meet by shuffles.
//
// PACKED rows (pass 1 of the two-pass matcher under prefilter_pack4) hold two
// features a byte, feature 2j in the low nibble of byte j: a window of C
// channels is C/2 contiguous bytes, whole words since C % 8 == 0. A chunk's
// packed bytes (half the global bytes) are copied with cp.async, two chunks
// deep; just before a chunk is scanned its warp sign-extends both nibbles of
// each byte with word-wide bit ops into the int8 windows the unpacked path
// stages, so the products and the results are those of the int8 rows.

#include <climits>
#include <cuda_runtime.h>

#include "mma_s8.cuh"

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

// 16 bytes, of which the first n (0..16) are copied and the rest zero-filled.
__device__ __forceinline__ void cp_async_zfill16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n));
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

// The bytes of a chunk's packed windows as staged: rounded up to 16.
__device__ __host__ __forceinline__ int raw_bytes(int cw, int channels) {
  return (cw * channels / 2 + 15) / 16 * 16;
}

// NT lane tiles of 8 lanes; PACKED rows.
template <int NT, bool PACKED>
__global__ void __launch_bounds__(THREADS)
coarse_kernel(const signed char* __restrict__ queries, int lanes, int n_lchunks, int nc,
              int channels, const signed char* __restrict__ db, long long row_bytes, int n_win,
              const int* __restrict__ rows, int n_rows, int rows_per_block, int chunk_off,
              int* __restrict__ best_out, int* __restrict__ first_out) {
  extern __shared__ __align__(16) unsigned char smem[];
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
  const int raw = PACKED ? raw_bytes(cw, channels) : 0;
  unsigned char* s_q = smem;                  // [lane][j][cp]
  // This warp's buffers: int8 rows, two chunks of windows; packed rows, one
  // chunk of windows and two of packed bytes, unpacked just before use.
  unsigned char* s_buf = smem + LC * qs + warp * (PACKED ? buf + 2 * raw : 2 * buf);
  auto slot = [&](int it) { return PACKED ? s_buf + buf + (it & 1) * raw : s_buf + (it & 1) * buf; };

  // Item it of this warp: chunk it % n_chunks of its row it / n_chunks.
  const int my_rows = n_r > warp ? (n_r - warp + WARPS - 1) / WARPS : 0;
  const int n_items = my_rows * n_chunks;
  auto row_of = [&](int it) { return warp + WARPS * (it / n_chunks); };

  // Stage the windows [w0, w0 + cw) of item it's row into slot(it), zero
  // past n_win and past C in each window. Packed rows: the chunk's packed
  // bytes, one contiguous run starting 16-byte aligned (w0 is a multiple of
  // 48 and C of 8), zero past n_win.
  auto stage = [&](int it) {
    unsigned char* dst = slot(it);
    const int rr = row_of(it);
    const long long row = rows ? rows[(long long)group * n_rows + r0 + rr] : r0 + rr;
    const int w0 = (it % n_chunks) * chunk_off;
    const int nw = min(cw, n_win - w0);
    const signed char* src = db + row * row_bytes;
    if (PACKED) {
      const signed char* p = src + (long long)w0 * channels / 2;
      const int valid = nw * channels / 2;
      for (int i = lane; i < raw / 16; i += 32) {
        const int n = min(max(valid - 16 * i, 0), 16);
        cp_async_zfill16(dst + 16 * i, n ? p + 16 * i : src, n);
      }
    } else if (channels % 16 == 0) {
      for (int i = lane; i < cw * (cp / 16); i += 32) {
        const int w = i / (cp / 16), u = i % (cp / 16);
        const bool ok = w < nw && 16 * u < channels;
        cp_async16(dst + w * ws + 16 * u, ok ? src + (long long)(w0 + w) * channels + 16 * u : src,
                   ok);
      }
    } else {
      for (int i = lane; i < cw * (cp / 8); i += 32) {
        const int w = i / (cp / 8), u = i % (cp / 8);
        const bool ok = w < nw && 8 * u < channels;
        cp_async8(dst + w * ws + 8 * u, ok ? src + (long long)(w0 + w) * channels + 8 * u : src,
                  ok);
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
      val = *reinterpret_cast<const long long*>(q_src + ((long long)v * nc + j) * channels + 8 * u);
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
    unsigned char* cur = PACKED ? s_buf : slot(it);
    if (PACKED) {
      // Sign-extend both nibbles of each packed byte into the int8 windows;
      // features past C are zero, as are windows past n_win (zero bytes).
      const int* p = reinterpret_cast<const int*>(slot(it));
      const int pwords = channels / 8;
      for (int i = lane; i < cw * (cp / 16); i += 32) {
        const int w = i / (cp / 16), u = i % (cp / 16);
        const int a = 2 * u < pwords ? p[w * pwords + 2 * u] : 0;
        const int b = 2 * u + 1 < pwords ? p[w * pwords + 2 * u + 1] : 0;
        int4 v;
        unpack_word((unsigned)a, v.x, v.y);
        unpack_word((unsigned)b, v.z, v.w);
        *reinterpret_cast<int4*>(cur + w * ws + 16 * u) = v;
      }
      __syncwarp();
    }

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

template <int NT, bool PACKED>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream, const signed char* queries,
                   int lanes, int n_lchunks, int nc, int channels, const signed char* db,
                   long long row_bytes, int n_win, const int* rows, int n_rows,
                   int rows_per_block, int chunk_off, int* best, int* first) {
  cudaError_t err = cudaFuncSetAttribute(
      coarse_kernel<NT, PACKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  coarse_kernel<NT, PACKED><<<grid, THREADS, smem, stream>>>(
      queries, lanes, n_lchunks, nc, channels, db, row_bytes, n_win, rows, n_rows,
      rows_per_block, chunk_off, best, first);
  return cudaGetLastError();
}

// The bytes of shared memory hpfw_coarse_scan takes for these shapes: the
// block's query lanes (8 for lanes <= 8, else 16) at nc * Cp + 16 bytes each
// (Cp = 32 for channels <= 32, else 64) and, a warp, two buffers of cw =
// chunk_off + nc - 1 windows at Cp + 16 bytes (int8 rows) or one such buffer
// and two of cw windows' packed bytes (packed rows).
long long coarse_smem(int lanes, int nc, int channels, int chunk_off, bool packed) {
  const long long cp = channels <= 32 ? 32 : 64;
  const long long lc = lanes <= 8 ? 8 : 16;
  const long long cw = chunk_off + nc - 1, buf = cw * (cp + 16);
  return lc * (nc * cp + 16) +
         WARPS * (packed ? buf + 2LL * raw_bytes((int)cw, channels) : 2 * buf);
}

}  // namespace

// queries: (n_groups * lanes, nc, channels) int8; db: rows of row_bytes int8,
// the first n_win * channels of which are scanned (n_win * channels / 2 when
// packed: nibble-packed rows, row_bytes a multiple of 16); both 16-byte
// aligned. rows: (n_groups, n_rows) row indices or null (rows 0 .. n_rows -
// 1, one group). best, first: (n_groups * lanes, n_rows). A block scans
// rows_per_block rows, each in chunks of chunk_off offsets (a multiple of 48).
extern "C" int hpfw_coarse_scan(const signed char* queries, int n_groups, int lanes,
                                int nc, int channels, const signed char* db,
                                long long row_bytes, int n_win, const int* rows,
                                int n_rows, int rows_per_block, int chunk_off,
                                int packed, int* best, int* first,
                                cudaStream_t stream) {
  const int nt = lanes <= 8 ? 1 : 2;
  const int n_lchunks = (lanes + 8 * nt - 1) / (8 * nt);
  if (n_groups <= 0 || lanes <= 0 || n_rows <= 0 || nc < 0 || n_win - nc + 1 < 1 ||
      channels % 8 || channels < 8 || channels > 64 || row_bytes % (packed ? 16 : 4) ||
      row_bytes < (long long)n_win * channels / (packed ? 2 : 1) || rows_per_block <= 0 ||
      chunk_off <= 0 || chunk_off % (16 * MT) || (rows == nullptr && n_groups != 1) ||
      (long long)n_groups * n_lchunks > 65535 ||
      (reinterpret_cast<size_t>(queries) | reinterpret_cast<size_t>(db)) % 16)
    return (int)cudaErrorInvalidValue;
  const long long smem = coarse_smem(lanes, nc, channels, chunk_off, packed);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_rows + rows_per_block - 1) / rows_per_block, n_groups * n_lchunks);
  cudaError_t err;
#define HPFW_COARSE_LAUNCH(NT, PACKED)                                                    \
  launch<NT, PACKED>(grid, (size_t)smem, stream, queries, lanes, n_lchunks, nc, channels, \
                     db, row_bytes, n_win, rows, n_rows, rows_per_block, chunk_off, best, \
                     first)
  if (nt == 1)
    err = packed ? HPFW_COARSE_LAUNCH(1, true) : HPFW_COARSE_LAUNCH(1, false);
  else
    err = packed ? HPFW_COARSE_LAUNCH(2, true) : HPFW_COARSE_LAUNCH(2, false);
#undef HPFW_COARSE_LAUNCH
  return (int)err;
}
