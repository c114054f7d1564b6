// K2: hashprint encoder (context projection, lag delta, sign, bit-pack), sm_90a.
//
// Replaces hpfw_tpu/ops/pallas_fingerprint.py::_fingerprint_kernel (driven by
// pallas_fingerprint_from_spec_presplit). For projection row r and filter i:
//   y[r, i] = sum_j sum_b spec[r + j, b] * filters[j * n_bins + b, i]
//   d[n, i] = y[n, i] - y[n + lag, i],   bit = d > 0 ("gt") or d >= 0 ("ge")
// and the 64 bits of a print go into two 32-bit words (lsb0, or msb0: filter
// i to bit 63 - i, which the TPU kernel lacks).
//
// Precision: the TPU kernel's scheme, as in K1 (csrc/frontend.cu). Both
// operands are split into three bf16 parts (h, m, l) that carry 24 mantissa
// bits, and the six products of significance >= 2^-16 (the filters' l.h,
// m.m, h.l, m.h, h.m, h.h, small first) run on the tensor cores (wgmma
// m64n128k16 bf16 -> f32). The split is exact in float32 and gives the
// parts of hpfw_tpu/ops/fused.py::filters_pad_split bit for bit. Each
// 32-deep slice's twelve products (two k16 steps) go into a fragment that
// the first overwrites, which a rounded f32 add folds into the sum.
//
// Bound: compute, six bf16 products a float32 product: 6 * 2 * M * 2,420 *
// 64 operations for M = N + lag projection rows (0.74 GFLOP for a 10 s
// query; 19.1 GFLOP, 0.0194 ms at 989 TFLOP/s, for a 240 s track); the
// inputs are a few MB. A short input has few tiles, so its time is one
// block's chain of slices unless the reduction is spread over more blocks.
// Design: two launches a call. The split pass splits the filters, one
// 32-deep slice a block, into the layout wgmma's A operand takes, and the
// spectrum into chunk-major bf16 parts (8 bins x consecutive rows, 16
// bytes a row), into scratch the wrapper allocates: each value is split
// once, not once a block. The encoder starts by a programmatic dependent
// launch and waits for the split pass (griddepcontrol.wait) before its
// first read. The 64 filters are wgmma's M and a tile of ROWS = 128
// projection rows its N; a tile yields ROWS - lag prints (112 at lag 16).
// There is no context matrix: the core matrix of rows r..r+7 of a staged
// chunk is 128 contiguous bytes at any r (no swizzle), so context frame
// j's B operand is frame 0's descriptor with its start 16 * j bytes on.
// The bins are padded with zeros to a multiple of 32 (121 -> 128, the
// TPU's BIN_PAD). The context frames are cut into KSPLIT = 4 fixed parts,
// one a block of a thread-block cluster, so a one-window launch still puts
// four blocks on the card, and each block's slices into two fixed halves,
// one a warpgroup, so two chains of products share the tensor cores. One
// thread stages a block's spectrum rows with TMA bulk copies (one a part
// and chunk, a barrier a 32-bin group, issued in the order the warpgroups
// first need them) and each warpgroup's filter slices through a ring of three
// (one bulk copy a slice), all completed on mbarriers. The two
// warpgroups' partial tiles are added in shared memory, the four ranks'
// meet in distributed shared memory, and rank z forms a quarter of the
// tile's prints: the partials added in rank order, then the lag delta,
// the sign, a __ballot_sync over the filters and (msb0) __brev. y never
// reaches device memory.
//
// Determinism: every y[r, i] is the same sequence of operations whatever the
// number of prints, the tile or the block: the split of the frames and of
// the slices depends on context_w alone, a tensor-core product of one row
// does not depend on the other rows of its tile, the slices and the
// partials are added in a fixed order. A print's bits therefore depend only
// on its own spectrum rows, which keeps chunked (streaming) extraction
// bit-identical to whole-track extraction.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int KSPLIT = 4;                  // fixed parts of the context frames = cluster size
constexpr int ROWS = 128;                  // projection rows a tile: wgmma N
constexpr int NF = 64;                     // filters = bits a print: wgmma M
constexpr int WGS = 2;                     // warpgroups a block, each a fixed half of the slices
constexpr int THREADS = 128 * WGS;
constexpr int BK = 32;                     // reduction slice: two k16 steps
constexpr int MAX_LAG = 64;                // ROWS - lag >= 64 prints a tile
constexpr int MAX_BINS = 128;              // bins a context frame, padded
// A filter slice part in the no-swizzle K-major core-matrix layout: element
// (i, k) at (k / 8) * 128 + (i / 8) * GROUP + (i % 8) * 16 + (k % 8) * 2
// bytes; a k16 step's operand starts 256 bytes on. A slice is three parts.
constexpr int GROUP = BK / 8 * 128;
constexpr int A_PART = NF / 8 * GROUP;
constexpr int A_SLICE = 3 * A_PART;
constexpr int A_STAGES = 3;                // filter slices in flight a warpgroup
constexpr int Y_LD = NF + 4;               // floats a row of the partial tile
constexpr int SPLIT_THREADS = 256;
constexpr int MAX_GROUPS = MAX_BINS / BK;  // 32-bin groups of a context frame
constexpr int N_BARS = MAX_GROUPS + WGS * A_STAGES;

// One block's shared memory: its spectrum rows p0 + j0 .. + spec_rows - 1
// (j0 the rank's first frame), split, each part chunk-major: element (rr,
// b) at (b / 8) * chunk + rr * 16 + (b % 8) * 2 bytes; then the ring of
// filter slices. The split spectrum in device memory has the same layout
// over all n_frames rows: unit (part, b / 8, f) of 16 bytes at ((part *
// chunks + b / 8) * n_frames + f) * 16.
struct Geometry {
  int bin_pad, chunks, frames, spec_rows, chunk, part;
  size_t spec_region, smem;
};

__host__ __device__ inline Geometry geometry(int n_bins, int context_w) {
  Geometry g;
  g.bin_pad = (n_bins + BK - 1) / BK * BK;
  g.chunks = g.bin_pad / 8;
  g.frames = (context_w + KSPLIT - 1) / KSPLIT;
  g.spec_rows = g.frames - 1 + ROWS;
  g.chunk = g.spec_rows * 16;
  g.part = g.chunks * g.chunk;
  const size_t spec = 3 * (size_t)g.part, y = (size_t)ROWS * Y_LD * 4;
  g.spec_region = ((spec > y ? spec : y) + 127) / 128 * 128;
  g.smem = g.spec_region + WGS * A_STAGES * A_SLICE + 8 * N_BARS;
  return g;
}

// Bytes of the split filters, then of the split spectrum, in the scratch.
__host__ __device__ inline long long filter_split_bytes(int n_bins, int context_w) {
  return (long long)context_w * (geometry(n_bins, context_w).bin_pad / BK) * A_SLICE;
}

__host__ __device__ inline long long spec_split_bytes(int n_frames, int n_bins, int context_w) {
  return 3LL * geometry(n_bins, context_w).chunks * n_frames * 16;
}

// mbarrier and TMA bulk-copy helpers. A barrier here takes one arrival
// (the thread that issues the copies, with the bytes they will bring) and
// completes its phase when those bytes have landed.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared by the TMA, counted on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// The split pass: blocks [0, filter_blocks) split the filters, one 32-deep
// slice (context frame s / spf, bins 32 * (s % spf) on) a block, into the
// layout the encoder's A operand takes; the rest split the spectrum, a unit
// of 8 bins of one row a thread. Zero past n_bins.
__global__ void __launch_bounds__(SPLIT_THREADS)
split_kernel(const float* __restrict__ spec, int n_frames, int n_bins,
             const float* __restrict__ filters, int context_w, int filter_blocks,
             unsigned char* __restrict__ fsplit, unsigned char* __restrict__ ssplit) {
  // The encoder may launch now; it waits for this grid before reading.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const Geometry geo = geometry(n_bins, context_w);
  if ((int)blockIdx.x < filter_blocks) {
    const int s = blockIdx.x, spf = geo.bin_pad / BK;
    const int j = s / spf, b0 = (s % spf) * BK;
    unsigned char* dst = fsplit + (long long)s * A_SLICE;
    for (int it = threadIdx.x; it < NF * BK / 2; it += SPLIT_THREADS) {
      const int i = it % NF, k = 2 * (it / NF);
      const long long row = (long long)j * n_bins + b0 + k;
      const float lo = b0 + k < n_bins ? filters[row * NF + i] : 0.f;
      const float hi = b0 + k + 1 < n_bins ? filters[(row + 1) * NF + i] : 0.f;
      unsigned h, m, l;
      split3(make_float2(lo, hi), h, m, l);
      unsigned char* d = dst + (k / 8) * 128 + (i / 8) * GROUP + (i % 8) * 16 + (k % 8) * 2;
      *reinterpret_cast<unsigned*>(d) = h;
      *reinterpret_cast<unsigned*>(d + A_PART) = m;
      *reinterpret_cast<unsigned*>(d + 2 * A_PART) = l;
    }
    return;
  }
  const long long u = (long long)(blockIdx.x - filter_blocks) * SPLIT_THREADS + threadIdx.x;
  if (u >= (long long)n_frames * geo.chunks) return;
  const int f = (int)(u / geo.chunks), ch = (int)(u % geo.chunks);
  const float* src = spec + (long long)f * n_bins + 8 * ch;
  unsigned h[4], m[4], l[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int b = 8 * ch + 2 * q;
    split3(make_float2(b < n_bins ? src[2 * q] : 0.f, b + 1 < n_bins ? src[2 * q + 1] : 0.f),
           h[q], m[q], l[q]);
  }
  const long long plane = (long long)geo.chunks * n_frames * 16;
  uint4* d = reinterpret_cast<uint4*>(ssplit + ((long long)ch * n_frames + f) * 16);
  d[0] = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(d) + plane) =
      make_uint4(m[0], m[1], m[2], m[3]);
  *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(d) + 2 * plane) =
      make_uint4(l[0], l[1], l[2], l[3]);
}

__global__ void __cluster_dims__(KSPLIT, 1, 1) __launch_bounds__(THREADS, 1)
encoder_kernel(const unsigned char* __restrict__ ssplit, int n_frames, int n_bins,
               const unsigned char* __restrict__ fsplit, int context_w, int lag,
               int n_prints, int tie_ge, int msb0, int* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Geometry geo = geometry(n_bins, context_w);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = tid / 128, wtid = tid % 128;
  const int rank = blockIdx.x % KSPLIT;      // the rank in the cluster
  const int tile_prints = ROWS - lag;
  const long long p0 = (long long)(blockIdx.x / KSPLIT) * tile_prints;
  const int j0 = rank * geo.frames;
  const int n_frames_here = max(0, min(geo.frames, context_w - j0));
  const int spf = geo.bin_pad / BK;          // slices a context frame
  // Warpgroup wg takes slices [first, first + n_steps) of the rank's.
  const int half = (n_frames_here * spf + 1) / 2;
  const int first = wg * half;
  const int n_steps = max(0, min(half, n_frames_here * spf - first));
  unsigned char* const s_spec = smem;
  unsigned char* const a_ring = smem + geo.spec_region + wg * A_STAGES * A_SLICE;
  // Barriers: the spectrum's, one a 32-bin group, then each warpgroup's ring
  // slots'.
  unsigned long long* const bars = reinterpret_cast<unsigned long long*>(
      smem + geo.spec_region + WGS * A_STAGES * A_SLICE);
  unsigned long long* const full = bars + MAX_GROUPS + wg * A_STAGES;

  // The warpgroup's slice `step` (slice j0 * spf + first + step of the split
  // filters, contiguous) into its ring slot step % A_STAGES; one thread.
  auto stage = [&](int step) {
    unsigned long long* bar = full + step % A_STAGES;
    mbar_expect(bar, A_SLICE);
    bulk_copy(a_ring + (step % A_STAGES) * A_SLICE,
              fsplit + (long long)(j0 * spf + first + step) * A_SLICE, A_SLICE, bar);
  };
  // The warpgroup's own barrier (ids 1 and 2; __syncthreads is 0).
  auto wg_sync = [&]() { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory"); };

  if (tid == 0) {
    for (int i = 0; i < N_BARS; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // This rank's spectrum rows: each (part, 8-bin chunk) is one contiguous
  // run of rows in the split spectrum and in shared memory, one bulk copy of
  // the rows before n_frames; the rows past it are zeroed here.
  const long long f0 = p0 + j0;
  const int valid = (int)max(0LL, min((long long)geo.spec_rows, n_frames - f0));
  for (int i = tid; i < 3 * geo.chunks * (geo.spec_rows - valid); i += THREADS) {
    const int pc = i / (geo.spec_rows - valid), rr = valid + i % (geo.spec_rows - valid);
    *reinterpret_cast<uint4*>(s_spec + (pc / geo.chunks) * geo.part +
                              (pc % geo.chunks) * geo.chunk + rr * 16) = make_uint4(0, 0, 0, 0);
  }
  // The split pass's output is read from here on.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (tid == 0) {
    // The 32-bin groups in the order the warpgroups first need them.
    const int g1 = half % spf;
    for (int k = 0; k < spf; ++k) {
      const int grp = k == 0 ? 0 : k <= g1 ? (k == 1 ? g1 : k - 1) : k;
      mbar_expect(bars + grp, 3 * (BK / 8) * valid * 16);
      for (int pc = 0; pc < 3 * (BK / 8) && valid > 0; ++pc) {
        const int part = pc / (BK / 8), ch = grp * (BK / 8) + pc % (BK / 8);
        bulk_copy(s_spec + part * geo.part + ch * geo.chunk,
                  ssplit + ((long long)(part * geo.chunks + ch) * n_frames + f0) * 16,
                  valid * 16, bars + grp);
      }
    }
  }
  if (wtid == 0)
    for (int st = 0; st < A_STAGES - 1 && st < n_steps; ++st) stage(st);

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_async_shared();    // the zeroed rows, for the tensor cores
  __syncthreads();

  // Slice step: twelve wgmma into `part` (the first overwrites it), small
  // products first, while slice step + A_STAGES - 1 is copied. The two
  // warpgroups' chains of products run side by side on the tensor cores.
  for (int step = 0; step < n_steps; ++step) {
    const int sl = first + step;             // the rank's slice
    const unsigned char* a = a_ring + (step % A_STAGES) * A_SLICE;
    mbar_wait(bars + sl % spf, 0);           // the slice's bins of the spectrum
    mbar_wait(full + step % A_STAGES, (step / A_STAGES) & 1);
    const unsigned char* b = s_spec + (sl / spf) * 16 + (sl % spf) * (BK / 8) * geo.chunk;
    wgmma_fence();
    fence_operand(part);
#pragma unroll
    for (int kh = 0; kh < BK / 16; ++kh) {
      const unsigned long long ah = wgmma_desc(a + kh * 256, 128, GROUP);
      const unsigned long long bh = wgmma_desc(b + kh * 2 * geo.chunk, geo.chunk, 128);
      const unsigned long long am = ah + (A_PART >> 4), al = ah + (2 * A_PART >> 4);
      const unsigned long long bm = bh + (geo.part >> 4), bl = bh + (2 * geo.part >> 4);
      wgmma_m64n128k16(part, al, bh, kh);
      wgmma_m64n128k16(part, am, bm, 1);
      wgmma_m64n128k16(part, ah, bl, 1);
      wgmma_m64n128k16(part, am, bh, 1);
      wgmma_m64n128k16(part, ah, bm, 1);
      wgmma_m64n128k16(part, ah, bh, 1);
    }
    wgmma_commit();
    // Slot (step - 1) % A_STAGES is free: slice step - 1's products are
    // done in every warp of the warpgroup (its barrier below).
    if (wtid == 0 && step + A_STAGES - 1 < n_steps) stage(step + A_STAGES - 1);
    wgmma_wait_all();
    fence_operand(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    wg_sync();
  }
  // Every copy into this block has landed before its shared memory is
  // reused: a rank with no context frames (context_w 5 leaves rank 3 none)
  // waits here on the spectrum groups its loop never read.
  for (int grp = 0; grp < spf; ++grp) mbar_wait(bars + grp, 0);
  __syncthreads();

  // This rank's partial tile into shared memory, row-major over projection
  // rows: warpgroup 0's sums, then warpgroup 1's added to them. Accumulator
  // i of the thread is filter 16 * (warp % 4) + lane / 4 (+ 8 for i % 4 >=
  // 2), row 8 * (i / 4) + 2 * (lane % 4) + i % 2.
  float* const y = reinterpret_cast<float*>(smem);
  const int f = 16 * (warp % 4) + lane / 4;
#pragma unroll
  for (int w = 0; w < WGS; ++w) {
    if (wg == w) {
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        const int r = 8 * (i / 4) + 2 * (lane % 4);
        float* y0 = y + r * Y_LD + f;
        float* y1 = y0 + Y_LD;
        y0[0] = w ? y0[0] + acc[i] : acc[i];
        y1[0] = w ? y1[0] + acc[i + 1] : acc[i + 1];
        y0[8] = w ? y0[8] + acc[i + 2] : acc[i + 2];
        y1[8] = w ? y1[8] + acc[i + 3] : acc[i + 3];
      }
    }
    if (w + 1 < WGS) __syncthreads();
  }
  cluster.sync();

  // Rank z forms prints [z * per, (z + 1) * per) of the tile, one a warp at
  // a time: the KSPLIT partials of rows n and n + lag added in rank order,
  // then the delta, the sign and the pack.
  const int per = (tile_prints + KSPLIT - 1) / KSPLIT;
  const int n_end = min(tile_prints, (rank + 1) * per);
  for (int n = rank * per + warp; n < n_end; n += THREADS / 32) {
    const long long p = p0 + n;
    if (p >= n_prints) break;  // the same for the whole warp
    float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll
    for (int r = 0; r < KSPLIT; ++r) {
      const float* src = cluster.map_shared_rank(y, r);
      a0 += src[n * Y_LD + lane];
      a1 += src[n * Y_LD + 32 + lane];
      b0 += src[(n + lag) * Y_LD + lane];
      b1 += src[(n + lag) * Y_LD + 32 + lane];
    }
    const float d0 = a0 - b0, d1 = a1 - b1;
    unsigned w0 = __ballot_sync(0xffffffffu, tie_ge ? d0 >= 0.f : d0 > 0.f);
    unsigned w1 = __ballot_sync(0xffffffffu, tie_ge ? d1 >= 0.f : d1 > 0.f);
    if (msb0) {  // filter i -> bit 63 - i of the 64-bit word
      const unsigned t = __brev(w1);
      w1 = __brev(w0);
      w0 = t;
    }
    if (lane == 0) {
      out[2LL * p] = (int)w0;
      out[2LL * p + 1] = (int)w1;
    }
  }
  cluster.sync();   // no block leaves while another reads its partials
}

}  // namespace

// Bytes of scratch hpfw_fingerprint needs: the split filters and spectrum.
extern "C" long long hpfw_fingerprint_scratch(int n_frames, int n_bins, int context_w) {
  if (n_frames <= 0 || n_bins <= 0 || n_bins > MAX_BINS || context_w <= 0) return 0;
  return filter_split_bytes(n_bins, context_w) + spec_split_bytes(n_frames, n_bins, context_w);
}

// spec: (n_frames, n_bins) row-major. filters: (context_w * n_bins, 64)
// row-major, time-major rows. scratch: hpfw_fingerprint_scratch bytes,
// 16-byte aligned. out: (n_prints, 2) words, n_prints = n_frames -
// context_w + 1 - lag, 1 <= lag <= 64. Two launches: the split pass, then
// the encoder.
extern "C" int hpfw_fingerprint(const float* spec, int n_frames, int n_bins,
                                const float* filters, int context_w, int lag,
                                int n_prints, int tie_ge, int msb0, void* scratch, int* out,
                                cudaStream_t stream) {
  if (n_prints <= 0 || n_bins <= 0 || n_bins > MAX_BINS || context_w <= 0 || lag <= 0 ||
      lag > MAX_LAG || n_prints != n_frames - context_w + 1 - lag ||
      reinterpret_cast<size_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Geometry geo = geometry(n_bins, context_w);
  const long long tiles = ((long long)n_prints + ROWS - lag - 1) / (ROWS - lag);
  const long long units = (long long)n_frames * geo.chunks;
  const long long split_blocks =
      context_w * (geo.bin_pad / BK) + (units + SPLIT_THREADS - 1) / SPLIT_THREADS;
  if (geo.smem > 227 * 1024 || KSPLIT * tiles > 0x7fffffff || split_blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  unsigned char* fsplit = static_cast<unsigned char*>(scratch);
  unsigned char* ssplit = fsplit + filter_split_bytes(n_bins, context_w);
  split_kernel<<<(unsigned)split_blocks, SPLIT_THREADS, 0, stream>>>(
      spec, n_frames, n_bins, filters, context_w, context_w * (geo.bin_pad / BK), fsplit,
      ssplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(encoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  // A programmatic dependent launch: the encoder's blocks start while the
  // split pass runs and wait for it (griddepcontrol.wait) before its reads.
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(KSPLIT * tiles));
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = geo.smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, encoder_kernel, (const unsigned char*)ssplit, n_frames,
                           n_bins, (const unsigned char*)fsplit, context_w, lag, n_prints,
                           tie_ge, msb0, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
