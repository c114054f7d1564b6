// K1: CQT filterbank with the log-magnitude epilogue, for sm_90a.
//
// Replaces hpfw_tpu/ops/pallas_frontend.py::_frontend_kernel (driven by
// pallas_cqt_from_frames). Computes, for every frame f and bin b,
//   spec[f, b] = log(log_eps + sqrt(re^2 + im^2)),
//   re = sum_k frames[f, k] * K[k, b],  im = sum_k frames[f, k] * K[k, bin_pad + b],
// where K is the NDFT matrix in the reference's padded layout: the real bank
// in columns [0, n_bins), the imaginary bank in [bin_pad, bin_pad + n_bins).
//
// Precision: the TPU kernel's scheme. Both operands are split into three
// bf16 parts (h, m, l) that carry 24 mantissa bits, and the six products of
// significance >= 2^-16 (hh, hm, mh, hl, mm, lh) run on the tensor cores
// (wgmma m64n128k16 bf16 -> f32). K is split once on the host in float64
// (ops/frontend.py::cqt_kernel_split) and stored transposed, (3, 2 * bin_pad,
// frame_len) bf16; the frames are split as _split3 does, once a block. The
// tensor cores add each product into the accumulator with truncated
// alignment, so every 32-deep slice of the reduction is summed into its own
// fragment, the small products first, and then added to the running sum with
// a rounded f32 add (summed into one accumulator, a 240 s track's spectrum
// misses the 1e-4 gate).
//
// Bound: compute, six bf16 products a float32 product: ~6 * 2 * F *
// frame_len * 2 * n_bins operations (9.9 GFLOP for a 10 s query, 245 GFLOP
// for a 240 s track) at 989 TFLOP/s; the 12.6 MB of split K stays in L2, and
// each block of BM frames reads all of it once, so L2 traffic falls as BM
// grows.
// Design: a block owns BM = 64 * WGS frames (WGS warpgroups, each 64 frames)
// and 64 bins, re and im columns both (N = 128 columns of K), so the
// magnitude and log run on the sums with no second kernel. Each 32-deep
// slice is twelve asynchronous wgmma (six products x two k16 steps) a
// warpgroup, both operands read from shared memory in the no-swizzle
// core-matrix layout. While they run, the block stages a later slice of K
// with cp.async (a ring of STAGES) and splits the frames of the next slice,
// loaded from the PCM (row stride `hop`, a torch unfold view) one slice
// earlier still, into bf16 parts. A small grid (up to 16 tiles of 64
// frames: one wave) takes one warpgroup a block; a larger one two, which
// halves the L2 reads of K. The frame_len reduction is cut into KSPLIT
// fixed chunks, one a block of a thread-block cluster of KSPLIT, so a 10 s
// query (415 frames, 14 tiles) still puts 112 blocks on the card. The chunk
// partials meet in distributed shared memory: rank z adds the KSPLIT partials
// of its BM / KSPLIT rows of the tile in rank order and applies the
// epilogue. No partial sums go to device memory.
//
// Determinism: every output is the same sequence of operations whatever F,
// the tile or the block: the chunk bounds depend on frame_len alone, a
// tensor-core product of one row does not depend on the other rows of its
// tile, the chunk partials are added in a fixed order, and both block
// shapes run a row's products in the same order. The same PCM window
// therefore gives the same spectrum row bit for bit wherever it sits in the
// input, which keeps length bucketing and exact-excerpt matches exact.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int KSPLIT = 8;           // fixed chunks of the reduction = cluster size
constexpr int BINS = 64;            // bins a block; 2 * BINS columns of K
constexpr int BN = 2 * BINS;
constexpr int BK = 32;              // reduction slice: two k16 steps
constexpr int STAGES = 3;           // slices of K in flight
constexpr int P_LD = BN + 4;        // floats a row of the partial tile
// No-swizzle K-major core-matrix layout of a (rows x BK) bf16 tile: element
// (r, k) at (k / 8) * 128 + (r / 8) * GROUP + (r % 8) * 16 + (k % 8) * 2
// bytes; a k16 step's operand starts 256 bytes on.
constexpr int GROUP = BK / 8 * 128;         // bytes an 8-row group
constexpr int B_PART = BN / 8 * GROUP;      // bytes of one part of a K slice
constexpr int B_SLOT = 3 * B_PART;

template <int WGS>
struct Shape {
  static constexpr int BM = 64 * WGS;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int A_PART = BM / 8 * GROUP;      // bytes of one part of a frame slice
  static constexpr int A_BUF = 3 * A_PART;
  static constexpr int F4 = BM * BK / 4 / THREADS;   // float4 of a frame slice a thread
  static constexpr size_t SMEM_BYTES = STAGES * B_SLOT + 2 * A_BUF;
  static_assert(BM * P_LD * 4 <= SMEM_BYTES, "the partial tile reuses the buffers");
  static_assert(BM % KSPLIT == 0 && F4 * THREADS * 4 == BM * BK, "whole rows a rank");
};

// 16 bytes from global to shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int WGS>
__global__ void __cluster_dims__(KSPLIT, 1, 1) __launch_bounds__(128 * WGS, 1)
cqt_kernel(const float* __restrict__ frames, long long row_stride, int n_frames,
           int frame_len, const __nv_bfloat16* __restrict__ ksplit, int n_bins, int bin_pad,
           int chunk, float log_eps, float* __restrict__ out) {
  using S = Shape<WGS>;
  constexpr int BM = S::BM, THREADS = S::THREADS, F4 = S::F4;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int wg = tid / 128, lane = tid % 32, warp = (tid % 128) / 32;
  const int f0 = blockIdx.y * BM;
  const int b0 = blockIdx.z * BINS;
  const int kbeg = blockIdx.x * chunk;   // blockIdx.x is the rank in the cluster
  const int kend = min(kbeg + chunk, frame_len);
  const int n_steps = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  const long long k_plane = 2LL * bin_pad * frame_len;
  unsigned char* const a_buf = smem + STAGES * B_SLOT;

  // Stage slice `step` of K into slot step % STAGES: for each part, BN rows
  // (the re then the im columns of the block's bins) of BK values.
  auto stage = [&](int step) {
    const int k0 = kbeg + step * BK;
    unsigned char* dst = smem + (step % STAGES) * B_SLOT;
    for (int i = tid; i < 3 * BN * (BK / 8); i += THREADS) {
      const int part = i / (BN * (BK / 8)), rem = i % (BN * (BK / 8));
      const int n = rem / (BK / 8), kg = rem % (BK / 8);
      const int gn = n < BINS ? b0 + n : bin_pad + b0 + (n - BINS);
      const int k = k0 + 8 * kg;
      const bool ok = k < kend;
      cp_async16(dst + part * B_PART + kg * 128 + (n / 8) * GROUP + (n % 8) * 16,
                 ok ? ksplit + part * k_plane + (long long)gn * frame_len + k : ksplit, ok);
    }
  };

  // This thread's float4s of the frames of slice `step` (zero past F and
  // past the chunk), and their split into a_buf's buffer step % 2.
  float4 fr[F4];
  auto load = [&](int step) {
    const int k0 = kbeg + step * BK;
#pragma unroll
    for (int r = 0; r < F4; ++r) {
      const int q = tid + r * THREADS, row = q / (BK / 4), k = k0 + 4 * (q % (BK / 4));
      const int f = f0 + row;
      fr[r] = f < n_frames && k < kend
                  ? __ldg(reinterpret_cast<const float4*>(frames + (long long)f * row_stride + k))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto split = [&](int step) {
    unsigned char* dst = a_buf + (step % 2) * S::A_BUF;
#pragma unroll
    for (int r = 0; r < F4; ++r) {
      const int q = tid + r * THREADS, row = q / (BK / 4), k = 4 * (q % (BK / 4));
      unsigned h0, m0, l0, h1, m1, l1;
      split3(make_float2(fr[r].x, fr[r].y), h0, m0, l0);
      split3(make_float2(fr[r].z, fr[r].w), h1, m1, l1);
      unsigned char* d = dst + (k / 8) * 128 + (row / 8) * GROUP + (row % 8) * 16 + (k % 8) * 2;
      *reinterpret_cast<uint2*>(d) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(d + S::A_PART) = make_uint2(m0, m1);
      *reinterpret_cast<uint2*>(d + 2 * S::A_PART) = make_uint2(l0, l1);
    }
  };

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) stage(s);
    cp_async_commit();
  }
  if (n_steps > 0) {
    load(0);
    split(0);
  }
  if (n_steps > 1) load(1);
  cp_async_wait<STAGES - 2>();
  fence_async_shared();
  __syncthreads();

  // Slice step: twelve wgmma into `part` (the first overwrites it), small
  // products first; while they run, stage slice step + STAGES - 1 of K,
  // split slice step + 1's frames and load slice step + 2's.
  for (int step = 0; step < n_steps; ++step) {
    const unsigned char* a = a_buf + (step % 2) * S::A_BUF + wg * 8 * GROUP;
    const unsigned char* b = smem + (step % STAGES) * B_SLOT;
    wgmma_fence();
    fence_operand(part);
#pragma unroll
    for (int kh = 0; kh < BK / 16; ++kh) {
      const unsigned long long ah = wgmma_desc(a + kh * 256, 128, GROUP),
                               bh = wgmma_desc(b + kh * 256, 128, GROUP);
      const unsigned long long am = ah + (S::A_PART >> 4), al = ah + (2 * S::A_PART >> 4);
      const unsigned long long bm = bh + (B_PART >> 4), bl = bh + (2 * B_PART >> 4);
      wgmma_m64n128k16(part, al, bh, kh);
      wgmma_m64n128k16(part, am, bm, 1);
      wgmma_m64n128k16(part, ah, bl, 1);
      wgmma_m64n128k16(part, am, bh, 1);
      wgmma_m64n128k16(part, ah, bm, 1);
      wgmma_m64n128k16(part, ah, bh, 1);
    }
    wgmma_commit();
    if (step + STAGES - 1 < n_steps) stage(step + STAGES - 1);
    cp_async_commit();
    if (step + 1 < n_steps) {
      split(step + 1);
      if (step + 2 < n_steps) load(step + 2);
    }
    wgmma_wait_all();
    fence_operand(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    cp_async_wait<STAGES - 2>();
    fence_async_shared();
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // This chunk's partial tile into shared memory: column c < BINS is bin
  // b0 + c's re, column BINS + c its im. Accumulator i of the thread is row
  // 16 * warp + lane / 4 (+ 8 for i % 4 >= 2) of its warpgroup's 64, column
  // 8 * (i / 4) + 2 * (lane % 4) + i % 2.
  float* Ps = reinterpret_cast<float*>(smem);
  const int row0 = 64 * wg + 16 * warp + lane / 4;
#pragma unroll
  for (int i = 0; i < 64; i += 4) {
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    *reinterpret_cast<float2*>(Ps + row0 * P_LD + col) = make_float2(acc[i], acc[i + 1]);
    *reinterpret_cast<float2*>(Ps + (row0 + 8) * P_LD + col) = make_float2(acc[i + 2], acc[i + 3]);
  }
  cluster.sync();

  // Rank z adds the KSPLIT partials of rows [z * RROWS, (z + 1) * RROWS) in
  // rank order, then applies the magnitude and log.
  constexpr int RROWS = BM / KSPLIT;
  const int rank = (int)cluster.block_rank();
  for (int p = tid; p < RROWS * BINS; p += THREADS) {
    const int row = rank * RROWS + p / BINS, b = p % BINS;
    float re = 0.f, im = 0.f;
#pragma unroll
    for (int r = 0; r < KSPLIT; ++r) {
      const float* src = cluster.map_shared_rank(Ps, r) + row * P_LD;
      re += src[b];
      im += src[BINS + b];
    }
    const int f = f0 + row;
    if (f < n_frames && b0 + b < n_bins)
      out[(long long)f * n_bins + b0 + b] = logf(log_eps + sqrtf(re * re + im * im));
  }
  cluster.sync();   // no block leaves while another reads its partials
}

template <int WGS>
cudaError_t launch(cudaStream_t stream, const float* frames, long long row_stride,
                   int n_frames, int frame_len, const void* ksplit, int n_bins, int bin_pad,
                   int chunk, float log_eps, float* out) {
  using S = Shape<WGS>;
  const dim3 grid(KSPLIT, (n_frames + S::BM - 1) / S::BM, bin_pad / BINS);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(cqt_kernel<WGS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  cqt_kernel<WGS><<<grid, S::THREADS, S::SMEM_BYTES, stream>>>(
      frames, row_stride, n_frames, frame_len, reinterpret_cast<const __nv_bfloat16*>(ksplit),
      n_bins, bin_pad, chunk, log_eps, out);
  return cudaGetLastError();
}

}  // namespace

// frames: row f starts at frames + f * row_stride, frame_len floats each;
// frames and row_stride 16-byte aligned. ksplit: (3, 2 * bin_pad, frame_len)
// bf16, the h, m, l parts of the transposed padded NDFT matrix, 16-byte
// aligned. out: (n_frames, n_bins) float32. One launch.
extern "C" int hpfw_cqt(const float* frames, long long row_stride, int n_frames,
                        int frame_len, const void* ksplit, int n_bins, int bin_pad,
                        float log_eps, float* out, cudaStream_t stream) {
  if (n_frames <= 0 || frame_len <= 0 || frame_len % 8 || n_bins <= 0 || bin_pad % BINS ||
      n_bins > bin_pad || row_stride < 0 || row_stride % 4 ||
      (reinterpret_cast<size_t>(frames) | reinterpret_cast<size_t>(ksplit)) % 16)
    return (int)cudaErrorInvalidValue;
  const int chunk = ((frame_len + KSPLIT - 1) / KSPLIT + BK - 1) / BK * BK;
  // Up to 16 tiles of 64 frames (one wave of clusters) take one warpgroup a
  // block; more take two. The results are equal.
  if ((n_frames + 63) / 64 * (bin_pad / BINS) <= 16)
    return (int)launch<1>(stream, frames, row_stride, n_frames, frame_len, ksplit, n_bins,
                          bin_pad, chunk, log_eps, out);
  return (int)launch<2>(stream, frames, row_stride, n_frames, frame_len, ksplit, n_bins,
                        bin_pad, chunk, log_eps, out);
}

// The message for a cudaError_t code returned by any hpfw_* entry point.
extern "C" const char* hpfw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
