// K2: hashprint encoder (context projection, lag delta, sign, bit-pack), sm_90a.
//
// Replaces hpfw_tpu/ops/pallas_fingerprint.py::_fingerprint_kernel (driven by
// pallas_fingerprint_from_spec_presplit). For print n and filter i:
//   y[r, i] = sum_j sum_b spec[r + j, b] * filters[j * n_bins + b, i]
//   d[n, i] = y[n, i] - y[n + lag, i],   bit = d > 0 ("gt") or d >= 0 ("ge")
// and the 64 bits of a print go into two 32-bit words.
//
// Bound: shared-memory traffic and its latency. The projection is ~2 * (N +
// lag) * context_dim * 64 FLOP (0.12 GFLOP for a 10 s query). The full filter
// bank (context_w * n_bins * 64 floats, 620 KB at the default config) does
// not fit a block's 227 KB, so each block streams it through shared memory
// one context frame (n_bins * 64 floats, 31 KB) at a time while its spectrum
// rows stay put.
// Design: one block per tile of 64 prints, register-tiled. Each of the 256
// threads owns 4 filters (one float4 of the slab) for RPT projection rows, so
// one (frame, bin) step is one float4 filter read, RPT spectrum reads and
// 4 * RPT FMAs. The spectrum values are gathered into registers before the
// FMAs so that their loads are in flight together: one load per FMA, issued
// in turn, serialises on shared-memory latency. The projections then go to
// shared memory, each warp takes one print, and __ballot_sync over the 32
// filter lanes yields an lsb0 word directly; msb0 is __brev of each word with
// the two words swapped.
//
// Determinism: every y[r, i] is one fmaf chain over (j, b) in order, whatever
// the tile, so a print depends only on its own spectrum rows.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;                     // prints per block
constexpr int THREADS = 256;
constexpr int NF = 64;                       // filters = bits per print
constexpr int FPT = 4;                       // filters per thread (one float4)
constexpr int FGROUPS = NF / FPT;            // 16
constexpr int RGROUPS = THREADS / FGROUPS;   // 16 row lanes
constexpr int MAX_RPT = 8;                   // TILE + lag <= 128, so lag <= 64

template <int RPT>
__global__ void __launch_bounds__(THREADS)
encoder_kernel(const float* __restrict__ spec, int n_frames, int n_bins,
               const float4* __restrict__ filters4, int context_w, int lag,
               int n_prints, int tie_ge, int msb0, int* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int rows = TILE + lag;             // projection rows this tile needs
  const int spec_floats = (rows + context_w - 1) * n_bins;
  float* s_spec = reinterpret_cast<float*>(smem4);
  float4* s_work4 = smem4 + (spec_floats + 3) / 4;   // a filter slab, later y

  const int p0 = blockIdx.x * TILE;
  const int valid = min(rows + context_w - 1, n_frames - p0) * n_bins;
  const float* src = spec + (long long)p0 * n_bins;
  for (int i = threadIdx.x; i < spec_floats; i += THREADS)
    s_spec[i] = i < valid ? src[i] : 0.f;

  const int fx = threadIdx.x % FGROUPS;    // filters 4*fx .. 4*fx+3
  const int ry = threadIdx.x / FGROUPS;    // rows ry + RGROUPS*q
  float acc[RPT][FPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
#pragma unroll
    for (int c = 0; c < FPT; ++c) acc[q][c] = 0.f;
  }

  const int slab4 = n_bins * FGROUPS;      // float4s in one context frame's slab
  for (int j = 0; j < context_w; ++j) {
    __syncthreads();  // the previous slab is consumed (and the spectrum loaded)
    const float4* slab = filters4 + (long long)j * slab4;
    for (int i = threadIdx.x; i < slab4; i += THREADS) s_work4[i] = slab[i];
    __syncthreads();
    const float* col = s_spec + (ry + j) * n_bins;
    for (int b = 0; b < n_bins; ++b) {
      const float4 f = s_work4[b * FGROUPS + fx];
      float sv[RPT];
#pragma unroll
      for (int q = 0; q < RPT; ++q)
        sv[q] = (ry + RGROUPS * q < rows) ? col[RGROUPS * q * n_bins + b] : 0.f;
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        acc[q][0] = fmaf(sv[q], f.x, acc[q][0]);
        acc[q][1] = fmaf(sv[q], f.y, acc[q][1]);
        acc[q][2] = fmaf(sv[q], f.z, acc[q][2]);
        acc[q][3] = fmaf(sv[q], f.w, acc[q][3]);
      }
    }
  }
  __syncthreads();

  float4* s_y4 = s_work4;  // rows * FGROUPS float4s
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int r = ry + RGROUPS * q;
    if (r < rows)
      s_y4[r * FGROUPS + fx] = make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
  }
  __syncthreads();

  const float* s_y = reinterpret_cast<const float*>(s_y4);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int n = warp; n < TILE; n += THREADS / 32) {
    const int p = p0 + n;
    if (p >= n_prints) break;  // the same for the whole warp
    const float d0 = s_y[n * NF + lane] - s_y[(n + lag) * NF + lane];
    const float d1 = s_y[n * NF + 32 + lane] - s_y[(n + lag) * NF + 32 + lane];
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
}

template <int RPT>
cudaError_t launch(const float* spec, int n_frames, int n_bins, const float* filters,
                   int context_w, int lag, int n_prints, int tie_ge, int msb0,
                   int* out, cudaStream_t stream) {
  const int rows = TILE + lag;
  const int work = (n_bins > rows ? n_bins : rows) * NF;
  const int spec_floats = (rows + context_w - 1) * n_bins;
  const size_t smem = sizeof(float) * ((size_t)(spec_floats + 3) / 4 * 4 + work);
  cudaError_t err = cudaFuncSetAttribute(
      encoder_kernel<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_prints + TILE - 1) / TILE;
  encoder_kernel<RPT><<<blocks, THREADS, smem, stream>>>(
      spec, n_frames, n_bins, reinterpret_cast<const float4*>(filters), context_w,
      lag, n_prints, tie_ge, msb0, out);
  return cudaGetLastError();
}

}  // namespace

// spec: (n_frames, n_bins) row-major. filters: (context_w * n_bins, 64)
// row-major, time-major rows, 16-byte aligned. out: (n_prints, 2) words,
// n_prints = n_frames - context_w + 1 - lag.
extern "C" int hpfw_fingerprint(const float* spec, int n_frames, int n_bins,
                                const float* filters, int context_w, int lag,
                                int n_prints, int tie_ge, int msb0, int* out,
                                cudaStream_t stream) {
  if (n_prints <= 0 || n_bins <= 0 || context_w <= 0 || lag <= 0 ||
      n_prints != n_frames - context_w + 1 - lag ||
      reinterpret_cast<size_t>(filters) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // Rows per thread, from the projection rows the tile needs.
  switch ((TILE + lag + RGROUPS - 1) / RGROUPS) {
    case 5: return (int)launch<5>(spec, n_frames, n_bins, filters, context_w, lag,
                                  n_prints, tie_ge, msb0, out, stream);
    case 6: return (int)launch<6>(spec, n_frames, n_bins, filters, context_w, lag,
                                  n_prints, tie_ge, msb0, out, stream);
    case 7: return (int)launch<7>(spec, n_frames, n_bins, filters, context_w, lag,
                                  n_prints, tie_ge, msb0, out, stream);
    case MAX_RPT: return (int)launch<MAX_RPT>(spec, n_frames, n_bins, filters, context_w,
                                              lag, n_prints, tie_ge, msb0, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
