// K1: CQT filterbank with the log-magnitude epilogue, for sm_90a.
//
// Replaces hpfw_tpu/ops/pallas_frontend.py::_frontend_kernel (driven by
// pallas_cqt_from_frames). Computes, for every frame f and bin b,
//   spec[f, b] = log(log_eps + sqrt(re^2 + im^2)),
//   re = sum_k frames[f, k] * K[k, b],  im = sum_k frames[f, k] * K[k, n_bins + b],
// where K is the (frame_len, 2 * n_bins) float32 NDFT matrix [Kre | Kim].
//
// Bound: compute. The product is ~2 * F * frame_len * 2 * n_bins FLOP
// (1.6 GFLOP for a 10 s query at the default config, 41 GFLOP for a 240 s
// track), against 4 * frame_len * 2 * n_bins bytes of K that stay in L2.
// Design: a shared-memory-tiled float32 FFMA GEMM. Each thread owns the real
// and the imaginary accumulators of the same 4 bins for 4 frames. Frames are
// read straight from the PCM with row stride `hop` (a torch unfold view), so
// the 16x-overlapping frame matrix is never written. The frame_len reduction
// is cut into KSPLIT fixed chunks, one per grid z, so a 10 s query (415
// frames, 28 output tiles) still puts 224 blocks on the 132 SMs; a second
// kernel adds the KSPLIT partial sums in order and applies the magnitude and
// log. No tensor cores: TF32 would break the bit contract, and
// split-precision tensor-core products are later work.
//
// Determinism: each partial is one fmaf chain over its chunk in order, and
// the chunk bounds depend on frame_len alone, so every output is the same
// sequence of operations whatever F, the tile or the block. The same PCM
// window therefore gives the same spectrum row bit for bit wherever it sits
// in the input, which keeps length bucketing and exact-excerpt matches exact.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // frames per block
constexpr int BN = 32;   // bins per block (each bin has a re and an im column)
constexpr int BK = 16;   // reduction slice staged in shared memory
constexpr int TM = 4;    // frames per thread
constexpr int TN = 4;    // bins per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 128
constexpr int KSPLIT = 8;  // fixed chunks of the frame_len reduction
constexpr int EPI_THREADS = 256;

// Partial sums over chunk blockIdx.z: partials[z, f, b] = re, [z, f, n_bins + b] = im.
__global__ void __launch_bounds__(THREADS)
cqt_partial_kernel(const float* __restrict__ frames, long long row_stride,
                   int n_frames, int frame_len, const float* __restrict__ kmat,
                   int n_bins, int chunk, float* __restrict__ partials) {
  __shared__ float As[BK][BM + 1];  // +1 spreads the transposing stores over banks
  __shared__ float Bre[BK][BN];
  __shared__ float Bim[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int f0 = blockIdx.x * BM;
  const int b0 = blockIdx.y * BN;
  const long long kcols = 2LL * n_bins;
  const int kbeg = blockIdx.z * chunk;
  const int kend = min(kbeg + chunk, frame_len);

  float re[TM][TN];
  float im[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      re[i][j] = 0.f;
      im[i][j] = 0.f;
    }
  }

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    // Consecutive threads read consecutive samples of one frame.
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int m = i / BK;
      const int k = i % BK;
      const int f = f0 + m;
      As[k][m] = (f < n_frames && k0 + k < kend)
                     ? frames[(long long)f * row_stride + k0 + k]
                     : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int k = i / BN;
      const int n = i % BN;
      const int b = b0 + n;
      const bool ok = b < n_bins && k0 + k < kend;
      const long long row = (long long)(k0 + k) * kcols;
      Bre[k][n] = ok ? kmat[row + b] : 0.f;
      Bim[k][n] = ok ? kmat[row + n_bins + b] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], br[TN], bi[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        br[j] = Bre[k][tx * TN + j];
        bi[j] = Bim[k][tx * TN + j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          re[i][j] = fmaf(a[i], br[j], re[i][j]);
          im[i][j] = fmaf(a[i], bi[j], im[i][j]);
        }
      }
    }
    __syncthreads();
  }

  float* part = partials + (long long)blockIdx.z * n_frames * kcols;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int f = f0 + ty * TM + i;
    if (f >= n_frames) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int b = b0 + tx * TN + j;
      if (b < n_bins) {
        part[(long long)f * kcols + b] = re[i][j];
        part[(long long)f * kcols + n_bins + b] = im[i][j];
      }
    }
  }
}

// out[f, b] = log(log_eps + |sum over z of the partials|), z in order.
__global__ void __launch_bounds__(EPI_THREADS)
cqt_epilogue_kernel(const float* __restrict__ partials, int n_frames, int n_bins,
                    float log_eps, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * EPI_THREADS + threadIdx.x;
  if (i >= (long long)n_frames * n_bins) return;
  const long long f = i / n_bins;
  const int b = (int)(i % n_bins);
  const long long plane = (long long)n_frames * 2 * n_bins;
  const float* p = partials + f * 2 * n_bins + b;
  float re = 0.f, im = 0.f;
#pragma unroll
  for (int z = 0; z < KSPLIT; ++z) {
    re += p[z * plane];
    im += p[z * plane + n_bins];
  }
  out[i] = logf(log_eps + sqrtf(re * re + im * im));
}

}  // namespace

// The number of partial sums hpfw_cqt needs room for: its `partials`
// argument holds hpfw_cqt_splits() * n_frames * 2 * n_bins floats.
extern "C" int hpfw_cqt_splits() { return KSPLIT; }

// frames: row f starts at frames + f * row_stride, frame_len floats each.
// kmat: (frame_len, 2 * n_bins) row-major. partials: scratch, see above.
// out: (n_frames, n_bins).
extern "C" int hpfw_cqt(const float* frames, long long row_stride, int n_frames,
                        int frame_len, const float* kmat, int n_bins, float log_eps,
                        float* partials, float* out, cudaStream_t stream) {
  if (n_frames <= 0 || frame_len <= 0 || n_bins <= 0 || row_stride < 0)
    return (int)cudaErrorInvalidValue;
  const int chunk = ((frame_len + KSPLIT - 1) / KSPLIT + BK - 1) / BK * BK;
  const dim3 grid((n_frames + BM - 1) / BM, (n_bins + BN - 1) / BN, KSPLIT);
  cqt_partial_kernel<<<grid, THREADS, 0, stream>>>(frames, row_stride, n_frames,
                                                   frame_len, kmat, n_bins, chunk,
                                                   partials);
  const long long n_out = (long long)n_frames * n_bins;
  cqt_epilogue_kernel<<<(unsigned)((n_out + EPI_THREADS - 1) / EPI_THREADS),
                        EPI_THREADS, 0, stream>>>(partials, n_frames, n_bins,
                                                  log_eps, out);
  return (int)cudaGetLastError();
}

// The message for a cudaError_t code returned by any hpfw_* entry point.
extern "C" const char* hpfw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
