// Load-floor probe: the row sums of an int8 (T, W) matrix into (T,) int32,
// sm_90a.
//
// Replaces the inline Pallas kernel `k` of benchmarks/pass1_tune.py::main
// (:97, pallas_call :101), the measured read floor that the pass-1 coarse
// sweep (K4 over every coarse row) is judged against. Every byte is read once
// and feeds the sum, so the load cannot be elided.
//
// Bound: device-memory bandwidth. The config-4 coarse DB is 100,000 rows of
// 10,368 B (1.04 GB), at least 0.31 ms at 3.35 TB/s; the work is one dp4a a
// four bytes. Design: one warp a row, 16-byte loads, UNROLL of them in flight
// a thread, each word summed as four signed bytes by __dp4a against
// 0x01010101, then a warp shuffle reduction; no shared memory.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
constexpr int ONES = 0x01010101;

__global__ void __launch_bounds__(THREADS)
row_sum_kernel(const int4* __restrict__ db, long long n_rows, int chunks,
               int* __restrict__ out) {
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const int4* r = db + row * chunks;
  int acc = 0;
  for (int c0 = lane; c0 < chunks; c0 += UNROLL * 32) {
    int4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = c0 + u * 32;
      v[u] = c < chunks ? __ldg(r + c) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      acc = __dp4a(v[u].x, ONES, acc);
      acc = __dp4a(v[u].y, ONES, acc);
      acc = __dp4a(v[u].z, ONES, acc);
      acc = __dp4a(v[u].w, ONES, acc);
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) out[row] = acc;
}

}  // namespace

// db: n_rows rows of row_bytes int8, 16-byte aligned, row_bytes a multiple of
// 16; out: (n_rows,) int32.
extern "C" int hpfw_row_sum(const signed char* db, long long n_rows, long long row_bytes,
                            int* out, cudaStream_t stream) {
  if (n_rows <= 0 || row_bytes <= 0 || row_bytes % 16 || row_bytes / 16 > INT_MAX ||
      reinterpret_cast<size_t>(db) % 16)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_rows + WARPS - 1) / WARPS;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  row_sum_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      reinterpret_cast<const int4*>(db), n_rows, (int)(row_bytes / 16), out);
  return (int)cudaGetLastError();
}
