// Host side of api.fingerprint_stream's staging: one copy thread's chunk of a
// PCM batch copied into pinned memory with streaming (non-temporal) stores.
//
// The pinned copy is read next by the card's copy engine, never by this core,
// so caching it only evicts other lines, and an ordinary store that misses
// the cache first reads the line it overwrites: half again the memory traffic
// the copy needs. On an H100's host, eight threads copied a 338 MB batch with
// these stores in a median 15.2 ms, and with memmove (np.copyto) on the same
// chunks in 16.6 ms, faster in 18 of 22 paired readings (PERF.md, section 6).
// Host code only: no kernel.

#include <emmintrin.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" void hpfw_stream_copy(void* dst, const void* src, size_t n) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  // Plain bytes up to a 16-byte boundary of the destination, which the
  // streaming stores need; the source may sit at any alignment.
  size_t head = (16 - (reinterpret_cast<uintptr_t>(d) & 15)) & 15;
  if (head > n) head = n;
  std::memcpy(d, s, head);
  d += head;
  s += head;
  n -= head;
  const size_t lines = n / 64;
  for (size_t i = 0; i < lines; ++i, d += 64, s += 64) {
    const __m128i a = _mm_loadu_si128(reinterpret_cast<const __m128i*>(s));
    const __m128i b = _mm_loadu_si128(reinterpret_cast<const __m128i*>(s + 16));
    const __m128i c = _mm_loadu_si128(reinterpret_cast<const __m128i*>(s + 32));
    const __m128i e = _mm_loadu_si128(reinterpret_cast<const __m128i*>(s + 48));
    _mm_stream_si128(reinterpret_cast<__m128i*>(d), a);
    _mm_stream_si128(reinterpret_cast<__m128i*>(d + 16), b);
    _mm_stream_si128(reinterpret_cast<__m128i*>(d + 32), c);
    _mm_stream_si128(reinterpret_cast<__m128i*>(d + 48), e);
  }
  // The streaming stores are weakly ordered: fence them before the caller
  // hands the chunk to the copy engine.
  _mm_sfence();
  std::memcpy(d, s, n - lines * 64);
}
