#include "crc32c.h"

#include <cstring>

namespace bps {

#ifndef __SSE4_2__
namespace {

const uint32_t* Crc32cTable() {
  static uint32_t table[256];
  static bool init = [] {
    // Castagnoli polynomial, reflected: 0x82F63B78.
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) {
        c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
      }
      table[i] = c;
    }
    return true;
  }();
  (void)init;
  return table;
}

}  // namespace
#endif

uint32_t Crc32c(const void* data, size_t len, uint32_t seed) {
  uint32_t c = seed ^ 0xFFFFFFFFu;
  const unsigned char* p = static_cast<const unsigned char*>(data);
#ifdef __SSE4_2__
  // Hardware CRC32C (the SSE4.2 crc32 instruction implements exactly
  // this reflected-Castagnoli update): ~10+ GB/s vs ~0.4 GB/s for the
  // byte-at-a-time table, which is what keeps the per-frame wire
  // trailer inside BENCH_integrity_r19.json's <5% paced-goodput gate.
  uint64_t c64 = c;
  while (len >= 8) {
    uint64_t w;
    memcpy(&w, p, sizeof(w));
    c64 = __builtin_ia32_crc32di(c64, w);
    p += 8;
    len -= 8;
  }
  c = static_cast<uint32_t>(c64);
  while (len--) {
    c = __builtin_ia32_crc32qi(c, *p++);
  }
#else
  const uint32_t* table = Crc32cTable();
  for (size_t i = 0; i < len; ++i) {
    c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  }
#endif
  return c ^ 0xFFFFFFFFu;
}

}  // namespace bps
