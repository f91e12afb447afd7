// Vectorized elementwise summation on host memory.
//
// Capability parity: reference byteps/common/cpu_reducer.{h,cc}
// (CpuReducer::sum with AVX/OpenMP over fp32/fp16/int dtypes; used by
// workers for PCIe-stage reduction and by the parameter servers for
// gradient summation — "spare CPU cores do the math", SURVEY.md §2.1).
// Fresh design: plain C++ loops shaped for compiler auto-vectorization
// (-O3 -march=native emits AVX2/AVX-512 on the PS fleet), bf16 as the
// first-class half type (TPU-native wire format) via float expansion,
// optional OpenMP when compiled with -fopenmp.
#pragma once

#include <cstdint>

namespace bps {

class CpuReducer {
 public:
  // dst[i] += src[i] over len bytes of `dtype` elements.
  static void Sum(void* dst, const void* src, int64_t len_bytes, int dtype);
  // dst[i] = a[i] + b[i]
  static void Sum(void* dst, const void* a, const void* b, int64_t len_bytes,
                  int dtype);
  static void Copy(void* dst, const void* src, int64_t len_bytes);
  // dst[i] *= scale (float dtypes only; used for averaging / async EMA)
  static void Scale(void* dst, double scale, int64_t len_bytes, int dtype);
};

// bf16 <-> f32 helpers (round-to-nearest-even on pack).
inline float Bf16ToF32(uint16_t v) {
  union { uint32_t u; float f; } x;
  x.u = static_cast<uint32_t>(v) << 16;
  return x.f;
}

inline uint16_t F32ToBf16(float f) {
  union { uint32_t u; float f32; } x;
  x.f32 = f;
  uint32_t rounding_bias = 0x7FFF + ((x.u >> 16) & 1);
  return static_cast<uint16_t>((x.u + rounding_bias) >> 16);
}

// IEEE fp16 <-> f32 (software, matches reference half.h capability).
float Fp16ToF32(uint16_t h);
uint16_t F32ToFp16(float f);

}  // namespace bps
