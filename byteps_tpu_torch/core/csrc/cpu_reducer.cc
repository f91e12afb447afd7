#include "cpu_reducer.h"

#include <cstring>
#if defined(__F16C__) && defined(__AVX__)
#include <immintrin.h>
#endif

#include "common.h"
#include "logging.h"

namespace bps {

float Fp16ToF32(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t mant = h & 0x3FF;
  union { uint32_t u; float f; } x;
  if (exp == 0) {
    if (mant == 0) {
      x.u = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while ((mant & 0x400) == 0) {
        mant <<= 1;
        exp--;
      }
      mant &= 0x3FF;
      x.u = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    x.u = sign | 0x7F800000u | (mant << 13);
  } else {
    x.u = sign | ((exp + 127 - 15) << 23) | (mant << 13);
  }
  return x.f;
}

uint16_t F32ToFp16(float f) {
  union { uint32_t u; float f32; } x;
  x.f32 = f;
  uint32_t sign = (x.u >> 16) & 0x8000u;
  int32_t exp = static_cast<int32_t>((x.u >> 23) & 0xFF) - 127 + 15;
  uint32_t mant = x.u & 0x7FFFFF;
  if (exp >= 31) return static_cast<uint16_t>(sign | 0x7C00u);  // inf/overflow
  if (exp <= 0) {
    if (exp < -10) return static_cast<uint16_t>(sign);
    mant |= 0x800000;
    uint32_t shift = static_cast<uint32_t>(14 - exp);
    uint32_t half = 1u << (shift - 1);
    return static_cast<uint16_t>(sign | ((mant + half) >> shift));
  }
  // round to nearest even on the 13 dropped bits
  uint32_t rounded = mant + 0xFFF + ((mant >> 13) & 1);
  if (rounded & 0x800000) {
    rounded = 0;
    exp++;
    if (exp >= 31) return static_cast<uint16_t>(sign | 0x7C00u);
  }
  return static_cast<uint16_t>(sign | (exp << 10) | (rounded >> 13));
}

namespace {

template <typename T>
void SumT(T* dst, const T* a, const T* b, int64_t n) {
#pragma omp parallel for simd
  for (int64_t i = 0; i < n; ++i) dst[i] = a[i] + b[i];
}

void SumBf16(uint16_t* dst, const uint16_t* a, const uint16_t* b, int64_t n) {
#pragma omp parallel for simd
  for (int64_t i = 0; i < n; ++i)
    dst[i] = F32ToBf16(Bf16ToF32(a[i]) + Bf16ToF32(b[i]));
}

void SumFp16(uint16_t* dst, const uint16_t* a, const uint16_t* b, int64_t n) {
#if defined(__F16C__) && defined(__AVX__)
  // Hardware half<->float converts, 8 lanes at a time: the scalar
  // conversion is branch-heavy (subnormals, round-to-nearest-even) and
  // runs ~30x slower — slow enough to make fp16-wire summation the
  // server bottleneck.
  int64_t vec_end = n & ~int64_t(7);
#pragma omp parallel for
  for (int64_t i = 0; i < vec_end; i += 8) {
    __m256 va = _mm256_cvtph_ps(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(a + i)));
    __m256 vb = _mm256_cvtph_ps(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(b + i)));
    _mm_storeu_si128(
        reinterpret_cast<__m128i*>(dst + i),
        _mm256_cvtps_ph(_mm256_add_ps(va, vb),
                        _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC));
  }
  for (int64_t i = vec_end; i < n; ++i)
    dst[i] = F32ToFp16(Fp16ToF32(a[i]) + Fp16ToF32(b[i]));
#else
#pragma omp parallel for simd
  for (int64_t i = 0; i < n; ++i)
    dst[i] = F32ToFp16(Fp16ToF32(a[i]) + Fp16ToF32(b[i]));
#endif
}

template <typename T>
void ScaleT(T* dst, double s, int64_t n) {
#pragma omp parallel for simd
  for (int64_t i = 0; i < n; ++i)
    dst[i] = static_cast<T>(dst[i] * s);
}

}  // namespace

void CpuReducer::Sum(void* dst, const void* a, const void* b,
                     int64_t len_bytes, int dtype) {
  int esz = DtypeSize(dtype);
  BPS_CHECK_GT(esz, 0) << "bad dtype " << dtype;
  int64_t n = len_bytes / esz;
  switch (dtype) {
    case BPS_FLOAT32:
      SumT(static_cast<float*>(dst), static_cast<const float*>(a),
           static_cast<const float*>(b), n);
      break;
    case BPS_FLOAT64:
      SumT(static_cast<double*>(dst), static_cast<const double*>(a),
           static_cast<const double*>(b), n);
      break;
    case BPS_BFLOAT16:
      SumBf16(static_cast<uint16_t*>(dst), static_cast<const uint16_t*>(a),
              static_cast<const uint16_t*>(b), n);
      break;
    case BPS_FLOAT16:
      SumFp16(static_cast<uint16_t*>(dst), static_cast<const uint16_t*>(a),
              static_cast<const uint16_t*>(b), n);
      break;
    case BPS_INT32:
      SumT(static_cast<int32_t*>(dst), static_cast<const int32_t*>(a),
           static_cast<const int32_t*>(b), n);
      break;
    case BPS_INT64:
      SumT(static_cast<int64_t*>(dst), static_cast<const int64_t*>(a),
           static_cast<const int64_t*>(b), n);
      break;
    case BPS_INT8:
      SumT(static_cast<int8_t*>(dst), static_cast<const int8_t*>(a),
           static_cast<const int8_t*>(b), n);
      break;
    case BPS_UINT8:
      SumT(static_cast<uint8_t*>(dst), static_cast<const uint8_t*>(a),
           static_cast<const uint8_t*>(b), n);
      break;
    default:
      BPS_FATAL << "unsupported dtype " << dtype;
  }
}

void CpuReducer::Sum(void* dst, const void* src, int64_t len_bytes,
                     int dtype) {
  Sum(dst, dst, src, len_bytes, dtype);
}

void CpuReducer::Copy(void* dst, const void* src, int64_t len_bytes) {
  memcpy(dst, src, static_cast<size_t>(len_bytes));
}

void CpuReducer::Scale(void* dst, double s, int64_t len_bytes, int dtype) {
  int esz = DtypeSize(dtype);
  BPS_CHECK_GT(esz, 0);
  int64_t n = len_bytes / esz;
  switch (dtype) {
    case BPS_FLOAT32:
      ScaleT(static_cast<float*>(dst), s, n);
      break;
    case BPS_FLOAT64:
      ScaleT(static_cast<double*>(dst), s, n);
      break;
    case BPS_BFLOAT16: {
      auto* p = static_cast<uint16_t*>(dst);
#pragma omp parallel for simd
      for (int64_t i = 0; i < n; ++i)
        p[i] = F32ToBf16(static_cast<float>(Bf16ToF32(p[i]) * s));
      break;
    }
    case BPS_FLOAT16: {
      auto* p = static_cast<uint16_t*>(dst);
#pragma omp parallel for simd
      for (int64_t i = 0; i < n; ++i)
        p[i] = F32ToFp16(static_cast<float>(Fp16ToF32(p[i]) * s));
      break;
    }
    // Integer scaling truncates toward zero (averaging an int tensor is
    // inherently lossy; supported so a stray int leaf in a gradient tree
    // degrades gracefully instead of killing the worker).
    case BPS_INT32:
      ScaleT(static_cast<int32_t*>(dst), s, n);
      break;
    case BPS_INT64:
      ScaleT(static_cast<int64_t*>(dst), s, n);
      break;
    case BPS_INT8:
      ScaleT(static_cast<int8_t*>(dst), s, n);
      break;
    case BPS_UINT8:
      ScaleT(static_cast<uint8_t*>(dst), s, n);
      break;
    default:
      BPS_FATAL << "Scale: unsupported dtype " << dtype;
  }
}

}  // namespace bps
