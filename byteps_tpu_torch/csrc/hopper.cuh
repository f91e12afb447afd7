// Hopper (sm_90a) building blocks for the port's hand-written kernels:
// mbarriers, TMA tile loads through a tensor map, shared-memory matrix
// descriptors, and warpgroup matrix multiplies (wgmma) in bf16 / f16 and
// in TF32 with f32 accumulators. Inline PTX only; no CUTLASS, no -lcuda
// (cuTensorMapEncodeTiled, a libcuda entry point, is fetched through the
// runtime at first use).
//
// Tiles in shared memory are [rows][cols] panels whose rows are 32, 64 or
// 128 bytes long, stored in the swizzle of that width (TMA writes them so,
// wgmma reads them so): one panel, or several side by side for wider
// tiles.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// --- shared memory, mbarriers, TMA -------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes initialised mbarriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of transactions (TMA copies).
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed. A phase that has
// not completed after ~2^32 cycles (about two seconds) can only be a copy
// that never comes: the kernel traps, and the launch fails, instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 32)) {
      __trap();
    }
  }
}

// One box of a 4-D tensor map into shared memory; completion is reported
// to `bar` as transaction bytes. Coordinates innermost first.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// Orders this thread's generic-proxy accesses to shared memory (stores
// that a wgmma will read, reads of a buffer TMA will overwrite) before the
// async proxy's; a __syncthreads() after it extends that to the block.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- wgmma -------------------------------------------------------------------

// Swizzle code of a shared-memory matrix descriptor for rows of `row_bytes`.
__host__ __device__ constexpr uint32_t swizzle_code(int row_bytes) {
  return row_bytes == 128 ? 1u : row_bytes == 64 ? 2u : 3u;  // 128B, 64B, 32B
}

// Matrix descriptor of a tile in shared memory: start address, leading and
// stride byte offsets (LBO, SBO; both in bytes here), swizzle code.
// K-major swizzled operands ignore LBO and step SBO from one 8-row group
// to the next; MN-major swizzled operands step LBO from one panel to the
// next along M/N and SBO from one 8-row group to the next along K.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swz) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)swz << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of a register that an
// in-flight wgmma owns across the instructions that issue and wait for it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Two values rounded to T and packed into one 32-bit register, the first in
// the low half: one register of a wgmma A fragment.
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The two values of a pack2 register, back in f32 (exact).
template <typename T> __device__ __forceinline__ float2 unpack2(uint32_t x);
template <> __device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t x) {
  return make_float2(__uint_as_float(x << 16), __uint_as_float(x & 0xffff0000u));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(uint32_t x) {
  return __half22float2(*reinterpret_cast<__half2*>(&x));
}

// Accumulator operand lists: d[0 .. N/2) of an m64nNk16 product.
#define BTT_D8(i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define BTT_OUT16 BTT_D8(0)
#define BTT_OUT32 BTT_D8(0), BTT_D8(8)
#define BTT_OUT64 BTT_D8(0), BTT_D8(8), BTT_D8(16), BTT_D8(24)
#define BTT_OUT128 \
  BTT_D8(0), BTT_D8(8), BTT_D8(16), BTT_D8(24), BTT_D8(32), BTT_D8(40), BTT_D8(48), BTT_D8(56)
#define BTT_ACC16 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define BTT_ACC32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define BTT_ACC64                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define BTT_ACC128                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

// D[64 x N] (+)= A[64 x 16] B[16 x N], both operands in shared memory,
// both K-major. `accumulate` 0 overwrites D.
template <typename T, int N> struct WgmmaSS;
// D[64 x N] += A[64 x 16] B[16 x N], A from registers (four packed pairs a
// thread), B in shared memory MN-major (transposed).
template <typename T, int N> struct WgmmaRS;

#define BTT_WGMMA_SS(TYPE, TS, N, TAIL)                                                   \
  template <> struct WgmmaSS<TYPE, N> {                                                  \
    __device__ __forceinline__ static void run(float* d, uint64_t da, uint64_t db,       \
                                               int accumulate) {                         \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " TAIL                               \
                   : BTT_OUT##N                                                           \
                   : "l"(da), "l"(db), "r"(accumulate));                                  \
    }                                                                                     \
  };
#define BTT_WGMMA_RS(TYPE, TS, N, TAIL)                                                   \
  template <> struct WgmmaRS<TYPE, N> {                                                  \
    __device__ __forceinline__ static void run(float* d, const uint32_t* a, uint64_t db) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " TAIL                               \
                   : BTT_OUT##N                                                           \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));       \
    }                                                                                     \
  };

// Operands after the accumulators: SS (desc a, desc b, accumulate) and RS
// (four A registers, desc b, 1); the trailing immediates are scale-a,
// scale-b, then transpose-a and transpose-b (SS: 0, 0) or transpose-b (RS:
// 1, the B tile is MN-major).
#define BTT_SS_TAIL(N, TS, ACC, DA, DB, P)                                        \
  P ", 0;\nwgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TS "." TS " " ACC ", " DA \
    ", " DB ", p, 1, 1, 0, 0;\n}\n"
#define BTT_RS_TAIL(N, TS, ACC, A, DB, P)                                        \
  P ", 0;\nwgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TS "." TS " " ACC ", " A \
    ", " DB ", p, 1, 1, 1;\n}\n"

#define BTT_WGMMA_BOTH(TYPE, TS)                                                               \
  BTT_WGMMA_SS(TYPE, TS, 32, BTT_SS_TAIL(32, TS, BTT_ACC32, "%16", "%17", "%18"))             \
  BTT_WGMMA_SS(TYPE, TS, 64, BTT_SS_TAIL(64, TS, BTT_ACC64, "%32", "%33", "%34"))             \
  BTT_WGMMA_RS(TYPE, TS, 16, BTT_RS_TAIL(16, TS, BTT_ACC16, "{%8, %9, %10, %11}", "%12", "%13")) \
  BTT_WGMMA_RS(TYPE, TS, 32,                                                                   \
               BTT_RS_TAIL(32, TS, BTT_ACC32, "{%16, %17, %18, %19}", "%20", "%21"))           \
  BTT_WGMMA_RS(TYPE, TS, 64,                                                                   \
               BTT_RS_TAIL(64, TS, BTT_ACC64, "{%32, %33, %34, %35}", "%36", "%37"))           \
  BTT_WGMMA_RS(TYPE, TS, 128,                                                                  \
               BTT_RS_TAIL(128, TS, BTT_ACC128, "{%64, %65, %66, %67}", "%68", "%69"))

BTT_WGMMA_BOTH(__nv_bfloat16, "bf16")
BTT_WGMMA_BOTH(__half, "f16")

// x rounded to TF32 (cvt.rna: to nearest, ties away from zero, on the 13
// low mantissa bits, which come out zero): a wgmma TF32 operand.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x as hi + lo, both TF32: hi = rna(x), lo = rna(x - hi) (x - hi is exact
// in f32). hi lo' + lo hi' + hi hi' holds a product to about 2^-21 of
// |x x'| (the lo lo' term, 2^-22, is dropped): CUTLASS's "fast F32".
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// TF32 products with f32 accumulators, m64nNk8. TF32 operands in shared
// memory are K-major only (the transpose immediates exist for 16-bit
// types alone), so neither form takes them.
// D[64 x N] (+)= A[64 x 8] B[8 x N], both operands in shared memory.
template <int N> struct WgmmaTf32SS;
// D[64 x N] += A[64 x 8] B[8 x N], A from registers: a[0] row g, column
// t; a[1] row g + 8, column t; a[2] row g, column t + 4; a[3] row g + 8,
// column t + 4 (g = 16 warp + lane / 4, t = lane % 4).
template <int N> struct WgmmaTf32RS;

#define BTT_TF32_SS(N, ACC, DA, DB, P)                                                     \
  template <> struct WgmmaTf32SS<N> {                                                      \
    __device__ __forceinline__ static void run(float* d, uint64_t da, uint64_t db,         \
                                               int accumulate) {                           \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P                                   \
                   ", 0;\nwgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 " ACC     \
                   ", " DA ", " DB ", p, 1, 1;\n}\n"                                        \
                   : BTT_OUT##N                                                             \
                   : "l"(da), "l"(db), "r"(accumulate));                                    \
    }                                                                                       \
  };
#define BTT_TF32_RS(N, ACC, A, DB, P)                                                      \
  template <> struct WgmmaTf32RS<N> {                                                      \
    __device__ __forceinline__ static void run(float* d, const uint32_t* a, uint64_t db) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P                                   \
                   ", 0;\nwgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 " ACC     \
                   ", " A ", " DB ", p, 1, 1;\n}\n"                                         \
                   : BTT_OUT##N                                                             \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));         \
    }                                                                                       \
  };

BTT_TF32_SS(16, BTT_ACC16, "%8", "%9", "%10")
BTT_TF32_SS(32, BTT_ACC32, "%16", "%17", "%18")
BTT_TF32_SS(64, BTT_ACC64, "%32", "%33", "%34")
BTT_TF32_SS(128, BTT_ACC128, "%64", "%65", "%66")
BTT_TF32_RS(16, BTT_ACC16, "{%8, %9, %10, %11}", "%12", "%13")
BTT_TF32_RS(32, BTT_ACC32, "{%16, %17, %18, %19}", "%20", "%21")
BTT_TF32_RS(64, BTT_ACC64, "{%32, %33, %34, %35}", "%36", "%37")
BTT_TF32_RS(128, BTT_ACC128, "{%64, %65, %66, %67}", "%68", "%69")

// --- host: tensor maps -------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Tensor map of a row-major [B, S, H, D] tensor of 16-bit values or f32,
// read in boxes of `rows` consecutive positions of one (batch, head) and
// `cols` columns (32, 64 or 128 bytes: the swizzle of that width). Rows
// past S read as zeros.
inline cudaError_t encode_bshd(CUtensorMap* map, const void* ptr, CUtensorMapDataType dtype, int B,
                               int S, int H, int D, int cols, int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return cudaErrorMisalignedAddress;
  const cuuint64_t size = dtype == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;  // bytes a value
  const int row_bytes = cols * (int)size;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * size, (cuuint64_t)H * D * size,
                                 (cuuint64_t)S * H * D * size};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, dtype, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
