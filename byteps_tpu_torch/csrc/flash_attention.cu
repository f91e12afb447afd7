// Flash attention for Hopper (sm_90a): forward (with and without the row
// logsumexp), dQ, and dK/dV, bound through a plain C interface (ctypes).
//
// Replaces the four Pallas TPU kernels of byteps_tpu/ops/flash_attention.py:
//   fa_fwd_kernel<T, D, true>   <- _fa_kernel via _flash_fwd_impl(return_lse=True)
//   fa_fwd_kernel<T, D, false>  <- _kernel_nolse (forward with no residuals)
//   fa_bwd_dq_kernel<T, D>      <- _fa_bwd_dq_kernel (+ _bwd_recompute/_bwd_mask/_bwd_live)
//   fa_bwd_dkv_kernel<T, D>     <- _fa_bwd_dkv_kernel
//
// Layout: q, k, v, o, dO, dq, dk, dv are [batch, seq, heads, head_dim]
// row-major (the public layout; no transposes around the kernels); lse and
// D = rowsum(dO * O) are f32 [batch, heads, seq_q].
//
// What bounds it on the H100. At GPT-2 small's shapes (b 8, s 512, h 12,
// d 64, bf16, causal) the forward reads q, k, v and writes o: ~25 MB, about
// 7.5 us at 3.35 TB/s, against ~3.2 GFLOP, 3.3 us at the bf16 tensor-core
// peak, so the least time is set by bytes. This first version does every
// product as f32 FMAs on the CUDA cores from shared memory (no mma.sync,
// no wgmma): the f32 FMA peak (67 TFLOP/s) makes ~48 us the floor for the
// causal forward, and shared-memory bandwidth makes it slower still. That
// is the price of a kernel whose numerics are simple to hold against the
// plain version: every product of two inputs is exact in f32, sums are f32.
// What the design does about the bound it has: each 64-row Q tile stays in
// shared memory while K/V tiles stream past it, so q, k and v are read once
// per tile pair and the [s, s] score matrix never reaches device memory;
// causal and sliding-window loop bounds are computed per tile, so masked
// tiles cost nothing and the window's work scales with seq * window.
// wgmma with TMA-fed tiles is the redesign this leaves for later.
//
// Conventions kept from the TPU kernels: causal mask top-left aligned
// (q_pos >= k_pos, both from 0, also when seq_q != seq_k); masked logits
// -1e30; a row with l == 0 writes o = 0 and lse = +1e30; p is cast to v's
// dtype before p.v; the backward forms dp from f32 dO and f32 v, casts ds to
// k's (dQ) or q's (dK) dtype, and forms dV from f32 p and f32 dO.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int NT = 256;       // threads per block: 16 row groups x 16 lanes
constexpr float kNegInf = -1e30f;
constexpr float kBig = 1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

// x rounded to T and back: the kernels' counterpart of `.astype(T)`.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// Sum / max over the 16 lanes that share a row group (lanes 0-15 or 16-31).
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Rows [start, start + ROWS) of head (b, h) of a [B, S, H, D] tensor into a
// [ROWS][LD] f32 tile; rows past S are zero.
template <typename T, int D, int LD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b, int h, int H, int S,
                                          int start) {
  for (int i = threadIdx.x; i < ROWS * D; i += NT) {
    const int r = i / D, c = i % D, s = start + r;
    dst[r * LD + c] = s < S ? to_f<T>(src[((size_t)(b * S + s) * H + h) * D + c]) : 0.f;
  }
}

__device__ __forceinline__ bool live(int qp, int kp, int Sq, int Sk, int causal, int window) {
  bool ok = qp < Sq && kp < Sk;
  if (causal) {
    ok = ok && qp >= kp;
    if (window > 0) ok = ok && qp - kp < window;
  }
  return ok;
}

// Thread layout shared by all three kernels: tid = ty * 16 + tx. A thread
// owns tile rows ty*4 .. ty*4+3, score columns tx + 16*j (j < 4), and output
// columns tx + 16*c (c < D/16). The 16 lanes of a row group sit in one half
// warp, so row reductions are four shuffles.

template <typename T, int D, bool LSE>
__global__ void __launch_bounds__(NT)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Sk, float scale,
              int causal, int window) {
  constexpr int LD = D + 1, LP = BK + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, D, LD, BQ>(sQ, q, b, h, H, Sq, q0);

  const int nk = (Sk + BK - 1) / BK;
  int kt_lo = 0, kt_hi = nk;
  if (causal) {
    kt_hi = min(nk, (min(q0 + BQ, Sq) - 1) / BK + 1);
    if (window > 0) kt_lo = max(0, q0 - (window - 1)) / BK;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, LD, BK>(sK, k, b, h, H, Sk, k0);
    load_tile<T, D, LD, BK>(sV, v, b, h, H, Sk, k0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = live(qp, k0 + tx + 16 * j, Sq, Sk, causal, window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        sP[(ty * 4 + i) * LP + tx + 16 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty * 4 + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = sV[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Sq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + ((size_t)(b * Sq + qp) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] / safe_l);
    if (LSE && tx == 0) lse[(size_t)bh * Sq + qp] = l[i] == 0.f ? kBig : m[i] + logf(safe_l);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ dvec, T* __restrict__ dq, int H, int Sq, int Sk,
                 float scale, int causal, int window) {
  constexpr int LD = D + 1, LP = BK + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + BQ * LD;
  float* sK = sDO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sDS = sV + BK * LD;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, D, LD, BQ>(sQ, q, b, h, H, Sq, q0);
  load_tile<T, D, LD, BQ>(sDO, dout, b, h, H, Sq, q0);
  float row_lse[4], row_d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    row_lse[i] = qp < Sq ? lse[(size_t)bh * Sq + qp] : kBig;
    row_d[i] = qp < Sq ? dvec[(size_t)bh * Sq + qp] : 0.f;
  }

  const int nk = (Sk + BK - 1) / BK;
  int kt_lo = 0, kt_hi = nk;
  if (causal) {
    kt_hi = min(nk, (min(q0 + BQ, Sq) - 1) / BK + 1);
    if (window > 0) kt_lo = max(0, q0 - (window - 1)) / BK;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, D, LD, BK>(sK, k, b, h, H, Sk, k0);
    load_tile<T, D, LD, BK>(sV, v, b, h, H, Sk, k0);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sQ[(ty * 4 + i) * LD + d];
        g[i] = sDO[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = sK[(tx + 16 * j) * LD + d];
        bv[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live(qp, k0 + tx + 16 * j, Sq, Sk, causal, window)
                            ? expf(s[i][j] * scale - row_lse[i])
                            : 0.f;
        const float ds = p * (dp[i][j] - row_d[i]) * scale;
        sDS[(ty * 4 + i) * LP + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ds[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sDS[(ty * 4 + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = sK[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(ds[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Sq) continue;
    T* row = dq + ((size_t)(b * Sq + qp) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) row[tx + 16 * c] = from_f<T>(acc[i][c]);
  }
}

// One block per (head, 64-row K tile) walking the Q tiles: dK and dV of a
// tile are summed in its own registers, so no atomics and no second pass.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ dvec, T* __restrict__ dk, T* __restrict__ dv, int H,
                  int Sq, int Sk, float scale, int causal, int window) {
  constexpr int LD = D + 1, LP = BQ + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sDO = sQ + BQ * LD;
  float* sP = sDO + BQ * LD;
  float* sDS = sP + BK * LP;
  float* sL = sDS + BK * LP;
  float* sD = sL + BQ;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, D, LD, BK>(sK, k, b, h, H, Sk, k0);
  load_tile<T, D, LD, BK>(sV, v, b, h, H, Sk, k0);

  const int nq = (Sq + BQ - 1) / BQ;
  int qt_lo = 0, qt_hi = nq;
  if (causal) {
    qt_lo = k0 / BQ;  // first Q tile holding a q_pos >= k0
    if (window > 0) qt_hi = min(nq, (min(k0 + BK, Sk) - 1 + window - 1) / BQ + 1);
  }

  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile<T, D, LD, BQ>(sQ, q, b, h, H, Sq, q0);
    load_tile<T, D, LD, BQ>(sDO, dout, b, h, H, Sq, q0);
    for (int r = threadIdx.x; r < BQ; r += NT) {
      const int qp = q0 + r;
      sL[r] = qp < Sq ? lse[(size_t)bh * Sq + qp] : kBig;
      sD[r] = qp < Sq ? dvec[(size_t)bh * Sq + qp] : 0.f;
    }
    __syncthreads();

    // Transposed tiles: rows are keys (ty), columns are queries (tx).
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], bv[4], bq[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sK[(ty * 4 + i) * LD + d];
        bv[i] = sV[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bq[j] = sQ[(tx + 16 * j) * LD + d];
        g[j] = sDO[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], bq[j], s[i][j]);
          dp[i][j] = fmaf(bv[i], g[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kp = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const float p = live(q0 + qc, kp, Sq, Sk, causal, window)
                            ? expf(s[i][j] * scale - sL[qc])
                            : 0.f;
        const float ds = p * (dp[i][j] - sD[qc]) * scale;
        sP[(ty * 4 + i) * LP + qc] = p;
        sDS[(ty * 4 + i) * LP + qc] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float p[4], ds[4], g[DC], qv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = sP[(ty * 4 + i) * LP + qq];
        ds[i] = sDS[(ty * 4 + i) * LP + qq];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        g[c] = sDO[qq * LD + tx + 16 * c];
        qv[c] = sQ[qq * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc_v[i][c] = fmaf(p[i], g[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(ds[i], qv[c], acc_k[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    if (kp >= Sk) continue;
    const size_t off = ((size_t)(b * Sk + kp) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[off + tx + 16 * c] = from_f<T>(acc_k[i][c]);
      dv[off + tx + 16 * c] = from_f<T>(acc_v[i][c]);
    }
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                int Sq, int Sk, float scale, int causal, int window, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem = sizeof(float) * (BQ * LD + 2 * BK * LD + BQ * (BK + 1));
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  cudaError_t err;
  if (lse != nullptr) {
    if ((err = prepare(fa_fwd_kernel<T, D, true>, smem)) != cudaSuccess) return err;
    fa_fwd_kernel<T, D, true><<<grid, NT, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, H, Sq, Sk, scale, causal,
        window);
  } else {
    if ((err = prepare(fa_fwd_kernel<T, D, false>, smem)) != cudaSuccess) return err;
    fa_fwd_kernel<T, D, false><<<grid, NT, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, nullptr, H, Sq, Sk, scale, causal, window);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* dvec, void* dq, int B, int H, int Sq, int Sk,
                   float scale, int causal, int window, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem = sizeof(float) * (2 * BQ * LD + 2 * BK * LD + BQ * (BK + 1));
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  cudaError_t err;
  if ((err = prepare(fa_bwd_dq_kernel<T, D>, smem)) != cudaSuccess) return err;
  fa_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)dvec, (T*)dq, H, Sq, Sk, scale, causal, window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* dvec, void* dk, void* dv, int B, int H, int Sq,
                    int Sk, float scale, int causal, int window, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem =
      sizeof(float) * (2 * BK * LD + 2 * BQ * LD + 2 * BK * (BQ + 1) + 2 * BQ);
  const dim3 grid((Sk + BK - 1) / BK, B * H);
  cudaError_t err;
  if ((err = prepare(fa_bwd_dkv_kernel<T, D>, smem)) != cudaSuccess) return err;
  fa_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)dvec, (T*)dk, (T*)dv, H, Sq, Sk, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16. head_dim: 16, 32, 64, 128.
// Every entry point returns the cudaError_t of its launch (0 on success);
// an unsupported dtype or head_dim returns cudaErrorInvalidValue.
#define BTT_DISPATCH(FN, ...)                                                   \
  switch (dtype * 1000 + D) {                                                   \
    case 16: return (int)FN<float, 16>(__VA_ARGS__);                          \
    case 32: return (int)FN<float, 32>(__VA_ARGS__);                          \
    case 64: return (int)FN<float, 64>(__VA_ARGS__);                          \
    case 128: return (int)FN<float, 128>(__VA_ARGS__);                        \
    case 1016: return (int)FN<__nv_bfloat16, 16>(__VA_ARGS__);                \
    case 1032: return (int)FN<__nv_bfloat16, 32>(__VA_ARGS__);                \
    case 1064: return (int)FN<__nv_bfloat16, 64>(__VA_ARGS__);                \
    case 1128: return (int)FN<__nv_bfloat16, 128>(__VA_ARGS__);               \
    case 2016: return (int)FN<__half, 16>(__VA_ARGS__);                       \
    case 2032: return (int)FN<__half, 32>(__VA_ARGS__);                       \
    case 2064: return (int)FN<__half, 64>(__VA_ARGS__);                       \
    case 2128: return (int)FN<__half, 128>(__VA_ARGS__);                      \
    default: return (int)cudaErrorInvalidValue;                               \
  }

extern "C" {

// lse == NULL launches the forward without the logsumexp output.
int btt_fa_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int dtype, int B,
               int H, int Sq, int Sk, int D, float scale, int causal, int window, void* stream) {
  BTT_DISPATCH(fwd, q, k, v, o, lse, B, H, Sq, Sk, scale, causal, window, (cudaStream_t)stream);
}

int btt_fa_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* dvec, void* dq, int dtype, int B, int H, int Sq, int Sk, int D,
                  float scale, int causal, int window, void* stream) {
  BTT_DISPATCH(bwd_dq, q, k, v, dout, lse, dvec, dq, B, H, Sq, Sk, scale, causal, window,
               (cudaStream_t)stream);
}

int btt_fa_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* dvec, void* dk, void* dv, int dtype, int B, int H,
                   int Sq, int Sk, int D, float scale, int causal, int window, void* stream) {
  BTT_DISPATCH(bwd_dkv, q, k, v, dout, lse, dvec, dk, dv, B, H, Sq, Sk, scale, causal, window,
               (cudaStream_t)stream);
}

const char* btt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
