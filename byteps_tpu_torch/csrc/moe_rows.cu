// The dropless expert layer's row passes on the held rows only, for Hopper
// (sm_90a): the gather of each routed pair's token row, the SwiGLU between
// the two grouped products (and its backward), and the combine of each
// token's rows back into token order, bound through a plain C interface
// (ctypes). ops/moe_rows.py wraps them; parallel/moe.py (_routed_rows) runs
// them around torch._grouped_mm.
//
// Replaces no TPU kernel: the JAX package has no dropless expert layer
// (its MoE is GShard's, with a capacity and one-hot einsums). This is the
// port's own, for DeepSeek-V3's fine-grained experts (models/deepseek.py,
// DeepseekMoE; RoutedExperts holds `held` experts of all of them).
//
// Layout: the T k (token, expert) pairs of a layer are sorted so that the
// pairs of the held experts come first, by expert (parallel/moe.py,
// expert_plan). offs [held] int32 holds the end of each held expert's rows,
// so rows = offs[held - 1] pairs are held; the buffers are sized for the
// worst case, P = T k rows, because that count stays on the card. src [P]
// int64 is each sorted pair's token; pos [T k] int64 the sorted place of
// pair t k + j, and mine [T k] whether that pair's expert is held here. x,
// y are [*, d] and h [P, 2f] = [gate | up], a [P, f], in bf16 or f32 (T);
// weight and dweight are f32 [P].
//
// What bounds it on the H100: a few FLOPs a byte, so bytes. Run as PyTorch
// ops over all P rows, a layer's forward moved ~11 GB (gathers and masked
// copies of [P, d], three elementwise passes over [P, f]), twice with the
// checkpoint's recompute, and its backward ~18-20 GB (a sort-based
// index_put accumulate, a cat of the two gate/up gradients, masked copies):
// ~12-15 ms a layer at 3.35 TB/s, while 4-12 % of the P rows are held at
// Moonlight's routing. Here every pass reads rows from the card itself
// (offs[held - 1], or mine) and walks only the held rows:
// - one warp a row (a token for the combine), lanes along the row in
//   16-byte loads (8 bf16 or 4 f32; d and f are multiples of 8), kUnroll
//   loads in flight a lane; warps stride over the rows (a grid-stride loop
//   whose grid fills the SMs at the kernel's occupancy, never sized to P),
//   so no block is launched for an absent row, and nothing on the host
//   waits for the count;
// - the combine writes every token's row (0 where none of its pairs is
//   held), the only pass that touches all T rows: T d elements written,
//   against the held rows' reads;
// - the SwiGLU's backward writes [dgate | dup] into one [P, 2f] buffer (no
//   cat) and each held row's dweight as an f32 row sum over the warp, and
//   writes dweight = 0 for rows [rows, P): weight carries the router's
//   gradient, so every entry of it is an output;
// - sums are f32 in a fixed order (the combine over j = 0 .. k-1, the row
//   sum lane by lane then by xor shuffles), with no atomics: a result
//   repeats to the bit from run to run.
//
// The guarantee: torch._grouped_mm leaves rows at or past rows unset in its
// outputs, and the buffers these kernels write are left unset there too. No
// value from such a row reaches any output or gradient, in either
// direction, because no kernel reads one: the gather, the SwiGLU and its
// backward stop at rows, and the combine (the gather's backward too) reads
// a sorted row only for a pair that is mine, and the mine pairs are
// exactly the sorted rows below rows. The products read only rows within
// their groups.
//
// Numerics: a = silu(g) u w in f32 (silu(g) = g / (1 + exp(-g))), rounded
// once to T; its backward, with s = sigmoid(g) and m = da w: dg = m u s (1 +
// g (1 - s)), du = m silu(g), dweight = sum over the row of da silu(g) u,
// each in f32 and the first two rounded once to T. The combine's and the
// gather backward's sums are f32, rounded once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-byte loads in flight a lane

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements of T, loaded and stored as one 16-byte access.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// The held pairs: the end of the last held expert's rows, read on the card.
__device__ __forceinline__ long long held_rows(const int* __restrict__ offs, int held) {
  return (long long)__ldg(offs + held - 1);
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ long long first_warp() {
  return (long long)blockIdx.x * kWarps + threadIdx.x / 32;
}
__device__ __forceinline__ long long warp_stride() { return (long long)gridDim.x * kWarps; }

// --- gather: out[p] = x[src[p]] for p < rows ---------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    moe_gather_kernel(const T* __restrict__ x, const int64_t* __restrict__ src,
                      const int* __restrict__ offs, int held, T* __restrict__ out, int d) {
  using P = Pack<T, V>;
  const long long rows = held_rows(offs, held);
  const int n = d / V;
  const int lane = lane_id();
  for (long long p = first_warp(); p < rows; p += warp_stride()) {
    const P* from = reinterpret_cast<const P*>(x + src[p] * d);
    P* to = reinterpret_cast<P*>(out + p * d);
    for (int c0 = lane; c0 < n; c0 += 32 * kUnroll) {
      P v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (c0 + 32 * u < n) v[u] = from[c0 + 32 * u];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (c0 + 32 * u < n) to[c0 + 32 * u] = v[u];
    }
  }
}

// --- combine: out[t] = sum_j [mine[t k + j]] y[pos[t k + j]], every t --------

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    moe_combine_kernel(const T* __restrict__ y, const int64_t* __restrict__ pos,
                       const bool* __restrict__ mine, T* __restrict__ out, long long tokens, int k,
                       int d) {
  using P = Pack<T, V>;
  const int n = d / V;
  const int lane = lane_id();
  for (long long t = first_warp(); t < tokens; t += warp_stride()) {
    const long long q0 = t * k;
    P* to = reinterpret_cast<P*>(out + t * d);
    for (int c0 = lane; c0 < n; c0 += 32 * kUnroll) {
      float acc[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < V; ++i) acc[u][i] = 0.f;
      for (int j = 0; j < k; ++j) {
        if (!mine[q0 + j]) continue;  // the same for the whole warp
        const P* from = reinterpret_cast<const P*>(y + pos[q0 + j] * d);
        P v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (c0 + 32 * u < n) v[u] = from[c0 + 32 * u];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (c0 + 32 * u < n) {
#pragma unroll
            for (int i = 0; i < V; ++i) acc[u][i] += to_f32(v[u].v[i]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (c0 + 32 * u < n) {
          P o;
#pragma unroll
          for (int i = 0; i < V; ++i) o.v[i] = from_f32<T>(acc[u][i]);
          to[c0 + 32 * u] = o;
        }
      }
    }
  }
}

// --- SwiGLU: a[p] = silu(g) u w[p] for p < rows, h[p] = [g | u] ---------------

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    moe_swiglu_kernel(const T* __restrict__ h, const float* __restrict__ w,
                      const int* __restrict__ offs, int held, T* __restrict__ a, int f) {
  using P = Pack<T, V>;
  const long long rows = held_rows(offs, held);
  const int n = f / V;
  const int lane = lane_id();
  for (long long p = first_warp(); p < rows; p += warp_stride()) {
    const float wp = w[p];
    const P* gate = reinterpret_cast<const P*>(h + p * 2 * f);
    const P* up = gate + n;
    P* to = reinterpret_cast<P*>(a + p * f);
    for (int c0 = lane; c0 < n; c0 += 32 * kUnroll) {
      P gv[kUnroll], uv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (c0 + 32 * u < n) {
          gv[u] = gate[c0 + 32 * u];
          uv[u] = up[c0 + 32 * u];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (c0 + 32 * u < n) {
          P o;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float g = to_f32(gv[u].v[i]);
            const float silu = g / (1.f + expf(-g));
            o.v[i] = from_f32<T>(silu * to_f32(uv[u].v[i]) * wp);
          }
          to[c0 + 32 * u] = o;
        }
      }
    }
  }
}

// Its backward: dh[p] = [dg | du] and dw[p] for p < rows, dw[p] = 0 for
// rows <= p < P.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    moe_swiglu_bwd_kernel(const T* __restrict__ h, const float* __restrict__ w,
                          const T* __restrict__ da, const int* __restrict__ offs, int held,
                          T* __restrict__ dh, float* __restrict__ dw, long long P_, int f) {
  using P = Pack<T, V>;
  const long long rows = held_rows(offs, held);
  const int n = f / V;
  const int lane = lane_id();
  for (long long p = first_warp(); p < rows; p += warp_stride()) {
    const float wp = w[p];
    const P* gate = reinterpret_cast<const P*>(h + p * 2 * f);
    const P* up = gate + n;
    const P* grad = reinterpret_cast<const P*>(da + p * f);
    P* dgate = reinterpret_cast<P*>(dh + p * 2 * f);
    P* dup = dgate + n;
    float part = 0.f;
    for (int c0 = lane; c0 < n; c0 += 32 * kUnroll) {
      P gv[kUnroll], uv[kUnroll], av[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (c0 + 32 * u < n) {
          gv[u] = gate[c0 + 32 * u];
          uv[u] = up[c0 + 32 * u];
          av[u] = grad[c0 + 32 * u];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (c0 + 32 * u < n) {
          P og, ou;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float g = to_f32(gv[u].v[i]);
            const float up_i = to_f32(uv[u].v[i]);
            const float dai = to_f32(av[u].v[i]);
            const float s = 1.f / (1.f + expf(-g));
            const float silu = g * s;
            const float m = dai * wp;
            og.v[i] = from_f32<T>(m * up_i * s * (1.f + g * (1.f - s)));
            ou.v[i] = from_f32<T>(m * silu);
            part += dai * (silu * up_i);
          }
          dgate[c0 + 32 * u] = og;
          dup[c0 + 32 * u] = ou;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) dw[p] = part;
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = rows + (long long)blockIdx.x * blockDim.x + threadIdx.x; p < P_; p += stride)
    dw[p] = 0.f;
}

// Blocks of a kernel that the card holds at once: its SMs times the
// kernel's occupancy.
template <typename K>
int full_grid(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return (sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
}

// That many blocks, or fewer where `work` rows need fewer warps.
int grid_for(int full, long long work) {
  const long long need = (work + kWarps - 1) / kWarps;
  return (int)(need < full ? need : full);
}

template <typename T, int V>
cudaError_t run_gather(const void* x, const int64_t* src, const int* offs, int held, void* out,
                       long long P_, int d, cudaStream_t stream) {
  static const int full = full_grid(moe_gather_kernel<T, V>);
  const int grid = grid_for(full, P_);
  if (grid == 0) return cudaSuccess;
  moe_gather_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), src, offs, held, static_cast<T*>(out), d);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t run_combine(const void* y, const int64_t* pos, const bool* mine, void* out,
                        long long tokens, int k, int d, cudaStream_t stream) {
  static const int full = full_grid(moe_combine_kernel<T, V>);
  const int grid = grid_for(full, tokens);
  if (grid == 0) return cudaSuccess;
  moe_combine_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(y), pos, mine, static_cast<T*>(out), tokens, k, d);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t run_swiglu(const void* h, const float* w, const int* offs, int held, void* a,
                       long long P_, int f, cudaStream_t stream) {
  static const int full = full_grid(moe_swiglu_kernel<T, V>);
  const int grid = grid_for(full, P_);
  if (grid == 0) return cudaSuccess;
  moe_swiglu_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), w, offs, held, static_cast<T*>(a), f);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t run_swiglu_backward(const void* h, const float* w, const void* da, const int* offs,
                                int held, void* dh, float* dw, long long P_, int f,
                                cudaStream_t stream) {
  static const int full = full_grid(moe_swiglu_bwd_kernel<T, V>);
  const int grid = grid_for(full, P_);
  if (grid == 0) return cudaSuccess;
  moe_swiglu_bwd_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), w, static_cast<const T*>(da), offs, held, static_cast<T*>(dh),
      dw, P_, f);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32 (4 a load), 1 bfloat16 (8 a load). Every entry
// point returns the cudaError_t of its launch (0 on success; no launch for
// an empty tensor); an unsupported dtype returns cudaErrorInvalidValue. P
// is the rows of the buffers (T k), held the entries of offs (at least 1).
#define BTT_MOE_DISPATCH(FN, ...)                               \
  switch (dtype) {                                              \
    case 0: return (int)FN<float, 4>(__VA_ARGS__);              \
    case 1: return (int)FN<__nv_bfloat16, 8>(__VA_ARGS__);      \
    default: return (int)cudaErrorInvalidValue;                 \
  }

extern "C" {

// out [P, d]: row p < offs[held - 1] is x [*, d]'s row src[p]; the rest
// are left as they are.
int btt_moe_gather(const void* x, const int64_t* src, const int* offs, int held, void* out,
                   long long P, int d, int dtype, void* stream) {
  BTT_MOE_DISPATCH(run_gather, x, src, offs, held, out, P, d, (cudaStream_t)stream);
}

// out [tokens, d]: token t's sum of y [*, d]'s rows pos[t k + j] over the
// j < k with mine[t k + j].
int btt_moe_combine(const void* y, const int64_t* pos, const bool* mine, void* out,
                    long long tokens, int k, int d, int dtype, void* stream) {
  BTT_MOE_DISPATCH(run_combine, y, pos, mine, out, tokens, k, d, (cudaStream_t)stream);
}

// a [P, f] from h [P, 2f] and w [P], rows below offs[held - 1].
int btt_moe_swiglu(const void* h, const float* w, const int* offs, int held, void* a, long long P,
                   int f, int dtype, void* stream) {
  BTT_MOE_DISPATCH(run_swiglu, h, w, offs, held, a, P, f, (cudaStream_t)stream);
}

// dh [P, 2f] (rows below offs[held - 1]) and dw [P] (all of it) from h, w
// and da [P, f].
int btt_moe_swiglu_backward(const void* h, const float* w, const void* da, const int* offs,
                            int held, void* dh, float* dw, long long P, int f, int dtype,
                            void* stream) {
  BTT_MOE_DISPATCH(run_swiglu_backward, h, w, da, offs, held, dh, dw, P, f,
                   (cudaStream_t)stream);
}

const char* btt_moe_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
