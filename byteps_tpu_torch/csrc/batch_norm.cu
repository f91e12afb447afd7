// Batch norm over channels_last activations for Hopper (sm_90a): the train
// forward (batch statistics, running averages updated in place), the eval
// forward (running statistics), and the backward, each with an optional ReLU
// after the norm, bound through a plain C interface (ctypes).
//
// Replaces no TPU kernel: flax's nn.BatchNorm is left to XLA, which fuses
// it. This is the port's counterpart of that fusion, for ResNet's norms
// (byteps_tpu_torch/models/resnet.py, BatchNorm).
//
// Layout: x, y, dy, dx are NHWC-dense, i.e. a row-major [rows, C] matrix with
// rows = N * H * W, in bf16 or f32 (the template's T); scale, bias, the
// running mean and var, and every statistic are f32 [C].
//
// What bounds it on the H100. Per element it does a few FLOPs, so it is
// bound by bytes: at ResNet-50's 2.85 G norm elements a step (batch 256,
// 224 x 224), each byte a bf16 element moves costs ~1.7 ms a step at 3.35
// TB/s. The torch-op norm with its ReLU moved ~176 bytes an element over
// forward and backward (f32 copies, squares, means, and autograd's saved f32
// intermediates). Here:
// - forward (train): pass (a) reads x once for per-slab f32 sums of x and
//   x^2; (b) combines the slabs; (c) reads x again and writes y. 6 bytes an
//   element in bf16. Eval runs (c) alone on the running statistics;
// - backward: pass (a) reads x and dy once for per-slab sums of dy' and
//   dy' * (x - mean) (dy' = dy under the ReLU mask); (b) combines them into
//   dscale, dbias and the dx constants; (c) reads x and dy again and writes
//   dx. 10 bytes an element in bf16. Only x (in its own dtype) and three f32
//   [C] vectors are saved between forward and backward: x - mean and the
//   ReLU mask are recomputed from x with the forward's own arithmetic
//   (affine()), so the mask is the forward's bit for bit;
// - each thread moves 16 bytes a load along C (8 bf16 or 4 f32 channels; one
//   element where C is not a multiple of that), neighbouring threads on
//   neighbouring channels, four rows in flight a thread (two of x and two of
//   dy in the backward), at most 85 registers a thread so that three blocks
//   share an SM;
// - the grid is (channel tiles, row slabs) sized to about 792 blocks of
//   256 threads, two waves of three a SM on the 132 SMs, at every shape,
//   from the stem (3.21 M rows x 64 channels: 1 tile x 792 slabs of 4055
//   rows) to stage 4 (12,544 rows x 2048 channels: 8 tiles x 99 slabs of
//   127 rows). The geometry is chosen by the wrapper (ops/batch_norm.py,
//   geometry) and passed in;
// - no floating-point atomics: each block writes its slab's partial sums to
//   a workspace [2, slabs, C], and pass (b) adds them in slab order, so a
//   result repeats to the bit from run to run.
//
// Numerics, as BatchNorm.forward's torch ops (flax's): mean = E[x], var =
// max(E[x^2] - mean^2, 0), the biased var into the running average with
// momentum 0.9 (the old average's weight), y = (x - mean) * (rsqrt(var +
// eps) * scale) + bias in f32, then max(y, 0) with the ReLU, cast to T. Where
// E[x^2] - mean^2 < 0 was clipped, the gradient through var is 0: dx leaves
// out its xhat term (torch.clamp's gradient).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;  // blocks an SM keeps: at most 85 registers a thread
constexpr int kLanes = 32;     // slab lanes a channel in pass (b)

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

// V elements of T, loaded and stored as one access (16 bytes for V > 1).
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// rows = N * H * W; a block walks rows [blockIdx.y * rows_per_slab, ...) of
// channels [blockIdx.x * blockDim.x * V, ...).
struct Shape {
  long long rows;
  long long rows_per_slab;
  int C;
};

// rstd of a channel, the same instruction wherever it is needed.
__device__ __forceinline__ float rstd_of(float var, float eps) {
  return rsqrtf(__fadd_rn(var, eps));
}

// y before the ReLU: the forward's arithmetic, which the backward repeats
// (masked()) to recover the ReLU mask bit for bit.
__device__ __forceinline__ float affine(float x, float mean, float mul, float bias) {
  return __fmaf_rn(__fsub_rn(x, mean), mul, bias);
}

// The rows of this block's slab, U of them in flight a thread: calls
// body(row index, pack of x, pack of dy) for each (dy's pack is x's when
// dy is NULL).
template <typename T, int V, int U, typename F>
__device__ __forceinline__ void for_rows(const T* __restrict__ x, const T* __restrict__ dy, int g,
                                         int cv, const Shape& s, F body) {
  const long long r0 = (long long)blockIdx.y * s.rows_per_slab;
  const long long r1 = min(r0 + s.rows_per_slab, s.rows);
  const Pack<T, V>* src = reinterpret_cast<const Pack<T, V>*>(x) + g;
  const Pack<T, V>* dsrc = reinterpret_cast<const Pack<T, V>*>(dy) + g;
  const int step = blockDim.y;
  for (long long r = r0 + threadIdx.y; r < r1; r += (long long)U * step) {
    Pack<T, V> p[U], q[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long rr = r + (long long)u * step;
      if (rr < r1) {
        p[u] = src[rr * cv];
        if (dy != nullptr) q[u] = dsrc[rr * cv];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long rr = r + (long long)u * step;
      if (rr < r1) body(rr, p[u], dy != nullptr ? q[u] : p[u]);
    }
  }
}

// Adds a[i] and b[i] of every thread over threadIdx.y, in order of y, and
// writes the block's partial of each of its channels to part[slab][c] (a)
// and part[slabs + slab][c] (b). red holds blockDim.y * 2 * blockDim.x * V
// floats.
template <int V>
__device__ __forceinline__ void store_partials(const float (&a)[V], const float (&b)[V],
                                               float* red, float* __restrict__ part, int C) {
  const int w = blockDim.x * V;
  float* row = red + threadIdx.y * 2 * w;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    row[threadIdx.x * V + i] = a[i];
    row[w + threadIdx.x * V + i] = b[i];
  }
  __syncthreads();
  const long long plane = (long long)gridDim.y * C;
  float* out = part + (long long)blockIdx.y * C + blockIdx.x * w;
  const int limit = C - blockIdx.x * w;
  for (int k = threadIdx.y * blockDim.x + threadIdx.x; k < 2 * w; k += blockDim.x * blockDim.y) {
    float acc = 0.f;
    for (int y = 0; y < blockDim.y; ++y) acc += red[y * 2 * w + k];
    const int c = k < w ? k : k - w;
    if (c < limit) out[(k < w ? 0 : plane) + c] = acc;
  }
}

// Sums channel c's partials of both planes over the slabs in a fixed order:
// lane l takes slabs l, l + kLanes, ..., then the lanes are added in order.
// Block (32 channels, kLanes lanes); returns true in the thread that holds
// the sums (threadIdx.y == 0, c < C).
__device__ __forceinline__ bool sum_slabs(const float* __restrict__ part, int slabs, int C, int c,
                                          float* a, float* b) {
  __shared__ float red[2][kLanes][32];
  float sa = 0.f, sb = 0.f;
  if (c < C) {
    const long long plane = (long long)slabs * C;
    for (int sl = threadIdx.y; sl < slabs; sl += kLanes) {
      sa += part[(long long)sl * C + c];
      sb += part[plane + (long long)sl * C + c];
    }
  }
  red[0][threadIdx.y][threadIdx.x] = sa;
  red[1][threadIdx.y][threadIdx.x] = sb;
  __syncthreads();
  if (threadIdx.y != 0 || c >= C) return false;
  sa = 0.f;
  sb = 0.f;
  for (int l = 0; l < kLanes; ++l) {
    sa += red[0][l][threadIdx.x];
    sb += red[1][l][threadIdx.x];
  }
  *a = sa;
  *b = sb;
  return true;
}

// --- forward ---------------------------------------------------------------

// Pass (a): per-slab f32 sums of x and x^2.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, Shape s) {
  extern __shared__ float red[];
  const int cv = s.C / V;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  float sum[V], sq[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sum[i] = sq[i] = 0.f;
  if (g < cv) {
    for_rows<T, V, 4>(x, nullptr, g, cv, s, [&](long long, const Pack<T, V>& p, const Pack<T, V>&) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float f = to_f32(p.v[i]);
        sum[i] += f;
        sq[i] = __fmaf_rn(f, f, sq[i]);
      }
    });
  }
  store_partials<V>(sum, sq, red, part, s.C);
}

// Pass (b): mean, var (clipped at 0) and whether var was not clipped, into
// stats [3, C]; the running averages updated in place as the torch ops do
// (momentum * old + fresh * new, each product rounded; fresh is 1 - momentum
// rounded from double, as torch rounds the Python scalar).
__global__ void bn_finalize_kernel(const float* __restrict__ part, int slabs, int C,
                                   long long rows, float momentum, float fresh,
                                   float* __restrict__ stats,
                                   float* __restrict__ run_mean, float* __restrict__ run_var) {
  const int c = blockIdx.x * 32 + threadIdx.x;
  float sx, sxx;
  if (!sum_slabs(part, slabs, C, c, &sx, &sxx)) return;
  const float n = (float)rows;
  const float mean = __fdiv_rn(sx, n);
  const float raw = __fsub_rn(__fdiv_rn(sxx, n), __fmul_rn(mean, mean));
  const float var = fmaxf(raw, 0.f);
  stats[c] = mean;
  stats[C + c] = var;
  stats[2 * C + c] = raw >= 0.f ? 1.f : 0.f;
  run_mean[c] = __fadd_rn(__fmul_rn(momentum, run_mean[c]), __fmul_rn(fresh, mean));
  run_var[c] = __fadd_rn(__fmul_rn(momentum, run_var[c]), __fmul_rn(fresh, var));
}

// Pass (c), and the whole eval forward: y = affine(x), then the ReLU.
template <typename T, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bn_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                                const float* __restrict__ mean, const float* __restrict__ var,
                                const float* __restrict__ scale, const float* __restrict__ bias,
                                float eps, Shape s) {
  const int cv = s.C / V;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= cv) return;
  float m[V], mul[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = g * V + i;
    m[i] = mean[c];
    mul[i] = __fmul_rn(rstd_of(var[c], eps), scale[c]);
    b[i] = bias[c];
  }
  Pack<T, V>* dst = reinterpret_cast<Pack<T, V>*>(y) + g;
  for_rows<T, V, 4>(x, nullptr, g, cv, s, [&](long long r, const Pack<T, V>& p, const Pack<T, V>&) {
    Pack<T, V> o;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float v = affine(to_f32(p.v[i]), m[i], mul[i], b[i]);
      if (kRelu) v = v < 0.f ? 0.f : v;
      o.v[i] = from_f32<T>(v);
    }
    dst[r * cv] = o;
  });
}

// --- backward --------------------------------------------------------------
//
// With xc = x - mean and mul = rstd * scale (the forward's multiplier):
// dbias = sum dy', dscale = rstd * sum dy' * xc, and
// dx = mul * (dy' - dbias / rows - xc * rstd * dscale / rows)
//    = mul * dy' - (xc * cx + bx),  bx = mul * dbias / rows,
//                                   cx = mul * rstd * dscale / rows.
// Each pass keeps only the constants it needs a channel (mean, and for the
// ReLU mask mul and bias; the dx pass bx and cx too), so that the bf16
// passes stay within kMinBlocks' registers without spilling.

// dy under the ReLU mask of the forward (y > 0), recomputed from xc.
template <bool kRelu>
__device__ __forceinline__ float masked(float d, float xc, float mul, float b) {
  return (!kRelu || __fmaf_rn(xc, mul, b) > 0.f) ? d : 0.f;
}

// Pass (a): per-slab f32 sums of dy' and dy' * xc. Two rows of x and dy in
// flight a thread.
template <typename T, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const float* __restrict__ mean, const float* __restrict__ var,
                         const float* __restrict__ scale, const float* __restrict__ bias,
                         float eps, float* __restrict__ part, Shape s) {
  extern __shared__ float red[];
  const int cv = s.C / V;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  float sd[V], sdc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sd[i] = sdc[i] = 0.f;
  if (g < cv) {
    float m[V], mul[V], b[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = g * V + i;
      m[i] = mean[c];
      mul[i] = kRelu ? __fmul_rn(rstd_of(var[c], eps), scale[c]) : 0.f;
      b[i] = kRelu ? bias[c] : 0.f;
    }
    for_rows<T, V, 2>(x, dy, g, cv, s, [&](long long, const Pack<T, V>& p, const Pack<T, V>& q) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xc = __fsub_rn(to_f32(p.v[i]), m[i]);
        const float d = masked<kRelu>(to_f32(q.v[i]), xc, mul[i], b[i]);
        sd[i] += d;
        sdc[i] = __fmaf_rn(d, xc, sdc[i]);
      }
    });
  }
  store_partials<V>(sd, sdc, red, part, s.C);
}

// Pass (b): dbias, dscale, and the dx constants coef [2, C]: bx, and cx
// where var was not clipped (0 where it was: the gradient through var is
// 0). For eval's running statistics, which do not depend on x, both are 0.
__global__ void bn_bwd_finalize_kernel(const float* __restrict__ part, int slabs, int C,
                                       long long rows, const float* __restrict__ var,
                                       const float* __restrict__ keep,
                                       const float* __restrict__ scale, float eps,
                                       float* __restrict__ dscale, float* __restrict__ dbias,
                                       float* __restrict__ coef) {
  const int c = blockIdx.x * 32 + threadIdx.x;
  float sd, sdc;
  if (!sum_slabs(part, slabs, C, c, &sd, &sdc)) return;
  const float rstd = rstd_of(var[c], eps);
  const float mul = __fmul_rn(rstd, scale[c]);
  const float ds = rstd * sdc;
  dbias[c] = sd;
  dscale[c] = ds;
  const float n = (float)rows;
  const bool batch = keep != nullptr;
  coef[c] = batch ? mul * (sd / n) : 0.f;
  coef[C + c] = batch && keep[c] != 0.f ? mul * rstd * (ds / n) : 0.f;
}

// Pass (c): dx = mul * dy' - (xc * cx + bx).
template <typename T, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                     const float* __restrict__ mean, const float* __restrict__ var,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     const float* __restrict__ coef, float eps, Shape s) {
  const int cv = s.C / V;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= cv) return;
  float m[V], mul[V], b[V], bx[V], cx[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = g * V + i;
    m[i] = mean[c];
    mul[i] = __fmul_rn(rstd_of(var[c], eps), scale[c]);
    b[i] = kRelu ? bias[c] : 0.f;
    bx[i] = coef[c];
    cx[i] = coef[s.C + c];
  }
  Pack<T, V>* dst = reinterpret_cast<Pack<T, V>*>(dx) + g;
  for_rows<T, V, 2>(x, dy, g, cv, s, [&](long long r, const Pack<T, V>& p, const Pack<T, V>& q) {
    Pack<T, V> o;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float xc = __fsub_rn(to_f32(p.v[i]), m[i]);
      const float d = masked<kRelu>(to_f32(q.v[i]), xc, mul[i], b[i]);
      o.v[i] = from_f32<T>(__fmaf_rn(mul[i], d, -__fmaf_rn(xc, cx[i], bx[i])));
    }
    dst[r * cv] = o;
  });
}

// --- launches --------------------------------------------------------------

struct Grid {
  dim3 grid, block;
  size_t smem;  // bytes of store_partials' red
  Shape shape;
};

template <int V>
Grid make_grid(long long rows, int C, int tx, int ty, int tiles, int slabs,
               long long rows_per_slab) {
  Grid g;
  g.grid = dim3(tiles, slabs);
  g.block = dim3(tx, ty);
  g.smem = (size_t)ty * 2 * tx * V * sizeof(float);
  g.shape = Shape{rows, rows_per_slab, C};
  return g;
}

dim3 finalize_grid(int C) { return dim3((C + 31) / 32); }
const dim3 kFinalizeBlock(32, kLanes);

template <typename T, int V>
cudaError_t run_forward(const void* x, void* y, float* part, float* stats, float* run_mean,
                    float* run_var, const float* scale, const float* bias, int relu, int train,
                    long long rows, int C, int tx, int ty, int tiles, int slabs,
                    long long rows_per_slab, float eps, float momentum, float fresh,
                    cudaStream_t stream) {
  const Grid g = make_grid<V>(rows, C, tx, ty, tiles, slabs, rows_per_slab);
  const T* xt = static_cast<const T*>(x);
  const float* mean = run_mean;
  const float* var = run_var;
  cudaError_t err;
  if (train) {
    bn_stats_kernel<T, V><<<g.grid, g.block, g.smem, stream>>>(xt, part, g.shape);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bn_finalize_kernel<<<finalize_grid(C), kFinalizeBlock, 0, stream>>>(
        part, slabs, C, rows, momentum, fresh, stats, run_mean, run_var);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    mean = stats;
    var = stats + C;
  }
  if (relu)
    bn_apply_kernel<T, V, true><<<g.grid, g.block, 0, stream>>>(xt, static_cast<T*>(y), mean, var,
                                                                scale, bias, eps, g.shape);
  else
    bn_apply_kernel<T, V, false><<<g.grid, g.block, 0, stream>>>(xt, static_cast<T*>(y), mean,
                                                                 var, scale, bias, eps, g.shape);
  return cudaGetLastError();
}

template <typename T, int V, bool kRelu>
cudaError_t backward_passes(const T* x, const T* dy, T* dx, float* part, const float* mean,
                            const float* var, const float* keep, const float* scale,
                            const float* bias, float* dscale, float* dbias, float* coef,
                            const Grid& g, int slabs, float eps, cudaStream_t stream) {
  const int C = g.shape.C;
  cudaError_t err;
  bn_bwd_reduce_kernel<T, V, kRelu><<<g.grid, g.block, g.smem, stream>>>(
      x, dy, mean, var, scale, bias, eps, part, g.shape);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bn_bwd_finalize_kernel<<<finalize_grid(C), kFinalizeBlock, 0, stream>>>(
      part, slabs, C, g.shape.rows, var, keep, scale, eps, dscale, dbias, coef);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bn_bwd_dx_kernel<T, V, kRelu><<<g.grid, g.block, 0, stream>>>(x, dy, dx, mean, var, scale, bias,
                                                                coef, eps, g.shape);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t run_backward(const void* x, const void* dy, void* dx, float* part, const float* mean,
                     const float* var, const float* keep, const float* scale, const float* bias,
                     float* dscale, float* dbias, float* coef, int relu, long long rows, int C,
                     int tx, int ty, int tiles, int slabs, long long rows_per_slab, float eps,
                     cudaStream_t stream) {
  const Grid g = make_grid<V>(rows, C, tx, ty, tiles, slabs, rows_per_slab);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  if (relu)
    return backward_passes<T, V, true>(xt, dyt, dxt, part, mean, var, keep, scale, bias, dscale,
                                       dbias, coef, g, slabs, eps, stream);
  return backward_passes<T, V, false>(xt, dyt, dxt, part, mean, var, keep, scale, bias, dscale,
                                      dbias, coef, g, slabs, eps, stream);
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16. vec: elements a load (16 bytes: 4 f32
// or 8 bf16; or 1). Every entry point returns the cudaError_t of its
// launches (0 on success); an unsupported dtype or vec returns
// cudaErrorInvalidValue.
#define BTT_BN_DISPATCH(FN, ...)                                  \
  switch (dtype * 100 + vec) {                                    \
    case 1: return (int)FN<float, 1>(__VA_ARGS__);                \
    case 4: return (int)FN<float, 4>(__VA_ARGS__);                \
    case 101: return (int)FN<__nv_bfloat16, 1>(__VA_ARGS__);      \
    case 108: return (int)FN<__nv_bfloat16, 8>(__VA_ARGS__);      \
    default: return (int)cudaErrorInvalidValue;                   \
  }

extern "C" {

// train != 0: passes (a), (b), (c), writing stats [3, C] (mean, var, not
// clipped) and updating run_mean and run_var in place; part is the
// workspace [2, slabs, C]. train == 0: pass (c) on run_mean and run_var
// (stats and part unused).
int btt_bn_forward(const void* x, void* y, float* part, float* stats, float* run_mean,
                   float* run_var, const float* scale, const float* bias, int dtype, int vec,
                   int relu, int train, long long rows, int C, int tx, int ty, int tiles,
                   int slabs, long long rows_per_slab, float eps, float momentum, float fresh,
                   void* stream) {
  BTT_BN_DISPATCH(run_forward, x, y, part, stats, run_mean, run_var, scale, bias, relu, train, rows, C,
                  tx, ty, tiles, slabs, rows_per_slab, eps, momentum, fresh,
                  (cudaStream_t)stream);
}

// mean and var: the forward's (the batch's, or the running ones in eval);
// keep: the forward's not-clipped flags, or NULL for eval. Writes dx,
// dscale, dbias; part [2, slabs, C] and coef [2, C] are workspace.
int btt_bn_backward(const void* x, const void* dy, void* dx, float* part, const float* mean,
                    const float* var, const float* keep, const float* scale, const float* bias,
                    float* dscale, float* dbias, float* coef, int dtype, int vec, int relu,
                    long long rows, int C, int tx, int ty, int tiles, int slabs,
                    long long rows_per_slab, float eps, void* stream) {
  BTT_BN_DISPATCH(run_backward, x, dy, dx, part, mean, var, keep, scale, bias, dscale, dbias, coef,
                  relu, rows, C, tx, ty, tiles, slabs, rows_per_slab, eps, (cudaStream_t)stream);
}

const char* btt_bn_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
