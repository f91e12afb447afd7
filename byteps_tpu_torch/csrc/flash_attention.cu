// Flash attention for Hopper (sm_90a): forward (with and without the row
// logsumexp), dQ, and dK/dV, bound through a plain C interface (ctypes).
//
// Replaces the four Pallas TPU kernels of byteps_tpu/ops/flash_attention.py:
//   fa_fwd_wgmma_kernel<T, D, true>   bf16/f16 <- _fa_kernel via
//   fa_fwd_tf32_kernel<D, true>       f32          _flash_fwd_impl(return_lse=True)
//   fa_fwd_wgmma_kernel<T, D, false>  bf16/f16 <- _kernel_nolse (forward with
//   fa_fwd_tf32_kernel<D, false>      f32          no residuals)
//   fa_bwd_dq_wgmma_kernel<T, D>      bf16/f16 <- _fa_bwd_dq_kernel (+ _bwd_recompute,
//   fa_bwd_dq_tf32_kernel<D>          f32          _bwd_mask, _bwd_live)
//   fa_bwd_dkv_wgmma_kernel<T, D>     bf16/f16 <- _fa_bwd_dkv_kernel
//   fa_bwd_dkv_tf32_kernel<D>         f32
//
// Layout: q, k, v, o, dO, dq, dk, dv are [batch, seq, heads, head_dim]
// row-major (the public layout; no transposes around the kernels); lse and
// D = rowsum(dO * O) are f32 [batch, heads, seq_q].
//
// What bounds the forward on the H100. At GPT-2 small's shapes (b 8, s 512,
// h 12, d 64, bf16, causal) it reads q, k, v and writes o: ~25 MB, about
// 7.5 us at 3.35 TB/s, against ~3.2 GFLOP of products, 3.3 us at the bf16
// tensor-core peak, so the least time is set by bytes. The bf16/f16
// forward (fa_fwd_wgmma_kernel) is built for that:
// - one warpgroup per 64 query rows; S = Q K^T and O += P V are wgmma
//   products on the tensor cores with f32 accumulators in registers;
// - the Q tile is loaded once per block and K/V tiles stream through a
//   two-stage ring in shared memory, each copied by TMA in its natural
//   layout (one box of a [b, s, h, d] tensor map, swizzled for wgmma, rows
//   past the sequence zero-filled) and signalled through an mbarrier, so
//   the next tile's copy overlaps this tile's two products and no thread
//   spends instructions on addresses;
// - the online softmax runs on the accumulator fragment itself (a row is
//   held by the four threads of a quad: two shuffles reduce it), in base 2
//   (one FMA and one ex2 a probability), and P, rounded to T, is repacked
//   in registers as the A operand of P V: the [64, 64] probabilities never
//   touch shared memory;
// - masks are evaluated only on tiles that cross the diagonal, the window
//   edge or the sequence end, as two compares against per-row column
//   bounds; the causal and window loop bounds are per tile, and the
//   heaviest causal q tiles are launched first;
// - the softmax, not the tensor cores or the copies, sets the pace, so the
//   kernel keeps to 95-ish registers and 42 KB of shared memory at d 64:
//   five blocks share an SM and hide each other's waits. Issuing the next
//   tile's S before this tile's softmax (two S fragments in registers)
//   needs ~140 registers, leaves room for three blocks, and measured
//   slower.
// The bf16/f16 backward kernels follow the same design (their note is
// above fa_bwd_dq_wgmma_kernel). In f32 all four run on the tensor cores
// too, each product as three TF32 products (their note is above
// fa_fwd_tf32_kernel). Every product of two bf16/f16 inputs is exact in
// f32, so those kernels differ from the plain version in the order of
// their f32 sums and in ex2's last bits (a relative 1e-6 in p, far below
// its rounding to bf16 or f16); the f32 ones also in the split's 2^-21 a
// product.
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

#include <atomic>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr float kNegInf = -1e30f;
constexpr float kBig = 1e30f;

// --- the bf16/f16 forward on the tensor cores --------------------------------

constexpr int WG = 128;     // threads of a tensor-core kernel: one warpgroup
constexpr int STAGES = 2;   // streaming tiles in flight in shared memory

// A [R rows][D] tile in shared memory: panels of DP <= 64 columns (rows of
// 32, 64 or 128 bytes, in the swizzle of that width), side by side.
template <int D, int R = 64> struct Tile {
  static constexpr int DP = D < 64 ? D : 64;  // columns per panel
  static constexpr int ROW = DP * 2;          // bytes per panel row
  static constexpr int PANEL = R * ROW;       // bytes per panel
  static constexpr int BYTES = D / DP * PANEL;
  static constexpr uint32_t SWZ = hopper::swizzle_code(ROW);
  // Byte offset of columns 16j .. 16j+15, the j-th K step of an operand
  // that is K-major along D.
  __host__ __device__ static constexpr uint32_t kstep(int j) {
    return (j / (DP / 16)) * PANEL + (j % (DP / 16)) * 32;
  }
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// One tile of the online softmax on this thread's S fragment of a [64 x
// 2 NS] tile: s[i*4 + r*2 + e] is row r, key column c0 + 8i + e of the
// tile, live when it lies in [lo[r], hi[r]] (with MASK; every element is
// live without). The running max m is kept in base 2 (max s * scale * log2
// e), so each p is one FMA and one ex2; masked elements get logit -1e30
// and p = 0. On return s holds p (unrounded f32).
template <bool MASK, int NS = 32>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], const int (&lo)[2],
                                             const int (&hi)[2], float scale_log2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < NS / 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[i * 4 + r * 2 + e];
        if (MASK && !(8 * i + e >= lo[r] && 8 * i + e <= hi[r])) x = kNegInf;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * scale_log2);
    corr[r] = exp2_approx(m[r] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < NS / 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[i * 4 + r * 2 + e];
        x = !MASK || (8 * i + e >= lo[r] && 8 * i + e <= hi[r])
                ? exp2_approx(fmaf(x, scale_log2, -m_new))
                : 0.f;
        rs += x;
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l[r] = l[r] * corr[r] + rs;
    m[r] = m_new;
  }
}

// Thread layout of the wgmma fragments: warp w of the warpgroup holds tile
// rows 16w + lane/4 and 16w + lane/4 + 8; element [i*4 + r*2 + e] of an
// m64nN accumulator is row (r), column 8i + 2*(lane%4) + e. D is the head
// dim of q and k, DV that of v and o (DV = D but for latent attention's
// 192 / 128).
template <typename T, int D, int DV, bool LSE>
__global__ void __launch_bounds__(WG)
fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, T* __restrict__ o,
                    float* __restrict__ lse, int H, int Sq, int Sk, float scale, int causal,
                    int window) {
  using G = Tile<D>;
  using GV = Tile<DV>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + G::BYTES;            // stage st at sK + st * G::BYTES
  const uint32_t sV = sK + STAGES * G::BYTES;   // stage st at sV + st * GV::BYTES
  const uint32_t bar_q = sV + STAGES * GV::BYTES;
  const uint32_t bar_k = bar_q + 8;             // stage st at bar_k + 8 * st
  const uint32_t bar_v = bar_k + 8 * STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // most live K tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int nk = (Sk + BK - 1) / BK;
  int kt_lo = 0, kt_hi = nk;
  if (causal) {
    kt_hi = min(nk, (min(q0 + BQ, Sq) - 1) / BK + 1);
    if (window > 0) kt_lo = max(0, q0 - (window - 1)) / BK;
  }

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar_k + 8 * st, 1);
      mbar_init(bar_v + 8 * st, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Issued by thread 0: K and V tile kt into ring stage st.
  auto load_kv = [&](int kt, int st) {
    mbar_expect_tx(bar_k + 8 * st, G::BYTES);
    for (int p = 0; p < D / G::DP; ++p)
      tma_load_4d(sK + st * G::BYTES + p * G::PANEL, &tk, bar_k + 8 * st, p * G::DP, h, kt * BK,
                  b);
    mbar_expect_tx(bar_v + 8 * st, GV::BYTES);
    for (int p = 0; p < DV / GV::DP; ++p)
      tma_load_4d(sV + st * GV::BYTES + p * GV::PANEL, &tv, bar_v + 8 * st, p * GV::DP, h,
                  kt * BK, b);
  };
  if (tid == 0 && kt_lo < kt_hi) {
    mbar_expect_tx(bar_q, G::BYTES);
    for (int p = 0; p < D / G::DP; ++p)
      tma_load_4d(sQ + p * G::PANEL, &tq, bar_q, p * G::DP, h, q0, b);
    load_kv(kt_lo, 0);
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  const int qr = q0 + warp * 16 + (lane >> 2);  // query position of this thread's row 0
  const int c0 = 2 * (lane & 3);                // this thread's first column in 8
  const float scale_log2 = scale * kLog2e;
  int lo[2], hi[2];                             // live columns of a masked tile

  if (kt_lo < kt_hi) mbar_wait(bar_q, 0);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int it = kt - kt_lo, st = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    // The other stage was last read in the previous tile, which every warp
    // has finished (the barrier at the end of the loop).
    if (tid == 0 && kt + 1 < kt_hi) load_kv(kt + 1, (it + 1) % STAGES);
    const int k0 = kt * BK;

    // The first step overwrites s (accumulate 0); zeroing it anyway keeps
    // ptxas at ~95 registers at d 64 (108-111 without), five blocks an SM.
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    mbar_wait(bar_k + 8 * st, parity);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {  // 16 columns of d a step
      const uint32_t off = (j / (G::DP / 16)) * G::PANEL + (j % (G::DP / 16)) * 32;
      WgmmaSS<T, 64>::run(s, smem_desc(sQ + off, 16, 8 * G::ROW, G::SWZ),
                          smem_desc(sK + st * G::BYTES + off, 16, 8 * G::ROW, G::SWZ), j > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    float corr[2];
    const bool full =
        k0 + BK <= Sk && q0 + BQ <= Sq &&
        (!causal || (k0 + BK - 1 <= q0 && (window <= 0 || q0 + BQ - 1 - k0 < window)));
    if (full) {
      softmax_tile<false>(s, m, l, corr, lo, hi, scale_log2);
    } else {
      // live columns of each row, relative to this thread's column c0:
      // key < Sk, and with causal key <= query and query - key < window;
      // none past the last query
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qp = qr + 8 * r;
        hi[r] = (qp < Sq ? (causal ? min(qp, Sk - 1) : Sk - 1) : -1) - k0 - c0;
        lo[r] = (causal && window > 0 ? qp - window + 1 : 0) - k0 - c0;
      }
      softmax_tile<true>(s, m, l, corr, lo, hi, scale_log2);
    }
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    // P rounded to T (p.astype(v.dtype)) as the A fragment of P V: keys
    // 16j .. 16j+15 are accumulator chunks 2j and 2j+1.
    uint32_t pa[16];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[4 * j + x] = pack2<T>(s[8 * j + 2 * x], s[8 * j + 2 * x + 1]);

    mbar_wait(bar_v + 8 * st, parity);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)  // 16 keys a step
      WgmmaRS<T, DV>::run(acc, pa + 4 * j,
                          smem_desc(sV + st * GV::BYTES + j * 16 * GV::ROW, GV::PANEL,
                                    8 * GV::ROW, GV::SWZ));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(pa);
    __syncthreads();  // stage st is free for the tile after next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qr + 8 * r;
    if (qp >= Sq) continue;
    const float safe_l = l[r] == 0.f ? 1.f : l[r];
    T* orow = o + ((size_t)(b * Sq + qp) * H + h) * DV + c0;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      *reinterpret_cast<uint32_t*>(orow + 8 * i) =
          pack2<T>(acc[i * 4 + r * 2] / safe_l, acc[i * 4 + r * 2 + 1] / safe_l);
    if (LSE && (lane & 3) == 0)
      lse[(size_t)bh * Sq + qp] = l[r] == 0.f ? kBig : m[r] * kLn2 + logf(safe_l);
  }
}

// --- the bf16/f16 backward on the tensor cores --------------------------------
//
//   fa_bwd_dq_wgmma_kernel<T, D>   <- _fa_bwd_dq_kernel (+ _bwd_recompute,
//                                     _bwd_mask, _bwd_live)
//   fa_bwd_dkv_wgmma_kernel<T, D>  <- _fa_bwd_dkv_kernel
// of byteps_tpu/ops/flash_attention.py, for bf16 and f16 (f32 takes three
// TF32 products a product: fa_bwd_dq_tf32_kernel, fa_bwd_dkv_tf32_kernel).
//
// What bounds them on the H100. At GPT-2 small's shapes (b 8, s 512, h 12,
// d 64, causal) dQ reads q, k, v, dO, lse and D and writes dq, ~31 MB or
// 9.4 us at 3.35 TB/s, against 6 d operations per live (query, key) pair
// (S, dP, dS K), 4.8 GFLOP or 4.9 us at the bf16 tensor-core peak; dK/dV
// moves ~38 MB (11.3 us) against 10 d a pair (S^T, dP^T, dS^T Q and two
// products for P^T dO), 8.1 GFLOP (8.2 us). Both are bound by bytes. On an
// H100 at 700 W they run at 55 % (dQ) and 36 % (dK/dV) of it, held by each
// tile's chain of copy wait, products, recompute and barrier, which three
// or four blocks an SM overlap. The design:
// - every product is a wgmma with f32 accumulators in registers. dQ takes
//   one warpgroup per 64 query rows and walks the K tiles: S = Q K^T and
//   dP = dO V^T (both operands K-major over d), then dQ += dS K with K read
//   MN-major. dK/dV takes one warpgroup per 64 key rows and walks the Q
//   tiles with transposed tiles, rows keys and columns queries: S^T = K Q^T
//   and dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q with dO and Q read
//   MN-major. The accumulator fragments of S^T and dP^T are already the A
//   fragments of those products, so no tile is transposed through shared
//   memory and p and ds never leave registers;
// - the tiles loaded once (Q and dO, or K and V) and the two-stage ring of
//   streaming tiles are copied by TMA with mbarrier completion, as in the
//   forward. lse and D are per-row registers in dQ; dK/dV needs them per
//   column and keeps each Q tile's 2 x 64 values in shared memory beside
//   its ring stage (read from global a tile ahead);
// - p = exp(s scale - lse) is one FMA and one ex2 (lse scaled by log2 e).
//   lse = +1e30, a row with no live key or a row past the sequence (whose
//   Q and dO tiles TMA fills with zeros), gives p = 0 exactly. Masks are
//   per-row column bounds, evaluated only on tiles that cross the diagonal,
//   the window edge or a sequence end;
// - the rounding points are the TPU kernel's: dP from 16-bit dO and V with
//   f32 sums (exact products); ds rounded to T before dQ and dK; dV from f32
//   p (`p.astype(do.dtype)` with do already f32). For dV, p is split into
//   p_hi = p rounded to T and p_lo = p - p_hi rounded to T, and dV takes two
//   products, P_hi^T dO + P_lo^T dO, which hold p to 2^-18 p in bf16 (2^-22
//   p in f16, or 2^-25 absolute where p_lo is subnormal). Rounding P to T
//   alone, as FlashAttention-2/3 do, would add a rounding of 2^-9 p that
//   the reference does not have and no check here could see (limit()'s
//   eps |dv| term is larger);
// - the heaviest causal tiles launch first: dQ's last q tiles, dK/dV's
//   first K tiles. At d 128 dK/dV takes 32-query tiles (N = 32 for S^T and
//   dP^T), so its two [64 x 128] f32 accumulators fit in registers beside
//   the S^T and dP^T fragments.

// ds = p (dp - D) scale on this thread's fragment of a [64 query][2 NS
// key] dQ tile (layout of fa_fwd_wgmma_kernel), p = 2^(s scale log2 e -
// lse2) with lse2 = lse log2 e per row; with MASK, elements outside
// [lo[r], hi[r]] get p = 0. On return s holds ds (f32).
template <bool MASK, int NS>
__device__ __forceinline__ void ds_rows(float (&s)[NS], const float (&dp)[NS],
                                        const float (&lse2)[2], const float (&dd)[2],
                                        const int (&lo)[2], const int (&hi)[2], float scale_log2,
                                        float scale) {
#pragma unroll
  for (int i = 0; i < NS / 4; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = i * 4 + r * 2 + e;
        float p = exp2_approx(fmaf(s[x], scale_log2, -lse2[r]));
        if (MASK && !(8 * i + e >= lo[r] && 8 * i + e <= hi[r])) p = 0.f;
        s[x] = p * (dp[x] - dd[r]) * scale;
      }
}

// The same on a transposed [64 key][BN query] dK/dV tile, whose lse2 and D
// are per column: rows[c] and rows[BN + c] for query column c. On return s
// holds p and dp holds ds (both f32).
template <int BN, bool MASK>
__device__ __forceinline__ void p_ds_cols(float (&s)[BN / 2], float (&dp)[BN / 2],
                                          const float* rows, int c0, const int (&lo)[2],
                                          const int (&hi)[2], float scale_log2, float scale) {
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * i + c0);
    const float2 dd = *reinterpret_cast<const float2*>(rows + BN + 8 * i + c0);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = i * 4 + r * 2 + e;
        float p = exp2_approx(fmaf(s[x], scale_log2, -(e ? l2.y : l2.x)));
        if (MASK && !(8 * i + e >= lo[r] && 8 * i + e <= hi[r])) p = 0.f;
        s[x] = p;
        dp[x] = p * (dp[x] - (e ? dd.y : dd.x)) * scale;
      }
  }
}

// Two f32 values as hi + lo, each a pack2 register of T: hi the values
// rounded to T, lo the remainders rounded to T.
template <typename T>
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = hopper::pack2<T>(a, b);
  const float2 h = hopper::unpack2<T>(hi);
  lo = hopper::pack2<T>(a - h.x, b - h.y);
}

// dQ of one 64-row q tile, walking its live K tiles (replaces
// _fa_bwd_dq_kernel for bf16/f16; design in the note above).
template <typename T, int D, int DV>
__global__ void __launch_bounds__(WG)
fa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                       const float* __restrict__ dvec, T* __restrict__ dq, int H, int Sq, int Sk,
                       float scale, int causal, int window) {
  using G = Tile<D>;    // Q, K
  using GV = Tile<DV>;  // dO, V
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sDO = sQ + G::BYTES;
  const uint32_t sK = sDO + GV::BYTES;          // stage st at sK + st * G::BYTES
  const uint32_t sV = sK + STAGES * G::BYTES;   // stage st at sV + st * GV::BYTES
  const uint32_t bar_q = sV + STAGES * GV::BYTES;  // Q and dO
  const uint32_t bar_k = bar_q + 8;             // stage st at bar_k + 8 * st
  const uint32_t bar_v = bar_k + 8 * STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = BQ * (gridDim.y - 1 - blockIdx.y);  // most live K tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int nk = (Sk + BK - 1) / BK;
  int kt_lo = 0, kt_hi = nk;
  if (causal) {
    kt_hi = min(nk, (min(q0 + BQ, Sq) - 1) / BK + 1);
    if (window > 0) kt_lo = max(0, q0 - (window - 1)) / BK;
  }

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar_k + 8 * st, 1);
      mbar_init(bar_v + 8 * st, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Issued by thread 0: K and V tile kt into ring stage st.
  auto load_kv = [&](int kt, int st) {
    mbar_expect_tx(bar_k + 8 * st, G::BYTES);
    for (int p = 0; p < D / G::DP; ++p)
      tma_load_4d(sK + st * G::BYTES + p * G::PANEL, &tk, bar_k + 8 * st, p * G::DP, h, kt * BK,
                  b);
    mbar_expect_tx(bar_v + 8 * st, GV::BYTES);
    for (int p = 0; p < DV / GV::DP; ++p)
      tma_load_4d(sV + st * GV::BYTES + p * GV::PANEL, &tv, bar_v + 8 * st, p * GV::DP, h,
                  kt * BK, b);
  };
  if (tid == 0 && kt_lo < kt_hi) {
    mbar_expect_tx(bar_q, G::BYTES + GV::BYTES);
    for (int p = 0; p < D / G::DP; ++p)
      tma_load_4d(sQ + p * G::PANEL, &tq, bar_q, p * G::DP, h, q0, b);
    for (int p = 0; p < DV / GV::DP; ++p)
      tma_load_4d(sDO + p * GV::PANEL, &tdo, bar_q, p * GV::DP, h, q0, b);
    load_kv(kt_lo, 0);
  }

  const int qr = q0 + warp * 16 + (lane >> 2);  // query position of this thread's row 0
  const int c0 = 2 * (lane & 3);                // this thread's first column in 8
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qr + 8 * r;
    lse2[r] = (qp < Sq ? lse[(size_t)bh * Sq + qp] : kBig) * kLog2e;
    dd[r] = qp < Sq ? dvec[(size_t)bh * Sq + qp] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  int lo[2], hi[2];  // live columns of a masked tile

  if (kt_lo < kt_hi) mbar_wait(bar_q, 0);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int it = kt - kt_lo, st = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    // The other stage was last read in the previous tile, which every warp
    // has finished (the barrier at the end of the loop).
    if (tid == 0 && kt + 1 < kt_hi) load_kv(kt + 1, (it + 1) % STAGES);
    const int k0 = kt * BK;

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    mbar_wait(bar_k + 8 * st, parity);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 16; ++j)  // S = Q K^T, 16 columns of d a step
      WgmmaSS<T, 64>::run(s, smem_desc(sQ + G::kstep(j), 16, 8 * G::ROW, G::SWZ),
                          smem_desc(sK + st * G::BYTES + G::kstep(j), 16, 8 * G::ROW, G::SWZ),
                          j > 0);
    mbar_wait(bar_v + 8 * st, parity);
#pragma unroll
    for (int j = 0; j < DV / 16; ++j)  // dP = dO V^T
      WgmmaSS<T, 64>::run(dp, smem_desc(sDO + GV::kstep(j), 16, 8 * GV::ROW, GV::SWZ),
                          smem_desc(sV + st * GV::BYTES + GV::kstep(j), 16, 8 * GV::ROW,
                                    GV::SWZ),
                          j > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // Rows past Sq need no mask: their lse2 is huge, so p = 0.
    const bool inner = k0 + BK <= Sk && (!causal || (k0 + BK - 1 <= q0 &&
                                                    (window <= 0 || q0 + BQ - 1 - k0 < window)));
    if (inner) {
      ds_rows<false>(s, dp, lse2, dd, lo, hi, scale_log2, scale);
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qp = qr + 8 * r;
        hi[r] = (causal ? min(qp, Sk - 1) : Sk - 1) - k0 - c0;
        lo[r] = (causal && window > 0 ? qp - window + 1 : 0) - k0 - c0;
      }
      ds_rows<true>(s, dp, lse2, dd, lo, hi, scale_log2, scale);
    }

    // dS rounded to T (ds.astype(k.dtype)) as the A fragment of dS K.
    uint32_t da[16];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        da[4 * j + x] = pack2<T>(s[8 * j + 2 * x], s[8 * j + 2 * x + 1]);

    fence_regs(acc);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)  // dQ += dS K, 16 keys a step
      WgmmaRS<T, D>::run(acc, da + 4 * j,
                         smem_desc(sK + st * G::BYTES + j * 16 * G::ROW, G::PANEL, 8 * G::ROW,
                                   G::SWZ));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(da);
    __syncthreads();  // stage st is free for the tile after next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qr + 8 * r;
    if (qp >= Sq) continue;
    T* row = dq + ((size_t)(b * Sq + qp) * H + h) * D + c0;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(row + 8 * i) =
          pack2<T>(acc[i * 4 + r * 2], acc[i * 4 + r * 2 + 1]);
  }
}

// Queries per tile of the dK/dV kernel: 32 where dK and dV have 128
// columns or more keeps its registers (two accumulators of [64 x 128], or
// [64 x 192] and [64 x 128] for latent attention) clear of spills.
template <int D> __host__ __device__ constexpr int dkv_bn() { return D >= 128 ? 32 : 64; }

// dK and dV of one 64-row K tile, walking its live Q tiles with transposed
// score tiles (replaces _fa_bwd_dkv_kernel for bf16/f16; design in the
// note above). dV keeps f32 p: two products, P_hi^T dO + P_lo^T dO.
template <typename T, int D, int DV>
__global__ void __launch_bounds__(WG)
fa_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                        const float* __restrict__ dvec, T* __restrict__ dk, T* __restrict__ dv,
                        int H, int Sq, int Sk, float scale, int causal, int window) {
  constexpr int BN = dkv_bn<D>();
  using GK = Tile<D>;        // K: 64 key rows
  using GV = Tile<DV>;       // V: 64 key rows
  using GQ = Tile<D, BN>;    // Q: BN query rows
  using GO = Tile<DV, BN>;   // dO: BN query rows
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sK = (base + 1023u) & ~1023u;
  const uint32_t sV = sK + GK::BYTES;
  const uint32_t sQ = sV + GV::BYTES;               // stage st at sQ + st * GQ::BYTES
  const uint32_t sDO = sQ + STAGES * GQ::BYTES;     // stage st at sDO + st * GO::BYTES
  const uint32_t sRows = sDO + STAGES * GO::BYTES;  // f32 [STAGES][lse2, D][BN]
  const uint32_t bar_kv = sRows + STAGES * 2 * BN * 4;
  const uint32_t bar_q = bar_kv + 8;                // stage st at bar_q + 8 * st
  const uint32_t bar_do = bar_q + 8 * STAGES;
  float* rows = reinterpret_cast<float*>(smem_raw + (sRows - base));

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = BK * blockIdx.y;  // the first keys, live for the most queries, first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int nq = (Sq + BN - 1) / BN;
  int qt_lo = 0, qt_hi = nq;
  if (causal) {
    qt_lo = k0 / BN;  // first Q tile holding a q_pos >= k0
    if (window > 0) qt_hi = min(nq, (min(k0 + BK, Sk) - 1 + window - 1) / BN + 1);
  }

  // Thread c < BN reads lse (as lse2) and thread 64 + c reads D of query
  // column c of tile qt; rows past Sq read as lse = +1e30, D = 0.
  const int rc = tid & 63;
  auto row_value = [&](int qt) {
    const int qp = qt * BN + rc;
    if (tid < 64) return (qp < Sq ? lse[(size_t)bh * Sq + qp] : kBig) * kLog2e;
    return qp < Sq ? dvec[(size_t)bh * Sq + qp] : 0.f;
  };
  auto put_row = [&](int st, float x) {
    if (rc < BN) rows[(2 * st + (tid >> 6)) * BN + rc] = x;
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar_q + 8 * st, 1);
      mbar_init(bar_do + 8 * st, 1);
    }
    mbar_fence_init();
  }
  if (qt_lo < qt_hi) put_row(0, row_value(qt_lo));
  __syncthreads();

  // Issued by thread 0: Q and dO tile qt into ring stage st.
  auto load_qdo = [&](int qt, int st) {
    mbar_expect_tx(bar_q + 8 * st, GQ::BYTES);
    for (int p = 0; p < D / GQ::DP; ++p)
      tma_load_4d(sQ + st * GQ::BYTES + p * GQ::PANEL, &tq, bar_q + 8 * st, p * GQ::DP, h,
                  qt * BN, b);
    mbar_expect_tx(bar_do + 8 * st, GO::BYTES);
    for (int p = 0; p < DV / GO::DP; ++p)
      tma_load_4d(sDO + st * GO::BYTES + p * GO::PANEL, &tdo, bar_do + 8 * st, p * GO::DP, h,
                  qt * BN, b);
  };
  if (tid == 0 && qt_lo < qt_hi) {
    mbar_expect_tx(bar_kv, GK::BYTES + GV::BYTES);
    for (int p = 0; p < D / GK::DP; ++p)
      tma_load_4d(sK + p * GK::PANEL, &tk, bar_kv, p * GK::DP, h, k0, b);
    for (int p = 0; p < DV / GV::DP; ++p)
      tma_load_4d(sV + p * GV::PANEL, &tv, bar_kv, p * GV::DP, h, k0, b);
    load_qdo(qt_lo, 0);
  }

  const int kr = k0 + warp * 16 + (lane >> 2);  // key position of this thread's row 0
  const int c0 = 2 * (lane & 3);                // this thread's first column in 8
  const float scale_log2 = scale * kLog2e;
  float acc_k[D / 2], acc_v[DV / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc_v[i] = 0.f;
  int lo[2], hi[2];  // live columns of a masked tile

  if (qt_lo < qt_hi) mbar_wait(bar_kv, 0);
  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int it = qt - qt_lo, st = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    // The other stage (tiles and rows) was last read in the previous tile,
    // which every warp has finished (the barrier at the end of the loop).
    if (tid == 0 && qt + 1 < qt_hi) load_qdo(qt + 1, (it + 1) % STAGES);
    const float next_row = qt + 1 < qt_hi ? row_value(qt + 1) : 0.f;
    const int q0 = qt * BN;

    float s[BN / 2], dp[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
    mbar_wait(bar_q + 8 * st, parity);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 16; ++j)  // S^T = K Q^T, 16 columns of d a step
      WgmmaSS<T, BN>::run(s, smem_desc(sK + GK::kstep(j), 16, 8 * GK::ROW, GK::SWZ),
                          smem_desc(sQ + st * GQ::BYTES + GQ::kstep(j), 16, 8 * GQ::ROW, GQ::SWZ),
                          j > 0);
    mbar_wait(bar_do + 8 * st, parity);
#pragma unroll
    for (int j = 0; j < DV / 16; ++j)  // dP^T = V dO^T
      WgmmaSS<T, BN>::run(dp, smem_desc(sV + GV::kstep(j), 16, 8 * GV::ROW, GV::SWZ),
                          smem_desc(sDO + st * GO::BYTES + GO::kstep(j), 16, 8 * GO::ROW,
                                    GO::SWZ),
                          j > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // Rows past Sk need no mask: they are never written, and rows of a
    // product do not mix.
    const float* st_rows = rows + 2 * st * BN;
    const bool inner = q0 + BN <= Sq && (!causal || (q0 >= k0 + BK - 1 &&
                                                    (window <= 0 || q0 + BN - 1 - k0 < window)));
    if (inner) {
      p_ds_cols<BN, false>(s, dp, st_rows, c0, lo, hi, scale_log2, scale);
    } else {
      // live query columns of each key row, relative to c0: query < Sq,
      // and with causal query >= key and query - key < window
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kp = kr + 8 * r;
        lo[r] = (causal ? kp : 0) - q0 - c0;
        hi[r] = (causal && window > 0 ? min(Sq - 1, kp + window - 1) : Sq - 1) - q0 - c0;
      }
      p_ds_cols<BN, true>(s, dp, st_rows, c0, lo, hi, scale_log2, scale);
    }

    // A fragments: P^T as hi + lo halves in T (dV keeps f32 p), dS^T
    // rounded to T (ds.astype(q.dtype)); queries 16j .. 16j+15 are
    // accumulator chunks 2j and 2j+1.
    uint32_t ph[BN / 4], pl[BN / 4], da[BN / 4];
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        split2<T>(s[8 * j + 2 * x], s[8 * j + 2 * x + 1], ph[4 * j + x], pl[4 * j + x]);
        da[4 * j + x] = pack2<T>(dp[8 * j + 2 * x], dp[8 * j + 2 * x + 1]);
      }

    fence_regs(acc_v);
    fence_regs(acc_k);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {  // 16 queries a step
      const uint64_t bdo = smem_desc(sDO + st * GO::BYTES + j * 16 * GO::ROW, GO::PANEL,
                                     8 * GO::ROW, GO::SWZ);
      WgmmaRS<T, DV>::run(acc_v, ph + 4 * j, bdo);  // dV += P_hi^T dO
      WgmmaRS<T, DV>::run(acc_v, pl + 4 * j, bdo);  // dV += P_lo^T dO
      WgmmaRS<T, D>::run(acc_k, da + 4 * j,        // dK += dS^T Q
                         smem_desc(sQ + st * GQ::BYTES + j * 16 * GQ::ROW, GQ::PANEL,
                                   8 * GQ::ROW, GQ::SWZ));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_v);
    fence_regs(acc_k);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(da);
    if (qt + 1 < qt_hi) put_row((it + 1) % STAGES, next_row);
    __syncthreads();  // stage st is free for the tile after next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = kr + 8 * r;
    if (kp >= Sk) continue;
    const size_t row = (size_t)(b * Sk + kp) * H + h;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(dk + row * D + c0 + 8 * i) =
          pack2<T>(acc_k[i * 4 + r * 2], acc_k[i * 4 + r * 2 + 1]);
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      *reinterpret_cast<uint32_t*>(dv + row * DV + c0 + 8 * i) =
          pack2<T>(acc_v[i * 4 + r * 2], acc_v[i * 4 + r * 2 + 1]);
  }
}

// --- f32 on the tensor cores: three TF32 products ----------------------------
//
//   fa_fwd_tf32_kernel<D, true>   <- _fa_kernel (with lse)
//   fa_fwd_tf32_kernel<D, false>  <- _kernel_nolse
//   fa_bwd_dq_tf32_kernel<D>      <- _fa_bwd_dq_kernel
//   fa_bwd_dkv_tf32_kernel<D>     <- _fa_bwd_dkv_kernel
// of byteps_tpu/ops/flash_attention.py, for f32.
//
// What bounds them on the H100. f32 accuracy from the tensor cores takes
// three TF32 products a product: each operand is split into hi = x rounded
// to TF32 (cvt.rna) and lo = x - hi rounded to TF32, and a b = a_lo b_hi +
// a_hi b_lo + a_hi b_hi (small terms first, one f32 accumulator; the a_lo
// b_lo term, 2^-22 of |a b|, is dropped), which holds each product to about
// 2^-21 of itself, where one TF32 product errs by 2^-11. At 495 / 3 TFLOP/s
// that is the least time: at GPT-2 small's shapes (b 8, s 512, h 12, d 64,
// causal) 0.0196 ms for the forward's 3.2 GFLOP against 0.0150 ms for its
// 50 MB of f32, 0.0293 ms for dQ (0.0189 ms of bytes) and 0.0391 ms for
// dK/dV (0.0227 ms of bytes). The design follows the bf16 kernels', with
// what TF32 changes:
// - wgmma reads TF32 operands from shared memory K-major only (the
//   transpose immediates exist for 16-bit types alone). Q K^T (and dO V^T,
//   K Q^T, V dO^T) reduce over d, along which the [b, s, h, d] rows are
//   already K-major, so TMA's tiles serve as they land. P V, dS K, P^T dO
//   and dS^T Q reduce over keys or queries, so V, K, dO and Q are also
//   needed as [d][s] tiles: after each TMA tile lands the warpgroup's
//   threads split it and write the transpose (split_transpose), in the
//   128- or 64-byte swizzle wgmma reads;
// - that pass also writes the split: hi over the TMA tile in place and lo
//   beside it; P and dS (the A operands of the second products) are split
//   in registers. A thread's accumulator pair sits at columns 2t, 2t+1 of
//   each 8, where a TF32 A fragment takes columns t and t+4, so the
//   transposed tiles store row r of each 8 at K index perm8(r) and the
//   fragment needs no shuffle;
// - an f32 tile is twice a bf16 one and hi + lo doubles it again: the
//   forward keeps Q (hi, lo), a two-stage ring of raw K and V tiles of 32
//   keys, K's lo and V^T's hi and lo, 88 KB at d 64 (176 KB at d 128), so
//   two blocks share an SM and one's split and softmax overlap the other's
//   products; dQ keeps Q's and dO's hi, their lo as register A fragments
//   (split_frags), a two-stage ring of raw K and V tiles of 32 keys, their
//   lo and K^T's hi and lo, 97 KB at d 64, two blocks an SM (64-key tiles,
//   one block, took 11 % longer; 16-key tiles with lo in shared memory, two
//   blocks, 34 %; at d 128: 16 keys, lo in shared memory, 193 KB); dK/dV
//   keeps K and V (hi, lo), a two-stage ring of Q and dO tiles, their lo
//   and their transposes' hi and lo, 226 KB at d 64 (64 queries a tile; 16
//   at d 128, 209 KB): one block an SM, whose split, products and softmax
//   run one after another, only the TMA ring overlapping them;
// - the rest is the bf16 kernels': online softmax in base 2 on the
//   accumulator fragment, per-row column bounds on the tiles that cross a
//   mask edge, the heaviest tiles first, lse and D per query column in
//   shared memory for dK/dV. f32 needs no rounding points: p and ds go to
//   the products as they are, each split into hi and lo.

// A [R rows][C] f32 tile in shared memory, K-major along C: panels of PC =
// min(C, 32) columns side by side, rows of 64 or 128 bytes in the swizzle
// of that width (as TMA writes a box of PC columns, and as a TF32 wgmma
// reads an operand).
template <int R, int C> struct F32Tile {
  static constexpr int PC = C < 32 ? C : 32;  // columns per panel
  static constexpr int ROW = PC * 4;          // bytes per panel row
  static constexpr int PANEL = R * ROW;       // bytes per panel
  static constexpr int BYTES = C / PC * PANEL;
  static constexpr uint32_t SWZ = hopper::swizzle_code(ROW);
  // Byte offset of columns 8j .. 8j+7, the j-th K step.
  __host__ __device__ static constexpr uint32_t kstep(int j) {
    return (j / (PC / 8)) * PANEL + (j % (PC / 8)) * 32;
  }
  __device__ static uint64_t desc(uint32_t addr) {
    return hopper::smem_desc(addr, 16, 8 * ROW, SWZ);
  }
  // Byte offset of element (r, c): the 16-byte chunk of c in its row,
  // XORed with r mod 8 (128-byte rows) or r / 2 mod 4 (64-byte rows).
  __device__ __forceinline__ static uint32_t offset(uint32_t r, uint32_t c) {
    const uint32_t x = ROW == 128 ? (r & 7) : ((r >> 1) & 3);
    return (c / PC) * PANEL + r * ROW + ((((c % PC) >> 2) ^ x) << 4) + (c & 3) * 4;
  }
};

// K index of row r of a transposed tile: within each 8, rows 2t and 2t + 1
// go to t and t + 4 (see a_frags).
__device__ __forceinline__ int perm8(int r) {
  return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
}

// A tile of BYTES bytes split in place: hi over the raw f32 values, lo at
// the same offsets in `lo` (any layout). Each thread loads all its values
// before it splits and stores any, so their latencies overlap.
template <int BYTES>
__device__ __forceinline__ void split_tile(uint8_t* raw, uint8_t* lo) {
  constexpr int N = BYTES / 16 / WG;  // float4s a thread
  static_assert(BYTES % (16 * WG) == 0, "a tile splits evenly over the warpgroup");
  float4 x[N];
#pragma unroll
  for (int n = 0; n < N; ++n) x[n] = reinterpret_cast<const float4*>(raw)[n * WG + threadIdx.x];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    uint4 h, l;
    hopper::split_tf32(x[n].x, h.x, l.x);
    hopper::split_tf32(x[n].y, h.y, l.y);
    hopper::split_tf32(x[n].z, h.z, l.z);
    hopper::split_tf32(x[n].w, h.w, l.w);
    reinterpret_cast<uint4*>(raw)[n * WG + threadIdx.x] = h;
    reinterpret_cast<uint4*>(lo)[n * WG + threadIdx.x] = l;
  }
}

// A [R][C] tile as TMA wrote it (F32Tile<R, C>) into its transpose's hi and
// lo halves (F32Tile<C, R>, row r at K index perm8(r)); with NATURAL also
// split in place (hi over the raw values, lo into nlo). Thread t takes row
// t % R of the tile (one K index of the transpose) and columns 4 (n WG/R +
// t/R) .. +3 for n < N: a warp reads 32 consecutive rows at one 16-byte
// chunk and writes one 128-byte row of the transpose a column, both free
// of bank conflicts, and every value is loaded before any is stored.
template <int R, int C, bool NATURAL>
__device__ __forceinline__ void split_transpose(uint8_t* raw, uint8_t* nlo, uint8_t* th,
                                                uint8_t* tl) {
  using GN = F32Tile<R, C>;
  using GT = F32Tile<C, R>;
  constexpr int N = R * C / 4 / WG;  // float4s a thread
  static_assert(WG % R == 0 && N * WG * 4 == R * C, "a tile splits evenly over the warpgroup");
  const int r = threadIdx.x % R, k = perm8(r);
  float4 x[N];
#pragma unroll
  for (int n = 0; n < N; ++n)
    x[n] = *reinterpret_cast<const float4*>(
        raw + GN::offset(r, 4 * (n * (WG / R) + (int)threadIdx.x / R)));
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int c = 4 * (n * (WG / R) + (int)threadIdx.x / R);
    uint32_t h[4], l[4];
    hopper::split_tf32(x[n].x, h[0], l[0]);
    hopper::split_tf32(x[n].y, h[1], l[1]);
    hopper::split_tf32(x[n].z, h[2], l[2]);
    hopper::split_tf32(x[n].w, h[3], l[3]);
    if constexpr (NATURAL) {
      const uint32_t off = GN::offset(r, c);
      *reinterpret_cast<uint4*>(raw + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(nlo + off) = make_uint4(l[0], l[1], l[2], l[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      *reinterpret_cast<uint32_t*>(th + GT::offset(c + e, k)) = h[e];
      *reinterpret_cast<uint32_t*>(tl + GT::offset(c + e, k)) = l[e];
    }
  }
}

// The A fragments (hi and lo) of TF32 products from this thread's
// accumulator fragment x of a [64 x 2 NS] tile, one K step of 8 columns
// per 4 registers. Accumulator x[4j + 2r + e] is row r, column 8j + 2t + e
// (t = lane % 4); A register a of step j is row a & 1, K index t + 4 (a >>
// 1). So registers (x[4j], x[4j + 2], x[4j + 1], x[4j + 3]) put column 8j +
// 2t at K index t and 8j + 2t + 1 at t + 4, where perm8 stores the B
// operand's rows.
template <int NS>
__device__ __forceinline__ void a_frags(const float (&x)[NS], uint32_t (&hi)[NS],
                                        uint32_t (&lo)[NS]) {
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int a = 0; a < 4; ++a)
      hopper::split_tf32(x[4 * j + (a == 1 ? 2 : a == 2 ? 1 : a)], hi[4 * j + a], lo[4 * j + a]);
}

// This thread's A fragments of a [64][D] tile as TMA wrote it (F32Tile<64,
// D>), split in place: hi over the raw values, the lo halves into `lo`, 4
// registers per K step of 8 columns (register a of step j: row g + 8 (a &
// 1), column 8j + t + 4 (a >> 1), g = 16 warp + lane / 4, t = lane % 4).
// The warpgroup's fragments cover the tile once, so no value is written by
// another thread than the one that read it.
template <int D>
__device__ __forceinline__ void split_frags(uint8_t* raw, uint32_t (&lo)[D / 2]) {
  using G = F32Tile<64, D>;
  const int g = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2), t = threadIdx.x & 3;
  float x[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i)
    x[i] = *reinterpret_cast<const float*>(
        raw + G::offset(g + 8 * (i & 1), 8 * (i / 4) + t + 4 * ((i >> 1) & 1)));
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    uint32_t hi;
    hopper::split_tf32(x[i], hi, lo[i]);
    *reinterpret_cast<uint32_t*>(
        raw + G::offset(g + 8 * (i & 1), 8 * (i / 4) + t + 4 * ((i >> 1) & 1))) = hi;
  }
}

// Keys per tile of the f32 forward: 32 keeps it at 88 KB of shared memory
// at d 64, two blocks an SM (at 64 keys, 144 KB and one block an SM, it
// took a quarter longer at GPT-2 small's shape on an H100).
constexpr int BKF = 32;

// The f32 forward of one 64-row q tile, walking its live K tiles (replaces
// _fa_kernel / _kernel_nolse for f32; design in the note above).
template <int D, bool LSE>
__global__ void __launch_bounds__(WG)
fa_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
                   float* __restrict__ lse, int H, int Sq, int Sk, float scale, int causal,
                   int window) {
  using GQ = F32Tile<BQ, D>;   // Q: raw, then hi in place
  using GK = F32Tile<BKF, D>;  // a K or V tile as TMA writes it
  using GV = F32Tile<D, BKF>;  // V^T, keys at perm8
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sQ = (base + 1023u) & ~1023u;
  const uint32_t sQlo = sQ + GQ::BYTES;
  const uint32_t sK = sQlo + GQ::BYTES;          // stage st at sK + st * GK::BYTES
  const uint32_t sV = sK + STAGES * GK::BYTES;   // stage st at sV + st * GK::BYTES
  const uint32_t sKlo = sV + STAGES * GK::BYTES;
  const uint32_t sVh = sKlo + GK::BYTES;
  const uint32_t sVl = sVh + GV::BYTES;
  const uint32_t bar_q = sVl + GV::BYTES;
  const uint32_t bar_kv = bar_q + 8;             // stage st at bar_kv + 8 * st
  auto at = [&](uint32_t a) { return smem_raw + (a - base); };

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // most live K tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int nk = (Sk + BKF - 1) / BKF;
  int kt_lo = 0, kt_hi = nk;
  if (causal) {
    kt_hi = min(nk, (min(q0 + BQ, Sq) - 1) / BKF + 1);
    if (window > 0) kt_lo = max(0, q0 - (window - 1)) / BKF;
  }

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < STAGES; ++st) mbar_init(bar_kv + 8 * st, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // Issued by thread 0: K and V tile kt into ring stage st.
  auto load_kv = [&](int kt, int st) {
    mbar_expect_tx(bar_kv + 8 * st, 2 * GK::BYTES);
    for (int p = 0; p < D / GK::PC; ++p) {
      tma_load_4d(sK + st * GK::BYTES + p * GK::PANEL, &tk, bar_kv + 8 * st, p * GK::PC, h,
                  kt * BKF, b);
      tma_load_4d(sV + st * GK::BYTES + p * GK::PANEL, &tv, bar_kv + 8 * st, p * GK::PC, h,
                  kt * BKF, b);
    }
  };
  if (tid == 0 && kt_lo < kt_hi) {
    mbar_expect_tx(bar_q, GQ::BYTES);
    for (int p = 0; p < D / GQ::PC; ++p)
      tma_load_4d(sQ + p * GQ::PANEL, &tq, bar_q, p * GQ::PC, h, q0, b);
    load_kv(kt_lo, 0);
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const int qr = q0 + warp * 16 + (lane >> 2);  // query position of this thread's row 0
  const int c0 = 2 * (lane & 3);                // this thread's first column in 8
  const float scale_log2 = scale * kLog2e;
  int lo[2], hi[2];                             // live columns of a masked tile

  if (kt_lo < kt_hi) {
    mbar_wait(bar_q, 0);
    split_tile<GQ::BYTES>(at(sQ), at(sQlo));  // fenced with the first K/V tile's split
  }
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int it = kt - kt_lo, st = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    // The other stage was last read in the previous tile, which every warp
    // has finished (the barrier at the end of the loop).
    if (tid == 0 && kt + 1 < kt_hi) load_kv(kt + 1, (it + 1) % STAGES);
    const int k0 = kt * BKF;
    const uint32_t kst = sK + st * GK::BYTES;

    mbar_wait(bar_kv + 8 * st, parity);
    split_tile<GK::BYTES>(at(kst), at(sKlo));
    split_transpose<BKF, D, false>(at(sV + st * GK::BYTES), nullptr, at(sVh), at(sVl));
    fence_proxy_async();
    __syncthreads();

    float s[BKF / 2];
#pragma unroll
    for (int i = 0; i < BKF / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 8; ++j)  // S = Q K^T: Q_lo K_hi, then Q_hi K_lo, then Q_hi K_hi
      WgmmaTf32SS<BKF>::run(s, GQ::desc(sQlo + GQ::kstep(j)), GK::desc(kst + GK::kstep(j)),
                            j > 0);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      WgmmaTf32SS<BKF>::run(s, GQ::desc(sQ + GQ::kstep(j)), GK::desc(sKlo + GK::kstep(j)), 1);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      WgmmaTf32SS<BKF>::run(s, GQ::desc(sQ + GQ::kstep(j)), GK::desc(kst + GK::kstep(j)), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    float corr[2];
    const bool full =
        k0 + BKF <= Sk && q0 + BQ <= Sq &&
        (!causal || (k0 + BKF - 1 <= q0 && (window <= 0 || q0 + BQ - 1 - k0 < window)));
    if (full) {
      softmax_tile<false, BKF / 2>(s, m, l, corr, lo, hi, scale_log2);
    } else {
      // live columns of each row, relative to this thread's column c0 (as
      // in fa_fwd_wgmma_kernel)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qp = qr + 8 * r;
        hi[r] = (qp < Sq ? (causal ? min(qp, Sk - 1) : Sk - 1) : -1) - k0 - c0;
        lo[r] = (causal && window > 0 ? qp - window + 1 : 0) - k0 - c0;
      }
      softmax_tile<true, BKF / 2>(s, m, l, corr, lo, hi, scale_log2);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    uint32_t ph[BKF / 2], pl[BKF / 2];  // P as the A fragments of P V
    a_frags<BKF / 2>(s, ph, pl);
    fence_regs(acc);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BKF / 8; ++j)  // O += P V, 8 keys a step: P_lo V_hi, P_hi V_lo, P_hi V_hi
      WgmmaTf32RS<D>::run(acc, pl + 4 * j, GV::desc(sVh + GV::kstep(j)));
#pragma unroll
    for (int j = 0; j < BKF / 8; ++j)
      WgmmaTf32RS<D>::run(acc, ph + 4 * j, GV::desc(sVl + GV::kstep(j)));
#pragma unroll
    for (int j = 0; j < BKF / 8; ++j)
      WgmmaTf32RS<D>::run(acc, ph + 4 * j, GV::desc(sVh + GV::kstep(j)));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(ph);
    fence_regs(pl);
    __syncthreads();  // stage st and the split tiles are free
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qr + 8 * r;
    if (qp >= Sq) continue;
    const float safe_l = l[r] == 0.f ? 1.f : l[r];
    float* orow = o + ((size_t)(b * Sq + qp) * H + h) * D + c0;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(orow + 8 * i) =
          make_float2(acc[i * 4 + r * 2] / safe_l, acc[i * 4 + r * 2 + 1] / safe_l);
    if (LSE && (lane & 3) == 0)
      lse[(size_t)bh * Sq + qp] = l[r] == 0.f ? kBig : m[r] * kLn2 + logf(safe_l);
  }
}

// Queries per tile of the f32 dK/dV kernel: 16 at d 128 keeps its shared
// memory within the SM's.
template <int D> __host__ __device__ constexpr int f32_dkv_bn() { return D == 128 ? 16 : 64; }

// dK and dV of one 64-row K tile in f32, walking its live Q tiles with
// transposed score tiles (replaces _fa_bwd_dkv_kernel for f32; design in
// the note above).
template <int D>
__global__ void __launch_bounds__(WG)
fa_bwd_dkv_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                       const float* __restrict__ dvec, float* __restrict__ dk,
                       float* __restrict__ dv, int H, int Sq, int Sk, float scale, int causal,
                       int window) {
  constexpr int BN = f32_dkv_bn<D>();
  using GK = F32Tile<BK, D>;  // K, V: raw, then hi in place
  using GQ = F32Tile<BN, D>;  // a Q or dO tile as TMA writes it
  using GT = F32Tile<D, BN>;  // Q^T, dO^T: queries at perm8
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sK = (base + 1023u) & ~1023u;
  const uint32_t sKlo = sK + GK::BYTES;
  const uint32_t sV = sKlo + GK::BYTES;
  const uint32_t sVlo = sV + GK::BYTES;
  const uint32_t sQ = sVlo + GK::BYTES;             // stage st at sQ + st * GQ::BYTES
  const uint32_t sDO = sQ + STAGES * GQ::BYTES;     // stage st at sDO + st * GQ::BYTES
  const uint32_t sQlo = sDO + STAGES * GQ::BYTES;
  const uint32_t sDOlo = sQlo + GQ::BYTES;
  const uint32_t sQth = sDOlo + GQ::BYTES;
  const uint32_t sQtl = sQth + GT::BYTES;
  const uint32_t sDth = sQtl + GT::BYTES;
  const uint32_t sDtl = sDth + GT::BYTES;
  const uint32_t sRows = sDtl + GT::BYTES;          // f32 [STAGES][lse2, D][BN]
  const uint32_t bar_kv = sRows + STAGES * 2 * BN * 4;
  const uint32_t bar_q = bar_kv + 8;                // Q and dO, stage st at bar_q + 8 * st
  auto at = [&](uint32_t a) { return smem_raw + (a - base); };
  float* rows = reinterpret_cast<float*>(at(sRows));

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = BK * blockIdx.y;  // the first keys, live for the most queries, first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int nq = (Sq + BN - 1) / BN;
  int qt_lo = 0, qt_hi = nq;
  if (causal) {
    qt_lo = k0 / BN;  // first Q tile holding a q_pos >= k0
    if (window > 0) qt_hi = min(nq, (min(k0 + BK, Sk) - 1 + window - 1) / BN + 1);
  }

  // Thread c < BN reads lse (as lse2) and thread 64 + c reads D of query
  // column c of tile qt; rows past Sq read as lse = +1e30, D = 0.
  const int rc = tid & 63;
  auto row_value = [&](int qt) {
    const int qp = qt * BN + rc;
    if (tid < 64) return (qp < Sq ? lse[(size_t)bh * Sq + qp] : kBig) * kLog2e;
    return qp < Sq ? dvec[(size_t)bh * Sq + qp] : 0.f;
  };
  auto put_row = [&](int st, float x) {
    if (rc < BN) rows[(2 * st + (tid >> 6)) * BN + rc] = x;
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < STAGES; ++st) mbar_init(bar_q + 8 * st, 1);
    mbar_fence_init();
  }
  if (qt_lo < qt_hi) put_row(0, row_value(qt_lo));
  __syncthreads();

  // Issued by thread 0: Q and dO tile qt into ring stage st.
  auto load_qdo = [&](int qt, int st) {
    mbar_expect_tx(bar_q + 8 * st, 2 * GQ::BYTES);
    for (int p = 0; p < D / GQ::PC; ++p) {
      tma_load_4d(sQ + st * GQ::BYTES + p * GQ::PANEL, &tq, bar_q + 8 * st, p * GQ::PC, h,
                  qt * BN, b);
      tma_load_4d(sDO + st * GQ::BYTES + p * GQ::PANEL, &tdo, bar_q + 8 * st, p * GQ::PC, h,
                  qt * BN, b);
    }
  };
  if (tid == 0 && qt_lo < qt_hi) {
    mbar_expect_tx(bar_kv, 2 * GK::BYTES);
    for (int p = 0; p < D / GK::PC; ++p) {
      tma_load_4d(sK + p * GK::PANEL, &tk, bar_kv, p * GK::PC, h, k0, b);
      tma_load_4d(sV + p * GK::PANEL, &tv, bar_kv, p * GK::PC, h, k0, b);
    }
    load_qdo(qt_lo, 0);
  }

  const int kr = k0 + warp * 16 + (lane >> 2);  // key position of this thread's row 0
  const int c0 = 2 * (lane & 3);                // this thread's first column in 8
  const float scale_log2 = scale * kLog2e;
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  int lo[2], hi[2];  // live columns of a masked tile

  if (qt_lo < qt_hi) {
    mbar_wait(bar_kv, 0);
    split_tile<GK::BYTES>(at(sK), at(sKlo));  // fenced with the first Q/dO tile's split
    split_tile<GK::BYTES>(at(sV), at(sVlo));
  }
  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int it = qt - qt_lo, st = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    // The other stage (tiles and rows) was last read in the previous tile,
    // which every warp has finished (the barrier at the end of the loop).
    if (tid == 0 && qt + 1 < qt_hi) load_qdo(qt + 1, (it + 1) % STAGES);
    const float next_row = qt + 1 < qt_hi ? row_value(qt + 1) : 0.f;
    const int q0 = qt * BN;
    const uint32_t qst = sQ + st * GQ::BYTES, dost = sDO + st * GQ::BYTES;

    mbar_wait(bar_q + 8 * st, parity);
    split_transpose<BN, D, true>(at(qst), at(sQlo), at(sQth), at(sQtl));
    split_transpose<BN, D, true>(at(dost), at(sDOlo), at(sDth), at(sDtl));
    fence_proxy_async();
    __syncthreads();

    float s[BN / 2], dp[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 8; ++j)  // S^T = K Q^T: K_lo Q_hi, K_hi Q_lo, K_hi Q_hi
      WgmmaTf32SS<BN>::run(s, GK::desc(sKlo + GK::kstep(j)), GQ::desc(qst + GQ::kstep(j)), j > 0);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      WgmmaTf32SS<BN>::run(s, GK::desc(sK + GK::kstep(j)), GQ::desc(sQlo + GQ::kstep(j)), 1);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      WgmmaTf32SS<BN>::run(s, GK::desc(sK + GK::kstep(j)), GQ::desc(qst + GQ::kstep(j)), 1);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)  // dP^T = V dO^T, the same three
      WgmmaTf32SS<BN>::run(dp, GK::desc(sVlo + GK::kstep(j)), GQ::desc(dost + GQ::kstep(j)),
                           j > 0);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      WgmmaTf32SS<BN>::run(dp, GK::desc(sV + GK::kstep(j)), GQ::desc(sDOlo + GQ::kstep(j)), 1);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      WgmmaTf32SS<BN>::run(dp, GK::desc(sV + GK::kstep(j)), GQ::desc(dost + GQ::kstep(j)), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // Rows past Sk need no mask: they are never written, and rows of a
    // product do not mix.
    const float* st_rows = rows + 2 * st * BN;
    const bool inner = q0 + BN <= Sq && (!causal || (q0 >= k0 + BK - 1 &&
                                                    (window <= 0 || q0 + BN - 1 - k0 < window)));
    if (inner) {
      p_ds_cols<BN, false>(s, dp, st_rows, c0, lo, hi, scale_log2, scale);
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kp = kr + 8 * r;
        lo[r] = (causal ? kp : 0) - q0 - c0;
        hi[r] = (causal && window > 0 ? min(Sq - 1, kp + window - 1) : Sq - 1) - q0 - c0;
      }
      p_ds_cols<BN, true>(s, dp, st_rows, c0, lo, hi, scale_log2, scale);
    }

    // dV += P^T dO, 8 queries a step: P_lo dO_hi, P_hi dO_lo, P_hi dO_hi
    uint32_t ah[BN / 2], al[BN / 2];
    a_frags<BN / 2>(s, ah, al);
    fence_regs(acc_v);
    fence_regs(ah);
    fence_regs(al);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      WgmmaTf32RS<D>::run(acc_v, al + 4 * j, GT::desc(sDth + GT::kstep(j)));
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      WgmmaTf32RS<D>::run(acc_v, ah + 4 * j, GT::desc(sDtl + GT::kstep(j)));
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      WgmmaTf32RS<D>::run(acc_v, ah + 4 * j, GT::desc(sDth + GT::kstep(j)));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_v);
    fence_regs(ah);
    fence_regs(al);

    // dK += dS^T Q, the same three with dS^T (in dp) and Q^T
    a_frags<BN / 2>(dp, ah, al);
    fence_regs(acc_k);
    fence_regs(ah);
    fence_regs(al);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      WgmmaTf32RS<D>::run(acc_k, al + 4 * j, GT::desc(sQth + GT::kstep(j)));
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      WgmmaTf32RS<D>::run(acc_k, ah + 4 * j, GT::desc(sQtl + GT::kstep(j)));
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      WgmmaTf32RS<D>::run(acc_k, ah + 4 * j, GT::desc(sQth + GT::kstep(j)));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_k);
    fence_regs(ah);
    fence_regs(al);
    if (qt + 1 < qt_hi) put_row((it + 1) % STAGES, next_row);
    __syncthreads();  // stage st, its rows and the split tiles are free
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = kr + 8 * r;
    if (kp >= Sk) continue;
    const size_t off = ((size_t)(b * Sk + kp) * H + h) * D + c0;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<float2*>(dk + off + 8 * i) =
          make_float2(acc_k[i * 4 + r * 2], acc_k[i * 4 + r * 2 + 1]);
      *reinterpret_cast<float2*>(dv + off + 8 * i) =
          make_float2(acc_v[i * 4 + r * 2], acc_v[i * 4 + r * 2 + 1]);
    }
  }
}

// Keys per tile of the f32 dQ kernel, and whether it keeps Q's and dO's
// lo halves as register A fragments (d <= 64; at d 128 they would take 128
// registers) rather than in shared memory. 32 keys with lo in registers
// hold it to 97 KB at d 64, two blocks an SM; at d 128, 16 keys and lo in
// shared memory fit 193 KB (tools/fa_f32_ablate.py times the others).
template <int D> __host__ __device__ constexpr int f32_dq_bk() { return D == 128 ? 16 : 32; }
template <int D> __host__ __device__ constexpr bool f32_dq_reg_lo() { return D <= 64; }

// dQ of one 64-row q tile in f32, walking its live K tiles (replaces
// _fa_bwd_dq_kernel for f32; design in the note above).
template <int D>
__global__ void __launch_bounds__(WG)
fa_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                      const float* __restrict__ dvec, float* __restrict__ dq, int H, int Sq,
                      int Sk, float scale, int causal, int window) {
  constexpr int BKQ = f32_dq_bk<D>();
  constexpr bool REG_LO = f32_dq_reg_lo<D>();
  using GQ = F32Tile<BQ, D>;   // Q, dO: raw, then hi in place
  using GK = F32Tile<BKQ, D>;  // a K or V tile as TMA writes it
  using GT = F32Tile<D, BKQ>;  // K^T, keys at perm8
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sQ = (base + 1023u) & ~1023u;
  const uint32_t sDO = sQ + GQ::BYTES;
  const uint32_t sQlo = sDO + GQ::BYTES;         // without REG_LO
  const uint32_t sDOlo = sQlo + GQ::BYTES;
  const uint32_t sK = sQlo + (REG_LO ? 0 : 2 * GQ::BYTES);  // stage st at sK + st * GK::BYTES
  const uint32_t sV = sK + STAGES * GK::BYTES;   // stage st at sV + st * GK::BYTES
  const uint32_t sKlo = sV + STAGES * GK::BYTES;
  const uint32_t sVlo = sKlo + GK::BYTES;
  const uint32_t sKth = sVlo + GK::BYTES;
  const uint32_t sKtl = sKth + GT::BYTES;
  const uint32_t bar_q = sKtl + GT::BYTES;       // Q and dO
  const uint32_t bar_kv = bar_q + 8;             // stage st at bar_kv + 8 * st
  auto at = [&](uint32_t a) { return smem_raw + (a - base); };

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = BQ * (gridDim.y - 1 - blockIdx.y);  // most live K tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int nk = (Sk + BKQ - 1) / BKQ;
  int kt_lo = 0, kt_hi = nk;
  if (causal) {
    kt_hi = min(nk, (min(q0 + BQ, Sq) - 1) / BKQ + 1);
    if (window > 0) kt_lo = max(0, q0 - (window - 1)) / BKQ;
  }

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < STAGES; ++st) mbar_init(bar_kv + 8 * st, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // Issued by thread 0: K and V tile kt into ring stage st.
  auto load_kv = [&](int kt, int st) {
    mbar_expect_tx(bar_kv + 8 * st, 2 * GK::BYTES);
    for (int p = 0; p < D / GK::PC; ++p) {
      tma_load_4d(sK + st * GK::BYTES + p * GK::PANEL, &tk, bar_kv + 8 * st, p * GK::PC, h,
                  kt * BKQ, b);
      tma_load_4d(sV + st * GK::BYTES + p * GK::PANEL, &tv, bar_kv + 8 * st, p * GK::PC, h,
                  kt * BKQ, b);
    }
  };
  if (tid == 0 && kt_lo < kt_hi) {
    mbar_expect_tx(bar_q, 2 * GQ::BYTES);
    for (int p = 0; p < D / GQ::PC; ++p) {
      tma_load_4d(sQ + p * GQ::PANEL, &tq, bar_q, p * GQ::PC, h, q0, b);
      tma_load_4d(sDO + p * GQ::PANEL, &tdo, bar_q, p * GQ::PC, h, q0, b);
    }
    load_kv(kt_lo, 0);
  }

  const int qr = q0 + warp * 16 + (lane >> 2);  // query position of this thread's row 0
  const int c0 = 2 * (lane & 3);                // this thread's first column in 8
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qr + 8 * r;
    lse2[r] = (qp < Sq ? lse[(size_t)bh * Sq + qp] : kBig) * kLog2e;
    dd[r] = qp < Sq ? dvec[(size_t)bh * Sq + qp] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  uint32_t qlo[REG_LO ? D / 2 : 1], dolo[REG_LO ? D / 2 : 1];  // with REG_LO
  int lo[2], hi[2];  // live columns of a masked tile

  if (kt_lo < kt_hi) {
    mbar_wait(bar_q, 0);
    if constexpr (REG_LO) {  // fenced with the first K/V tile's split
      split_frags<D>(at(sQ), qlo);
      split_frags<D>(at(sDO), dolo);
    } else {
      split_tile<GQ::BYTES>(at(sQ), at(sQlo));
      split_tile<GQ::BYTES>(at(sDO), at(sDOlo));
    }
  }
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int it = kt - kt_lo, st = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    // The other stage was last read in the previous tile, which every warp
    // has finished (the barrier at the end of the loop).
    if (tid == 0 && kt + 1 < kt_hi) load_kv(kt + 1, (it + 1) % STAGES);
    const int k0 = kt * BKQ;
    const uint32_t kst = sK + st * GK::BYTES, vst = sV + st * GK::BYTES;

    mbar_wait(bar_kv + 8 * st, parity);
    split_transpose<BKQ, D, true>(at(kst), at(sKlo), at(sKth), at(sKtl));
    split_tile<GK::BYTES>(at(vst), at(sVlo));
    fence_proxy_async();
    __syncthreads();

    float s[BKQ / 2], dp[BKQ / 2];
#pragma unroll
    for (int i = 0; i < BKQ / 2; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    if constexpr (REG_LO) {
      fence_regs(qlo);
      fence_regs(dolo);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {  // S = Q K^T: Q_lo K_hi, then Q_hi K_lo, then Q_hi K_hi
      if constexpr (REG_LO) {
        WgmmaTf32RS<BKQ>::run(s, qlo + 4 * j, GK::desc(kst + GK::kstep(j)));
      } else {
        WgmmaTf32SS<BKQ>::run(s, GQ::desc(sQlo + GQ::kstep(j)), GK::desc(kst + GK::kstep(j)), 1);
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      WgmmaTf32SS<BKQ>::run(s, GQ::desc(sQ + GQ::kstep(j)), GK::desc(sKlo + GK::kstep(j)), 1);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      WgmmaTf32SS<BKQ>::run(s, GQ::desc(sQ + GQ::kstep(j)), GK::desc(kst + GK::kstep(j)), 1);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {  // dP = dO V^T, the same three
      if constexpr (REG_LO) {
        WgmmaTf32RS<BKQ>::run(dp, dolo + 4 * j, GK::desc(vst + GK::kstep(j)));
      } else {
        WgmmaTf32SS<BKQ>::run(dp, GQ::desc(sDOlo + GQ::kstep(j)), GK::desc(vst + GK::kstep(j)),
                              1);
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      WgmmaTf32SS<BKQ>::run(dp, GQ::desc(sDO + GQ::kstep(j)), GK::desc(sVlo + GK::kstep(j)), 1);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      WgmmaTf32SS<BKQ>::run(dp, GQ::desc(sDO + GQ::kstep(j)), GK::desc(vst + GK::kstep(j)), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    if constexpr (REG_LO) {
      fence_regs(qlo);
      fence_regs(dolo);
    }

    // Rows past Sq need no mask: their lse2 is huge, so p = 0.
    const bool inner = k0 + BKQ <= Sk && (!causal || (k0 + BKQ - 1 <= q0 &&
                                                     (window <= 0 || q0 + BQ - 1 - k0 < window)));
    if (inner) {
      ds_rows<false>(s, dp, lse2, dd, lo, hi, scale_log2, scale);
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qp = qr + 8 * r;
        hi[r] = (causal ? min(qp, Sk - 1) : Sk - 1) - k0 - c0;
        lo[r] = (causal && window > 0 ? qp - window + 1 : 0) - k0 - c0;
      }
      ds_rows<true>(s, dp, lse2, dd, lo, hi, scale_log2, scale);
    }

    // dQ += dS K, 8 keys a step: dS_lo K_hi, dS_hi K_lo, dS_hi K_hi, with
    // dS as the A fragments of the S accumulator and K^T from the split
    uint32_t ah[BKQ / 2], al[BKQ / 2];
    a_frags<BKQ / 2>(s, ah, al);
    fence_regs(acc);
    fence_regs(ah);
    fence_regs(al);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BKQ / 8; ++j)
      WgmmaTf32RS<D>::run(acc, al + 4 * j, GT::desc(sKth + GT::kstep(j)));
#pragma unroll
    for (int j = 0; j < BKQ / 8; ++j)
      WgmmaTf32RS<D>::run(acc, ah + 4 * j, GT::desc(sKtl + GT::kstep(j)));
#pragma unroll
    for (int j = 0; j < BKQ / 8; ++j)
      WgmmaTf32RS<D>::run(acc, ah + 4 * j, GT::desc(sKth + GT::kstep(j)));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(ah);
    fence_regs(al);
    __syncthreads();  // stage st and the split tiles are free
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qr + 8 * r;
    if (qp >= Sq) continue;
    float* row = dq + ((size_t)(b * Sq + qp) * H + h) * D + c0;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(row + 8 * i) =
          make_float2(acc[i * 4 + r * 2], acc[i * 4 + r * 2 + 1]);
  }
}

// Raises a kernel's dynamic shared-memory limit once per device: the first
// launch of each instantiation on a device pays for it, later ones do not.
struct Prepared {
  std::atomic<uint64_t> devices{0};  // bit d: done on device d

  template <typename Kernel>
  cudaError_t operator()(Kernel kernel, size_t smem) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const uint64_t bit = 1ull << (dev & 63);
    if (devices.load(std::memory_order_acquire) & bit) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) devices.fetch_or(bit, std::memory_order_release);
    return err;
  }
};

template <typename T, int D, int DV>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                int Sq, int Sk, float scale, int causal, int window, cudaStream_t stream) {
  static Prepared with_lse, without_lse;
  cudaError_t err;
  CUtensorMap tq, tk, tv;
  // x walks (batch, head) fastest, so each wave takes one q tile of every
  // head before the next, lighter one (the kernels reverse y).
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  if constexpr (std::is_same<T, float>::value) {
    using GQ = F32Tile<BQ, D>;
    using GK = F32Tile<BKF, D>;
    // Q and its lo, the K/V ring, K's lo, V^T's hi and lo, 1024 bytes to
    // align them to the swizzle atom, the mbarriers
    constexpr size_t smem = 2 * GQ::BYTES + 2 * STAGES * GK::BYTES + GK::BYTES +
                            2 * F32Tile<D, BKF>::BYTES + 1024 + 8 * (1 + STAGES);
    const CUtensorMapDataType dt = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    if ((err = hopper::encode_bshd(&tq, q, dt, B, Sq, H, D, GQ::PC, BQ)) != cudaSuccess ||
        (err = hopper::encode_bshd(&tk, k, dt, B, Sk, H, D, GK::PC, BKF)) != cudaSuccess ||
        (err = hopper::encode_bshd(&tv, v, dt, B, Sk, H, D, GK::PC, BKF)) != cudaSuccess)
      return err;
    if (lse != nullptr) {
      if ((err = with_lse(fa_fwd_tf32_kernel<D, true>, smem)) != cudaSuccess) return err;
      fa_fwd_tf32_kernel<D, true><<<grid, WG, smem, stream>>>(tq, tk, tv, (float*)o, (float*)lse,
                                                              H, Sq, Sk, scale, causal, window);
    } else {
      if ((err = without_lse(fa_fwd_tf32_kernel<D, false>, smem)) != cudaSuccess) return err;
      fa_fwd_tf32_kernel<D, false><<<grid, WG, smem, stream>>>(tq, tk, tv, (float*)o, nullptr, H,
                                                               Sq, Sk, scale, causal, window);
    }
  } else {
    using G = Tile<D>;
    using GV = Tile<DV>;
    // Q + the K/V ring, 1024 bytes to align them to the swizzle atom, the
    // mbarriers
    constexpr size_t smem =
        (1 + STAGES) * G::BYTES + STAGES * GV::BYTES + 1024 + 8 * (1 + 2 * STAGES);
    const CUtensorMapDataType dt = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if ((err = hopper::encode_bshd(&tq, q, dt, B, Sq, H, D, G::DP, BQ)) != cudaSuccess ||
        (err = hopper::encode_bshd(&tk, k, dt, B, Sk, H, D, G::DP, BK)) != cudaSuccess ||
        (err = hopper::encode_bshd(&tv, v, dt, B, Sk, H, DV, GV::DP, BK)) != cudaSuccess)
      return err;
    if (lse != nullptr) {
      if ((err = with_lse(fa_fwd_wgmma_kernel<T, D, DV, true>, smem)) != cudaSuccess)
        return err;
      fa_fwd_wgmma_kernel<T, D, DV, true><<<grid, WG, smem, stream>>>(
          tq, tk, tv, (T*)o, (float*)lse, H, Sq, Sk, scale, causal, window);
    } else {
      if ((err = without_lse(fa_fwd_wgmma_kernel<T, D, DV, false>, smem)) != cudaSuccess)
        return err;
      fa_fwd_wgmma_kernel<T, D, DV, false><<<grid, WG, smem, stream>>>(
          tq, tk, tv, (T*)o, nullptr, H, Sq, Sk, scale, causal, window);
    }
  }
  return cudaGetLastError();
}

// Tensor maps of q and dO (boxes of q_rows positions) and of k and v (boxes
// of k_rows positions) for the tensor-core backward, in panels of the
// tiles' width; q and k have head dim D, v and dO DV.
template <typename T, int D, int DV>
cudaError_t encode_qkvdo(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v,
                         const void* dout, int B, int H, int Sq, int Sk, int q_rows,
                         int k_rows) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int DP = F32 ? F32Tile<BK, D>::PC : Tile<D>::DP;
  constexpr int DPV = F32 ? F32Tile<BK, DV>::PC : Tile<DV>::DP;
  const CUtensorMapDataType dt = F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  cudaError_t err;
  if ((err = hopper::encode_bshd(&maps[0], q, dt, B, Sq, H, D, DP, q_rows)) != cudaSuccess ||
      (err = hopper::encode_bshd(&maps[1], k, dt, B, Sk, H, D, DP, k_rows)) != cudaSuccess ||
      (err = hopper::encode_bshd(&maps[2], v, dt, B, Sk, H, DV, DPV, k_rows)) != cudaSuccess ||
      (err = hopper::encode_bshd(&maps[3], dout, dt, B, Sq, H, DV, DPV, q_rows)) != cudaSuccess)
    return err;
  return cudaSuccess;
}

template <typename T, int D, int DV>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* dvec, void* dq, int B, int H, int Sq, int Sk,
                   float scale, int causal, int window, cudaStream_t stream) {
  static Prepared prepared;
  cudaError_t err;
  CUtensorMap m[4];
  // x walks (batch, head) fastest, so each wave takes one q tile of every
  // head before the next, lighter one (the kernels reverse y).
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  if constexpr (std::is_same<T, float>::value) {
    constexpr int BKQ = f32_dq_bk<D>();
    if ((err = encode_qkvdo<T, D, DV>(m, q, k, v, dout, B, H, Sq, Sk, BQ, BKQ)) != cudaSuccess)
      return err;
    // Q and dO (and their lo without f32_dq_reg_lo), the K/V ring, K's and
    // V's lo, K^T's hi and lo, 1024 bytes of alignment, the mbarriers
    constexpr size_t smem = (f32_dq_reg_lo<D>() ? 2 : 4) * F32Tile<BQ, D>::BYTES +
                            (2 * STAGES + 2) * F32Tile<BKQ, D>::BYTES +
                            2 * F32Tile<D, BKQ>::BYTES + 1024 + 8 * (1 + STAGES);
    if ((err = prepared(fa_bwd_dq_tf32_kernel<D>, smem)) != cudaSuccess) return err;
    fa_bwd_dq_tf32_kernel<D><<<grid, WG, smem, stream>>>(
        m[0], m[1], m[2], m[3], (const float*)lse, (const float*)dvec, (float*)dq, H, Sq, Sk,
        scale, causal, window);
  } else {
    if ((err = encode_qkvdo<T, D, DV>(m, q, k, v, dout, B, H, Sq, Sk, BQ, BK)) != cudaSuccess)
      return err;
    // Q, dO + the K/V ring, 1024 bytes of alignment, the mbarriers
    constexpr size_t smem = (1 + STAGES) * (Tile<D>::BYTES + Tile<DV>::BYTES) + 1024 +
                            8 * (1 + 2 * STAGES);
    if ((err = prepared(fa_bwd_dq_wgmma_kernel<T, D, DV>, smem)) != cudaSuccess) return err;
    fa_bwd_dq_wgmma_kernel<T, D, DV><<<grid, WG, smem, stream>>>(
        m[0], m[1], m[2], m[3], (const float*)lse, (const float*)dvec, (T*)dq, H, Sq, Sk, scale,
        causal, window);
  }
  return cudaGetLastError();
}

template <typename T, int D, int DV>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* dvec, void* dk, void* dv, int B, int H, int Sq,
                    int Sk, float scale, int causal, int window, cudaStream_t stream) {
  static Prepared prepared;
  cudaError_t err;
  CUtensorMap m[4];
  // x walks (batch, head) fastest, so each wave takes one K tile of every
  // head before the next, lighter one.
  const dim3 grid(B * H, (Sk + BK - 1) / BK);
  if constexpr (std::is_same<T, float>::value) {
    constexpr int BN = f32_dkv_bn<D>();
    if ((err = encode_qkvdo<T, D, DV>(m, q, k, v, dout, B, H, Sq, Sk, BN, BK)) != cudaSuccess)
      return err;
    // K, V and their lo, the Q/dO ring, their lo, their transposes' hi and
    // lo, the ring's lse/D rows, 1024 bytes of alignment, the mbarriers
    constexpr size_t smem = 4 * F32Tile<BK, D>::BYTES + (2 * STAGES + 2) * F32Tile<BN, D>::BYTES +
                            4 * F32Tile<D, BN>::BYTES + STAGES * 2 * BN * sizeof(float) + 1024 +
                            8 * (1 + STAGES);
    if ((err = prepared(fa_bwd_dkv_tf32_kernel<D>, smem)) != cudaSuccess) return err;
    fa_bwd_dkv_tf32_kernel<D><<<grid, WG, smem, stream>>>(
        m[0], m[1], m[2], m[3], (const float*)lse, (const float*)dvec, (float*)dk, (float*)dv, H,
        Sq, Sk, scale, causal, window);
  } else {
    constexpr int BN = dkv_bn<D>();
    if ((err = encode_qkvdo<T, D, DV>(m, q, k, v, dout, B, H, Sq, Sk, BN, BK)) != cudaSuccess)
      return err;
    // K, V + the Q/dO ring + its lse/D rows, 1024 bytes of alignment, the
    // mbarriers
    constexpr size_t smem = Tile<D>::BYTES + Tile<DV>::BYTES +
                            STAGES * (Tile<D, BN>::BYTES + Tile<DV, BN>::BYTES) +
                            STAGES * 2 * BN * sizeof(float) + 1024 + 8 * (1 + 2 * STAGES);
    if ((err = prepared(fa_bwd_dkv_wgmma_kernel<T, D, DV>, smem)) != cudaSuccess) return err;
    fa_bwd_dkv_wgmma_kernel<T, D, DV><<<grid, WG, smem, stream>>>(
        m[0], m[1], m[2], m[3], (const float*)lse, (const float*)dvec, (T*)dk, (T*)dv, H, Sq, Sk,
        scale, causal, window);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16. Head dims (D of q and k,
// Dv of v): 16, 32, 64 and 128 with Dv = D in every dtype, and D 192 with
// Dv 128 (latent attention) in bfloat16 and float16. Every entry point
// returns the cudaError_t of its launch (0 on success); an unsupported
// dtype or head dim returns cudaErrorInvalidValue.
#define BTT_DISPATCH(FN, ...)                                                   \
  if (Dv != D) {                                                                \
    if (D == 192 && Dv == 128 && dtype == 1)                                    \
      return (int)FN<__nv_bfloat16, 192, 128>(__VA_ARGS__);                    \
    if (D == 192 && Dv == 128 && dtype == 2)                                    \
      return (int)FN<__half, 192, 128>(__VA_ARGS__);                           \
    return (int)cudaErrorInvalidValue;                                          \
  }                                                                             \
  switch (dtype * 1000 + D) {                                                   \
    case 16: return (int)FN<float, 16, 16>(__VA_ARGS__);                      \
    case 32: return (int)FN<float, 32, 32>(__VA_ARGS__);                      \
    case 64: return (int)FN<float, 64, 64>(__VA_ARGS__);                      \
    case 128: return (int)FN<float, 128, 128>(__VA_ARGS__);                   \
    case 1016: return (int)FN<__nv_bfloat16, 16, 16>(__VA_ARGS__);            \
    case 1032: return (int)FN<__nv_bfloat16, 32, 32>(__VA_ARGS__);            \
    case 1064: return (int)FN<__nv_bfloat16, 64, 64>(__VA_ARGS__);            \
    case 1128: return (int)FN<__nv_bfloat16, 128, 128>(__VA_ARGS__);          \
    case 2016: return (int)FN<__half, 16, 16>(__VA_ARGS__);                   \
    case 2032: return (int)FN<__half, 32, 32>(__VA_ARGS__);                   \
    case 2064: return (int)FN<__half, 64, 64>(__VA_ARGS__);                   \
    case 2128: return (int)FN<__half, 128, 128>(__VA_ARGS__);                 \
    default: return (int)cudaErrorInvalidValue;                               \
  }

extern "C" {

// lse == NULL launches the forward without the logsumexp output.
int btt_fa_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int dtype, int B,
               int H, int Sq, int Sk, int D, int Dv, float scale, int causal, int window,
               void* stream) {
  BTT_DISPATCH(fwd, q, k, v, o, lse, B, H, Sq, Sk, scale, causal, window, (cudaStream_t)stream);
}

int btt_fa_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* dvec, void* dq, int dtype, int B, int H, int Sq, int Sk, int D,
                  int Dv, float scale, int causal, int window, void* stream) {
  BTT_DISPATCH(bwd_dq, q, k, v, dout, lse, dvec, dq, B, H, Sq, Sk, scale, causal, window,
               (cudaStream_t)stream);
}

int btt_fa_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* dvec, void* dk, void* dv, int dtype, int B, int H,
                   int Sq, int Sk, int D, int Dv, float scale, int causal, int window,
                   void* stream) {
  BTT_DISPATCH(bwd_dkv, q, k, v, dout, lse, dvec, dk, dv, B, H, Sq, Sk, scale, causal, window,
               (cudaStream_t)stream);
}

const char* btt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
