// B9 `gmm_stats_fused` for Hopper (sm_90a).
//
// Replaces `gmm_stats_fused` (tdc_tpu/ops/pallas_kernels.py:1364,
// `pallas_call` at :1408; body `_gmm_mxu` :1294 and `_gmm_fold` :1312):
// the diagonal-covariance GMM E-step. Per row i and component k, with
// nv = −½/σ², mv = μ/σ² and bias_k = −½(Σμ²/σ² + Σlog σ² + d·log 2π) +
// log π_k computed by the wrapper, as the JAX wrapper computes 1/σ², μ/σ²
// and the bias in XLA:
//   logp = Σ_d (x²·nv_k + x·mv_k) + bias_k
//        (the reference's −½·(x²)·(1/σ²)ᵀ + x·(μ/σ²)ᵀ + bias, with both
//         products summed into one running sum over d)
//   norm_i = logsumexp_k logp,  r = exp(logp − norm_i)
// and the outputs are ll_sum = Σ_i norm_i (), nk = Σ_i r (K,), Σ_i r·x and
// Σ_i r·x² (K, d), all f32. No (N, K) buffer for all N exists.
//
// Bound on this card: operations. The E-step product and the moment
// product rᵀ·[x | x²] are 4·N·K·d flops each, both run on the tensor cores
// as 3 TF32 products (24·N·K·d at 495 TFLOP/s; 8·N·K·d on the f32 FMA
// pipe, 67 TFLOP/s, the bound of the design before this one); the 2·N·K
// exps run on the SFU beside them; x is read in N·d·4 bytes and the
// log-prob scratch moves 8·N·K bytes (34 GB at N = 2^22, K = 1024).
//
// Troubles of the TPU design, and what this design does about them:
// - Every row adds into all K components, and the row logsumexp needs the
//   whole K row before any responsibility. The TPU kernel holds a
//   (block_n, K) tile and both (K, d) accumulators in VMEM. Here two
//   phases per row chunk. `gmm_norm_tc_kernel` walks the K tiles of its
//   split for a block of 128 rows with an online max and rescaled sum
//   (the flash-attention recurrence) and writes each log-prob tile to a
//   scratch of at most MU_SCRATCH_BYTES (ops/fuzzy_kernels.py, 512 MiB,
//   whatever N and K): the chunk is as many rows as the scratch holds
//   whole K rows of. Where a chunk has too few row blocks to fill the card
//   (8,192 rows at K = 16,384), each row block's K tiles are split among
//   several CTAs (`phase1_k_splits`); `gmm_norm_merge_kernel` merges the
//   splits' (max, sum) in split order into norm (N,) f32 and each block's
//   Σ norm as an f64 partial. `gmm_accum_tc_kernel` then reads the chunk's log-probs and forms
//   r = exp(logp − norm). The E-step product runs once per (row,
//   component) pair: 8·N·K·d flops where the design before this one
//   recomputed the product in phase 2 (12·N·K·d). Both phases read the
//   same logp bits, so r of a row's dominant component is exp(0) = 1
//   exactly.
// - Phase 2's moment product runs on the tensor cores in 3xTF32
//   (tf32_accum.cuh): a CTA of 16 warps owns 64 components x one
//   128-column slice of x and its squares (x² formed as it is staged,
//   never as an N x d copy), so each r is formed once; f32 fragments per
//   128-row block, f64 carries in 128 KB of shared memory (the design
//   before held both moments' f64 sums there too, for 8 warps). The carries
//   go to per-row-range f64 slots in chunk order and the slots are summed
//   in g order by `gmm_reduce_kernel`: no float atomics, so two runs are
//   bitwise equal.
// - The E-step product, Σ x²·nv + x·mv + bias, is the reference's expanded
//   Mahalanobis form, which cancels when σ² is small. Its 3xTF32 form on
//   the tensor cores meets B9's card tolerances with the same max errors
//   as an f32 FMA-pipe form of phase 1 (one running sum per (row,
//   component) pair) on the route's inputs and the ragged and ragged soft
//   cases (PERF.md). Scaling by −½ is exact, so only the order of the
//   additions differs from the reference's.
//
// Ragged N, K and d are masked: rows past N get r = 0 and add nothing to
// Σ norm, components past K are never candidates (the job of the −1e30
// bias columns and the `n_fake` correction in the JAX wrapper). The build
// uses no fast-math: expf and logf are the accurate library functions.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

#include "champion.cuh"
#include "tf32_accum.cuh"

namespace {

using namespace tdc;

constexpr int kGmmBN = 64;  // components per phase-1 K tile

// The tensor-core phase 1's shared memory: row-major tiles of one
// BK-column step, rows 20 floats apart (the MMA fragment loads are then
// free of bank conflicts), and the row merges.
constexpr int kRowStride = BK + 4;
struct __align__(16) GmmTcSmem {
  float x[BM][kRowStride];       // x tile: [row][col]
  float x2[BM][kRowStride];      // its squares
  float nv[kGmmBN][kRowStride];  // −½/σ² tile: [component][col]
  float mv[kGmmBN][kRowStride];  // μ/σ² tile
  float mx[2][BM];               // the two component halves' running max
  float s[2][BM];                // and rescaled sums, per row
};

// One BK-column step of the x, −½/σ² and μ/σ² tiles, held in registers
// between its global load and its store to shared memory, so the next
// step's loads are in flight while the current one computes. Rows past n,
// components past k and columns past d load as 0.
template <bool kVec>
struct GmmStepRegs {
  static constexpr int kW = kVec ? 4 : 1;            // floats per load
  static constexpr int kPer = BK / kW;               // loads per tile row
  static constexpr int kX = BM * kPer / kThreads;
  static constexpr int kC = kGmmBN * kPer / kThreads;
  using T = typename std::conditional<kVec, float4, float>::type;
  T x[kX];
  T nv[kC];
  T mv[kC];

  __device__ __forceinline__ void load(const float* __restrict__ xg,
                                       const float* __restrict__ nvg,
                                       const float* __restrict__ mvg,
                                       long long n, int k, int d,
                                       long long row0, int kt, int dk) {
#pragma unroll
    for (int t = 0; t < kX; ++t) {
      const int i = threadIdx.x + t * kThreads;
      const long long row = row0 + i / kPer;
      const int col = dk + (i % kPer) * kW;
      x[t] = (row < n && col < d)
                 ? *reinterpret_cast<const T*>(xg + row * d + col)
                 : T{};
    }
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      const int i = threadIdx.x + t * kThreads;
      const int j = kt + i / kPer;
      const int col = dk + (i % kPer) * kW;
      const bool ok = j < k && col < d;
      const long long off = (long long)j * d + col;
      nv[t] = ok ? *reinterpret_cast<const T*>(nvg + off) : T{};
      mv[t] = ok ? *reinterpret_cast<const T*>(mvg + off) : T{};
    }
  }

  // Stores the step row-major, with x² beside x.
  __device__ __forceinline__ void store_rows(GmmTcSmem& sm) const {
#pragma unroll
    for (int t = 0; t < kX; ++t) {
      const int i = threadIdx.x + t * kThreads;
      const int r = i / kPer, kk = (i % kPer) * kW;
      T sq = x[t];
      float* f = reinterpret_cast<float*>(&sq);
#pragma unroll
      for (int w = 0; w < kW; ++w) f[w] = f[w] * f[w];
      *reinterpret_cast<T*>(&sm.x[r][kk]) = x[t];
      *reinterpret_cast<T*>(&sm.x2[r][kk]) = sq;
    }
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      const int i = threadIdx.x + t * kThreads;
      const int cc = i / kPer, kk = (i % kPer) * kW;
      *reinterpret_cast<T*>(&sm.nv[cc][kk]) = nv[t];
      *reinterpret_cast<T*>(&sm.mv[cc][kk]) = mv[t];
    }
  }
};

// s·exp(mx − to), 0 for an empty (−inf, 0) pair.
__device__ __forceinline__ float lse_rescale(float mx, float s, float to) {
  return s == 0.f ? 0.f : s * expf(mx - to);
}

// The E-step product of phase 1 on the tensor cores: one kDepth-column
// step of acc += A·Bᵀ in 3xTF32, A and B row-major in shared memory with
// rows kS floats apart (kS ≡ 4 (mod 32): the fragment loads are free
// of bank conflicts). The warp's fragments cover rows r0 + i·16 (+8) of
// A (i < 2) and rows c0 + j·8 of B (j < 4); r0 and c0 include the
// lane's group, lane / 4.
template <int kS, int kDepth>
__device__ __forceinline__ void mma_rows_3xtf32(float (&acc)[2][4][4],
                                                const float (*a)[kS],
                                                const float (*b)[kS],
                                                int r0, int c0) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int kk = 0; kk < kDepth; kk += 8) {
    unsigned ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + i * 16;
      split_tf32(a[r][kk + t4], ah[i][0], al[i][0]);
      split_tf32(a[r + 8][kk + t4], ah[i][1], al[i][1]);
      split_tf32(a[r][kk + t4 + 4], ah[i][2], al[i][2]);
      split_tf32(a[r + 8][kk + t4 + 4], ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split_tf32(b[c0 + j * 8][kk + t4], bh[j][0], bl[j][0]);
      split_tf32(b[c0 + j * 8][kk + t4 + 4], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bh[j][0], bh[j][1]);
  }
}

// Phase 1 over the rows [row_lo, row_lo + 128·gridDim.x) ∩ [0, n): CTA
// (blockIdx.x, blockIdx.y) takes a block of 128 rows and split blockIdx.y
// of gridDim.y of the K tiles, writes each row's log-probs there to
// scr[(row − row_lo)·kp + j] (components past k hold values phase 2 never
// reads), and the row's running (max, Σ exp(logp − max)) over its split
// to part[split·stride + row − row_lo] and part[(splits + split)·stride +
// row − row_lo]. The E-step product runs on the tensor cores in 3xTF32
// (tf32_accum.cuh's split and MMA). Warp (wr, wc) holds rows wr·32..+32
// and components wc·32..+32 of each 128 x 64 tile as 2 x 4 m16n8 tiles;
// per BK-column step the x² · nv and x · mv products go into the same
// fragments. The online logsumexp runs per fragment row; the 4 lanes of a
// row and then the two component halves merge in a fixed order. The
// scalar-load form (d % 4 != 0) takes one CTA per SM: at two its
// registers spilled.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kVec ? 2 : 1)
    gmm_norm_tc_kernel(const float* __restrict__ x,
                       const float* __restrict__ nv,
                       const float* __restrict__ mv,
                       const float* __restrict__ bias, long long n, int k,
                       int d, long long row_lo, float* __restrict__ scr,
                       int kp, float* __restrict__ part, long long stride) {
  __shared__ GmmTcSmem sm;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int wr = warp % 4, wc = warp / 4;
  const long long row0 = row_lo + (long long)blockIdx.x * BM;
  float mx[2][2], ss[2][2];  // row wr·32 + i·16 + gq + 8h at [i][h]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[i][h] = -CUDART_INF_F;
      ss[i][h] = 0.f;
    }
  const int ndk = (d + BK - 1) / BK;
  const int nkt = (k + kGmmBN - 1) / kGmmBN;
  const int kt_hi = nkt * (blockIdx.y + 1) / gridDim.y * kGmmBN;
  for (int kt = nkt * blockIdx.y / gridDim.y * kGmmBN; kt < kt_hi;
       kt += kGmmBN) {
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    GmmStepRegs<kVec> regs;
    regs.load(x, nv, mv, n, k, d, row0, kt, 0);
    for (int st = 0; st < ndk; ++st) {
      regs.store_rows(sm);
      __syncthreads();
      if (st + 1 < ndk) regs.load(x, nv, mv, n, k, d, row0, kt, (st + 1) * BK);
      mma_rows_3xtf32<kRowStride, BK>(acc, sm.x2, sm.nv, wr * 32 + gq,
                                      wc * 32 + gq);
      mma_rows_3xtf32<kRowStride, BK>(acc, sm.x, sm.mv, wr * 32 + gq,
                                      wc * 32 + gq);
      __syncthreads();
    }
    // logp = the product + bias (−inf past k): to the scratch; then each
    // row's 8 values of the tile join its running (max, sum) at once, the
    // max first, so each takes one exp and no branch.
    float bj[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = kt + wc * 32 + j * 8 + 2 * t4 + e;
        bj[j][e] = c < k ? bias[c] : -CUDART_INF_F;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + wr * 32 + i * 16 + gq + 8 * h;
        float top = mx[i][h];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* v = &acc[i][j][2 * h];
          v[0] += bj[j][0];
          v[1] += bj[j][1];
          top = fmaxf(top, fmaxf(v[0], v[1]));
          if (row < n)
            *reinterpret_cast<float2*>(scr + (row - row_lo) * kp + kt +
                                       wc * 32 + j * 8 + 2 * t4) =
                make_float2(v[0], v[1]);
        }
        if (top != -CUDART_INF_F) {
          float sum = lse_rescale(mx[i][h], ss[i][h], top);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sum += expf(acc[i][j][2 * h] - top) +
                   expf(acc[i][j][2 * h + 1] - top);
          ss[i][h] = sum;
          mx[i][h] = top;
        }
      }
  }
  // Merge the 4 lanes of each row (fmaxf and + commute, so both lanes of a
  // pair end with the same bits), then the two component halves.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, mx[i][h], off);
        const float os = __shfl_xor_sync(0xffffffffu, ss[i][h], off);
        const float top = fmaxf(mx[i][h], om);
        ss[i][h] = lse_rescale(mx[i][h], ss[i][h], top) +
                   lse_rescale(om, os, top);
        mx[i][h] = top;
      }
      if (t4 == 0) {
        const int r = wr * 32 + i * 16 + gq + 8 * h;
        sm.mx[wc][r] = mx[i][h];
        sm.s[wc][r] = ss[i][h];
      }
    }
  __syncthreads();
  if (tid < BM && row0 + tid < n) {
    const float a = sm.mx[0][tid], b = sm.mx[1][tid];
    const float top = fmaxf(a, b);
    const long long at = blockIdx.y * stride + (row0 - row_lo) + tid;
    part[at] = top;
    part[gridDim.y * stride + at] = lse_rescale(a, sm.s[0][tid], top) +
                                    lse_rescale(b, sm.s[1][tid], top);
  }
}

// Phase 1's row merge over its `splits` K splits, for the rows [row_lo,
// row_lo + 128·gridDim.x) ∩ [0, n), one CTA of 128 threads per 128 rows:
// norm_i = top + log Σ_j s_j·exp(mx_j − top), top = max_j mx_j, the
// splits in order (one split: top + log s), and the CTA's Σ norm over its
// rows, in row order, as an f64 partial at ll_part[row0 / 128].
__global__ void __launch_bounds__(BM)
    gmm_norm_merge_kernel(const float* __restrict__ part, int splits,
                          long long stride, long long n, long long row_lo,
                          float* __restrict__ norm_out,
                          double* __restrict__ ll_part) {
  __shared__ float nrm[BM];
  const long long row0 = row_lo + (long long)blockIdx.x * BM;
  const long long row = row0 + threadIdx.x;
  if (row < n) {
    const long long at = row - row_lo;
    float top = -CUDART_INF_F;
    for (int j = 0; j < splits; ++j) top = fmaxf(top, part[j * stride + at]);
    float sum = 0.f;
    for (int j = 0; j < splits; ++j)
      sum += lse_rescale(part[j * stride + at],
                         part[(splits + j) * stride + at], top);
    nrm[threadIdx.x] = top + logf(sum);
    norm_out[row] = nrm[threadIdx.x];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int r = 0; r < BM && row0 + r < n; ++r) t += (double)nrm[r];
    ll_part[row0 / BM] = t;  // row_lo is a multiple of BM
  }
}

// Phase 2's weights: r = exp(logp − norm) from the scratch's logp and the
// row's norm, the same bits phase 1 normalised, so a row's dominant
// component takes exp(0) = 1 exactly.
struct GmmWeights {
  const float* norm;
  using Row = float;
  static constexpr bool kSide = false;
  __device__ __forceinline__ Row row(long long r) const { return norm[r]; }
  __device__ __forceinline__ float operator()(float lp, Row nr,
                                              float&) const {
    return expf(lp - nr);
  }
};

// Phase 2 on the tensor cores (tf32_accum.cuh): Σr, and Σr·x and Σr·x²
// from one r tile of 64 components, against a slice of x and its squares.
template <bool kVec>
__global__ void __launch_bounds__(kTcThreads, 1)
    gmm_accum_tc_kernel(const float* __restrict__ x,
                        const float* __restrict__ scr, int kp,
                        const float* __restrict__ norm, int k, int d,
                        long long row_lo, long long row_hi, TcOut out) {
  tc_accumulate<GmmWeights, kVec, true>(GmmWeights{norm}, x, scr, kp, k, d,
                                        row_lo, row_hi, out);
}

// Sums the G slots in g order: Σr·x, Σr·x² (K, d) from the (G, K, 2d)
// carries, nk (K,), and Σ norm from the phase-1 partials in block order.
__global__ void gmm_reduce_kernel(const double* __restrict__ ws,
                                  const double* __restrict__ wpart,
                                  const double* __restrict__ ll_part,
                                  int grid, long long nll, int k, int d,
                                  float* __restrict__ sx,
                                  float* __restrict__ sxx,
                                  float* __restrict__ nk,
                                  float* __restrict__ ll_sum) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long kd = (long long)k * d;
  if (e < kd) {
    const long long at = (e / d) * 2 * d + e % d;
    double a = 0.0, b = 0.0;
    for (int g = 0; g < grid; ++g) {
      a += ws[g * 2 * kd + at];
      b += ws[g * 2 * kd + at + d];
    }
    sx[e] = (float)a;
    sxx[e] = (float)b;
  }
  if (e < k) {
    double s = 0.0;
    for (int g = 0; g < grid; ++g) s += wpart[(long long)g * k + e];
    nk[e] = (float)s;
  }
  if (e == 0) {
    double s = 0.0;
    for (long long t = 0; t < nll; ++t) s += ll_part[t];
    ll_sum[0] = (float)s;
  }
}

bool vector_ok(const float* x, const float* nv, const float* mv, int d) {
  return vector_loads_ok(x, nv, d) && vector_loads_ok(x, mv, d);
}

}  // namespace

// Rows per phase-1 CTA: the Σ norm partials are (ceil(N / this),) f64.
extern "C" int tdc_gmm_row_block() { return BM; }

// B9, one row chunk of rows_per_chunk rows (a multiple of 128) at a time:
// phase 1 writes the chunk's log-probs to scr (rows_per_chunk x kp f32,
// kp a multiple of 64, phase 2's K tile, and >= k) in (row block, K
// split) CTAs, `splits` of them a row block (1 <= splits <= the 64-wide K
// tiles; part holds 2 x splits x rows_per_chunk f32 of their running
// (max, sum)), then merges the splits into norm (N,) and the Σ norm
// partials ll_part (ceil(N/128),); phase 2 adds the chunk's Σr, Σr·x,
// Σr·x² to the slots of ws (grid, K, 2d) and wpart (grid, K), both f64;
// then the fixed-order reduction into ll_sum (), nk (K,), sx and sxx (K,
// d). `phases`: bit 0 runs phase 1, bit 1 phase 2 and the reduction (3 is
// the kernel; 1 and 2 time the phases apart, 2 on the scratch the last
// chunk left).
extern "C" int tdc_gmm_stats(const float* x, const float* nv, const float* mv,
                             const float* bias, long long n, int k, int d,
                             long long rows_per_chunk, int kp, int grid,
                             int splits, float* scr, float* part,
                             float* norm, double* ll_part, double* ws,
                             double* wpart, float* ll_sum, float* nk,
                             float* sx, float* sxx, int phases,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 0 || k <= 0 || d <= 0 || rows_per_chunk <= 0 ||
      rows_per_chunk % BM != 0 || kp % (kTcK / 2) != 0 || kp < k ||
      grid < 1 || splits < 1 || splits > (k + kGmmBN - 1) / kGmmBN ||
      phases < 1 || phases > 3)
    return (int)cudaErrorInvalidValue;
  const bool vec = vector_ok(x, nv, mv, d);
  auto* nkern = vec ? gmm_norm_tc_kernel<true> : gmm_norm_tc_kernel<false>;
  auto* akern = vec ? gmm_accum_tc_kernel<true> : gmm_accum_tc_kernel<false>;
  const int smem = (int)sizeof(TcAccumSmem<true>);
  cudaError_t err = cudaFuncSetAttribute(
      akern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 agrid = tc_grid(k, d, true, grid);
  // At least one chunk, so an empty x still writes zero sums.
  for (long long lo = 0; lo == 0 || lo < n; lo += rows_per_chunk) {
    const long long hi = n - lo < rows_per_chunk ? n : lo + rows_per_chunk;
    if ((phases & 1) && hi > lo) {
      const unsigned blocks = (unsigned)((hi - lo + BM - 1) / BM);
      nkern<<<dim3(blocks, (unsigned)splits), kThreads, 0, st>>>(
          x, nv, mv, bias, n, k, d, lo, scr, kp, part, rows_per_chunk);
      gmm_norm_merge_kernel<<<blocks, BM, 0, st>>>(
          part, splits, rows_per_chunk, n, lo, norm, ll_part);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    if (phases & 2) {
      akern<<<agrid, kTcThreads, smem, st>>>(
          x, scr, kp, norm, k, d, lo, hi > lo ? hi : lo,
          TcOut{ws, wpart, nullptr, lo == 0});
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  if (phases & 2) {
    const long long kd = (long long)k * d;
    gmm_reduce_kernel<<<(unsigned)((kd + 255) / 256), 256, 0, st>>>(
        ws, wpart, ll_part, grid, (n + BM - 1) / BM, k, d, sx, sxx, nk,
        ll_sum);
  }
  return (int)cudaGetLastError();
}
