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
// Σ_i r·x² (K, d), all f32. No (N, K) buffer exists.
//
// Bound on this card: operations. The two E-step products and the two
// moment products are 2·N·K·d FMA-pipe flops each (8·N·K·d); the 2·N·K
// exps run on the SFU beside them; x is read in N·d·4 bytes, three orders
// of magnitude below the flops at K = 1024, d = 128.
//
// Troubles of the TPU design, and what this design does about them:
// - Every row adds into all K components, and the row logsumexp needs the
//   whole K row before any responsibility. The TPU kernel holds a
//   (block_n, K) tile and both (K, d) accumulators in VMEM. Here, as in B6
//   (csrc/fuzzy_kernels.cu), two phases: `gmm_norm_kernel` walks every K
//   tile for a block of 128 rows with an online max and rescaled sum (the
//   flash-attention recurrence) and writes norm (N,) f32 and the block's
//   Σ norm as an f64 partial; then `gmm_accum_kernel` recomputes the
//   log-prob tile per (K tile, row block), forms r = exp(logp − norm) and
//   accumulates. The recompute costs the two E-step products once more
//   (12·N·K·d flops in all) and buys a kernel with no K·d limit.
// - A CTA of phase 2 owns one K tile of 64 components, one 128-column slice
//   of d and a contiguous range of row blocks, and keeps its (64, 128)
//   blocks of Σr·x and Σr·x²: f32 registers in row order within a 128-row
//   block, f64 in shared memory across blocks (128 KB, so one CTA per SM).
//   The G row-range partials and the Σ norm partials are summed in a fixed
//   order by `gmm_reduce_kernel`: no float atomics, so two runs are
//   bitwise equal. Both phases compute the log-prob tile with the same
//   code, so r of a row's dominant component is exp(0) = 1 exactly.
// - Registers: one running sum per (row, component) pair, not one per
//   product, keeps phase 1 within the 128 registers of two CTAs per SM
//   without spilling on the 16-byte load path (two sums spilled ~600
//   bytes; PERF.md has both versions' times). Scaling by −½ is exact, so
//   only the order of the additions differs from the reference's.
// - Cancellation: Σ x²·nv + x·mv + bias is the reference's expanded
//   Mahalanobis form, which cancels when σ² is small. It is kept as it is,
//   to give the reference's numbers.
//
// Ragged N, K and d are masked: rows past N get r = 0 and add nothing to
// Σ norm, components past K are never candidates (the job of the −1e30
// bias columns and the `n_fake` correction in the JAX wrapper). The build
// uses no fast-math: expf and logf are the accurate library functions.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

#include "champion.cuh"

namespace {

using namespace tdc;

constexpr int kGmmBN = 64;  // components per K tile (4 per thread)
constexpr int kTN = kGmmBN / 16;

struct __align__(16) GmmDotSmem {
  float xs[BK][kXsStride];   // x tile, transposed: xs[col][row]
  float nv[BK][kGmmBN + 4];  // −½/σ² tile, transposed: nv[col][component]
  float mv[BK][kGmmBN + 4];  // μ/σ² tile, transposed
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

  __device__ __forceinline__ void store(GmmDotSmem& sm) const {
#pragma unroll
    for (int t = 0; t < kX; ++t) {
      const int i = threadIdx.x + t * kThreads;
      const int r = i / kPer, kk = (i % kPer) * kW;
      const float* v = reinterpret_cast<const float*>(&x[t]);
#pragma unroll
      for (int w = 0; w < kW; ++w) sm.xs[kk + w][r] = v[w];
    }
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      const int i = threadIdx.x + t * kThreads;
      const int cc = i / kPer, kk = (i % kPer) * kW;
      const float* a = reinterpret_cast<const float*>(&nv[t]);
      const float* b = reinterpret_cast<const float*>(&mv[t]);
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        sm.nv[kk + w][cc] = a[w];
        sm.mv[kk + w][cc] = b[w];
      }
    }
  }
};

// logp of rows row0 + ty*TM + m against components kt + tx*4 + q of one K
// tile, over all of d, into lp[m][q]: x²·nv then x·mv added for each column
// in increasing order, then the bias. Components past k get bias 0 and must
// be skipped by the caller. Ends with a __syncthreads(), so `sm` may be
// reused right after.
template <bool kVec>
__device__ __forceinline__ void tile_logp(const float* __restrict__ x,
                                          const float* __restrict__ nv,
                                          const float* __restrict__ mv,
                                          const float* __restrict__ bias,
                                          long long n, int k, int d,
                                          long long row0, int kt,
                                          GmmDotSmem& sm,
                                          float (&lp)[TM][kTN]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int q = 0; q < kTN; ++q) lp[m][q] = 0.f;
  const int ndk = (d + BK - 1) / BK;
  GmmStepRegs<kVec> regs;
  regs.load(x, nv, mv, n, k, d, row0, kt, 0);
  for (int s = 0; s < ndk; ++s) {
    regs.store(sm);
    __syncthreads();
    if (s + 1 < ndk) regs.load(x, nv, mv, n, k, d, row0, kt, (s + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.xs[kk][ty * TM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sm.xs[kk][ty * TM + 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float4 b = *reinterpret_cast<const float4*>(&sm.nv[kk][tx * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&sm.mv[kk][tx * 4]);
      const float bn[kTN] = {b.x, b.y, b.z, b.w};
      const float bm[kTN] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const float a2 = a[m] * a[m];
#pragma unroll
        for (int q = 0; q < kTN; ++q)
          lp[m][q] = fmaf(a[m], bm[q], fmaf(a2, bn[q], lp[m][q]));
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kTN; ++q) {
    const int j = kt + tx * 4 + q;
    const float bj = j < k ? bias[j] : 0.f;
#pragma unroll
    for (int m = 0; m < TM; ++m) lp[m][q] += bj;
  }
}

// One step of the online logsumexp: (mx, s) holds max and Σ exp(v − max)
// over the values seen so far; (−inf, 0) is empty.
__device__ __forceinline__ void lse_add(float& mx, float& s, float v) {
  if (v > mx) {
    s = s * expf(mx - v) + 1.f;
    mx = v;
  } else if (v != -CUDART_INF_F) {
    s += expf(v - mx);
  }
}

// s·exp(mx − to), 0 for an empty (−inf, 0) pair.
__device__ __forceinline__ float lse_rescale(float mx, float s, float to) {
  return s == 0.f ? 0.f : s * expf(mx - to);
}

// Phase 1: norm_i = logsumexp_k logp_ik, and the CTA's Σ norm over its
// valid rows as an f64 partial. One CTA per 128 rows.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    gmm_norm_kernel(const float* __restrict__ x, const float* __restrict__ nv,
                    const float* __restrict__ mv,
                    const float* __restrict__ bias, long long n, int k, int d,
                    float* __restrict__ norm_out,
                    double* __restrict__ ll_part) {
  __shared__ GmmDotSmem sm;
  __shared__ double red[kThreads / 16];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long row0 = (long long)blockIdx.x * BM;
  float mx[TM], s[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    mx[m] = -CUDART_INF_F;
    s[m] = 0.f;
  }
  for (int kt = 0; kt < k; kt += kGmmBN) {
    float lp[TM][kTN];
    tile_logp<kVec>(x, nv, mv, bias, n, k, d, row0, kt, sm, lp);
#pragma unroll
    for (int q = 0; q < kTN; ++q) {
      if (kt + tx * 4 + q < k) {
#pragma unroll
        for (int m = 0; m < TM; ++m) lse_add(mx[m], s[m], lp[m][q]);
      }
    }
  }
  // Merge the 16 column owners of each row in a fixed butterfly order
  // (fmaxf and + commute, so every lane ends with the same bits).
  double part = 0.0;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, mx[m], off);
      const float os = __shfl_xor_sync(0xffffffffu, s[m], off);
      const float top = fmaxf(mx[m], om);
      s[m] = lse_rescale(mx[m], s[m], top) + lse_rescale(om, os, top);
      mx[m] = top;
    }
    const long long row = row0 + ty * TM + m;
    if (row < n) {
      const float norm = mx[m] + logf(s[m]);
      if (tx == 0) norm_out[row] = norm;
      part += (double)norm;
    }
  }
  if (tx == 0) red[ty] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int i = 0; i < kThreads / 16; ++i) t += red[i];
    ll_part[blockIdx.x] = t;
  }
}

// Phase 2's shared memory, 178.75 KB: one CTA per SM. The f64 running sums
// of Σr·x and Σr·x² live here, not in registers.
struct __align__(16) GmmAccumSmem {
  double tot[64][kThreads];  // thread t's 4 x 8 Σr·x at [0, 32), Σr·x² at
                             // [32, 64), each at [i][t]
  double red[kThreads];      // the CTA's final fixed-order reductions
  float r[BM][kGmmBN];       // r of the row block's K tile
  union __align__(16) {
    GmmDotSmem dots;
    float xc[kRC][kDC];  // x rows of one accumulate step, columns of the slice
  } u;
};

// Phase 2. CTA (blockIdx.x, blockIdx.y, blockIdx.z) = (K tile, d slice,
// row range g of G). Writes its Σr·x and Σr·x² partials to wsx[g] and
// wsxx[g] and, in the d slice 0 CTAs, its Σr partial to wpart[g].
// Dynamic shared memory: GmmAccumSmem.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    gmm_accum_kernel(const float* __restrict__ x, const float* __restrict__ nv,
                     const float* __restrict__ mv,
                     const float* __restrict__ bias,
                     const float* __restrict__ norm_row, long long n, int k,
                     int d, float* __restrict__ wsx, float* __restrict__ wsxx,
                     double* __restrict__ wpart) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GmmAccumSmem& sm = *reinterpret_cast<GmmAccumSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int kt = blockIdx.x * kGmmBN;
  const int dc = blockIdx.y * kDC;
  const int g = blockIdx.z, grid = gridDim.z;
  const long long nb = (n + BM - 1) / BM;
  const long long b0 = nb * g / grid, b1 = nb * (g + 1) / grid;
  // Accumulate mapping: components kt + cg*4 + i (i < 4), columns
  // dc + colg*4 + jj and dc + 64 + colg*4 + jj (jj < 4).
  const int cg = tid / 16, colg = tid % 16;
#pragma unroll
  for (int e = 0; e < 64; ++e) sm.tot[e][tid] = 0.0;
  double wtot[kTN];
#pragma unroll
  for (int q = 0; q < kTN; ++q) wtot[q] = 0.0;

  for (long long b = b0; b < b1; ++b) {
    const long long row0 = b * BM;
    float nr[TM];  // this thread's rows' norm, loaded before the tile
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const long long row = row0 + ty * TM + m;
      nr[m] = row < n ? norm_row[row] : 0.f;
    }
    ChunkRegs<kVec> chunk;
    {
      float lp[TM][kTN];
      tile_logp<kVec>(x, nv, mv, bias, n, k, d, row0, kt, sm.u.dots, lp);
      chunk.load(x, n, d, row0, dc);  // in flight while r is computed
      float wb[kTN] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const bool live = row0 + ty * TM + m < n;
        float out[kTN];
#pragma unroll
        for (int q = 0; q < kTN; ++q) {
          float r = 0.f;
          if (live && kt + tx * 4 + q < k) {
            r = expf(lp[m][q] - nr[m]);
            wb[q] += r;
          }
          out[q] = r;
        }
        *reinterpret_cast<float4*>(&sm.r[ty * TM + m][tx * 4]) =
            make_float4(out[0], out[1], out[2], out[3]);
      }
#pragma unroll
      for (int q = 0; q < kTN; ++q) wtot[q] += (double)wb[q];
    }
    float bx[4][8], bxx[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        bx[i][jj] = 0.f;
        bxx[i][jj] = 0.f;
      }
    for (int r0 = 0; r0 < BM; r0 += kRC) {
      // tile_logp ended with a barrier, and each step below ends with
      // one, so the chunk may overwrite the staging tiles; this barrier
      // also publishes r.
      chunk.store(sm.u.xc);
      __syncthreads();
      if (r0 + kRC < BM) chunk.load(x, n, d, row0 + r0 + kRC, dc);
#pragma unroll 4
      for (int rr = 0; rr < kRC; ++rr) {
        const float4 a =
            *reinterpret_cast<const float4*>(&sm.r[r0 + rr][cg * 4]);
        const float4 v0 =
            *reinterpret_cast<const float4*>(&sm.u.xc[rr][colg * 4]);
        const float4 v1 =
            *reinterpret_cast<const float4*>(&sm.u.xc[rr][64 + colg * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float sq = bv[jj] * bv[jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            bx[i][jj] = fmaf(av[i], bv[jj], bx[i][jj]);
            bxx[i][jj] = fmaf(av[i], sq, bxx[i][jj]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        sm.tot[i * 8 + jj][tid] += (double)bx[i][jj];
        sm.tot[32 + i * 8 + jj][tid] += (double)bxx[i][jj];
      }
  }

  const long long kd = (long long)k * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = kt + cg * 4 + i;
    if (j >= k) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = dc + (jj < 4 ? colg * 4 + jj : 64 + colg * 4 + jj - 4);
      if (col < d) {
        const long long at = g * kd + (long long)j * d + col;
        wsx[at] = (float)sm.tot[i * 8 + jj][tid];
        wsxx[at] = (float)sm.tot[32 + i * 8 + jj][tid];
      }
    }
  }
  if (blockIdx.y != 0) return;  // every d slice computes the same r
  // Σr per component kt + tx*4 + q: the 16 row owners (ty) in order.
#pragma unroll
  for (int q = 0; q < kTN; ++q) {
    sm.red[tid] = wtot[q];
    __syncthreads();
    if (ty == 0) {
      double w = 0.0;
      for (int t = 0; t < 16; ++t) w += sm.red[t * 16 + tx];
      const int j = kt + tx * 4 + q;
      if (j < k) wpart[(long long)g * k + j] = w;
    }
    __syncthreads();
  }
}

// Sums the G partials in g order: Σr·x, Σr·x² (K, d) and nk (K,), and the
// nll phase-1 partials of Σ norm in block order.
__global__ void gmm_reduce_kernel(const float* __restrict__ wsx,
                                  const float* __restrict__ wsxx,
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
    double a = 0.0, b = 0.0;
    for (int g = 0; g < grid; ++g) {
      a += (double)wsx[g * kd + e];
      b += (double)wsxx[g * kd + e];
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

int k_tiles(int k) { return (k + kGmmBN - 1) / kGmmBN; }
int d_slices(int d) { return (d + kDC - 1) / kDC; }
long long row_blocks(long long n) { return n > 0 ? (n + BM - 1) / BM : 0; }

bool vector_ok(const float* x, const float* nv, const float* mv, int d) {
  return vector_loads_ok(x, nv, d) && vector_loads_ok(x, mv, d);
}

}  // namespace

// Rows per phase-1 CTA: the Σ norm partials are (ceil(N / this),) f64.
extern "C" int tdc_gmm_row_block() { return BM; }

// Row ranges G of phase 2: about `target_ctas` CTAs in all, each range at
// least one 128-row block, at least 1.
extern "C" int tdc_gmm_grid(long long n, int k, int d, int target_ctas) {
  return accumulate_row_ranges(n, (long long)k_tiles(k) * d_slices(d),
                               target_ctas);
}

// Phase 1 alone: norm (N,) f32 and the Σ norm partials (ceil(N/128),) f64.
extern "C" int tdc_gmm_normalizer(const float* x, const float* nv,
                                  const float* mv, const float* bias,
                                  long long n, int k, int d, float* norm,
                                  double* ll_part, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  auto* kern = vector_ok(x, nv, mv, d) ? gmm_norm_kernel<true>
                                       : gmm_norm_kernel<false>;
  kern<<<(unsigned)row_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      x, nv, mv, bias, n, k, d, norm, ll_part);
  return (int)cudaGetLastError();
}

// Phase 2 alone, given phase 1's norm and partials: the accumulate and the
// fixed-order reduction into ll_sum (), nk (K,), sx and sxx (K, d).
extern "C" int tdc_gmm_accumulate(const float* x, const float* nv,
                                  const float* mv, const float* bias,
                                  const float* norm, const double* ll_part,
                                  long long n, int k, int d, int grid,
                                  float* wsx, float* wsxx, double* wpart,
                                  float* ll_sum, float* nk, float* sx,
                                  float* sxx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  auto* kern = vector_ok(x, nv, mv, d) ? gmm_accum_kernel<true>
                                       : gmm_accum_kernel<false>;
  const int smem = (int)sizeof(GmmAccumSmem);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 agrid((unsigned)k_tiles(k), (unsigned)d_slices(d),
                   (unsigned)grid);
  kern<<<agrid, kThreads, smem, st>>>(x, nv, mv, bias, norm, n, k, d, wsx,
                                      wsxx, wpart);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long kd = (long long)k * d;
  const long long total = kd > k ? kd : (long long)k;
  gmm_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      wsx, wsxx, wpart, ll_part, grid, row_blocks(n), k, d, sx, sxx, nk,
      ll_sum);
  return (int)cudaGetLastError();
}
