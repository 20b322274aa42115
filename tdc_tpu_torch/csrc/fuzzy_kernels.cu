// B6 `fuzzy_stats_fused`, B7 `fuzzy_normalizer` and B8 `fuzzy_accumulate`
// for Hopper (sm_90a).
//
// Replaces `fuzzy_stats_fused` (tdc_tpu/ops/pallas_kernels.py:708,
// `pallas_call` at :764; body `_fused_epilogue_kernel` with
// `_fuzzy_fold_for` :668) with two phases through a scratch, and the
// two-pass kernels of the K-sharded fuzzy tower with one phase each:
// `fuzzy_normalizer` (`pallas_call` at :1160, body `_fuzzy_norm_kernel`)
// with a row normaliser on the tensor cores and `fuzzy_accumulate`
// (:1215, `_fuzzy_accum_kernel`) with a phase 2 of its own, whose s is
// then the sum of every K-shard's normaliser.
// Per row i and centroid k:
//   d²  = max(‖x‖² + ‖c‖² − 2x·c, 0)        (‖x‖² computed here, ‖c‖² given)
//   inv = (d² + eps)^(−1/(m−1)),  u = inv / Σ_k inv,  μ = u^m
// and the outputs are Σ_i μ x_i (K, d), Σ_i μ (K,) and Σ μ d² (), all f32.
// No (N, K) buffer for all N exists.
//
// Bound on this card: operations. The distance product and the μᵀ·x
// accumulate are 2·N·K·d flops each; B6 runs the first on the f32 FMA
// pipe and the second on the tensor cores as 3 TF32 products (6·N·K·d at
// 495 TFLOP/s), B7 its product on the tensor cores in 3xTF32, B8 both on
// the FMA pipe. Every one of the N·K
// elements takes powers on the SFU; x is read in N·d·4 bytes, and B6's
// inv scratch moves 8·N·K bytes (34 GB at N = 2^22, K = 1024).
//
// Troubles of the TPU design, and what this design does about them:
// - The row normaliser Σ_k inv needs the whole K row before any μ. The TPU
//   kernel holds a (block_n, K) tile in VMEM. Here two phases.
//   B7's `fuzzy_norm_tc_kernel` walks every K tile for a block of 128 rows
//   on the tensor cores (tc_distance.cuh) and writes s_i = Σ_k inv_ik to
//   an (N,) f32 buffer (B8 also takes ‖x_i‖² from it).
// - B6 (`tdc_fuzzy_stats`): `fuzzy_norm_scratch_kernel`, phase 1 on the
//   f32 FMA pipe (`row_normalizer`), also writes each inv to a scratch of at
//   most MU_SCRATCH_BYTES (ops/fuzzy_kernels.py, 512 MiB, whatever N and
//   K), one row chunk of whole K rows at a time, and q_i = s_i^(1−m);
//   `fuzzy_accum_tc_kernel` reads the chunk's inv, forms μ = (inv / s)^m
//   and accumulates Σμ and Σμx on the tensor cores in 3xTF32
//   (tf32_accum.cuh: 128 centroids x a 128-column slice a CTA, f32
//   fragments per 128-row block, f64 carries in shared memory, one CTA
//   per SM). The distance product runs once per (row, centroid) pair:
//   4·N·K·d flops where the design before this one recomputed it in phase
//   2 (6·N·K·d). On the tensor cores in 3xTF32 the distance product failed
//   B6's card tolerance at m = 1.7 (PERF.md), so it stays on the f32 FMA
//   pipe. Phase 2 needs no d²: Σμd² is Σ (u·q − eps·μ), since
//   μ·(d² + eps) = u·s^(1−m). So each element takes one power in each
//   phase (inv, then u^m): 2 powf at m != 2 where it took 3 (past d =
//   128, phase 2 forms μ again in each 128-column slice: 1 + ⌈d/128⌉).
// - At large K the scratch holds few rows (8,192 at K = 16,384: 64 row
//   blocks, half the SMs); phase 1 then splits each row block's K tiles
//   among CTAs (`phase1_k_splits` in ops/fuzzy_kernels.py) and
//   `fuzzy_s_merge_kernel` adds the splits' s in split order.
// - Every row adds into every cluster, so the (K, d) accumulator is
//   tiled: a CTA of phase 2 owns one K tile, one column slice and a
//   contiguous range of row blocks of the chunk, and adds its sums to its
//   own f64 slot once per chunk, in chunk order; the G slots are summed
//   in a fixed order: no float atomics, so two runs are bitwise equal.
// - B8 (the K-sharded tower) gets s from outside and computes the distance
//   again:
//   - d <= kDC (one slice): `fuzzy_accum_kernel` computes the distance
//     tile and accumulates into its slice in one kernel, f32 on the CUDA
//     cores.
//   - d > kDC: run as one kernel per slice, the distance tile would be
//     recomputed in each of ⌈d/128⌉ slices: 1 + ⌈d/128⌉ products of
//     2·N·K·d, 7 at d = 768, where B8 measured 3.7x slower than its
//     plain version. Instead (design (a) in PERF.md): `fuzzy_mu_kernel`
//     computes each distance tile once over all of d and writes μ to a
//     scratch of at most MU_SCRATCH_BYTES, one (row chunk, K chunk) at a
//     time, with the Σμd² partials; `fuzzy_mux_kernel` then computes
//     Σμx = μᵀ·X (and Σμ) of the chunk as a tiled f32 product over row
//     ranges, the partials summed in g order. 2 products of 2·N·K·d at
//     every d, plus 8·N·K bytes of μ traffic (69 GB at N = 2^19, K =
//     16,384: ~21 ms at 3.35 TB/s beside the ~394 ms bound). Design (b),
//     one CTA holding a K tile's Σμx over all of d, was not taken: f64
//     carries for a 32 x 768 tile take 192 KB of the CTA's 227 KB of
//     shared memory, one CTA per SM with little room left to stage x, and
//     each K tile re-reads all of x.
//
// Ragged N, K and d are masked: rows past N get μ = 0, centroids past K are
// never candidates (the job of `_PAD_CENTROID` and the `n_fake` correction
// in the JAX wrapper). The powers keep the JAX formula: powf (B7:
// 2^(p·log2 v)), or at m = 2 the exact 1/v and u·u that XLA compiles those
// powers to; the build uses no fast-math. The phases are separate C entry
// points.

#include <cuda_runtime.h>

#include <type_traits>

#include "champion.cuh"
#include "tc_distance.cuh"
#include "tf32_accum.cuh"

namespace {

using namespace tdc;

constexpr int kFuzzyBN = 64;  // centroids per K tile (TN = 4 per thread)
constexpr int kTN = kFuzzyBN / 16;

// The dot products of rows row0 + ty*TM + m with the BN centroids of the
// K tile starting at kt, over all of d, into acc[m][q]: centroid kt +
// (q / 4) * 64 + tx * 4 + q % 4 (groups of 4 that lie 64 apart, so the
// 16-byte shared loads stay free of bank conflicts). The next BK-column
// step is loaded while the current one computes. Ends with a
// __syncthreads(), so `sm` may be reused right after.
template <bool kVec, int BN = kFuzzyBN>
__device__ __forceinline__ void tile_dots(const float* __restrict__ x,
                                          const float* __restrict__ c,
                                          long long n, int k, int d,
                                          long long row0, int kt,
                                          AssignSmem<BN>& sm,
                                          float (&acc)[TM][BN / 16]) {
  constexpr int TN = BN / 16;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[m][q] = 0.f;
  const int ndk = (d + BK - 1) / BK;
  StepRegs<kVec, BN> regs;
  regs.load(x, c, n, k, d, row0, kt, 0);
  for (int s = 0; s < ndk; ++s) {
    regs.store(sm);
    __syncthreads();
    if (s + 1 < ndk) regs.load(x, c, n, k, d, row0, kt, (s + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.xs[kk][ty * TM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sm.xs[kk][ty * TM + 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bb[TN];
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 b =
            *reinterpret_cast<const float4*>(&sm.cs[kk][g * 64 + tx * 4]);
        bb[4 * g] = b.x;
        bb[4 * g + 1] = b.y;
        bb[4 * g + 2] = b.z;
        bb[4 * g + 3] = b.w;
      }
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int q = 0; q < TN; ++q) acc[m][q] = fmaf(a[m], bb[q], acc[m][q]);
    }
    __syncthreads();
  }
}

// d² of one (row, centroid) pair from its dot product, as the JAX fold
// computes it: max(x2 + c2 − 2·cross, 0).
__device__ __forceinline__ float true_d2(float x2, float c2, float cross) {
  return fmaxf(x2 + c2 - 2.f * cross, 0.f);
}

// The formula's two powers. At m = 2 they are v^−1 and u², which XLA's
// simplifier (and PyTorch's CUDA pow) compute as the correctly rounded
// 1/v and u·u, so kM2 takes exactly those; every other m takes powf.
template <bool kM2>
__device__ __forceinline__ float inv_power(float v, float p) {
  return kM2 ? 1.f / v : powf(v, p);
}
template <bool kM2>
__device__ __forceinline__ float mu_power(float u, float m) {
  return kM2 ? u * u : powf(u, m);
}

// Phase 1's body over the 128 rows from row0: ‖x_i‖², then per K tile
// from kt_lo while kt < kt_hi (multiples of 64) the dot products and inv
// = (d²_ik + eps)^p, p = −1/(m−1), summed into s_i and handed to
// `tile(kt, inv)` (0 past k); then s_i over the 16
// column owners of each row in a fixed butterfly order (a + b == b + a,
// so every lane ends with the same bits) and `row(i, s_i, ‖x_i‖²)` on one
// lane of each row below n. B6 writes each inv to its scratch (`tile`).
template <bool kVec, bool kM2, class Tile, class Row>
__device__ __forceinline__ void row_normalizer(
    const float* __restrict__ x, const float* __restrict__ c,
    const float* __restrict__ c2, long long n, int k, int d, float p,
    float eps, long long row0, int kt_lo, int kt_hi,
    AssignSmem<kFuzzyBN>& sm, Tile tile, Row row) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float x2[TM], s[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    x2[m] = row_sq_norm(x, n, d, row0 + ty * TM + m);
    s[m] = 0.f;
  }
  for (int kt = kt_lo; kt < kt_hi; kt += kFuzzyBN) {
    float acc[TM][kTN];
    tile_dots<kVec>(x, c, n, k, d, row0, kt, sm, acc);
#pragma unroll
    for (int q = 0; q < kTN; ++q) {
      const int j = kt + tx * 4 + q;
      if (j < k) {
        const float cj = c2[j];
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          const float v =
              inv_power<kM2>(true_d2(x2[m], cj, acc[m][q]) + eps, p);
          s[m] += v;
          acc[m][q] = v;
        }
      } else {
#pragma unroll
        for (int m = 0; m < TM; ++m) acc[m][q] = 0.f;
      }
    }
    tile(kt, acc);
  }
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1)
      s[m] += __shfl_xor_sync(0xffffffffu, s[m], off);
    const long long i = row0 + ty * TM + m;
    if (tx == 0 && i < n) row(i, s[m], x2[m]);
  }
}

// B7's rescore takes B8's own x·c* below this share of ‖x‖² + ‖c‖²
// (fuzzy_norm_tc_kernel).
constexpr float kIllCond = 1.f / 1024.f;

// x·c in one f32 chain over d, the order of `tile_dots` (B8). Out of line:
// inlined into B7's m = 2 kernel, where it runs for almost no row, it
// slowed the whole kernel from 169 to 190 ms at the route's shape
// (PERF.md).
__device__ __noinline__ float chain_dot(const float* x, const float* c,
                                        int d) {
  float t = 0.f;
  for (int col = 0; col < d; ++col) t = fmaf(x[col], c[col], t);
  return t;
}

// B7's powers: inv = v^p, p = −1/(m−1). At m = 2 the exact 1/v that B6
// takes; at other m 2^(p·log2 v), B11's form (tall_kernels.cu `fuzzy_w`),
// one log2 and one exp2 in place of powf.
template <bool kM2>
__device__ __forceinline__ float norm_inv(float v, float p) {
  return kM2 ? 1.f / v : exp2f(p * log2f(v));
}

// B7 on `tc_distance` (tc_distance.cuh): the distance product on the
// tensor cores in 3xTF32. Per block, ‖x_i‖² first (16 lanes a row, the
// order of `row_sq_norm`, so the bits equal `row_sq_norms_kernel`'s, which
// B8 computes when it is not given them); per K tile each thread sums its
// 64 entries' inv = (d² + eps)^p, d² = max(‖x‖² + c2 − 2·x·c, 0), in f32
// and adds that into an f64 running s per row, and keeps the row's
// champion (champion.cuh's rule) with the inv it summed for it. The
// tensor core accumulates in f32 with truncation (PERF.md: min + ‖x‖²
// biased by 4.4e-5 relative at d = 769): the nearest centroids, where the
// cancellation in ‖x‖² + c2 − 2·x·c is worst, dominate s where K is small.
// So each row's champion is scored again on the CUDA cores (c2n: ‖c‖² as
// the wrapper gives B8 too; see the epilogue) and its inv replaces the one
// summed: s = Σ inv − inv_tc(c*) + inv(d²(c*)), in f64, rounded once. c2
// is the pre-pass's, padded with +inf.
template <bool kVec, bool kM2>
__global__ void __launch_bounds__(kDistThreads, 1)
    fuzzy_norm_tc_kernel(const float* __restrict__ x,
                         const float* __restrict__ c,
                         const float* __restrict__ split,
                         const float* __restrict__ c2,
                         const float* __restrict__ c2n, long long n, int k,
                         int d, float p, float eps,
                         float* __restrict__ s_out,
                         float* __restrict__ x2_out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  DistSmem& sm = *reinterpret_cast<DistSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rl0 = 64 * (warp / 4) + 16 * (warp % 4) + lane / 4;
  float best[2], binv[2];
  int barg[2];
  double s[2];
  tc_distance<kVec>(
      x, split, n, k, d, sm,
      [&](long long row0) {
#pragma unroll 1
        for (int i = 0; i < 8; ++i) {
          const int r = epilogue_row(i);
          const float v = row_sq_norm(x, n, d, row0 + r);
          if (tid % 16 == 0) sm.x2[r] = v;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          best[h] = CUDART_INF_F;
          barg[h] = kArgSentinel;
          binv[h] = 0.f;
          s[h] = 0.0;
        }
      },
      [&](int kt, const float (&acc)[kTcBN / 2]) {
        const float x2[2] = {sm.x2[rl0], sm.x2[rl0 + 8]};
        float ts[2] = {0.f, 0.f};
        for_each_entry(kt, acc, c2, [&](int h, int col, float cc, float a) {
          const float v = cc - 2.f * a;
          // 0 past K: d² is +inf there
          const float inv =
              norm_inv<kM2>(fmaxf(x2[h] + cc - 2.f * a, 0.f) + eps, p);
          ts[h] += inv;
          if (v < best[h]) {
            best[h] = v;
            barg[h] = col;
            binv[h] = inv;
          }
        });
        s[0] += (double)ts[0];
        s[1] += (double)ts[1];
      },
      [&](long long row0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          champion_quad(best[h], barg[h], binv[h]);
#pragma unroll
          for (int off = 1; off <= 2; off <<= 1)
            s[h] += __shfl_xor_sync(0xffffffffu, s[h], off);
          if (lane % 4 == 0) {
            const int r = rl0 + 8 * h;
            sm.lab[r] = barg[h];
            sm.val[r] = binv[h];
            sm.s[r] = s[h];
          }
        }
        named_barrier(1 + warp / 4, 128);
        // The champion's d² from x·c* in f32, 16 lanes a row, and B8's
        // ‖c‖² (c2n). Where that d² is all cancellation (a row on a
        // centroid: below kIllCond of ‖x‖² + ‖c‖²), x·c* as B8 will
        // compute it, in one f32 chain over d, so that the row's μ =
        // (inv / s)^m stays ≤ 1 (with a d² of other rounding it has no
        // bound, and the K-sharded fit drifted from the same fit on one K
        // shard: PERF.md). Its inv replaces the summed one; powf at
        // m != 2, as B8.
        const int tx = tid % 16;
#pragma unroll 1
        for (int i = 0; i < 8; ++i) {
          const int r = epilogue_row(i);
          const long long row = row0 + r;
          const int j = sm.lab[r];
          const bool live = row < n && j < k;
          const float* xp = x + row * d;
          const float* cp = c + (long long)(live ? j : 0) * d;
          float t = 0.f;  // x·c*
          if (live) {
            for (int col = tx; col < d; col += 16)
              t = fmaf(xp[col], cp[col], t);
          }
          t = row_lanes_sum(t);
          if (tx == 0 && row < n) {
            double sr = sm.s[r];
            if (live) {
              const float x2 = sm.x2[r], cj = c2n[j];
              float d2 = true_d2(x2, cj, t);
              if (d2 < kIllCond * (x2 + cj)) {
                d2 = true_d2(x2, cj, chain_dot(xp, cp, d));
              }
              sr += (double)inv_power<kM2>(d2 + eps, p) - (double)sm.val[r];
            }
            s_out[row] = (float)sr;
            x2_out[row] = sm.x2[r];
          }
        }
        named_barrier(1 + warp / 4, 128);  // the row state is free
      });
}

// B6's phase 1: `row_normalizer` over the rows [row_lo, row_lo +
// 128·gridDim.x) ∩ [0, n), CTA (blockIdx.x, blockIdx.y) on a block of 128
// rows and split blockIdx.y of gridDim.y of the K tiles: each inv = (d² +
// eps)^p to scr[(row − row_lo)·kp + j] (0 past k), and the split's sum of
// them to spart[split·stride + row − row_lo].
template <bool kVec, bool kM2>
__global__ void __launch_bounds__(kThreads)
    fuzzy_norm_scratch_kernel(const float* __restrict__ x,
                              const float* __restrict__ c,
                              const float* __restrict__ c2, long long n,
                              int k, int d, float p, float eps,
                              long long row_lo, float* __restrict__ scr,
                              int kp, float* __restrict__ spart,
                              long long stride) {
  __shared__ AssignSmem<kFuzzyBN> sm;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long row0 = row_lo + (long long)blockIdx.x * BM;
  const int nkt = (k + kFuzzyBN - 1) / kFuzzyBN;
  row_normalizer<kVec, kM2>(
      x, c, c2, n, k, d, p, eps, row0,
      nkt * blockIdx.y / gridDim.y * kFuzzyBN,
      nkt * (blockIdx.y + 1) / gridDim.y * kFuzzyBN, sm,
      [&](int kt, const float (&inv)[TM][kTN]) {
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          const long long i = row0 + ty * TM + m;
          if (i < n)
            *reinterpret_cast<float4*>(scr + (i - row_lo) * kp + kt +
                                       tx * 4) =
                make_float4(inv[m][0], inv[m][1], inv[m][2], inv[m][3]);
        }
      },
      [&](long long i, float s, float) {
        spart[blockIdx.y * stride + (i - row_lo)] = s;
      });
}

// B6's row merge over its `splits` K splits for the rows [row_lo,
// row_hi): s_i, the splits' sums added in split order, and q_i =
// s_i^(1−m) (1 / s_i at m = 2) for phase 2's objective.
template <bool kM2>
__global__ void fuzzy_s_merge_kernel(const float* __restrict__ spart,
                                     int splits, long long stride,
                                     long long row_lo, long long row_hi,
                                     float qexp, float* __restrict__ s_out,
                                     float* __restrict__ q_out) {
  const long long row =
      row_lo + (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= row_hi) return;
  const long long at = row - row_lo;
  float s = spart[at];
  for (int j = 1; j < splits; ++j) s += spart[j * stride + at];
  s_out[row] = s;
  q_out[row] = kM2 ? 1.f / s : powf(s, qexp);
}

// B6's phase-2 weights from the scratch's inv and the row's (s, q):
// u = inv / s and μ = u^m as the formula has them, and the objective's
// side sum u·q − eps·μ, which is μ·d²: μ·(d² + eps) = u·s^(1−m), since
// inv^(m−1) = 1/(d² + eps). So phase 2 needs no d² and inv takes one
// power per element, in phase 1.
template <bool kM2>
struct FuzzyWeights {
  const float* s;
  const float* q;
  float mexp, eps;
  using Row = float2;
  static constexpr bool kSide = true;
  __device__ __forceinline__ Row row(long long r) const {
    return make_float2(s[r], q[r]);
  }
  __device__ __forceinline__ float operator()(float inv, Row sq,
                                              float& side) const {
    const float u = inv / sq.x;
    const float mu = mu_power<kM2>(u, mexp);
    side = fmaf(u, sq.y, fmaf(-eps, mu, side));
    return mu;
  }
};

// B6's phase 2 on the tensor cores (tf32_accum.cuh): Σμ, Σμx and the
// objective's partials.
template <bool kVec, bool kM2>
__global__ void __launch_bounds__(kTcThreads, 1)
    fuzzy_accum_tc_kernel(const float* __restrict__ x,
                          const float* __restrict__ scr, int kp,
                          const float* __restrict__ s_row,
                          const float* __restrict__ q_row, float mexp,
                          float eps, int k, int d, long long row_lo,
                          long long row_hi, TcOut out) {
  tc_accumulate<FuzzyWeights<kM2>, kVec, false>(
      FuzzyWeights<kM2>{s_row, q_row, mexp, eps}, x, scr, kp, k, d, row_lo,
      row_hi, out);
}

// Sums B6's G slots in g order: Σμx (K, d), Σμ (K,), and the objective
// Σ (u·q − eps·μ) over the (G, K tiles) partials, clamped at 0 as the JAX
// wrapper clamps it.
__global__ void fuzzy_tc_reduce_kernel(const double* __restrict__ ws,
                                       const double* __restrict__ wpart,
                                       const double* __restrict__ opart,
                                       int grid, int ntk, int k, int d,
                                       float* __restrict__ wsums,
                                       float* __restrict__ weights,
                                       float* __restrict__ objective) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long kd = (long long)k * d;
  if (e < kd) {
    double s = 0.0;
    for (int g = 0; g < grid; ++g) s += ws[g * kd + e];
    wsums[e] = (float)s;
  }
  if (e < k) {
    double s = 0.0;
    for (int g = 0; g < grid; ++g) s += wpart[(long long)g * k + e];
    weights[e] = (float)s;
  }
  if (e == 0) {
    double s = 0.0;
    for (long long t = 0; t < (long long)grid * ntk; ++t) s += opart[t];
    objective[0] = fmaxf((float)s, 0.f);
  }
}

// B8's phase 2 at d <= kDC. Its shared memory, 110.5 KB: two CTAs fit
// one SM. The f64 running sums of Σμx live here, not in registers, which
// keeps a thread within the 128 registers that two 256-thread CTAs per SM
// allow.
struct __align__(16) AccumSmem {
  double tot[32][kThreads];  // thread t's 4 x 8 running Σμx at [i][t]
  double red[kThreads];      // the CTA's final fixed-order reductions
  float mu[BM][kFuzzyBN];    // μ of the row block's K tile
  union __align__(16) {
    AssignSmem<kFuzzyBN> dots;
    float xc[kRC][kDC];  // x rows of one accumulate step, columns of the slice
  } u;
};

// B8's phase 2 at d <= kDC. CTA (blockIdx.x, blockIdx.y, blockIdx.z) =
// (K tile, d slice, row range g of G). Writes its Σμx partial to ws[g]
// and, in the d slice 0 CTAs, its Σμ partial to wpart[g] and its Σμd²
// partial to opart[g * gridDim.x + blockIdx.x]. Dynamic shared memory:
// AccumSmem.
template <bool kVec, bool kM2>
__global__ void __launch_bounds__(kThreads, 2)
    fuzzy_accum_kernel(const float* __restrict__ x, const float* __restrict__ c,
                       const float* __restrict__ c2,
                       const float* __restrict__ s_row,
                       const float* __restrict__ x2_row, long long n, int k,
                       int d, float p, float mexp, float eps,
                       float* __restrict__ ws, double* __restrict__ wpart,
                       double* __restrict__ opart) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AccumSmem& sm = *reinterpret_cast<AccumSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int kt = blockIdx.x * kFuzzyBN;
  const int dc = blockIdx.y * kDC;
  const int g = blockIdx.z, grid = gridDim.z;
  const long long nb = (n + BM - 1) / BM;
  const long long b0 = nb * g / grid, b1 = nb * (g + 1) / grid;
  // Accumulate mapping: centroids kt + cg*4 + i (i < 4), columns
  // dc + colg*4 + jj and dc + 64 + colg*4 + jj (jj < 4).
  const int cg = tid / 16, colg = tid % 16;
#pragma unroll
  for (int e = 0; e < 32; ++e) sm.tot[e][tid] = 0.0;
  double wtot[kTN];
#pragma unroll
  for (int q = 0; q < kTN; ++q) wtot[q] = 0.0;
  double otot = 0.0;

  for (long long b = b0; b < b1; ++b) {
    const long long row0 = b * BM;
    // This thread's rows' ‖x‖² and s, loaded before the distance tile.
    float x2r[TM], sr[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const long long row = row0 + ty * TM + m;
      x2r[m] = row < n ? x2_row[row] : 0.f;
      sr[m] = row < n ? s_row[row] : 1.f;
    }
    ChunkRegs<kVec> chunk;
    {
      float acc[TM][kTN];
      tile_dots<kVec>(x, c, n, k, d, row0, kt, sm.u.dots, acc);
      chunk.load(x, n, d, row0, dc);  // in flight while μ is computed
      float wb[kTN] = {0.f, 0.f, 0.f, 0.f};
      float ob = 0.f;
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const bool live = row0 + ty * TM + m < n;
        float out[kTN];
#pragma unroll
        for (int q = 0; q < kTN; ++q) {
          const int j = kt + tx * 4 + q;
          float mu = 0.f;
          if (live && j < k) {
            const float d2 = true_d2(x2r[m], c2[j], acc[m][q]);
            const float u = inv_power<kM2>(d2 + eps, p) / sr[m];
            mu = mu_power<kM2>(u, mexp);
            wb[q] += mu;
            ob = fmaf(mu, d2, ob);
          }
          out[q] = mu;
        }
        *reinterpret_cast<float4*>(&sm.mu[ty * TM + m][tx * 4]) =
            make_float4(out[0], out[1], out[2], out[3]);
      }
#pragma unroll
      for (int q = 0; q < kTN; ++q) wtot[q] += (double)wb[q];
      otot += (double)ob;
    }
    float blk[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) blk[i][jj] = 0.f;
    for (int r0 = 0; r0 < BM; r0 += kRC) {
      // tile_dots ended with a barrier, and each step below ends with
      // one, so the chunk may overwrite the staging tiles; this barrier
      // also publishes μ.
      chunk.store(sm.u.xc);
      __syncthreads();
      if (r0 + kRC < BM) chunk.load(x, n, d, row0 + r0 + kRC, dc);
#pragma unroll 4
      for (int rr = 0; rr < kRC; ++rr) {
        const float4 a =
            *reinterpret_cast<const float4*>(&sm.mu[r0 + rr][cg * 4]);
        const float4 v0 =
            *reinterpret_cast<const float4*>(&sm.u.xc[rr][colg * 4]);
        const float4 v1 =
            *reinterpret_cast<const float4*>(&sm.u.xc[rr][64 + colg * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            blk[i][jj] = fmaf(av[i], bv[jj], blk[i][jj]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) sm.tot[i * 8 + jj][tid] += (double)blk[i][jj];
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
        ws[g * kd + (long long)j * d + col] = (float)sm.tot[i * 8 + jj][tid];
      }
    }
  }
  if (blockIdx.y != 0) return;  // every d slice computes the same μ
  // Σμ per centroid kt + tx*4 + q: the 16 row owners (ty) in order.
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
  sm.red[tid] = otot;
  __syncthreads();
  if (tid == 0) {
    double o = 0.0;
    for (int t = 0; t < kThreads; ++t) o += sm.red[t];
    opart[(long long)g * gridDim.x + blockIdx.x] = o;
  }
}

// Phase 2 at d > kDC (design (a)): μ through a bounded scratch.
//
// Centroids per K tile of the μ kernel: 128 (8 x 8 dot products per
// thread, one CTA per SM) at m = 2; at other m, powf needs the registers
// and 64 (two CTAs per SM) is faster on the card. A K chunk is a multiple
// of kMuBN, and so of both tiles and of the μᵀ·X kernel's kFuzzyBN.
constexpr int kMuBN = 128;
//
// `fuzzy_mu_kernel`, one CTA per 128-row block of a row chunk: for each
// BN-wide K tile of the K chunk [kc0, kc0 + kc), the distance tile
// over all of d
// (one product per (row, centroid) pair), then μ = (inv / s)^m written to
// mu[row − row_lo][kt − kc0] (0 for rows past N and centroids past K),
// and the block's Σμd² (f32 per tile, f64 across tiles, the threads in
// order) to opart[row block].
template <bool kVec, bool kM2, int BN>
__global__ void __launch_bounds__(kThreads)
    fuzzy_mu_kernel(const float* __restrict__ x, const float* __restrict__ c,
                    const float* __restrict__ c2,
                    const float* __restrict__ s_row,
                    const float* __restrict__ x2_row, long long n, int k,
                    int d, float p, float mexp, float eps, long long row_lo,
                    int kc0, int kc, float* __restrict__ mu,
                    double* __restrict__ opart) {
  constexpr int TN = BN / 16;
  __shared__ AssignSmem<BN> sm;
  __shared__ double red[kThreads];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long row0 = row_lo + (long long)blockIdx.x * BM;
  float x2r[TM], sr[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const long long row = row0 + ty * TM + m;
    x2r[m] = row < n ? x2_row[row] : 0.f;
    sr[m] = row < n ? s_row[row] : 1.f;
  }
  double otot = 0.0;
  for (int kt = kc0; kt < kc0 + kc; kt += BN) {
    float acc[TM][TN];
    tile_dots<kVec, BN>(x, c, n, k, d, row0, kt, sm, acc);
    float ob = 0.f;
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const bool live = row0 + ty * TM + m < n;
      float* dst = mu + (row0 - row_lo + ty * TM + m) * kc + (kt - kc0);
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        float out[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = kt + g * 64 + tx * 4 + q;
          float v = 0.f;
          if (live && j < k) {
            const float d2 = true_d2(x2r[m], c2[j], acc[m][4 * g + q]);
            const float u = inv_power<kM2>(d2 + eps, p) / sr[m];
            v = mu_power<kM2>(u, mexp);
            ob = fmaf(v, d2, ob);
          }
          out[q] = v;
        }
        *reinterpret_cast<float4*>(dst + g * 64 + tx * 4) =
            make_float4(out[0], out[1], out[2], out[3]);
      }
    }
    otot += (double)ob;
  }
  red[tid] = otot;
  __syncthreads();
  if (tid == 0) {
    double o = 0.0;
    for (int t = 0; t < kThreads; ++t) o += red[t];
    opart[row0 / BM] = o;  // row_lo is a multiple of BM
  }
}

// `fuzzy_mux_kernel`'s shared memory, 78 KB: two CTAs fit one SM.
struct __align__(16) MuxSmem {
  double tot[32][kThreads];  // thread t's 4 x 8 running Σμx at [i][t]
  double red[kThreads];      // a block's Σμ quarters
  float mu[kRC][kFuzzyBN];   // μ of one step's rows, the K tile
  float xc[kRC][kDC];        // x of one step's rows, columns of the slice
};

// Σμx = μᵀ·X and Σμ of one K chunk. CTA (blockIdx.x, blockIdx.y,
// blockIdx.z) = (K tile of the chunk, kDC-column d slice, row range g of
// the row chunk [row_lo, row_hi)). Each kRC-row step stages μ (from the
// scratch) and x in shared memory, the next step's loads in flight while
// it computes; each 128-row block is summed in f32 registers in row order
// and carried in f64 in shared memory. A warp covers 8 centroid groups x
// 4 column groups, so one step of a thread's 4 x 8 block reads 3 shared
// wavefronts for 32 FMAs. Writes its (64, kDC) Σμx partial to
// ws[g_base + g] and, in the d slice 0 CTAs, its Σμ partial to
// wpart[g_base + g]: per block, thread t sums rows 4(t/64)..+3 of each
// step of column t % 64 in f32, the 4 quarters add in order in f64, and
// the blocks carry in f64.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    fuzzy_mux_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                     long long n, int d, long long row_lo, long long row_hi,
                     int kc, int g_base, float* __restrict__ ws,
                     double* __restrict__ wpart) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MuxSmem& sm = *reinterpret_cast<MuxSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const int kt = blockIdx.x * kFuzzyBN;  // within the chunk
  const int dc = blockIdx.y * kDC;
  const bool slice0 = blockIdx.y == 0;
  const int g = blockIdx.z, grid = gridDim.z;
  const long long nb = (row_hi - row_lo + BM - 1) / BM;
  const long long b0 = nb * g / grid, b1 = nb * (g + 1) / grid;
  // Accumulate mapping: centroids kt + cg*4 + i (i < 4), columns
  // dc + colg*4 + jj and dc + 64 + colg*4 + jj (jj < 4).
  const int lane = tid % 32, warp = tid / 32;
  const int cg = (warp % 2) * 8 + lane / 4, colg = (warp / 2) * 4 + lane % 4;
#pragma unroll
  for (int e = 0; e < 32; ++e) sm.tot[e][tid] = 0.0;
  double wtot = 0.0;  // Σμ of centroid kt + tid (tid < 64)
  // One step: kRC rows from local row r (of the row chunk). Thread tid
  // stages μ row r + tid/16, float4 column (tid % 16) * 4.
  ChunkRegs<kVec> chunk;
  float4 mnext = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load_step = [&](long long r) {
    chunk.load(x, n, d, row_lo + r, dc);
    mnext = *reinterpret_cast<const float4*>(mu + (r + tid / 16) * kc + kt +
                                             (tid % 16) * 4);
  };
  if (b0 < b1) load_step(b0 * BM);
  for (long long b = b0; b < b1; ++b) {
    float blk[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) blk[i][jj] = 0.f;
    float wb = 0.f;
    for (int r0 = 0; r0 < BM; r0 += kRC) {
      // Each step ends with a barrier, so the staging tiles may be
      // overwritten; this barrier publishes them.
      chunk.store(sm.xc);
      *reinterpret_cast<float4*>(&sm.mu[tid / 16][(tid % 16) * 4]) = mnext;
      __syncthreads();
      if (r0 + kRC < BM) {
        load_step(b * BM + r0 + kRC);
      } else if (b + 1 < b1) {
        load_step((b + 1) * BM);
      }
      if (slice0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) wb += sm.mu[(tid / 64) * 4 + q][tid % 64];
      }
#pragma unroll 4
      for (int rr = 0; rr < kRC; ++rr) {
        const float4 a = *reinterpret_cast<const float4*>(&sm.mu[rr][cg * 4]);
        const float4 v0 =
            *reinterpret_cast<const float4*>(&sm.xc[rr][colg * 4]);
        const float4 v1 =
            *reinterpret_cast<const float4*>(&sm.xc[rr][64 + colg * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            blk[i][jj] = fmaf(av[i], bv[jj], blk[i][jj]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        sm.tot[i * 8 + jj][tid] += (double)blk[i][jj];
    if (slice0) {  // the block's Σμ: its 4 quarters in order
      sm.red[tid] = (double)wb;
      __syncthreads();
      if (tid < 64)
        wtot += ((sm.red[tid] + sm.red[tid + 64]) + sm.red[tid + 128]) +
                sm.red[tid + 192];
    }
  }
  float* dst = ws + (long long)(g_base + g) * kc * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = kt + cg * 4 + i;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = dc + (jj < 4 ? colg * 4 + jj : 64 + colg * 4 + jj - 4);
      if (col < d)
        dst[(long long)j * d + col] = (float)sm.tot[i * 8 + jj][tid];
    }
  }
  if (slice0 && tid < 64)
    wpart[(long long)(g_base + g) * kc + kt + tid] = wtot;
}

// One K chunk's sums from its G partials, each in g order: Σμx and Σμ of
// centroid kc0 + j.
__global__ void mu_reduce_kernel(const float* __restrict__ ws,
                                 const double* __restrict__ wpart, int grid,
                                 int kc, int kn, int d,
                                 float* __restrict__ wsums,
                                 float* __restrict__ weights) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long kd = (long long)kn * d;
  if (e < kd) {
    const long long j = e / d, col = e % d;
    double s = 0.0;
    for (int g = 0; g < grid; ++g)
      s += (double)ws[((long long)g * kc + j) * d + col];
    wsums[e] = (float)s;
  }
  if (e < kn) {
    double s = 0.0;
    for (int g = 0; g < grid; ++g) s += wpart[(long long)g * kc + e];
    weights[e] = (float)s;
  }
}

// objective = max(Σ parts, 0): 256 threads each sum a contiguous slice in
// order, then thread 0 sums the slices in order.
__global__ void __launch_bounds__(kThreads)
    sum_parts_kernel(const double* __restrict__ parts, long long len,
                     float* __restrict__ objective) {
  __shared__ double red[kThreads];
  const long long per = (len + kThreads - 1) / kThreads;
  const long long a = threadIdx.x * per;
  const long long b = a + per < len ? a + per : len;
  double s = 0.0;
  for (long long i = a; i < b; ++i) s += parts[i];
  red[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double o = 0.0;
    for (int t = 0; t < kThreads; ++t) o += red[t];
    objective[0] = fmaxf((float)o, 0.f);
  }
}

// Sums the G partials in g order: Σμx (K, d), Σμ (K,) and the objective,
// clamped at 0 as the JAX wrapper clamps it.
__global__ void fuzzy_reduce_kernel(const float* __restrict__ ws,
                                    const double* __restrict__ wpart,
                                    const double* __restrict__ opart,
                                    int grid, int ntk, int k, int d,
                                    float* __restrict__ wsums,
                                    float* __restrict__ weights,
                                    float* __restrict__ objective) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long kd = (long long)k * d;
  if (e < kd) {
    double s = 0.0;
    for (int g = 0; g < grid; ++g) s += (double)ws[g * kd + e];
    wsums[e] = (float)s;
  }
  if (e < k) {
    double s = 0.0;
    for (int g = 0; g < grid; ++g) s += wpart[(long long)g * k + e];
    weights[e] = (float)s;
  }
  if (e == 0) {
    double s = 0.0;
    for (long long t = 0; t < (long long)grid * ntk; ++t) s += opart[t];
    objective[0] = fmaxf((float)s, 0.f);
  }
}

// ‖x_i‖² alone, for B8 when no phase 1 ran on these rows: 16 lanes a row,
// the same order as phase 1's, so the bits equal the ones it writes.
__global__ void __launch_bounds__(kThreads)
    row_sq_norms_kernel(const float* __restrict__ x, long long n, int d,
                        float* __restrict__ x2_out) {
  const long long row = (long long)blockIdx.x * (kThreads / 16) +
                        threadIdx.x / 16;
  const float s = row_sq_norm(x, n, d, row);
  if (threadIdx.x % 16 == 0 && row < n) x2_out[row] = s;
}

int k_tiles(int k) { return (k + kFuzzyBN - 1) / kFuzzyBN; }
int d_slices(int d) { return (d + kDC - 1) / kDC; }

}  // namespace

// Centroids per K tile: the objective partials are (grid, ceil(K / tile)).
extern "C" int tdc_fuzzy_k_tile() { return kFuzzyBN; }

// Row ranges G of phase 2: about `target_ctas` CTAs in all, each range at
// least one 128-row block, at least 1.
extern "C" int tdc_fuzzy_grid(long long n, int k, int d, int target_ctas) {
  return accumulate_row_ranges(n, (long long)k_tiles(k) * d_slices(d),
                               target_ctas);
}

// B7: s (N,) f32, the row normaliser, and ‖x‖² (N,) f32 on `grid` CTAs,
// given c2 (K,) = ‖c‖² as B8 takes it; scratch
// (tdc_lloyd_scratch_floats(k, d) floats) for the split centroids and the
// pre-pass's ‖c‖².
extern "C" int tdc_fuzzy_normalizer(const float* x, const float* c,
                                    const float* c2, long long n, int k,
                                    int d, float p, float eps, int grid,
                                    float* scratch, float* s, float* x2,
                                    void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = (cudaError_t)launch_centroid_split(c, k, d, scratch, st);
  if (err != cudaSuccess) return (int)err;
  const bool vec = vector_loads_ok(x, c, d), m2 = p == -1.f;
  auto* kern = vec ? (m2 ? fuzzy_norm_tc_kernel<true, true>
                         : fuzzy_norm_tc_kernel<true, false>)
                   : (m2 ? fuzzy_norm_tc_kernel<false, true>
                         : fuzzy_norm_tc_kernel<false, false>);
  const int smem = (int)sizeof(DistSmem);  // past 48 KB: dynamic only
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kDistThreads, smem, st>>>(x, c, scratch,
                                         scratch + split_floats(k, d), c2, n,
                                         k, d, p, eps, s, x2);
  return (int)cudaGetLastError();
}

// ‖x‖² (N,) f32 of the rows, as phase 1 computes it.
extern "C" int tdc_row_sq_norms(const float* x, long long n, int d, float* x2,
                                void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((n + kThreads / 16 - 1) / (kThreads / 16));
  row_sq_norms_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, n, d,
                                                                    x2);
  return (int)cudaGetLastError();
}

// Phase 2 alone, given s and ‖x‖²: the accumulate and the fixed-order
// reduction. s may come from other centroids than c (B8 in the K-sharded
// tower takes the sum of every shard's phase 1): u = inv / s holds as it
// is, and at m = 2 the exact 1/v and u·u forms do not depend on where s
// came from.
extern "C" int tdc_fuzzy_accumulate(const float* x, const float* c,
                                    const float* c2, const float* s,
                                    const float* x2, long long n, int k,
                                    int d, float p, float mexp, float eps,
                                    int grid, float* ws, double* wpart,
                                    double* opart, float* wsums,
                                    float* weights, float* objective,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = vector_loads_ok(x, c, d), m2 = p == -1.f && mexp == 2.f;
  auto* kern = vec ? (m2 ? fuzzy_accum_kernel<true, true>
                         : fuzzy_accum_kernel<true, false>)
                   : (m2 ? fuzzy_accum_kernel<false, true>
                         : fuzzy_accum_kernel<false, false>);
  const int smem = (int)sizeof(AccumSmem);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int ntk = k_tiles(k);
  const dim3 agrid((unsigned)ntk, (unsigned)d_slices(d), (unsigned)grid);
  kern<<<agrid, kThreads, smem, st>>>(x, c, c2, s, x2, n, k, d, p, mexp, eps,
                                      ws, wpart, opart);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long kd = (long long)k * d;
  const long long total = kd > k ? kd : (long long)k;
  fuzzy_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      ws, wpart, opart, grid, ntk, k, d, wsums, weights, objective);
  return (int)cudaGetLastError();
}

// Phase 2 at d > kDC through the μ scratch (design (a); see the note at
// the top). mu holds rows_per_chunk x k_per_chunk f32 (multiples of BM and
// of kMuBN); for each K chunk and each row chunk in it, the μ kernel
// then the μᵀ·X kernel on `grid` row ranges; ws (row chunks · grid,
// k_per_chunk, d) f32, wpart (row chunks · grid, k_per_chunk) f64 and
// opart (K chunks, ceil(N / BM)) f64 hold the partials. `halves`: bit 0 runs
// the μ kernels, bit 1 the μᵀ·X kernels and the reductions; 3 is the
// kernel, 1 and 2 time the halves apart.
extern "C" int tdc_fuzzy_accumulate_mu(
    const float* x, const float* c, const float* c2, const float* s,
    const float* x2, long long n, int k, int d, float p, float mexp,
    float eps, long long rows_per_chunk, int k_per_chunk, int grid,
    float* mu, float* ws, double* wpart, double* opart, float* wsums,
    float* weights, float* objective, int halves, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 0 || k <= 0) return (int)cudaErrorInvalidValue;
  if (rows_per_chunk <= 0 || rows_per_chunk % BM != 0 || k_per_chunk <= 0 ||
      k_per_chunk % kMuBN != 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const bool vec = vector_loads_ok(x, c, d), m2 = p == -1.f && mexp == 2.f;
  auto* mk = vec ? (m2 ? fuzzy_mu_kernel<true, true, kMuBN>
                       : fuzzy_mu_kernel<true, false, kFuzzyBN>)
                 : (m2 ? fuzzy_mu_kernel<false, true, kMuBN>
                       : fuzzy_mu_kernel<false, false, kFuzzyBN>);
  auto* xk = vec ? fuzzy_mux_kernel<true> : fuzzy_mux_kernel<false>;
  const int smem = (int)sizeof(MuxSmem);
  cudaError_t err = cudaFuncSetAttribute(
      xk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long nb = (n + BM - 1) / BM;
  for (int kc0 = 0, kci = 0; kc0 < k; kc0 += k_per_chunk, ++kci) {
    const int kn = k - kc0 < k_per_chunk ? k - kc0 : k_per_chunk;
    // The chunk's width in the scratch: whole μ-kernel tiles, each two
    // μᵀ·X tiles.
    const int kw = (kn + kMuBN - 1) / kMuBN * kMuBN;
    int rci = 0;
    for (long long row_lo = 0; row_lo < n; row_lo += rows_per_chunk, ++rci) {
      const long long row_hi =
          n - row_lo < rows_per_chunk ? n : row_lo + rows_per_chunk;
      if (halves & 1) {
        mk<<<(unsigned)((row_hi - row_lo + BM - 1) / BM), kThreads, 0, st>>>(
            x, c, c2, s, x2, n, k, d, p, mexp, eps, row_lo, kc0, kw, mu,
            opart + kci * nb);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
      }
      if (halves & 2) {
        const dim3 xgrid((unsigned)(kw / kFuzzyBN), (unsigned)d_slices(d),
                         (unsigned)grid);
        xk<<<xgrid, kThreads, smem, st>>>(x, mu, n, d, row_lo, row_hi, kw,
                                          rci * grid, ws, wpart);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
      }
    }
    if (halves & 2) {
      const long long kd = (long long)kn * d;
      mu_reduce_kernel<<<(unsigned)((kd + 255) / 256), 256, 0, st>>>(
          ws, wpart, rci * grid, kw, kn, d,
          wsums + (long long)kc0 * d, weights + kc0);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  if (halves & 2) {
    const long long kchunks = (k + k_per_chunk - 1) / k_per_chunk;
    sum_parts_kernel<<<1, kThreads, 0, st>>>(opart, kchunks * nb, objective);
  }
  return (int)cudaGetLastError();
}

// B6, one row chunk of rows_per_chunk rows (a multiple of 128) at a time:
// phase 1 writes the chunk's inv to scr (rows_per_chunk x kp f32, kp a
// multiple of 128, phase 2's K tile, and >= k) in (row block, K split)
// CTAs, `splits` of them a row block (1 <= splits <= the 64-wide K tiles;
// spart holds splits x rows_per_chunk f32 of their sums), then merges the
// splits into s and q (N,); phase 2 adds the chunk's Σμ, Σμx and
// objective partials to the slots of wpart (grid, K), ws (grid, K, d) and
// opart (grid, K tiles), all f64; then the fixed-order reduction.
// `phases`: bit 0 runs phase 1, bit 1 phase 2 and the reduction (3 is the
// kernel; 1 and 2 time the phases apart, 2 on the scratch the last chunk
// left).
extern "C" int tdc_fuzzy_stats(const float* x, const float* c,
                               const float* c2, long long n, int k, int d,
                               float p, float mexp, float eps,
                               long long rows_per_chunk, int kp, int grid,
                               int splits, float* scr, float* spart,
                               float* s, float* q, double* ws,
                               double* wpart, double* opart, float* wsums,
                               float* weights, float* objective, int phases,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 0 || k <= 0 || d <= 0 || rows_per_chunk <= 0 ||
      rows_per_chunk % BM != 0 || kp % kTcK != 0 || kp < k || grid < 1 ||
      splits < 1 || splits > k_tiles(k) || phases < 1 || phases > 3)
    return (int)cudaErrorInvalidValue;
  const bool vec = vector_loads_ok(x, c, d), m2 = p == -1.f && mexp == 2.f;
  auto* nkern = vec ? (m2 ? fuzzy_norm_scratch_kernel<true, true>
                          : fuzzy_norm_scratch_kernel<true, false>)
                    : (m2 ? fuzzy_norm_scratch_kernel<false, true>
                          : fuzzy_norm_scratch_kernel<false, false>);
  auto* mkern = m2 ? fuzzy_s_merge_kernel<true> : fuzzy_s_merge_kernel<false>;
  auto* akern = vec ? (m2 ? fuzzy_accum_tc_kernel<true, true>
                          : fuzzy_accum_tc_kernel<true, false>)
                    : (m2 ? fuzzy_accum_tc_kernel<false, true>
                          : fuzzy_accum_tc_kernel<false, false>);
  const int smem = (int)sizeof(TcAccumSmem<false>);
  cudaError_t err = cudaFuncSetAttribute(
      akern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 agrid = tc_grid(k, d, false, grid);
  // At least one chunk, so an empty x still writes zero sums.
  for (long long lo = 0; lo == 0 || lo < n; lo += rows_per_chunk) {
    const long long hi = n - lo < rows_per_chunk ? n : lo + rows_per_chunk;
    if ((phases & 1) && hi > lo) {
      const unsigned blocks = (unsigned)((hi - lo + BM - 1) / BM);
      nkern<<<dim3(blocks, (unsigned)splits), kThreads, 0, st>>>(
          x, c, c2, n, k, d, p, eps, lo, scr, kp, spart, rows_per_chunk);
      mkern<<<(unsigned)((hi - lo + 255) / 256), 256, 0, st>>>(
          spart, splits, rows_per_chunk, lo, hi, 1.f - mexp, s, q);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    if (phases & 2) {
      akern<<<agrid, kTcThreads, smem, st>>>(
          x, scr, kp, s, q, mexp, eps, k, d, lo, hi > lo ? hi : lo,
          TcOut{ws, wpart, opart, lo == 0});
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  if (phases & 2) {
    const long long kd = (long long)k * d;
    fuzzy_tc_reduce_kernel<<<(unsigned)((kd + 255) / 256), 256, 0, st>>>(
        ws, wpart, opart, grid, (int)agrid.x, k, d, wsums, weights,
        objective);
  }
  return (int)cudaGetLastError();
}
