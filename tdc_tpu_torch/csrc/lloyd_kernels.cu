// B1 `lloyd_stats_fused`, B2 `distance_argmin` and B4
// `lloyd_stats_fused_weighted` for Hopper (sm_90a).
//
// B2 replaces `distance_argmin` / `_distance_argmin_kernel`
// (tdc_tpu/ops/pallas_kernels.py:175, body :119): per row the (min,
// argmin) of the distance over all K, with no (N, K) buffer. Bound on this
// card: the 2·N·K·d distance product (at K = 16,384 and d = 768 reading x
// is three orders of magnitude less). The earlier design ran it on the f32
// FMA pipe (328.18 ms at N = 2^19 against a 196.93 ms floor there); here
// it runs on the TF32 tensor cores in 3xTF32 (79.96 ms at 495 TFLOP/s),
// `tc_distance` (tc_distance.cuh), and `distance_argmin_tc_kernel` below
// folds each K tile's accumulators into a running champion per row in
// registers (champion.cuh's rule). The returned minimum is not the tensor
// core's: the tensor core accumulates in f32 with truncation, which biased
// min + ‖x‖² by up to 4.4e-5 relative at d = 769 (PERF.md). Each row's
// champion is scored again on the CUDA cores, ‖x − c*‖² (return_dist) or
// ‖c*‖² − 2·x·c* in f32, 16 lanes a row, as B1's SSE term is.
//
// B1 replaces `lloyd_stats_fused` (pallas_kernels.py:414; body
// `_fused_epilogue_kernel` :301 with `_cross_mxu` :341 and `_lloyd_fold`
// :355). On the TPU the (K, d) f32 accumulator stays in VMEM for the whole
// grid; at K = 1024, d = 128 it is 512 KiB, more than a CTA's 227 KB of
// shared memory, and CTAs run in no order. So here a grid of G persistent
// CTAs each takes every G-th row block, finds its champions, and adds its
// rows, in row order, into its own (K, d) slice of a (G, K, d) f32
// workspace, with per-CTA integer counts and an f64 SSE partial. A second
// kernel sums the G slices in slice order. Every sum has a fixed order: no
// float atomics, bitwise repeatable. Bound on this card: the 2·N·K·d
// distance product. On the f32 FMA pipe (the earlier design here, 38.21
// ms at N = 2^22, K = 1024, d = 128 against a 16.42 ms floor) it is the
// whole kernel; here it runs on the TF32 tensor cores as three TF32
// products (3xTF32, 6.67 ms at 495 TFLOP/s; ~12.4 ms measured, PERF.md),
// see `lloyd_fused_tc_kernel` below.
//
// B4 replaces `lloyd_stats_fused_weighted` (pallas_kernels.py:562; body
// `_fused_epilogue_kernel` :301 with `_lloyd_weighted_fold` :525): B1 with
// an f32 weight per row. Each row adds w·x to its champion's sums, w to its
// mass and w·(min + ‖x‖²) to the SSE. The mass is a float sum, kept per
// CTA in a (G, K) f32 array beside the (G, K, d) sums and summed in slice
// order as the sums are, so it has a fixed order too. A zero-weight row
// adds exactly nothing. Bound: as B1.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "champion.cuh"
#include "lloyd_reduce.cuh"
#include "tc_distance.cuh"
#include "tf32_accum.cuh"
#include "wgmma.cuh"

namespace {

using namespace tdc;

// ---------------------------------------------------------------------
// B1 and B4: the distance product on the tensor cores in 3xTF32.
//
// A CTA of three warpgroups, one per SM, G = min(SMs, row blocks) of
// them, each taking every G-th 128-row block:
//
// - Centroids: the pre-pass (`launch_centroid_split`: `split_centroids`,
//   `centroid_norms` below; the layout in tc_distance.cuh) splits them
//   into TF32 halves, in 32 KiB stages, and gives c2. The producer warp
//   (warp 8) streams the stages through a ring of kSlots shared-memory
//   slots with bulk copies and mbarriers, the same sequence for every row
//   block.
// - Product (warpgroups 0 and 1, 64 rows each): each stages its rows of
//   a 128-column chunk of x into its half of the x buffer, split the same
//   way (hi and lo, 128 KiB in all; where d <= 128 once per block, past it
//   per K tile and chunk), behind its own named barrier, and per k-step
//   of 8 columns issues `wgmma` m64n256k8 for
//   x_hi·c_hi, x_lo·c_hi and x_hi·c_lo (x_lo·c_lo, ~2^-22 of the product,
//   is dropped) into 128 f32 accumulators a thread. After each K tile the
//   champion fold reads the accumulators in registers: per row, over the
//   thread's 64 columns, then across the quad, with champion.cuh's rule
//   (`better`: the smallest index among equal minima, a later tile only on
//   strict <). The block's labels go to one of two label buffers.
// - Accumulate (warps 9-11), one block behind the product, so the two
//   overlap: the block's rows are grouped by label in shared memory,
//   stably; each warp takes whole labels, loads the workspace row once,
//   adds the group's rows in row order (x read again from L2, where the
//   staging left it) and stores it once. Labels are distinct within a
//   block, so a warp's read-modify-writes are independent and several are
//   in flight; the add order of every entry is row order. Counts (B1) are
//   the group sizes; B4's mass Σw goes to its own (G, K) array. Each row's
//   SSE term is ‖x − c‖² to its champion, in f32 on the CUDA cores as the
//   row is added (the same value as min + ‖x‖², without the rounding of
//   the tensor core's truncating f32 accumulation of x·c, which biased
//   min + ‖x‖² by up to 4.4e-5 relative at d = 769), and the block's
//   terms go through a fixed f64 tree.
// Twelve warps leave 168 registers a thread: the accumulators are live
// only inside a K tile, and restaging past d = 128 loads one column block
// at a time. No float atomics anywhere: two runs are bitwise equal.
constexpr int kChunkBlocks = 4;  // column blocks per staged x chunk
constexpr int kSlots = 3;        // centroid stages in the ring
constexpr int kConsumers = 256;  // the product's two warpgroups
constexpr int kProducerWarp = kConsumers / 32;
constexpr int kAccWarps = 3;  // the accumulate's warps, after the producer
constexpr int kAccThreads = 32 * kAccWarps;
constexpr int kFusedThreads = kConsumers + 32 + kAccThreads;
constexpr int kSlabFloats = kChunkBlocks * 64 * kColBlock;  // 32 KiB
constexpr int kSkip = 0x7fffffff;  // label of a row past n
constexpr int kSegsPerPass = 4;  // labels a warp accumulates at once

// 227 KB, one CTA per SM.
struct __align__(1024) FusedSmem {
  float xs[2][2][kSlabFloats];  // [hi, lo][warpgroup][column block][64][32]
  float ring[kSlots][kStageFloats];
  unsigned long long full[kSlots];   // a stage has landed
  unsigned long long empty[kSlots];  // the product is done with a slot
  unsigned long long ready[2];  // a block's labels are written
  unsigned long long freed[2];  // the accumulate is done with them
  int lab[2][kTcBM];
  float val[kTcBM];  // the row's SSE term
  unsigned char order[kTcBM];  // rows grouped by label, stably
  unsigned char seg[kTcBM + 1];  // group starts in `order`
  int nseg;
  unsigned heads[kTcBM / 32];  // ballots of group heads,
  unsigned live[kTcBM / 32];   // and of rows with a label < K
};

// One thread per (row j < K8, column block cb, 16-byte chunk q).
__global__ void split_centroids(const float* __restrict__ c, int k, int d,
                                float* __restrict__ split) {
  const int ncb = (d + kColBlock - 1) / kColBlock;
  const int k8 = split_rows(k);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)k8 * ncb * 8) return;
  const int q = (int)(i % 8);
  const int cb = (int)((i / 8) % ncb);
  const int j = (int)(i / (8 * ncb));
  const int kt = j / kTcBN, n = j % kTcBN;
  const int rows = tile_rows(kt, k8);
  float4 hi, lo;
  float* h = &hi.x;
  float* l = &lo.x;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int col = cb * kColBlock + 4 * q + e;
    const float v = (j < k && col < d) ? c[(long long)j * d + col] : 0.f;
    unsigned uh, ul;
    split_tf32(v, uh, ul);
    h[e] = __uint_as_float(uh);
    l[e] = __uint_as_float(ul);
  }
  float* base = split + stage_offset(kt, cb, 0, ncb, rows);
  const int at = swizzle_col(n, 4 * q);
  *reinterpret_cast<float4*>(base + at) = hi;
  *reinterpret_cast<float4*>(base + (long long)rows * kColBlock + at) = lo;
}

// One warp per centroid of the padded K tiles: ‖c‖² in a fixed order,
// +inf past K.
__global__ void centroid_norms(const float* __restrict__ c, int k, int d,
                               float* __restrict__ c2) {
  const int j = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  const int kp = (k + kTcBN - 1) / kTcBN * kTcBN;
  if (j >= kp) return;
  float s = 0.f;
  if (j < k) {
    for (int i = lane; i < d; i += 32) {
      const float v = c[(long long)j * d + i];
      s = fmaf(v, v, s);
    }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) c2[j] = j < k ? s : CUDART_INF_F;
}

// Stages columns [32·cb0, 32·(cb0 + nb)) of the calling warpgroup's 64
// rows of the block at row0 into its half of the split x buffer, 0 past n
// and d, kBatch column blocks of loads at a time (1 where the
// accumulators are live). Between the group's named barriers.
template <bool kVec, int kBatch>
__device__ __forceinline__ void stage_rows(const float* __restrict__ x,
                                           long long n, int d,
                                           long long row0, int cb0, int nb,
                                           FusedSmem& sm) {
  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, cw = (tid / 32) % 4;
  const int q = lane % 8, rr = lane / 8;
  // All of a block-start staging's loads in flight at once (the
  // accumulators are dead then); one column block at a time otherwise.
  constexpr int kUnroll = kBatch == kChunkBlocks ? 4 : 1;
#pragma unroll(kUnroll)
  for (int i = 0; i < 4 * (kChunkBlocks / kBatch); ++i) {
    const int rl = (i % 4) * 16 + cw * 4 + rr;
    const int b0 = (i / 4) * kBatch;
    const long long row = row0 + 64 * wg + rl;
    float v[kBatch][4];
#pragma unroll
    for (int bb = 0; bb < kBatch; ++bb) {
      const int b = b0 + bb;
      const int col = (cb0 + b) * kColBlock + 4 * q;
#pragma unroll
      for (int e = 0; e < 4; ++e) v[bb][e] = 0.f;
      if (b < nb && row < n) {
        if (kVec) {
          if (col < d) {
            const float4 t = *reinterpret_cast<const float4*>(x + row * d + col);
            v[bb][0] = t.x;
            v[bb][1] = t.y;
            v[bb][2] = t.z;
            v[bb][3] = t.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < d) v[bb][e] = x[row * d + col + e];
        }
      }
    }
#pragma unroll
    for (int bb = 0; bb < kBatch; ++bb) {
      const int b = b0 + bb;
      if (b < nb) {
        unsigned h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(v[bb][e], h[e], l[e]);
        const int at = b * 64 * kColBlock + swizzle_col(rl, 4 * q);
        *reinterpret_cast<uint4*>(&sm.xs[0][wg][at]) =
            make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(&sm.xs[1][wg][at]) =
            make_uint4(l[0], l[1], l[2], l[3]);
      }
    }
  }
}

// a += x (B1) or a += w·x (B4), and the row's (x − c)² over these
// columns, per element.
template <bool kWeighted>
__device__ __forceinline__ float add_row(float& a, float x, float c,
                                         float w) {
  if (kWeighted) {
    a += w * x;
  } else {
    a += x;
  }
  const float t = x - c;
  return t * t;
}
template <bool kWeighted>
__device__ __forceinline__ float add_row(float4& a, const float4& x,
                                         const float4& c, float w) {
  float s = add_row<kWeighted>(a.x, x.x, c.x, w);
  s += add_row<kWeighted>(a.y, x.y, c.y, w);
  s += add_row<kWeighted>(a.z, x.z, c.z, w);
  return s + add_row<kWeighted>(a.w, x.w, c.w, w);
}

// The accumulate of one block (warps 9-11): group the rows by label,
// add each group into the CTA's workspace slice, and return the block's
// SSE terms summed (a fixed f64 tree; the value of warp 9's lanes).
template <bool kVec, bool kWeighted>
__device__ __forceinline__ double accumulate_block(
    const float* __restrict__ x, const float* __restrict__ c,
    const float* __restrict__ w, long long row0, int rows, int k, int d,
    const int* lab, float* __restrict__ my_ws, int* __restrict__ my_cnt,
    float* __restrict__ my_mass, FusedSmem& sm) {
  const int at = threadIdx.x - kConsumers - 32, lane = at % 32, aw = at / 32;
  // Rows without a label < K keep this term: NaN where the row has no
  // finite candidate (as min + ‖x‖² is), 0 past n.
  for (int t = at; t < kTcBM; t += kAccThreads) {
    if (lab[t] >= k) sm.val[t] = t < rows ? __int_as_float(0x7fc00000) : 0.f;
  }
  group_rows<kTcBM, kAccWarps>(lab, k, at, 3, sm);
  // Each warp takes every 3rd group, kSegsPerPass at a time: the
  // workspace row of the group's label is read once, the group's rows are
  // added in row order, and it is written once.
  constexpr int kW = kVec ? 4 : 1;
  using V = typename std::conditional<kVec, float4, float>::type;
  const int nseg = sm.nseg;
  for (int s0 = aw; s0 < nseg; s0 += kAccWarps * kSegsPerPass) {
    int gl[kSegsPerPass], p0[kSegsPerPass], p1[kSegsPerPass];
#pragma unroll
    for (int u = 0; u < kSegsPerPass; ++u) {
      const int s = s0 + u * kAccWarps;
      const bool ok = s < nseg;
      p0[u] = ok ? sm.seg[s] : 0;
      p1[u] = ok ? sm.seg[s + 1] : 0;
      gl[u] = ok ? lab[sm.order[p0[u]]] : -1;
    }
    for (int jj = 0; jj < d; jj += 32 * kW) {
      const int j = jj + lane * kW;
      const bool in = j < d;
      V a[kSegsPerPass], cv[kSegsPerPass], xv[kSegsPerPass];
#pragma unroll
      for (int u = 0; u < kSegsPerPass; ++u) {
        a[u] = cv[u] = xv[u] = V{};
        if (gl[u] >= 0 && in) {
          a[u] = *reinterpret_cast<const V*>(my_ws + (long long)gl[u] * d + j);
          cv[u] = *reinterpret_cast<const V*>(c + (long long)gl[u] * d + j);
          xv[u] = *reinterpret_cast<const V*>(
              x + (row0 + sm.order[p0[u]]) * d + j);
        }
      }
#pragma unroll
      for (int u = 0; u < kSegsPerPass; ++u) {
        if (gl[u] < 0) continue;
        for (int p = p0[u]; p < p1[u]; ++p) {
          const int r = sm.order[p];
          V xr = xv[u];
          if (p > p0[u]) {
            xr = in ? *reinterpret_cast<const V*>(x + (row0 + r) * d + j)
                    : V{};
          }
          const float wr = kWeighted ? w[row0 + r] : 1.f;
          const float t = warp_sum(add_row<kWeighted>(a[u], xr, cv[u], wr));
          if (lane == 0) sm.val[r] = jj == 0 ? t : sm.val[r] + t;
        }
        if (in) {
          *reinterpret_cast<V*>(my_ws + (long long)gl[u] * d + j) = a[u];
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kSegsPerPass; ++u) {
        if (gl[u] < 0) continue;
        if (kWeighted) {
          float m = my_mass[gl[u]];
          for (int p = p0[u]; p < p1[u]; ++p) {
            const int r = sm.order[p];
            m += w[row0 + r];
            sm.val[r] *= w[row0 + r];
          }
          my_mass[gl[u]] = m;
        } else {
          my_cnt[gl[u]] += p1[u] - p0[u];
        }
      }
    }
  }
  named_barrier(3, kAccThreads);
  double t = 0.0;  // the block's SSE terms: a fixed f64 tree
  if (aw == 0) {
#pragma unroll
    for (int q = 0; q < kTcBM / 32; ++q) {
      const int r = lane + 32 * q;
      if (r < rows) t += (double)sm.val[r];
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      t += __shfl_xor_sync(0xffffffffu, t, off);
  }
  named_barrier(3, kAccThreads);  // val and order are free for the next
  return t;
}

// kWeighted = false is B1: integer counts in `cnt`, w and mass unused.
// kWeighted = true is B4: Σw·x in ws and Σw in `mass`, cnt unused.
// ws is (grid, K, d); cnt and mass are (grid, K); labels may be null.
template <bool kVec, bool kWeighted>
__global__ void __launch_bounds__(kFusedThreads, 1)
    lloyd_fused_tc_kernel(const float* __restrict__ x,
                          const float* __restrict__ c,
                          const float* __restrict__ split,
                          const float* __restrict__ c2,
                          const float* __restrict__ w, long long n, int k,
                          int d, float* __restrict__ ws,
                          int* __restrict__ cnt, float* __restrict__ mass,
                          double* __restrict__ sse_part,
                          int* __restrict__ labels) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  FusedSmem& sm = *reinterpret_cast<FusedSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long kd = (long long)k * d;
  float* my_ws = ws + blockIdx.x * kd;
  int* my_cnt = kWeighted ? nullptr : cnt + (long long)blockIdx.x * k;
  float* my_mass = kWeighted ? mass + (long long)blockIdx.x * k : nullptr;
  if (tid == 0) {
    if (smem_addr(smem_raw) % 1024 != 0) __trap();  // the swizzle needs it
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers / 32);
    }
    for (int q = 0; q < 2; ++q) {
      mbar_init(&sm.ready[q], kConsumers / 32);
      mbar_init(&sm.freed[q], kAccWarps);
    }
    mbar_init_fence();
  }
  for (long long i = tid; i < kd; i += kFusedThreads) my_ws[i] = 0.f;
  for (int i = tid; i < k; i += kFusedThreads) {
    if (kWeighted) {
      my_mass[i] = 0.f;
    } else {
      my_cnt[i] = 0;
    }
  }
  __syncthreads();

  const int ncb = (d + kColBlock - 1) / kColBlock;
  const int nch = (ncb + kChunkBlocks - 1) / kChunkBlocks;
  const int nkt = (k + kTcBN - 1) / kTcBN;
  const int k8 = split_rows(k);
  const long long nblocks = (n + kTcBM - 1) / kTcBM;

  if (warp == kProducerWarp) {
    if (lane == 0) {
      unsigned g = 0;
      for (long long b = blockIdx.x; b < nblocks; b += gridDim.x) {
        const long long nb = b + gridDim.x;
        if (kVec && nb < nblocks) {
          prefetch_l2(x + nb * kTcBM * d,
                      (unsigned)(min((long long)kTcBM, n - nb * kTcBM) * d *
                                 4));
        }
        for (int kt = 0; kt < nkt; ++kt) {
          const int rows = tile_rows(kt, k8);
          for (int cb = 0; cb < ncb; ++cb) {
            for (int half = 0; half < 2; ++half, ++g) {
              const int slot = g % kSlots;
              mbar_wait(&sm.empty[slot], ((g / kSlots) & 1) ^ 1);
              const unsigned bytes = rows * kColBlock * 4;
              mbar_expect_tx(&sm.full[slot], bytes);
              bulk_copy_g2s(sm.ring[slot],
                            split + stage_offset(kt, cb, half, ncb, rows),
                            bytes, &sm.full[slot]);
            }
          }
        }
      }
    }
    return;
  }

  if (warp > kProducerWarp) {  // the accumulate
    double sse = 0.0;  // the first accumulate thread's is the CTA's
    unsigned i = 0;
    for (long long b = blockIdx.x; b < nblocks; b += gridDim.x, ++i) {
      const long long row0 = b * kTcBM;
      const int rows = (int)min((long long)kTcBM, n - row0);
      mbar_wait(&sm.ready[i & 1], (i >> 1) & 1);
      sse += accumulate_block<kVec, kWeighted>(x, c, w, row0, rows, k, d,
                                               sm.lab[i & 1], my_ws, my_cnt,
                                               my_mass, sm);
      warp_arrive(&sm.freed[i & 1]);
    }
    if (tid == kConsumers + 32) sse_part[blockIdx.x] = sse;
    return;
  }

  // The product: warpgroup wg owns rows 64·wg.. of the block; in the
  // accumulator layout thread (warp ww of the group, lane gq·4 + t4) holds
  // rows 16·ww + gq and + 8, columns 8j + 2·t4 and + 1 (j < 32).
  const int wg = warp / 4, ww = warp % 4, gq = lane / 4, t4 = lane % 4;
  const int rl0 = 64 * wg + 16 * ww + gq;
  unsigned g = 0, i = 0;
  float acc[kTcBN / 2];
  for (long long b = blockIdx.x; b < nblocks; b += gridDim.x, ++i) {
    const long long row0 = b * kTcBM;
    const int rows = (int)min((long long)kTcBM, n - row0);
    if (nch == 1) {  // the group's rows, once: its products are done
      named_barrier(1 + wg, 128);
      stage_rows<kVec, kChunkBlocks>(x, n, d, row0, 0, ncb, sm);
      fence_proxy_async();
      named_barrier(1 + wg, 128);
    }
    float best[2] = {CUDART_INF_F, CUDART_INF_F};
    int barg[2] = {kArgSentinel, kArgSentinel};
    for (int kt = 0; kt < nkt; ++kt) {
      // Zeroed here rather than by the first product's scale-d: outside
      // the K tiles the accumulators are dead, which frees their 128
      // registers for the staging.
#pragma unroll
      for (int e = 0; e < kTcBN / 2; ++e) acc[e] = 0.f;
      int prev = -1;
      for (int cb = 0; cb < ncb; ++cb) {
        if (nch > 1 && cb % kChunkBlocks == 0) {
          // A new x chunk: the group's `wgmma`s on its half are done.
          if (prev >= 0) {
            wgmma_wait<0>();
            warp_arrive(&sm.empty[prev]);
            prev = -1;
          }
          named_barrier(1 + wg, 128);
          stage_rows<kVec, 1>(x, n, d, row0, cb,
                              min(kChunkBlocks, ncb - cb), sm);
          fence_proxy_async();
          named_barrier(1 + wg, 128);
        }
        const float* xh = &sm.xs[0][wg][(cb % kChunkBlocks) * 64 * kColBlock];
        const float* xl = &sm.xs[1][wg][(cb % kChunkBlocks) * 64 * kColBlock];
        const int ks = min(kColBlock / 8, (d - cb * kColBlock + 7) / 8);
        for (int half = 0; half < 2; ++half, ++g) {
          const int slot = g % kSlots;
          mbar_wait(&sm.full[slot], (g / kSlots) & 1);
          __syncwarp();  // `wgmma` is aligned: the warp converged
          const float* cs = sm.ring[slot];
          wgmma_fence();
          fence_operands(acc);
          for (int kk = 0; kk < ks; ++kk) {
            const unsigned long long db = sw128_desc(cs + 8 * kk);
            wgmma_m64n256k8_tf32(acc, sw128_desc(xh + 8 * kk), db, 1);
            if (half == 0) {
              wgmma_m64n256k8_tf32(acc, sw128_desc(xl + 8 * kk), db, 1);
            }
          }
          wgmma_commit();
          fence_operands(acc);
          wgmma_wait<1>();  // the previous stage's products are done
          if (prev >= 0) warp_arrive(&sm.empty[prev]);
          prev = slot;
        }
      }
      wgmma_wait<0>();
      warp_arrive(&sm.empty[prev]);
      fence_operands(acc);
      // The fold: this thread's 64 columns of the K tile for its two rows.
#pragma unroll
      for (int j = 0; j < kTcBN / 8; ++j) {
        const int col = kt * kTcBN + 8 * j + 2 * t4;
        const float2 cc = __ldg(reinterpret_cast<const float2*>(c2 + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 = cc.x - 2.f * acc[4 * j + 2 * h];
          const float v1 = cc.y - 2.f * acc[4 * j + 2 * h + 1];
          if (col < k && better(v0, col, best[h], barg[h])) {
            best[h] = v0;
            barg[h] = col;
          }
          if (col + 1 < k && better(v1, col + 1, best[h], barg[h])) {
            best[h] = v1;
            barg[h] = col + 1;
          }
        }
      }
    }
    // Across the quad (lanes differing in bits 0-1), then one writer per
    // row, once the accumulate is done with this label buffer's last use.
    mbar_wait(&sm.freed[i & 1], ((i >> 1) & 1) ^ 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best[h], off);
        const int oj = __shfl_xor_sync(0xffffffffu, barg[h], off);
        if (better(ov, oj, best[h], barg[h])) {
          best[h] = ov;
          barg[h] = oj;
        }
      }
      const int r = rl0 + 8 * h;
      if (t4 == 0) {
        const bool live = r < rows;
        sm.lab[i & 1][r] = live ? barg[h] : kSkip;
        if (labels && live) labels[row0 + r] = barg[h];
      }
    }
    warp_arrive(&sm.ready[i & 1]);
  }
}

// Sums the G slices in slice order: sums from the (K, d) slices of ws;
// counts from the (G, K) integer counts (B1, B5) or the (G, K) f32 mass
// (B4). B5 launches it too (lloyd_reduce.cuh).
__global__ void lloyd_reduce_kernel(const float* __restrict__ ws,
                                    const int* __restrict__ cnt,
                                    const float* __restrict__ mass,
                                    const double* __restrict__ sse_part,
                                    int grid, int k, int d,
                                    float* __restrict__ sums,
                                    float* __restrict__ counts,
                                    float* __restrict__ sse) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long kd = (long long)k * d;
  if (e < kd) {
    float s = 0.f;
    for (int g = 0; g < grid; ++g) s += ws[g * kd + e];
    sums[e] = s;
  }
  if (e < k) {
    if (cnt) {
      long long s = 0;
      for (int g = 0; g < grid; ++g) s += cnt[(long long)g * k + e];
      counts[e] = (float)s;
    } else {
      float s = 0.f;
      for (int g = 0; g < grid; ++g) s += mass[(long long)g * k + e];
      counts[e] = s;
    }
  }
  if (e == 0) {
    double s = 0.0;
    for (int g = 0; g < grid; ++g) s += sse_part[g];
    sse[0] = fmaxf((float)s, 0.f);
  }
}

template <bool kVec, bool kWeighted>
cudaError_t launch_tc(const float* x, const float* c, const float* split,
                      const float* c2, const float* w, long long n, int k,
                      int d, int grid, float* ws, int* cnt, float* mass,
                      double* sse_part, int* labels, cudaStream_t s) {
  auto kernel = lloyd_fused_tc_kernel<kVec, kWeighted>;
  const int smem = (int)sizeof(FusedSmem);  // past 48 KB: dynamic only
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kFusedThreads, smem, s>>>(x, c, split, c2, w, n, k, d, ws,
                                           cnt, mass, sse_part, labels);
  return cudaGetLastError();
}

// The pre-pass, the main kernel and the slice reduce.
template <bool kWeighted>
int launch_fused(const float* x, const float* c, const float* w, long long n,
                 int k, int d, int grid, float* scratch, float* ws,
                 int* cnt, float* mass, double* sse_part, float* sums,
                 float* counts, float* sse, int* labels, cudaStream_t s) {
  float* split = scratch;
  float* c2 = scratch + split_floats(k, d);
  cudaError_t err = (cudaError_t)launch_centroid_split(c, k, d, scratch, s);
  if (err != cudaSuccess) return (int)err;
  err = vector_loads_ok(x, c, d)
            ? launch_tc<true, kWeighted>(x, c, split, c2, w, n, k, d, grid,
                                         ws, cnt, mass, sse_part, labels, s)
            : launch_tc<false, kWeighted>(x, c, split, c2, w, n, k, d, grid,
                                          ws, cnt, mass, sse_part, labels, s);
  if (err != cudaSuccess) return (int)err;
  return launch_lloyd_reduce(ws, cnt, mass, sse_part, grid, k, d, sums,
                             counts, sse, s);
}

// ---------------------------------------------------------------------
// B2 on `tc_distance`: the fold keeps each row's two best shifted
// distances c2 − 2·x·c and their indices in registers (strict < in a
// thread's increasing columns), and after a block's last K tile the quad's
// merge (champion.cuh's rule). The tensor core's values decide only where
// they are far apart: its truncating accumulation errs by up to ~3.5e-5
// of ‖x‖² + ‖c‖² at d = 768 (PERF.md). Each row is scored again on the
// CUDA cores, 16 lanes a row, in f32: its champion, and its runner-up
// where the two lie within kNearTie of ‖x‖² + ‖c‖² (about seven times
// that error) of each other; between those two the f32 shifted distances
// ‖c‖² − 2·x·c decide, smallest index among equal ones. So the label is
// the one f32 values give wherever the tensor core's could mislead,
// whatever the K tiling: the K-sharded tower, which compares the shards'
// f32 minima, picks the labels of one GPU. The minimum returned is the
// label's ‖x − c‖² (return_dist; as B1's SSE term) or its ‖c‖² − 2·x·c,
// both from that pass. A row with no finite candidate keeps the sentinel
// label and a NaN minimum.
constexpr float kNearTie = 1.f / 4096.f;

// A row's x·c, ‖c‖², ‖x − c‖² and (kXX) ‖x‖² for centroid j in f32, the
// calling thread's 16-lane group summing over d in a fixed order; zeros
// where !live. Every lane of the group gets them.
struct RowScore {
  float xc, cc, dd, xx;
};
template <bool kXX>
__device__ __forceinline__ RowScore row_score(const float* __restrict__ xp,
                                              const float* __restrict__ c,
                                              int j, int d, bool live) {
  RowScore r = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    const float* cp = c + (long long)j * d;
    for (int col = threadIdx.x % 16; col < d; col += 16) {
      const float xv = xp[col], cv = cp[col], t = xv - cv;
      r.xc = fmaf(xv, cv, r.xc);
      r.cc = fmaf(cv, cv, r.cc);
      r.dd = fmaf(t, t, r.dd);
      if (kXX) r.xx = fmaf(xv, xv, r.xx);
    }
  }
  r.xc = row_lanes_sum(r.xc);
  r.cc = row_lanes_sum(r.cc);
  r.dd = row_lanes_sum(r.dd);
  if (kXX) r.xx = row_lanes_sum(r.xx);
  return r;
}

template <bool kVec>
__global__ void __launch_bounds__(kDistThreads, 1)
    distance_argmin_tc_kernel(const float* __restrict__ x,
                              const float* __restrict__ c,
                              const float* __restrict__ split,
                              const float* __restrict__ c2, long long n,
                              int k, int d, int return_dist,
                              int* __restrict__ labels,
                              float* __restrict__ mind) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  DistSmem& sm = *reinterpret_cast<DistSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rl0 = 64 * (warp / 4) + 16 * (warp % 4) + lane / 4;
  float b1[2], b2[2];  // a row's best and runner-up
  int j1[2], j2[2];
  tc_distance<kVec>(
      x, split, n, k, d, sm,
      [&](long long) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          b1[h] = b2[h] = CUDART_INF_F;
          j1[h] = j2[h] = kArgSentinel;
        }
      },
      [&](int kt, const float (&acc)[kTcBN / 2]) {
        for_each_entry(kt, acc, c2, [&](int h, int col, float cc, float a) {
          const float v = cc - 2.f * a;
          if (v < b2[h]) {
            if (v < b1[h]) {
              b2[h] = b1[h];
              j2[h] = j1[h];
              b1[h] = v;
              j1[h] = col;
            } else {
              b2[h] = v;
              j2[h] = col;
            }
          }
        });
      },
      [&](long long row0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          top2_quad(b1[h], j1[h], b2[h], j2[h]);
          if (lane % 4 == 0) {
            sm.lab[rl0 + 8 * h] = j1[h];
            sm.lab2[rl0 + 8 * h] = j2[h];
            sm.val[rl0 + 8 * h] = b2[h] - b1[h];
          }
        }
        named_barrier(1 + warp / 4, 128);
        const int tx = tid % 16;
#pragma unroll 1
        for (int i = 0; i < 8; ++i) {
          const int r = epilogue_row(i);
          const long long row = row0 + r;
          const float* xp = x + row * d;
          int j = sm.lab[r];
          RowScore sc = row_score<true>(xp, c, j, d, row < n && j < k);
          float v = sc.cc - 2.f * sc.xc;
          const int jr = sm.lab2[r];
          const bool near = row < n && j < k && jr < k &&
                            sm.val[r] <= kNearTie * (sc.xx + sc.cc + c2[jr]);
          if (__any_sync(0xffffffffu, near)) {
            const RowScore s2 = row_score<false>(xp, c, jr, d, near);
            const float v2 = s2.cc - 2.f * s2.xc;
            if (near && better(v2, jr, v, j)) {
              j = jr;
              v = v2;
              sc = s2;
            }
          }
          if (tx == 0 && row < n) {
            labels[row] = j;
            mind[row] = j >= k ? CUDART_NAN_F : return_dist ? sc.dd : v;
          }
        }
        named_barrier(1 + warp / 4, 128);  // the row state is free
      });
}

template <bool kVec>
cudaError_t launch_argmin(const float* x, const float* c, const float* split,
                          const float* c2, long long n, int k, int d,
                          int grid, int return_dist, int* labels, float* mind,
                          cudaStream_t s) {
  auto kernel = distance_argmin_tc_kernel<kVec>;
  const int smem = (int)sizeof(DistSmem);  // past 48 KB: dynamic only
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kDistThreads, smem, s>>>(x, c, split, c2, n, k, d,
                                          return_dist, labels, mind);
  return cudaGetLastError();
}

}  // namespace

int tdc::launch_lloyd_reduce(const float* ws, const int* cnt,
                             const float* mass, const double* sse_part,
                             int grid, int k, int d, float* sums,
                             float* counts, float* sse, cudaStream_t s) {
  const long long kd = (long long)k * d;
  const long long total = kd > k ? kd : (long long)k;
  const long long blocks = (total + 255) / 256;
  lloyd_reduce_kernel<<<(unsigned)blocks, 256, 0, s>>>(
      ws, cnt, mass, sse_part, grid, k, d, sums, counts, sse);
  return (int)cudaGetLastError();
}

int tdc::launch_centroid_split(const float* c, int k, int d,
                               float* scratch, cudaStream_t s) {
  const long long items = split_floats(k, d) / 8;  // 4 hi + 4 lo a thread
  split_centroids<<<(unsigned)((items + 255) / 256), 256, 0, s>>>(c, k, d,
                                                                  scratch);
  const int kp = (k + kTcBN - 1) / kTcBN * kTcBN;
  centroid_norms<<<(kp * 32 + 255) / 256, 256, 0, s>>>(
      c, k, d, scratch + split_floats(k, d));
  return (int)cudaGetLastError();
}

// B2: labels (n,) int32 and the minima (n,) f32 on `grid` CTAs; scratch
// (tdc_lloyd_scratch_floats(k, d) floats) for the split centroids and ‖c‖².
extern "C" int tdc_distance_argmin(const float* x, const float* c,
                                   long long n, int k, int d,
                                   int return_dist, int grid, float* scratch,
                                   int* labels, float* mind, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = (cudaError_t)launch_centroid_split(c, k, d, scratch, s);
  if (err != cudaSuccess) return (int)err;
  const float* c2 = scratch + split_floats(k, d);
  err = vector_loads_ok(x, c, d)
            ? launch_argmin<true>(x, c, scratch, c2, n, k, d, grid,
                                  return_dist, labels, mind, s)
            : launch_argmin<false>(x, c, scratch, c2, n, k, d, grid,
                                   return_dist, labels, mind, s);
  return (int)err;
}

// B1: scratch (tdc_lloyd_scratch_floats(k, d) floats: the split
// centroids and ‖c‖²), ws (grid, k, d) f32, cnt (grid, k) int32 and
// sse_part (grid,) f64 the workspace; labels (n,) int32 or null.
extern "C" int tdc_lloyd_stats_fused(const float* x, const float* c,
                                     long long n, int k, int d, int grid,
                                     float* scratch, float* ws, int* cnt,
                                     double* sse_part, float* sums,
                                     float* counts, float* sse, int* labels,
                                     void* stream) {
  return launch_fused<false>(x, c, nullptr, n, k, d, grid, scratch, ws, cnt,
                             nullptr, sse_part, sums, counts, sse, labels,
                             (cudaStream_t)stream);
}

// B4: as B1 with w (n,) f32; mass (grid, k) f32 in place of cnt, and
// counts receives the mass.
extern "C" int tdc_lloyd_stats_fused_weighted(
    const float* x, const float* c, const float* w, long long n, int k, int d,
    int grid, float* scratch, float* ws, float* mass, double* sse_part,
    float* sums, float* counts, float* sse, int* labels, void* stream) {
  return launch_fused<true>(x, c, w, n, k, d, grid, scratch, ws, nullptr,
                            mass, sse_part, sums, counts, sse, labels,
                            (cudaStream_t)stream);
}

// Floats of the per-call scratch of B1, B2, B4 and B7.
extern "C" int64_t tdc_lloyd_scratch_floats(int k, int d) {
  return centroid_scratch_floats(k, d);
}

extern "C" const char* tdc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
