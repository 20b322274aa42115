// B5 `lloyd_stats_fused(mxu_dtype="bfloat16")` for Hopper (sm_90a).
//
// Replaces `lloyd_stats_fused` (tdc_tpu/ops/pallas_kernels.py:414) with
// mxu_dtype="bfloat16": the epilogue `_LLOYD_BF16_EPILOGUE` (:405), whose
// `_cross_mxu_bf16` (:383) rounds both cross-product operands to bf16 and
// accumulates in f32, and the same `pallas_call` (:484) on bf16 inputs,
// where the two epilogues are bit-identical. It computes B1's function
// (Σx per cluster, counts, SSE = Σ min + Σ‖x‖², clamped at 0) with the
// champion taken on c2 − 2·bf16(x)·bf16(c), smallest index among equal
// minima, while Σx and ‖x‖² read the rows at their own dtype: f32 rows
// unrounded, bf16 rows widened. The wrapper passes the centroids already
// rounded to bf16, and c2 = ‖c‖² of the f32 centroids for f32 x or of the
// rounded ones for bf16 x (the JAX wrapper's `centroids.astype(x.dtype)`).
//
// Bound on this card: the 2·N·K·d product on the bf16 tensor cores, 989
// TFLOP/s dense (H100 SXM data sheet): 1.11 ms at N = 2^22, K = 1024,
// d = 128, against 0.64 ms to read f32 x once. At one bf16 product per
// k-step the product is a sixth of B1's 3xTF32 one, so the champion fold
// and the accumulate, on the CUDA cores, take most of the time (PERF.md).
// Accumulators in halves or quarters of a K tile that ping-pong, so that
// the fold of one overlaps the product of the next, need more than the
// 168 registers a thread that one 384-thread CTA an SM leaves: they
// spilled and ran slower.
//
// Design: B1's kernel (lloyd_kernels.cu, `lloyd_fused_tc_kernel`) with
// bf16 operands. A CTA of three warpgroups, one per SM, G = min(SMs, row
// blocks) of them, each taking every G-th 128-row block:
//
// - Centroids: a pre-pass (`bf16_stages`) lays the rounded centroids out
//   once per call as swizzled K-major stages of 256 centroids x 64 bf16
//   columns (32 KiB; zero past K and d) and gives c2 padded with +inf past
//   K. The producer warp (warp 8) streams the stages through a ring of
//   kSlots slots with bulk copies and mbarriers, the same sequence for
//   every row block.
// - Product (warpgroups 0 and 1, 64 rows each): each stages its rows of
//   a 256-column chunk of x as bf16 (f32 rows rounded to nearest even,
//   bf16 rows as they are, 0 past n and d; where d <= 256 once per block,
//   past it per K tile and chunk: `kOneChunk`, a kernel each) behind its
//   own named barrier, summing each row's ‖x‖² at the row's dtype on the
//   way, and per k-step of 16 columns issues one `wgmma` m64n256k16 bf16
//   product into 128 f32 accumulators a thread. After each K tile the champion fold reads the
//   accumulators in registers (champion.cuh's `better`: the smallest
//   index among equal minima, a later tile only on strict <). The block's
//   labels, minima and ‖x‖² go to one of two buffers.
// - Accumulate (warps 9-11), one block behind the product, so the two
//   overlap: the block's rows are grouped by label (`group_rows`); each
//   warp takes whole labels, kSegsPerPass at once, loads the workspace
//   row once, adds the group's rows in row order at their own dtype and
//   stores it once. Counts are the group sizes, one lane a group, so a
//   pass's count updates are in flight together. Each row's SSE term is
//   its minimum plus ‖x‖², the reference's function; the block's terms go
//   through a fixed f64 tree.
// Each CTA adds into its own (K, d) slice of a (G, K, d) f32 workspace
// with integer counts and an f64 SSE partial; lloyd_reduce.cuh sums the
// slices in slice order. No float atomics: two runs are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "champion.cuh"
#include "lloyd_reduce.cuh"
#include "wgmma.cuh"

namespace {

using namespace tdc;

constexpr int kBM = 128;         // rows per block: two warpgroups of 64
constexpr int kBN = 256;         // centroids per K tile (one m64n256)
constexpr int kColBlock = 64;    // bf16 columns per swizzled tile row
constexpr int kChunkBlocks = 4;  // column blocks per staged x chunk
constexpr int kSlots = 4;        // centroid stages in the ring
constexpr int kConsumers = 256;  // the product's two warpgroups
constexpr int kProducerWarp = kConsumers / 32;
constexpr int kAccWarps = 3;  // the accumulate's warps, after the producer
constexpr int kAccThreads = 32 * kAccWarps;
constexpr int kB5Threads = kConsumers + 32 + kAccThreads;
constexpr int kStageElems = kBN * kColBlock;                // 32 KiB
constexpr int kSlabElems = kChunkBlocks * 64 * kColBlock;  // 32 KiB
constexpr int kSkip = 0x7fffffff;  // label of a row past n
constexpr int kSegsPerPass = 4;    // labels a warp accumulates at once

// 197 KiB, one CTA per SM.
struct __align__(1024) Bf16Smem {
  __nv_bfloat16 xs[2][kSlabElems];  // [warpgroup][column block][64][64]
  __nv_bfloat16 ring[kSlots][kStageElems];
  unsigned long long full[kSlots];   // a stage has landed
  unsigned long long empty[kSlots];  // the product is done with a slot
  unsigned long long ready[2];  // a block's labels are written
  unsigned long long freed[2];  // the accumulate is done with them
  int lab[2][kBM];
  float best[2][kBM];  // the row's minimum, c2 − 2·x̃·c̃
  float x2[2][kBM];    // the row's ‖x‖²
  float x2_new[kBM];   // ‖x‖² of the rows being staged
  unsigned char order[kBM];    // rows grouped by label, stably
  unsigned char seg[kBM + 1];  // group starts in `order`
  int nseg;
  unsigned heads[kBM / 32];  // ballots of group heads,
  unsigned live[kBM / 32];   // and of rows with a label < K
};

// K padded to the K tile: the rows of every stage.
__host__ __device__ inline int padded_k(int k) {
  return (k + kBN - 1) / kBN * kBN;
}
__host__ __device__ inline int col_blocks(int d) {
  return (d + kColBlock - 1) / kColBlock;
}

// Floats of the per-call scratch: the stages (bf16, two to a float),
// then c2 padded to the K tile.
inline long long scratch_floats(int k, int d) {
  return (long long)padded_k(k) * col_blocks(d) * kColBlock / 2 + padded_k(k);
}

// One thread per (row j < K padded, column block cb, 16-byte chunk q):
// stage (j / 256, cb) in order of K tile, then column block.
__global__ void bf16_stages(const __nv_bfloat16* __restrict__ cb_in,
                            const float* __restrict__ c2, int k, int d,
                            __nv_bfloat16* __restrict__ stages,
                            float* __restrict__ c2p) {
  const int ncb = col_blocks(d);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)padded_k(k) * ncb * 8) return;
  const int q = (int)(i % 8);
  const int cb = (int)((i / 8) % ncb);
  const int j = (int)(i / (8 * ncb));
  alignas(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int col = cb * kColBlock + 8 * q + e;
    v[e] = (j < k && col < d) ? cb_in[(long long)j * d + col]
                              : __float2bfloat16_rn(0.f);
  }
  __nv_bfloat16* stage =
      stages + ((long long)(j / kBN) * ncb + cb) * kStageElems;
  *reinterpret_cast<uint4*>(stage + swizzle_col_bf16(j % kBN, 8 * q)) =
      *reinterpret_cast<const uint4*>(v);
  if (cb == 0 && q == 0) c2p[j] = j < k ? c2[j] : CUDART_INF_F;
}

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) {
  return v;
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Eight columns [col, col + 8) of row `row` as bf16, 0 past n and d, and
// the sum of their squares at the row's own dtype (f32 unrounded, bf16
// widened), in column order. kVec: 16-byte loads (f32 rows: d % 4 == 0;
// bf16 rows: d % 8 == 0; the base 16-byte aligned).
template <typename T, bool kVec>
__device__ __forceinline__ uint4 load8_bf16(const T* __restrict__ x,
                                            long long n, int d,
                                            long long row, int col,
                                            float& sq) {
  alignas(16) T in[8];
  if constexpr (kVec) {
    constexpr int kPer = 16 / (int)sizeof(T);  // elements per 16 bytes
#pragma unroll
    for (int h = 0; h < 8 / kPer; ++h) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (row < n && col + kPer * h < d)
        u = *reinterpret_cast<const uint4*>(x + row * d + col + kPer * h);
      *reinterpret_cast<uint4*>(in + kPer * h) = u;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      in[e] = (row < n && col + e < d) ? x[row * d + col + e] : T(0.f);
    }
  }
  alignas(16) __nv_bfloat16 out[8];
  sq = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float v = to_f32(in[e]);
    sq = fmaf(v, v, sq);
    out[e] = to_bf16(in[e]);
  }
  return *reinterpret_cast<const uint4*>(out);
}

// Stages columns [64·cb0, 64·(cb0 + nb)) of the calling warpgroup's 64
// rows of the block at row0 into its half of the x buffer as bf16, 0
// past n and d. With `norms`, the staged values' squares at the rows' own
// dtype go to x2_new (added where a column block past the first is
// staged): each row's 8 lanes (bits 0-2 of the lane) add their parts in a
// fixed tree. kLive: the accumulators are live, so one load is in flight
// and the parts are added per column block; else eight, and the parts
// are summed in registers first. Between the group's named barriers.
template <typename T, bool kVec, bool kLive>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x,
                                           long long n, int d,
                                           long long row0, int cb0, int nb,
                                           Bf16Smem& sm, bool norms) {
  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, cw = (tid / 32) % 4;
  const int q = lane % 8, rr = lane / 8;
  auto stage = [&](int b, int r4) {
    const int rl = r4 * 16 + cw * 4 + rr;
    float s;
    const uint4 v = load8_bf16<T, kVec>(x, n, d, row0 + 64 * wg + rl,
                                        (cb0 + b) * kColBlock + 8 * q, s);
    *reinterpret_cast<uint4*>(
        &sm.xs[wg][b * 64 * kColBlock + swizzle_col_bf16(rl, 8 * q)]) = v;
    return s;
  };
  auto add_norm = [&](float t, int r4, bool first) {
#pragma unroll
    for (int off = 1; off <= 4; off <<= 1)
      t += __shfl_xor_sync(0xffffffffu, t, off);
    float& out = sm.x2_new[64 * wg + r4 * 16 + cw * 4 + rr];
    if (q == 0) out = first ? t : out + t;
  };
  if constexpr (kLive) {
#pragma unroll 1
    for (int i = 0; i < 4 * nb; ++i) {
      const float s = stage(i / 4, i % 4);
      if (norms) add_norm(s, i % 4, cb0 + i / 4 == 0);
    }
  } else {
    float sq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int b = 0; b < nb; ++b) {
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) sq[r4] += stage(b, r4);
    }
    if (norms) {
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) add_norm(sq[r4], r4, cb0 == 0);
    }
  }
}

// kW columns of a row, widened to f32 (kW = 4: one 16- or 8-byte load).
template <typename T, bool kVec>
struct Cols {
  using V = typename std::conditional<kVec, float4, float>::type;
  static __device__ __forceinline__ V load(const T* __restrict__ p) {
    if constexpr (!kVec) {
      return to_f32(*p);
    } else if constexpr (std::is_same<T, float>::value) {
      return *reinterpret_cast<const float4*>(p);
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      const float2 lo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.y));
      return make_float4(lo.x, lo.y, hi.x, hi.y);
    }
  }
};

__device__ __forceinline__ void add(float& a, float x) { a += x; }
__device__ __forceinline__ void add(float4& a, const float4& x) {
  a.x += x.x;
  a.y += x.y;
  a.z += x.z;
  a.w += x.w;
}

// The accumulate of one block (warps 9-11): group the rows by label, add
// each group into the CTA's workspace slice and count it, and return the
// block's SSE terms, min + ‖x‖², summed (a fixed f64 tree; the value of
// warp 9's lanes).
template <typename T, bool kVec>
__device__ __forceinline__ double accumulate_block(
    const T* __restrict__ x, long long row0, int rows, int k, int d,
    const int* lab, const float* best, const float* x2,
    float* __restrict__ my_ws, int* __restrict__ my_cnt, Bf16Smem& sm) {
  const int at = threadIdx.x - kConsumers - 32, lane = at % 32, aw = at / 32;
  group_rows<kBM, kAccWarps>(lab, k, at, 3, sm);
  // Each warp takes every 3rd group, kSegsPerPass at a time: the
  // workspace row of the group's label is read once, the group's rows are
  // added in row order, and it is written once; the kSegsPerPass rows are
  // independent, so their loads are all in flight together.
  constexpr int kW = kVec ? 4 : 1;
  using C = Cols<T, kVec>;
  using V = typename C::V;
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
      V a[kSegsPerPass], xv[kSegsPerPass];
#pragma unroll
      for (int u = 0; u < kSegsPerPass; ++u) {
        a[u] = xv[u] = V{};
        if (gl[u] >= 0 && in) {
          a[u] = *reinterpret_cast<const V*>(my_ws + (long long)gl[u] * d + j);
          xv[u] = C::load(x + (row0 + sm.order[p0[u]]) * d + j);
        }
      }
#pragma unroll
      for (int u = 0; u < kSegsPerPass; ++u) {
        if (gl[u] < 0 || !in) continue;
        add(a[u], xv[u]);
        for (int p = p0[u] + 1; p < p1[u]; ++p)
          add(a[u], C::load(x + (row0 + sm.order[p]) * d + j));
        *reinterpret_cast<V*>(my_ws + (long long)gl[u] * d + j) = a[u];
      }
    }
    // Lane u counts group u: the labels differ, so the read-modify-writes
    // are independent and all in flight at once.
    int cl = -1, cn = 0;
#pragma unroll
    for (int u = 0; u < kSegsPerPass; ++u) {
      if (lane == u) {
        cl = gl[u];
        cn = p1[u] - p0[u];
      }
    }
    if (cl >= 0) my_cnt[cl] += cn;
  }
  named_barrier(3, kAccThreads);
  double t = 0.0;  // the block's SSE terms: a fixed f64 tree
  if (aw == 0) {
#pragma unroll
    for (int q = 0; q < kBM / 32; ++q) {
      const int r = lane + 32 * q;
      // A row with no finite candidate keeps NaN, as min + ‖x‖² does.
      if (r < rows) {
        t += lab[r] < k ? (double)(best[r] + x2[r])
                        : (double)__int_as_float(0x7fc00000);
      }
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      t += __shfl_xor_sync(0xffffffffu, t, off);
  }
  named_barrier(3, kAccThreads);  // order and seg are free for the next
  return t;
}

// T is the row dtype (float or __nv_bfloat16). stages and c2p come from
// the pre-pass; ws is (grid, K, d), cnt (grid, K); labels may be null.
// kOneChunk: d fits one staged chunk (d <= 256), so the rows are staged
// once per block and never while the accumulators are live; a kernel of
// its own, so that the restaging path's registers do not constrain it.
template <typename T, bool kVec, bool kOneChunk>
__global__ void __launch_bounds__(kB5Threads, 1)
    lloyd_bf16_tc_kernel(const T* __restrict__ x,
                         const __nv_bfloat16* __restrict__ stages,
                         const float* __restrict__ c2p, long long n, int k,
                         int d, float* __restrict__ ws, int* __restrict__ cnt,
                         double* __restrict__ sse_part,
                         int* __restrict__ labels) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Bf16Smem& sm = *reinterpret_cast<Bf16Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long kd = (long long)k * d;
  float* my_ws = ws + blockIdx.x * kd;
  int* my_cnt = cnt + (long long)blockIdx.x * k;
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
  for (long long i = tid; i < kd; i += kB5Threads) my_ws[i] = 0.f;
  for (int i = tid; i < k; i += kB5Threads) my_cnt[i] = 0;
  __syncthreads();

  const int ncb = col_blocks(d);
  const int nkt = (k + kBN - 1) / kBN;
  const long long nblocks = (n + kBM - 1) / kBM;

  if (warp == kProducerWarp) {
    if (lane == 0) {
      unsigned g = 0;
      for (long long b = blockIdx.x; b < nblocks; b += gridDim.x) {
        const long long nb = b + gridDim.x;
        if (kVec && nb < nblocks) {
          prefetch_l2(x + nb * kBM * d,
                      (unsigned)(min((long long)kBM, n - nb * kBM) * d *
                                 (long long)sizeof(T)));
        }
        for (int kt = 0; kt < nkt; ++kt) {
          for (int cb = 0; cb < ncb; ++cb, ++g) {
            const int slot = g % kSlots;
            mbar_wait(&sm.empty[slot], ((g / kSlots) & 1) ^ 1);
            const unsigned bytes = kStageElems * 2;
            mbar_expect_tx(&sm.full[slot], bytes);
            bulk_copy_g2s(sm.ring[slot],
                          stages + ((long long)kt * ncb + cb) * kStageElems,
                          bytes, &sm.full[slot]);
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
      const long long row0 = b * kBM;
      const int rows = (int)min((long long)kBM, n - row0);
      mbar_wait(&sm.ready[i & 1], (i >> 1) & 1);
      sse += accumulate_block<T, kVec>(x, row0, rows, k, d, sm.lab[i & 1],
                                       sm.best[i & 1], sm.x2[i & 1], my_ws,
                                       my_cnt, sm);
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
  float acc[kBN / 2];
  for (long long b = blockIdx.x; b < nblocks; b += gridDim.x, ++i) {
    const long long row0 = b * kBM;
    const int rows = (int)min((long long)kBM, n - row0);
    if (kOneChunk) {  // the group's rows, once: its products are done
      named_barrier(1 + wg, 128);
      stage_rows<T, kVec, false>(x, n, d, row0, 0, ncb, sm, true);
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
      for (int e = 0; e < kBN / 2; ++e) acc[e] = 0.f;
      int prev = -1;
      for (int cb = 0; cb < ncb; ++cb, ++g) {
        if (!kOneChunk && cb % kChunkBlocks == 0) {
          // A new x chunk: the group's `wgmma`s on its half are done.
          if (prev >= 0) {
            wgmma_wait<0>();
            warp_arrive(&sm.empty[prev]);
            prev = -1;
          }
          named_barrier(1 + wg, 128);
          // ‖x‖² is summed while the first K tile stages the chunks.
          stage_rows<T, kVec, true>(x, n, d, row0, cb,
                                    min(kChunkBlocks, ncb - cb), sm, kt == 0);
          fence_proxy_async();
          named_barrier(1 + wg, 128);
        }
        const __nv_bfloat16* xa =
            &sm.xs[wg][(cb % kChunkBlocks) * 64 * kColBlock];
        const int ks = min(kColBlock / 16, (d - cb * kColBlock + 15) / 16);
        const int slot = g % kSlots;
        mbar_wait(&sm.full[slot], (g / kSlots) & 1);
        __syncwarp();  // `wgmma` is aligned: the warp converged
        const __nv_bfloat16* cs = sm.ring[slot];
        wgmma_fence();
        fence_operands(acc);
        for (int kk = 0; kk < ks; ++kk) {
          wgmma_m64n256k16_bf16(acc, sw128_desc(xa + 16 * kk),
                                sw128_desc(cs + 16 * kk), 1);
        }
        wgmma_commit();
        fence_operands(acc);
        wgmma_wait<1>();  // the previous stage's products are done
        if (prev >= 0) warp_arrive(&sm.empty[prev]);
        prev = slot;
      }
      wgmma_wait<0>();
      warp_arrive(&sm.empty[prev]);
      fence_operands(acc);
      // The fold: this thread's 64 columns of the K tile for its two rows,
      // in column order, by champion.cuh's rule (the smallest index among
      // equal minima; a later tile only on strict <).
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = kt * kBN + 8 * j + 2 * t4;
        const float2 cc = __ldg(reinterpret_cast<const float2*>(c2p + col));
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
    // row, once the accumulate is done with this buffer's last use (and
    // the group has written x2_new).
    mbar_wait(&sm.freed[i & 1], ((i >> 1) & 1) ^ 1);
    named_barrier(1 + wg, 128);
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
        sm.best[i & 1][r] = best[h];
        sm.x2[i & 1][r] = sm.x2_new[r];
        if (labels && live) labels[row0 + r] = barg[h];
      }
    }
    warp_arrive(&sm.ready[i & 1]);
  }
}

template <typename T, bool kVec, bool kOneChunk>
cudaError_t launch_main(const T* x, const __nv_bfloat16* stages,
                        const float* c2p, long long n, int k, int d,
                        int grid, float* ws, int* cnt, double* sse_part,
                        int* labels, cudaStream_t s) {
  auto kernel = lloyd_bf16_tc_kernel<T, kVec, kOneChunk>;
  const int smem = (int)sizeof(Bf16Smem);  // past 48 KB: dynamic only
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kB5Threads, smem, s>>>(x, stages, c2p, n, k, d, ws, cnt,
                                        sse_part, labels);
  return cudaGetLastError();
}

// The pre-pass, the main kernel and the slice reduce.
template <typename T>
int launch_bf16(const T* x, const __nv_bfloat16* cb, const float* c2,
                long long n, int k, int d, int grid, float* scratch,
                float* ws, int* cnt, double* sse_part, float* sums,
                float* counts, float* sse, int* labels, cudaStream_t s) {
  auto* stages = reinterpret_cast<__nv_bfloat16*>(scratch);
  float* c2p = scratch + scratch_floats(k, d) - padded_k(k);
  const long long items = (long long)padded_k(k) * col_blocks(d) * 8;
  bf16_stages<<<(unsigned)((items + 255) / 256), 256, 0, s>>>(cb, c2, k, d,
                                                              stages, c2p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int kVecCols = 16 / (int)sizeof(T);  // columns per 16 bytes
  const bool vec = d % kVecCols == 0 &&
                   reinterpret_cast<unsigned long long>(x) % 16 == 0;
  const bool one = col_blocks(d) <= kChunkBlocks;
  auto run = vec ? (one ? launch_main<T, true, true>
                        : launch_main<T, true, false>)
                 : (one ? launch_main<T, false, true>
                        : launch_main<T, false, false>);
  err = run(x, stages, c2p, n, k, d, grid, ws, cnt, sse_part, labels, s);
  if (err != cudaSuccess) return (int)err;
  return tdc::launch_lloyd_reduce(ws, cnt, nullptr, sse_part, grid, k, d,
                                  sums, counts, sse, s);
}

}  // namespace

// B5: x is (n, d) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); cb the (k, d)
// centroids rounded to bf16; c2 (k,) f32; scratch
// (tdc_lloyd_bf16_scratch_floats(k, d) floats: the stages and the padded
// c2), ws (grid, k, d) f32, cnt (grid, k) int32 and sse_part (grid,) f64
// are the workspace; labels (n,) int32 or null.
extern "C" int tdc_lloyd_stats_fused_bf16(
    const void* x, int x_bf16, const void* cb, const float* c2, long long n,
    int k, int d, int grid, float* scratch, float* ws, int* cnt,
    double* sse_part, float* sums, float* counts, float* sse, int* labels,
    void* stream) {
  const auto* c = static_cast<const __nv_bfloat16*>(cb);
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16) {
    return launch_bf16(static_cast<const __nv_bfloat16*>(x), c, c2, n, k, d,
                       grid, scratch, ws, cnt, sse_part, sums, counts, sse,
                       labels, s);
  }
  return launch_bf16(static_cast<const float*>(x), c, c2, n, k, d, grid,
                     scratch, ws, cnt, sse_part, sums, counts, sse, labels,
                     s);
}

// Floats of B5's per-call scratch.
extern "C" int64_t tdc_lloyd_bf16_scratch_floats(int k, int d) {
  return scratch_floats(k, d);
}
