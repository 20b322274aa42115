// The distance product on the TF32 tensor cores in 3xTF32, shared by B2
// (`distance_argmin`, lloyd_kernels.cu) and B7 (`fuzzy_normalizer`,
// fuzzy_kernels.cu), and the split-centroid layout that B1 and B4
// (`lloyd_fused_tc_kernel`, lloyd_kernels.cu) stream too.
//
// Centroids: a pre-pass (`launch_centroid_split`) splits them once per
// call into TF32 halves, hi = rna(c) and lo = rna(c − hi), laid out as the
// swizzled 32-column tiles that `wgmma` reads, one 256-centroid K tile and
// one half at a time (a "stage", 32 KiB), and gives c2 = ‖c‖², +inf past K.
//
// `tc_distance` is one CTA of three warpgroups per SM, G = min(SMs, row
// blocks) CTAs, each taking every G-th 128-row block:
// - warpgroup 2 is the producer: it hands its registers to the others
//   (`setmaxnreg`: 40 a thread, the product's 232), and one thread of it
//   streams the centroid stages through a ring of kDistSlots shared-memory
//   slots with bulk copies and mbarriers, the same sequence for every row
//   block;
// - warpgroups 0 and 1 own 64 rows each. Per K tile and 32-column block of
//   x they split their rows' columns into TF32 halves into one of
//   kDistBufs shared buffers (the next two column blocks' loads in flight
//   in registers meanwhile) and issue `wgmma` m64n256k8 for x_hi·c_hi,
//   x_lo·c_hi and x_hi·c_lo (x_lo·c_lo, ~2^-22 of the product, is
//   dropped) into 128 f32 accumulators a thread. After each K tile the
//   caller's fold reads the accumulators in registers.
// At d = 768 a 128-row block of x split into its halves is 786 KB, far
// more than shared memory, so x is read again from L2 for every K tile
// (64 at K = 16,384): by the warpgroup's own threads, two column blocks
// ahead, three buffers deep, so that a buffer is rewritten only after
// every warp of the group has waited for the products that read it.
// No accumulate warps: the registers go to the accumulators, the x
// loads in flight and the fold's state. (Nine warps, a producer warp and
// no `setmaxnreg`, cap a thread at 168 registers: an SM quarter's
// register file holds three of the warps. B2 and B7 spilled there.)
// B1 and B4 keep their own loop (`lloyd_fused_tc_kernel`): up to d = 128
// they stage x once a block, into 128 KiB that do not fit beside this
// ring (restaging it every K tile cost B2 5% at their shape, PERF.md),
// and their accumulate warps would share the producer's warpgroup and,
// `setmaxnreg` acting on a whole warpgroup, its 40 registers.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "champion.cuh"
#include "tf32_accum.cuh"
#include "wgmma.cuh"

namespace tdc {

constexpr int kTcBM = 128;  // rows per block: two warpgroups of 64
constexpr int kTcBN = 256;  // centroids per K tile (one m64n256 per k-step)
constexpr int kColBlock = 32;  // columns per swizzled tile row (128 bytes)
constexpr int kStageFloats = kTcBN * kColBlock;  // 32 KiB

// Rows of the split-centroid buffer: K padded to 8 (one swizzle atom).
__host__ __device__ inline int split_rows(int k) { return (k + 7) / 8 * 8; }

// Floats of the split centroids: hi and lo of every 32-column block of
// every row. The per-call scratch holds them, then c2 padded to the K tile.
inline long long split_floats(int k, int d) {
  return 2LL * kColBlock * ((d + kColBlock - 1) / kColBlock) * split_rows(k);
}

// Floats of the per-call scratch of B1, B2, B4 and B7: the split
// centroids, then c2 padded to the K tile.
inline long long centroid_scratch_floats(int k, int d) {
  return split_floats(k, d) + (long long)(k + kTcBN - 1) / kTcBN * kTcBN;
}

// Float offset of stage (kt, cb, half) in the split-centroid buffer: the
// K tiles in order, in each the column blocks, in each hi then lo, each a
// tile of R rows (256, fewer in the last K tile).
__device__ __forceinline__ long long stage_offset(int kt, int cb, int half,
                                                  int ncb, int rows) {
  return (long long)kt * kTcBN * 2 * kColBlock * ncb +
         (long long)(2 * cb + half) * rows * kColBlock;
}

__device__ __forceinline__ int tile_rows(int kt, int k8) {
  return min(kTcBN, k8 - kt * kTcBN);
}

// The pre-pass into `scratch` (centroid_scratch_floats(k, d) floats): the
// split centroids, then c2. Defined in lloyd_kernels.cu.
int launch_centroid_split(const float* c, int k, int d, float* scratch,
                          cudaStream_t s);

constexpr int kDistSlots = 4;  // centroid stages in the ring: two blocks
constexpr int kDistBufs = 3;   // x column blocks staged per warpgroup
constexpr int kDistConsumers = 256;
constexpr int kDistProducerWarp = kDistConsumers / 32;
constexpr int kDistThreads = kDistConsumers + 128;
// Registers a thread: 128 x 40 + 256 x 232 fit the SM's 65,536.
constexpr int kDistProducerRegs = 40;
constexpr int kDistConsumerRegs = 232;
constexpr int kXTile = 64 * kColBlock;  // a group's rows of one block

// 227 KB, one CTA per SM. The per-row state serves the folds' epilogues.
struct __align__(1024) DistSmem {
  float xs[kDistBufs][2][2][kXTile];  // [buffer][hi, lo][warpgroup]
  float ring[kDistSlots][kStageFloats];
  unsigned long long full[kDistSlots];   // a stage has landed
  unsigned long long empty[kDistSlots];  // the product is done with a slot
  union {
    double s[kTcBM];  // B7: a row's Σ inv
    int lab2[kTcBM];  // B2: a row's runner-up
  };
  float x2[kTcBM];   // B7: a row's ‖x‖²
  float val[kTcBM];  // B7: the champion's inv as summed; B2: the gap
  int lab[kTcBM];    // a row's champion
};

// The calling thread's share of column block cb of its warpgroup's 64
// rows of the block at row0: rows 16·i + 4·w + lane / 8 of the group (i <
// 4, w its warp in the group), columns 32·cb + 4·(lane % 8)..+3; 0 past n
// and d.
template <bool kVec>
__device__ __forceinline__ void load_x_block(const float* __restrict__ x,
                                             long long n, int d,
                                             long long row0, int cb,
                                             float4 (&v)[4]) {
  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, cw = (tid / 32) % 4;
  const int col = cb * kColBlock + 4 * (lane % 8);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = row0 + 64 * wg + 16 * i + 4 * cw + lane / 8;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n && col < d) {
      const float* p = x + row * d + col;
      if (kVec) {
        t = __ldg(reinterpret_cast<const float4*>(p));
      } else {
        t.x = __ldg(p);
        if (col + 1 < d) t.y = __ldg(p + 1);
        if (col + 2 < d) t.z = __ldg(p + 2);
        if (col + 3 < d) t.w = __ldg(p + 3);
      }
    }
    v[i] = t;
  }
}

// Splits load_x_block's values into TF32 halves, stored into the group's
// swizzled hi and lo tiles.
__device__ __forceinline__ void store_x_block(const float4 (&v)[4],
                                              float* hi, float* lo) {
  const int lane = threadIdx.x % 32, cw = (threadIdx.x / 32) % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int at = swizzle_col(16 * i + 4 * cw + lane / 8, 4 * (lane % 8));
    unsigned h[4], l[4];
    split_tf32(v[i].x, h[0], l[0]);
    split_tf32(v[i].y, h[1], l[1]);
    split_tf32(v[i].z, h[2], l[2]);
    split_tf32(v[i].w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The product over every 128-row block of this CTA. Each consumer thread
// calls begin(row0) before the product of the block at row0, tile(kt,
// acc) after each K tile's and end(row0) after the block's last. In the
// accumulator layout thread (warp w of group wg, lane 4·gq + t4) holds
// rows 64·wg + 16·w + gq and + 8 of the block, columns 8j + 2·t4 and + 1
// of the K tile (j < 32): acc[4j + 2h + e] is row h, column e
// (`for_each_entry`).
template <bool kVec, class Begin, class Tile, class End>
__device__ __forceinline__ void tc_distance(const float* __restrict__ x,
                                            const float* __restrict__ split,
                                            long long n, int k, int d,
                                            DistSmem& sm, Begin begin,
                                            Tile tile, End end) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid == 0) {
    if (smem_addr(&sm) % 1024 != 0) __trap();  // the swizzle needs it
    for (int s = 0; s < kDistSlots; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kDistConsumers / 32);
    }
    mbar_init_fence();
  }
  // The last K tile's stages fill fewer rows than a product reads; the
  // rest of a slot keeps what an earlier stage left: finite, once zeroed
  // here. So a column past K, where c2 is +inf, scores +inf in every fold
  // and is never a candidate.
  for (int i = tid; i < kDistSlots * kStageFloats / 4; i += kDistThreads)
    reinterpret_cast<float4*>(sm.ring[0])[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  fence_proxy_async();
  __syncthreads();

  const int ncb = (d + kColBlock - 1) / kColBlock;
  const int nkt = (k + kTcBN - 1) / kTcBN;
  const int k8 = split_rows(k);
  const long long nblocks = (n + kTcBM - 1) / kTcBM;

  if (warp >= kDistProducerWarp) {
    setmaxnreg_dec<kDistProducerRegs>();
    if (warp == kDistProducerWarp && lane == 0) {
      unsigned g = 0;
      for (long long b = blockIdx.x; b < nblocks; b += gridDim.x) {
        for (int kt = 0; kt < nkt; ++kt) {
          const int rows = tile_rows(kt, k8);
          for (int cb = 0; cb < ncb; ++cb) {
            for (int half = 0; half < 2; ++half, ++g) {
              const int slot = g % kDistSlots;
              mbar_wait(&sm.empty[slot], ((g / kDistSlots) & 1) ^ 1);
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
  setmaxnreg_inc<kDistConsumerRegs>();

  const int wg = warp / 4;
  const int nxb = nkt * ncb;  // column blocks a row block stages
  unsigned g = 0, jb = 0;  // stages and column blocks consumed
  float acc[kTcBN / 2];
  float4 xa[4], xn[4];  // x of the next two column blocks, in flight
  for (long long b = blockIdx.x; b < nblocks; b += gridDim.x) {
    const long long row0 = b * kTcBM;
    begin(row0);
    load_x_block<kVec>(x, n, d, row0, 0, xa);
    if (nxb > 1) load_x_block<kVec>(x, n, d, row0, 1 % ncb, xn);
    int li = 0;  // the block's column blocks staged so far
    for (int kt = 0; kt < nkt; ++kt) {
      // Zeroed here rather than by the first product's scale-d: between
      // K tiles the fold reads them.
#pragma unroll
      for (int e = 0; e < kTcBN / 2; ++e) acc[e] = 0.f;
      int prev = -1;
      for (int cb = 0; cb < ncb; ++cb, ++jb, ++li) {
        // The products that last read this buffer (three column blocks
        // back) are done: every warp of the group waited for them before
        // the barrier of the block after them.
        float* xh = sm.xs[jb % kDistBufs][0][wg];
        float* xl = sm.xs[jb % kDistBufs][1][wg];
        store_x_block(xa, xh, xl);
        // Two column blocks ahead (x does not depend on the K tile): an L2
        // miss, x being read again every K tile, outlasts one block's
        // products.
#pragma unroll
        for (int i = 0; i < 4; ++i) xa[i] = xn[i];
        if (li + 2 < nxb) {
          load_x_block<kVec>(x, n, d, row0, (li + 2) % ncb, xn);
        }
        fence_proxy_async();
        named_barrier(1 + wg, 128);
        const int ks = min(kColBlock / 8, (d - cb * kColBlock + 7) / 8);
        const int sh = g % kDistSlots, sl = (g + 1) % kDistSlots;
        mbar_wait(&sm.full[sh], (g / kDistSlots) & 1);
        mbar_wait(&sm.full[sl], ((g + 1) / kDistSlots) & 1);
        g += 2;
        __syncwarp();  // `wgmma` is aligned: the warp converged
        const float* ch = sm.ring[sh];
        const float* cl = sm.ring[sl];
        wgmma_fence();
        fence_operands(acc);
        for (int kk = 0; kk < ks; ++kk) {
          const unsigned long long db = sw128_desc(ch + 8 * kk);
          wgmma_m64n256k8_tf32(acc, sw128_desc(xh + 8 * kk), db, 1);
          wgmma_m64n256k8_tf32(acc, sw128_desc(xl + 8 * kk), db, 1);
        }
        for (int kk = 0; kk < ks; ++kk) {
          wgmma_m64n256k8_tf32(acc, sw128_desc(xh + 8 * kk),
                               sw128_desc(cl + 8 * kk), 1);
        }
        wgmma_commit();
        fence_operands(acc);
        wgmma_wait<1>();  // the previous column block's products are done
        if (prev >= 0) {
          warp_arrive(&sm.empty[prev]);
          warp_arrive(&sm.empty[prev + 1]);
        }
        prev = sh;  // kDistSlots is even: the lo stage is in slot sh + 1
      }
      wgmma_wait<0>();
      warp_arrive(&sm.empty[prev]);
      warp_arrive(&sm.empty[prev + 1]);
      fence_operands(acc);
      tile(kt, acc);
    }
    end(row0);
  }
}

// Calls f(h, col, c2[col], a) for each of the calling thread's
// accumulator entries of K tile kt: row h (0 or 1, see `tc_distance`),
// column col of all K (< the K tiles' padded width; c2 is +inf past K),
// its dot product a. A row's columns come in increasing order, so a
// strict < keeps the smallest index among the thread's equal minima.
template <class F>
__device__ __forceinline__ void for_each_entry(
    int kt, const float (&acc)[kTcBN / 2], const float* __restrict__ c2,
    F f) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < kTcBN / 8; ++j) {
    const int col = kt * kTcBN + 8 * j + 2 * t4;
    const float2 cc = __ldg(reinterpret_cast<const float2*>(c2 + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      f(h, col, cc.x, acc[4 * j + 2 * h]);
      f(h, col + 1, cc.y, acc[4 * j + 2 * h + 1]);
    }
  }
}

// The two best (value, index) pairs across the quad (lanes differing in
// bits 0-1), with champion.cuh's rule: the same on every lane.
__device__ __forceinline__ void top2_quad(float& b1, int& j1, float& b2,
                                          int& j2) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const float o1 = __shfl_xor_sync(0xffffffffu, b1, off);
    const int i1 = __shfl_xor_sync(0xffffffffu, j1, off);
    const float o2 = __shfl_xor_sync(0xffffffffu, b2, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, j2, off);
    if (better(o1, i1, b1, j1)) {  // the other's best leads
      if (better(b1, j1, o2, i2)) {
        b2 = b1;
        j2 = j1;
      } else {
        b2 = o2;
        j2 = i2;
      }
      b1 = o1;
      j1 = i1;
    } else if (better(o1, i1, b2, j2)) {
      b2 = o1;
      j2 = i1;
    }
  }
}

// The champion across the quad (lanes differing in bits 0-1), with
// champion.cuh's rule; `carry` travels with it.
__device__ __forceinline__ void champion_quad(float& best, int& barg,
                                              float& carry) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oj = __shfl_xor_sync(0xffffffffu, barg, off);
    const float oc = __shfl_xor_sync(0xffffffffu, carry, off);
    if (better(ov, oj, best, barg)) {
      best = ov;
      barg = oj;
      carry = oc;
    }
  }
}

// Row r of the block (0..127) that the calling thread's 16-lane group
// serves in pass i (< 8) of a block's per-row epilogue: the group's
// warpgroup's rows, eight at a time.
__device__ __forceinline__ int epilogue_row(int i) {
  const int tid = threadIdx.x;
  return 64 * (tid / 128) + 8 * i + (tid % 128) / 16;
}

// The sum over the 16 lanes that share a row (lanes differing in bits
// 0-3), in a fixed butterfly order; every one of them gets it.
__device__ __forceinline__ float row_lanes_sum(float v) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace tdc
