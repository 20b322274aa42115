// B10 `lloyd_stats_tall` and B11 `fuzzy_stats_tall` for Hopper (sm_90a):
// the Lloyd and fuzzy sufficient statistics over feature-major points,
// xt (d, N), f32 or bf16.
//
// B10 replaces `lloyd_stats_tall` (tdc_tpu/ops/tall.py:132, `pallas_call`
// at :172; body `_tall_lloyd_kernel` :75). Per column j and centroid k:
//   x2 = Σ_f x_fj²,  cross = Σ_f c_kf·x_fj (f32, f in increasing order),
//   d² = max((x2 − 2·cross) + c2_k, 0)
// the champion is the smallest index among equal minima (champion.cuh's
// `better()`), and the outputs are Σx (K, d), counts (K,) and the SSE Σ of
// the clamped minima, all f32. For bf16 columns the wrapper passes the
// centroids rounded to bf16 (and c2 of the rounded values), so every
// product c·x is exact in f32, as the reference's bf16 contraction is.
//
// B11 replaces `fuzzy_stats_tall` (tall.py:266, `pallas_call` at :299;
// body `_tall_fuzzy_kernel` :215): from the same d²,
//   inv = (d² + eps)^(−1/(m−1)),  u = inv / Σ_k inv,  μ = u^m
// and the outputs are Σμx (K, d), Σμ (K,) and Σμ·d² (), all f32. At m = 2
// the powers take the exact forms 1/v and u·u (what XLA compiles `** -1.0`
// and `** 2.0` to), as B6 does, with u = inv · (1/s); at any other m both
// forms take exp2 and log2 (`fuzzy_w`). The build uses no fast-math. The
// reference runs its accumulate at DEFAULT precision on a TPU; here it is
// f32, the result of its interpret mode.
//
// Bound on this card: bytes. At the reference sweep's shape (N = 10^8,
// d = 5, K = 15) one call reads 2.0 GB of f32 columns (0.597 ms at
// 3.35 TB/s), against 2·N·K·d = 1.5e10 flops for B10 (0.224 ms at 67
// TFLOP/s) and 4·N·K·d for B11 (0.448 ms). These are the port's first
// bandwidth-bound kernels. B10 also issues ~225 instructions a column
// (per centroid d FMAs, then v, the compare and two selects; per column
// the accumulate), ~0.7 ms of issue across the card at 10^8 columns, so
// the loads have to overlap the arithmetic.
//
// Design. Two forms for each kernel, chosen by shape.
//
// - B10's streaming form (d ≤ 8 and K·(d+1) ≤ kLloydMax = 144, the
//   reference sweep's shapes and past them). A bandwidth-bound kernel needs
//   ~25 KB of loads in flight per SM to stream at 3.35 TB/s; with one
//   scalar load per thread and feature (the earlier design) its occupancy,
//   capped by the per-thread accumulators, left 10 KB in flight on f32
//   columns and 5 KB on bf16. Here one persistent CTA per SM (8 or 12
//   consumer warps and a producer warp) walks column tiles of 128 columns
//   a consumer warp. The producer streams each tile's d feature rows into a
//   ring of shared-memory slots (as many as fit beside the accumulators,
//   at least two and 32 KiB: at K = 15, d = 5, 12 warps and 2 slots of f32
//   columns, 5 of bf16), one `cp.async.bulk` per row completing on the
//   slot's mbarrier; bf16 rows are copied as they are and widened in
//   registers. So the bytes in flight no longer depend on registers or
//   occupancy. A row that is not 16-byte aligned (N·itemsize % 16 ≠ 0, or
//   a misaligned base) is copied from its aligned-down address and read at
//   its offset; a tile whose aligned copy would leave the tensor (the first
//   and the last three, at most) is read from device memory directly. Each
//   consumer thread takes 4 adjacent columns of a tile (one 16- or 8-byte
//   shared load a feature row where the rows are aligned), releases the
//   slot as soon as they sit in registers, and scores them against the
//   centroids in groups of 4 (one 16-byte broadcast load of 4 centroids'
//   feature f serves 16 FMAs; K is padded to 4 with centroids whose c2 is
//   +inf, never taken). Per column and centroid the arithmetic is the
//   earlier design's: cross = Σ_f c·x and x2 = Σ_f x² as fmaf chains in
//   increasing f, v = (x2 − 2·cross) + c2. The earlier kernel took d² =
//   max(v, 0), the first centroid unconditionally and a later one on
//   strict <; here the running minimum is of v itself, from +inf, on
//   strict <, which gives the same index wherever that minimum is > 0 and
//   every v finite, and a column where it is not (a column on a centroid,
//   values near the f32 range) is scored again with the clamp out of line
//   (`lloyd_exact`). So the labels are bitwise the earlier kernel's, at
//   five instructions a centroid and column beside the d FMAs (the clamp
//   was one more). d is a template parameter: every loop over features is
//   unrolled to d. Each consumer thread keeps its own (K, d+1) accumulator
//   in shared memory, laid out [entry][thread] (a warp's updates fall in
//   32 distinct banks whatever the labels), and adds its live columns to
//   their champions' rows in column order; at the end the CTA sums its
//   accumulators in thread order (f64; the slice reduce rounds once). 12
//   consumer warps where their accumulators leave room for the ring, else
//   8 (ops/tall.py `lloyd_plan`); at 144 entries the 8-warp accumulators
//   still leave two slots and 32 KiB of f32 columns at every d ≤ 8. The
//   kernel is bound by its instructions, not its bytes: ~225 a column,
//   issued at 60–65% of the SM's rate (PERF.md).
// - B11's private form (d ≤ 8 and K·(d+1) ≤ 96): one thread per column,
//   a CTA of 256 threads walking column tiles of 256 in a grid-stride
//   loop, so a warp's loads of xt[f, j0:j0+32] coalesce. The column's d
//   features sit in registers and the next tile's are loaded while the
//   current one computes. The centroids are staged feature-major, so one
//   16-byte shared load serves 4 of them, and taken in register groups of
//   16; the feature loop is unrolled to 8 under a uniform guard f < d.
//   B11 keeps a column's d² and inv in registers from its first pass (s)
//   to its second (μ) where K ≤ 16, and recomputes them otherwise (its
//   powers: `fuzzy_w`). Its accumulate Σ_j μ_kj·x_fj and Σ_j μ_kj runs on
//   the tensor cores: each thread writes its column's μ and features (and
//   a ones column) to its warp's shared tiles, and the warp runs
//   `mma.sync` m16n8k8 over its 32 columns with the 3xTF32 split (B6's,
//   tf32_accum.cuh), whose f32 fragments add into f64 carries every 32
//   columns; the CTA sums its 8 warps' carries in warp order.
// - tile (every other shape): one thread per column, the column's
//   features in registers 8 at a time (wider d reloads its chunks from
//   L1); the centroids are staged once per CTA or, where K·d does not fit
//   32 KB, per K stage and column tile. Every CTA owns a (K, d) f32 slice
//   of a (G, K, d) workspace in device memory. B10 takes B1's accumulate:
//   per column tile the champions (champion.cuh's `better()`) go to shared
//   memory and one thread per feature adds the tile's columns, in column
//   order, into its champion's row; counts are integer atomics. B11 stages
//   μ for 32 centroids and x for 32 features of the tile in shared memory,
//   and each thread sums 4 (centroid, feature) entries over the tile's
//   columns in order, then adds them into the slice.
//
// Masked columns replace the reference's padded columns and their
// correction (tall.py:197-207, :326-334): a column past N adds nothing.
// Every sum has a fixed order: within a thread or a warp (columns in
// order), within a CTA (threads, warps or columns in order) and across
// CTAs (the G partials summed in slice order: `tall_lloyd_reduce` for
// B10's streaming form, in f64 and rounded once, lloyd_reduce.cuh for its
// tile form, `tall_fuzzy_reduce` for B11). No float atomics: two runs are
// bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

#include "champion.cuh"
#include "lloyd_reduce.cuh"
#include "tf32_accum.cuh"
#include "wgmma.cuh"

namespace {

using tdc::better;
using tdc::bulk_copy_g2s;
using tdc::kArgSentinel;
using tdc::mbar_arrive;
using tdc::mbar_expect_tx;
using tdc::mbar_init;
using tdc::mbar_init_fence;
using tdc::mbar_wait;
using tdc::mma_tf32;
using tdc::split_tf32;
using tdc::warp_arrive;

constexpr int kCols = 256;       // threads per CTA = columns per tile
constexpr int kDR = 8;           // features per register chunk
constexpr int kKG = 16;          // private: centroids per register group
constexpr int kPrivMax = 96;     // B11 private while d ≤ kDR, K·(d+1) ≤ this
constexpr int kStageFloats = 8192;  // tile: centroid stage of ≤ 32 KB
constexpr int kKT = 32;          // B11 tile: centroids per μ tile
constexpr int kDS = 32;          // B11 tile: features per x slice
constexpr int kPad = kCols + 1;  // row stride of the B11 tiles (banks)

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

bool private_mode(int k, int d) {
  return d <= kDR && (long long)k * (d + 1) <= kPrivMax;
}

// B10's streaming form (d ≤ kDR, K·(d+1) ≤ kLloydMax): 8 or 12 consumer
// warps (as many as fit beside their accumulators and two ring slots),
// each thread kLloydC columns of a tile of 32·warps·kLloydC columns.
constexpr int kLloydC = 4;
constexpr int kLloydMax = 144;  // K·(d+1) limit
constexpr int kLloydMaxSlots = 16;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a CTA may take

bool lloyd_stream_mode(int k, int d) {
  return d <= kDR && (long long)k * (d + 1) <= kLloydMax;
}

// Byte offsets of the streaming form's shared memory: the slots' full and
// empty mbarriers, the centroids and c2 by group of 4 (d + 1 float4 a
// group, zero padded), red[threads] f64, the accumulators
// acc[K·(d+1)][threads] (label j's sums at rows j·(d+1) .. +d-1 f32, its
// count at row j·(d+1) + d int), then the ring: `slots` slots of d rows of
// a tile's elements and 16 bytes (a misaligned row's offset). ops/tall.py's
// `lloyd_smem` mirrors it.
struct LloydSmem {
  int cs, red, acc, ring, row_bytes, total;
};

__host__ __device__ __forceinline__ LloydSmem lloyd_smem(int k, int d,
                                                         int slots, int esize,
                                                         int warps) {
  LloydSmem L;
  const int threads = 32 * warps;
  const int kp4 = (k + 3) / 4 * 4;
  L.cs = 2 * kLloydMaxSlots * 8;
  L.red = L.cs + (d + 1) * kp4 * 4;
  L.acc = L.red + threads * 8;
  L.ring = (L.acc + k * (d + 1) * threads * 4 + 127) / 128 * 128;
  L.row_bytes = threads * kLloydC * esize + 16;
  L.total = L.ring + slots * d * L.row_bytes;
  return L;
}

// d² from x2, cross and c2, as the reference computes it; NaN stays NaN.
__device__ __forceinline__ float tall_d2(float x2, float cross, float c2) {
  const float v = (x2 - 2.f * cross) + c2;
  return v < 0.f ? 0.f : v;
}

// B11's powers from w, one value per (column, centroid), in both forms:
// at m = 2 w = 1/v, inv = w and μ = (w·(1/s))², the exact forms;
// otherwise w = p·log2(v), inv = 2^w and μ = 2^(m·(w − log2 s)): one
// log2 of each v and one of s in place of two powf (within the card
// tolerance at m = 1.7, PERF.md).
template <bool kM2>
__device__ __forceinline__ float fuzzy_w(float v, float p) {
  return kM2 ? 1.f / v : p * log2f(v);
}
template <bool kM2>
__device__ __forceinline__ float fuzzy_inv(float w) {
  return kM2 ? w : exp2f(w);
}
template <bool kM2>
__device__ __forceinline__ float fuzzy_mu(float w, float rs, float ls,
                                          float m) {
  return kM2 ? (w * rs) * (w * rs) : exp2f(m * (w - ls));
}

// ---------------------------------------------------------------------------
// The private form (d ≤ kDR, K·(d+1) ≤ kPrivMax).

// The d features of column `col` (0 past d or past N).
template <typename T>
__device__ __forceinline__ void load_column(const T* __restrict__ xt,
                                            long long n, int d,
                                            long long col,
                                            float (&xr)[kDR]) {
  const T* p = xt + col;
#pragma unroll
  for (int f = 0; f < kDR; ++f) {
    xr[f] = (f < d && col < n) ? widen(p[f * n]) : 0.f;
  }
}

// The private form's centroids feature-major cs[kDR][kp] (kp = K rounded
// up to kKG, zero padded) and c2s[kp].
__host__ __device__ __forceinline__ int padded_k(int k) {
  return (k + kKG - 1) / kKG * kKG;
}

__device__ __forceinline__ void stage_private(const float* __restrict__ c,
                                              const float* __restrict__ c2,
                                              int k, int d, int kp,
                                              float* cs, float* c2s) {
  for (int i = threadIdx.x; i < kDR * kp; i += kCols) {
    const int f = i / kp, j = i % kp;
    cs[i] = (f < d && j < k) ? c[(long long)j * d + f] : 0.f;
  }
  for (int i = threadIdx.x; i < kp; i += kCols) c2s[i] = i < k ? c2[i] : 0.f;
}

// d² of the column to centroids kg .. kg + kKG - 1 (garbage past K).
__device__ __forceinline__ void group_d2(const float* cs, const float* c2s,
                                         int kp, int d, int kg,
                                         const float (&x0)[kDR], float x2,
                                         float (&dd)[kKG]) {
#pragma unroll
  for (int q = 0; q < kKG; ++q) dd[q] = 0.f;
#pragma unroll
  for (int f = 0; f < kDR; ++f) {
    if (f < d) {
      const float4* row = reinterpret_cast<const float4*>(cs + f * kp + kg);
#pragma unroll
      for (int q = 0; q < kKG / 4; ++q) {
        const float4 cc = row[q];
        dd[4 * q] = fmaf(cc.x, x0[f], dd[4 * q]);
        dd[4 * q + 1] = fmaf(cc.y, x0[f], dd[4 * q + 1]);
        dd[4 * q + 2] = fmaf(cc.z, x0[f], dd[4 * q + 2]);
        dd[4 * q + 3] = fmaf(cc.w, x0[f], dd[4 * q + 3]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kKG; ++q) dd[q] = tall_d2(x2, dd[q], c2s[kg + q]);
}

// ---------------------------------------------------------------------------
// B10's streaming form.
//
// The centroids sit in shared memory by group of 4: group g holds, for
// each feature f, the float4 of centroids 4g .. 4g+3 at f, then their c2
// (zero past K), so a group's d + 1 loads take immediate offsets.

// x2 − 2·cross as one fmaf: 2·cross is exact, so these are the bits of
// (x2 − 2·cross) in two steps (barring overflow of 2·cross).
__device__ __forceinline__ float lloyd_shift(float x2, float cross) {
  return fmaf(-2.f, cross, x2);
}

// d² as the reference computes it; max.NaN keeps NaN and is one instruction
// (v < 0 ? 0 : v takes two; where v is −0 it gives +0, which compares and
// adds as −0 does).
__device__ __forceinline__ float lloyd_d2(float x2, float cross, float c2) {
  const float v = lloyd_shift(x2, cross) + c2;
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(0.f));
  return r;
}

// Scores a thread's kLloydC columns against the 4 centroids of group grp
// (the first at j0; a centroid past K has c2 = +inf, so v = +inf and it is
// never taken) and keeps, per column, the smallest unclamped v = (x2 −
// 2·cross) + c2 and its index: a centroid is taken on strict <, from r =
// +inf. Where that minimum is > 0 and every v finite (x2 below x2_limit),
// the clamp changes no comparison and this is the earlier kernel's
// champion (its first centroid unconditionally, a later one on strict <);
// the caller redoes every other column with the clamp (`lloyd_exact`).
template <int kD>
__device__ __forceinline__ void lloyd_group(const float4* grp, int j0,
                                            const float (&x)[kLloydC][kD],
                                            const float (&x2)[kLloydC],
                                            float (&r)[kLloydC],
                                            int (&a)[kLloydC]) {
  float cr[4][kLloydC];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int c = 0; c < kLloydC; ++c) cr[q][c] = 0.f;
#pragma unroll
  for (int f = 0; f < kD; ++f) {
    const float4 cc = grp[f];
    const float cv[4] = {cc.x, cc.y, cc.z, cc.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < kLloydC; ++c)
        cr[q][c] = fmaf(cv[q], x[c][f], cr[q][c]);
  }
  const float4 c2q = grp[kD];
  const float c2v[4] = {c2q.x, c2q.y, c2q.z, c2q.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int c = 0; c < kLloydC; ++c) {
      const float v = lloyd_shift(x2[c], cr[q][c]) + c2v[q];
      if (v < r[c]) {
        r[c] = v;
        a[c] = j0 + q;
      }
    }
  }
}

template <int kD>
struct LloydColumn {
  float x[kD];
};
struct LloydChampion {
  float best;
  int barg;
};

// The earlier kernel's champion of one column, clamp and all: d² =
// max((x2 − 2·cross) + c2, 0), the first centroid unconditionally, a later
// one on strict <. Taken only where the smallest v is not > 0, or x2 is
// not below the limit that keeps every v finite (a column on a centroid,
// or values near the f32 range); out of line, so the common path keeps
// its registers.
template <int kD>
__device__ __noinline__ LloydChampion lloyd_exact(const float4* cs, int k,
                                                  LloydColumn<kD> xc,
                                                  float x2) {
  LloydChampion out{0.f, 0};
  for (int j = 0; j < k; ++j) {
    const float* cj = reinterpret_cast<const float*>(cs + (j / 4) * (kD + 1))
                      + j % 4;
    float cross = 0.f;
#pragma unroll
    for (int f = 0; f < kD; ++f) cross = fmaf(cj[4 * f], xc.x[f], cross);
    const float v = lloyd_d2(x2, cross, cj[4 * kD]);
    if (j == 0 || v < out.best) out = {v, j};
  }
  return out;
}

// Whether the tile at column j0 (cols columns) is read from device memory
// and not staged: where the aligned-down copy of row 0 would start before
// the tensor (off0 != 0 at j0 = 0), or the aligned-up copy of row d-1 end
// past it.
template <int kD, int kE>
__device__ __forceinline__ bool lloyd_direct(unsigned long long base,
                                             long long n, long long j0,
                                             int cols, int off0) {
  if (j0 == 0 && off0 != 0) return true;
  if (cols == 0) return false;
  const unsigned long long end = base + (unsigned long long)kD * n * kE;
  const unsigned long long last =
      base + ((unsigned long long)(kD - 1) * n + j0 + cols) * kE;
  return (last + 15) / 16 * 16 > end;
}

// Element e of a staged row (f32 or bf16, widened).
template <typename T>
__device__ __forceinline__ float staged(const unsigned char* row, int e) {
  return widen(reinterpret_cast<const T*>(row)[e]);
}

// The 4 columns at tile offset c0 (a multiple of 4) of an aligned staged
// row: one 16-byte (f32) or 8-byte (bf16) shared load.
__device__ __forceinline__ void staged4(const float* row, int c0,
                                        float (&v)[kLloydC]) {
  const float4 q = *reinterpret_cast<const float4*>(row + c0);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void staged4(const __nv_bfloat16* row, int c0,
                                        float (&v)[kLloydC]) {
  const uint2 q = *reinterpret_cast<const uint2*>(row + c0);
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// Adds column x (label a) to this thread's accumulator: acc[(a·(d+1) +
// f)·kThreads + t], the count (an int) at f = d.
template <int kD, int kThreads>
__device__ __forceinline__ void lloyd_add(float* acc_t, int a,
                                          const float (&xc)[kD]) {
  float* row = acc_t + a * ((kD + 1) * kThreads);
#pragma unroll
  for (int f = 0; f < kD; ++f) row[f * kThreads] += xc[f];
  reinterpret_cast<int*>(row)[kD * kThreads] += 1;
}

// One persistent CTA per SM: warps 0..kW-1 consume, warp kW produces
// (lane 0 issues the copies). Tile i of the CTA (its
// tiles are blockIdx.x, blockIdx.x + G, ...) goes to slot i % slots; the
// slot's full barrier completes its phase when the copies land (or when
// the producer arrives, for a tile read directly), its empty barrier when
// the kW consumer warps have taken their columns out of it. stream_only:
// the consumers take the columns and add Σx² of the live ones to the SSE,
// nothing else (the memory path's share of the kernel's time).
template <typename T, int kD, int kW>
__global__ void __launch_bounds__(32 * kW + 32, 1)
    tall_lloyd_stream(const T* __restrict__ xt, const float* __restrict__ c,
                      const float* __restrict__ c2, long long n, int k,
                      int slots, int stream_only, double* __restrict__ ws,
                      int* __restrict__ cnt, double* __restrict__ sse_part,
                      int* __restrict__ labels) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kE = sizeof(T);
  constexpr int kThreads = 32 * kW;          // consumer threads
  constexpr int kTile = kThreads * kLloydC;  // columns a tile
  const LloydSmem L = lloyd_smem(k, kD, slots, kE, kW);
  auto* full = reinterpret_cast<unsigned long long*>(smem);
  auto* empty = full + kLloydMaxSlots;
  const int ngroups = (k + 3) / 4;
  float4* cs = reinterpret_cast<float4*>(smem + L.cs);
  double* red = reinterpret_cast<double*>(smem + L.red);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  unsigned char* ring = smem + L.ring;
  const int t = threadIdx.x;
  const int ntiles = (int)((n + kTile - 1) / kTile);

  // Row f starts off[f] elements past a 16-byte boundary, the same in
  // every tile (a tile is a multiple of 16 bytes long).
  const unsigned long long base = reinterpret_cast<unsigned long long>(xt);
  int off[kD];
  bool aligned = true;
#pragma unroll
  for (int f = 0; f < kD; ++f) {
    off[f] = (int)((base + (unsigned long long)f * n * kE) % 16) / kE;
    aligned = aligned && off[f] == 0;
  }
  // The tiles read directly: tile 0 where head_direct, and every tile from
  // tail_from on (at most the last three).
  const bool head_direct = lloyd_direct<kD, kE>(base, n, 0, 0, off[0]);
  int tail_from = ntiles;
  while (tail_from > 0) {
    const long long j0 = (long long)(tail_from - 1) * kTile;
    const int cols = (int)min((long long)kTile, n - j0);
    if (!lloyd_direct<kD, kE>(base, n, j0, cols, 0)) break;
    --tail_from;
  }

  if (t == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kW);
    }
    mbar_init_fence();
  }
  float* csf = reinterpret_cast<float*>(cs);
  for (int i = t; i < ngroups * (kD + 1) * 4; i += blockDim.x) {
    const int g = i / ((kD + 1) * 4), f = i / 4 % (kD + 1);
    const int j = 4 * g + i % 4;
    csf[i] = j < k ? (f < kD ? c[(long long)j * kD + f] : c2[j])
                   : (f < kD ? 0.f : CUDART_INF_F);
  }
  for (int i = t; i < k * (kD + 1) * kThreads; i += blockDim.x) {
    acc[i] = 0.f;  // the int counts' zero has the same bits
  }
  // Where x2 + max ‖c‖² < 1e38, |2·cross| ≤ x2 + ‖c‖² and every v is
  // finite; x2_limit is −1 (every column exact) where a ‖c‖² is not
  // below 1e38 (or is NaN).
  bool c2_small = true;
  float c2max = 0.f;
  for (int j = 0; j < k; ++j) {
    c2_small = c2_small && c2[j] < 1e38f;
    c2max = fmaxf(c2max, c2[j]);
  }
  const float x2_limit = c2_small ? 1e38f - c2max : -1.f;
  __syncthreads();

  if (t >= kThreads) {  // the producer warp
    if (t == kThreads) {
      int s = 0;
      unsigned phase = 0;
      int i = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++i) {
        if (i >= slots) mbar_wait(&empty[s], phase ^ 1);
        const long long j0 = (long long)tile * kTile;
        const int cols = (int)min((long long)kTile, n - j0);
        if ((tile == 0 && head_direct) || tile >= tail_from) {
          mbar_arrive(&full[s]);
        } else {
          unsigned bytes[kD];
          unsigned total = 0;
#pragma unroll
          for (int f = 0; f < kD; ++f) {
            bytes[f] = ((off[f] + cols) * kE + 15) / 16 * 16;
            total += bytes[f];
          }
          mbar_expect_tx(&full[s], total);
          unsigned char* slot = ring + (long long)s * kD * L.row_bytes;
#pragma unroll
          for (int f = 0; f < kD; ++f) {
            bulk_copy_g2s(slot + f * L.row_bytes,
                          xt + ((long long)f * n + j0 - off[f]), bytes[f],
                          &full[s]);
          }
        }
        if (++s == slots) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    __syncwarp();
  } else {  // the consumer warps
    double sse = 0.0;
    float* acc_t = acc + t;
    const int c0 = kLloydC * t;  // this thread's columns in a tile
    int s = 0;
    unsigned phase = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const long long col0 = (long long)tile * kTile + c0;
      // this thread's live columns (kLloydC in every tile but the last)
      const int live =
          tile < ntiles - 1
              ? kLloydC
              : (int)max(0LL, min((long long)kLloydC, n - col0));
      mbar_wait(&full[s], phase);
      float x[kLloydC][kD];
      const unsigned char* slot = ring + (long long)s * kD * L.row_bytes;
      if ((tile == 0 && head_direct) || tile >= tail_from) {
#pragma unroll
        for (int f = 0; f < kD; ++f)
#pragma unroll
          for (int q = 0; q < kLloydC; ++q)
            x[q][f] = q < live ? widen(xt[(long long)f * n + col0 + q]) : 0.f;
      } else if (aligned) {
#pragma unroll
        for (int f = 0; f < kD; ++f) {
          float v[kLloydC];
          staged4(reinterpret_cast<const T*>(slot + f * L.row_bytes), c0, v);
#pragma unroll
          for (int q = 0; q < kLloydC; ++q) x[q][f] = v[q];
        }
      } else {
#pragma unroll
        for (int f = 0; f < kD; ++f)
#pragma unroll
          for (int q = 0; q < kLloydC; ++q)
            x[q][f] = staged<T>(slot + f * L.row_bytes, off[f] + c0 + q);
      }
      warp_arrive(&empty[s]);  // the columns are in registers
      if (++s == slots) {
        s = 0;
        phase ^= 1;
      }
      float x2[kLloydC];
#pragma unroll
      for (int q = 0; q < kLloydC; ++q) {
        x2[q] = 0.f;
#pragma unroll
        for (int f = 0; f < kD; ++f) x2[q] = fmaf(x[q][f], x[q][f], x2[q]);
      }
      if (stream_only) {  // [stream only]
#pragma unroll
        for (int q = 0; q < kLloydC; ++q) {
          if (q < live) sse += (double)x2[q];
        }
        continue;
      }
      float best[kLloydC];
      int barg[kLloydC];
#pragma unroll
      for (int q = 0; q < kLloydC; ++q) {
        best[q] = CUDART_INF_F;
        barg[q] = 0;
      }
      // [distances]
      for (int g = 0; g < ngroups; ++g) {
        lloyd_group<kD>(cs + g * (kD + 1), 4 * g, x, x2, best, barg);
      }
      bool fast = true;
#pragma unroll
      for (int q = 0; q < kLloydC; ++q) {
        fast = fast && best[q] > 0.f && x2[q] < x2_limit;
      }
      if (!fast) {
#pragma unroll
        for (int q = 0; q < kLloydC; ++q) {
          if (!(best[q] > 0.f && x2[q] < x2_limit)) {
            LloydColumn<kD> col;
#pragma unroll
            for (int f = 0; f < kD; ++f) col.x[f] = x[q][f];
            const LloydChampion e = lloyd_exact<kD>(cs, k, col, x2[q]);
            best[q] = e.best;
            barg[q] = e.barg;
          }
        }
      }
      // [accumulate] each live column into its champion's row, in order
      float tile_sse = 0.f;
#pragma unroll
      for (int q = 0; q < kLloydC; ++q) {
        if (q < live) {
          lloyd_add<kD, kThreads>(acc_t, barg[q], x[q]);
          tile_sse += best[q];
        }
      }
      sse += (double)tile_sse;
      // [labels]
      if (labels != nullptr) {
        if (live == kLloydC) {
          *reinterpret_cast<int4*>(labels + col0) =
              make_int4(barg[0], barg[1], barg[2], barg[3]);
        } else {
#pragma unroll
          for (int q = 0; q < kLloydC; ++q) {
            if (q < live) labels[col0 + q] = barg[q];
          }
        }
      }
    }
    red[t] = sse;
  }
  __syncthreads();

  // The CTA's sums in thread order, kept in f64 (`tall_lloyd_reduce`
  // rounds each sum once).
  double* my_ws = ws + (long long)blockIdx.x * k * kD;
  int* my_cnt = cnt + (long long)blockIdx.x * k;
  for (int e = t; e < k * (kD + 1); e += blockDim.x) {
    const int j = e / (kD + 1), f = e % (kD + 1);
    const float* row = acc + e * kThreads;
    if (f < kD) {
      double sum = 0.0;
      for (int u = 0; u < kThreads; ++u) sum += (double)row[u];
      my_ws[j * kD + f] = sum;
    } else {
      int sum = 0;
      for (int u = 0; u < kThreads; ++u) {
        sum += reinterpret_cast<const int*>(row)[u];
      }
      my_cnt[j] = sum;
    }
  }
  if (t == 0) {
    double sum = 0.0;
    for (int u = 0; u < kThreads; ++u) sum += red[u];
    sse_part[blockIdx.x] = sum;
  }
}

// B11's private form accumulates μᵀ·X on the tensor cores: each warp
// writes its 32 columns' μ (K padded to kMT·16) and features (with a
// ones column at d for Σμ, in a second n8 tile where d = 8) to its own
// shared tiles and runs `mma.sync` m16n8k8 over them with the 3xTF32 split
// (tf32_accum.cuh; bf16 columns are exact in TF32, so their lo half is 0
// and dropped). kTiles is the number of (m16, n8) output tiles, 1 or at
// most 3 (K·(d+1) <= 96 with d <= 8: K <= 16 at d = 8, K <= 48 else).
constexpr int kMuPad = 8;  // μ row stride ≡ 8 (mod 32): no bank conflicts

__host__ __device__ __forceinline__ int mu_stride(int k) {
  return padded_k(k) + kMuPad;
}

// The (m16, n8) tiles of the private form's μᵀ·X: one per 16 centroids,
// and a second n8 tile (the ones column) where d = kDR.
__host__ __device__ __forceinline__ int fuzzy_tiles(int k, int d) {
  return padded_k(k) / kKG * (d == kDR ? 2 : 1);
}

// Shared memory of B11's private form: cs[kDR][kp], c2s[kp], per warp the
// μ tile [32][mu_stride] and the column tile [32][kDR] f32, the warps'
// (K, d+1) carries f64 and red[kCols] f64.
size_t fuzzy_private_smem(int k, int d) {
  const int kp = padded_k(k);
  const int warps = kCols / 32;
  return (size_t)(kDR + 1) * kp * 4 +
         (size_t)kCols * (mu_stride(k) + kDR) * 4 +
         (size_t)warps * kPrivMax * 8 + (size_t)kCols * 8;
}

// Two CTAs per SM at one output tile; one where three tiles' f32 and f64
// fragments (48 registers) would spill under the two-CTA limit of 128.
template <typename T, bool kM2, int kTiles>
__global__ void __launch_bounds__(kCols, kTiles == 1 ? 2 : 1)
    tall_fuzzy_private(const T* __restrict__ xt, const float* __restrict__ c,
                       const float* __restrict__ c2, long long n, int k,
                       int d, float p, float mexp, float eps,
                       float* __restrict__ ws, double* __restrict__ wpart,
                       double* __restrict__ opart) {
  extern __shared__ __align__(16) unsigned char smem[];
  // bf16 columns are exact in TF32: their split has no lo half.
  constexpr bool kExactX = !std::is_same<T, float>::value;
  const int kp = padded_k(k);
  const int d1 = d + 1;
  const int ms = mu_stride(k);
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  float* cs = reinterpret_cast<float*>(smem);
  float* c2s = cs + kDR * kp;
  float* mus = c2s + kp + warp * 32 * ms;  // this warp's μ tile
  float* xsm = c2s + kp + kCols * ms + warp * 32 * kDR;  // its columns
  double* wred = reinterpret_cast<double*>(c2s + kp + kCols * (ms + kDR));
  double* red = wred + (kCols / 32) * kPrivMax;
  stage_private(c, c2, k, d, kp, cs, c2s);
  __syncthreads();

  // mma fragments: lane = gq·4 + t4; tile tt is centroids 16·(tt / nt)..
  // and n8 tile tt % nt (nt = 2 where d = kDR: tile 1 is the ones column).
  const int gq = lane / 4, t4 = lane % 4;
  const int ntile = fuzzy_tiles(k, d);
  const int nt = d == kDR ? 2 : 1;
  double carry[kTiles][4];
#pragma unroll
  for (int tt = 0; tt < kTiles; ++tt)
#pragma unroll
    for (int r = 0; r < 4; ++r) carry[tt][r] = 0.0;

  double obj = 0.0;  // this thread's columns' Σμ·d²
  const long long ntiles = (n + kCols - 1) / kCols;
  const long long stride = (long long)gridDim.x * kCols;
  float xn[kDR];
  load_column(xt, n, d, (long long)blockIdx.x * kCols + t, xn);
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long col = tile * kCols + t;
    const bool live = col < n;
    float x0[kDR];
#pragma unroll
    for (int f = 0; f < kDR; ++f) x0[f] = xn[f];
    load_column(xt, n, d, col + stride, xn);
    float x2 = 0.f;
#pragma unroll
    for (int f = 0; f < kDR; ++f) x2 = fmaf(x0[f], x0[f], x2);
    // Pass 1: s = Σ_k inv. dd and w keep the last group's d² and w (see
    // fuzzy_w), the only group where K ≤ kKG.
    float dd[kKG], w[kKG];
    float s = 0.f;
    for (int kg = 0; kg < k; kg += kKG) {
      group_d2(cs, c2s, kp, d, kg, x0, x2, dd);
#pragma unroll
      for (int q = 0; q < kKG; ++q) {
        if (kg + q < k) {
          w[q] = fuzzy_w<kM2>(dd[q] + eps, p);
          s += fuzzy_inv<kM2>(w[q]);
        }
      }
    }
    // Pass 2: μ = (inv / s)^m into this column's row of the μ tile (0
    // past K and past N), Σμ·d² in registers.
    const float rs = 1.f / s;
    const float ls = kM2 ? 0.f : log2f(s);
    float ob = 0.f;
    float* mrow = mus + lane * ms;
    for (int kg = 0; kg < kp; kg += kKG) {
      if (k > kKG) {
        group_d2(cs, c2s, kp, d, kg, x0, x2, dd);
#pragma unroll
        for (int q = 0; q < kKG; ++q) w[q] = fuzzy_w<kM2>(dd[q] + eps, p);
      }
      float mu[kKG];
#pragma unroll
      for (int q = 0; q < kKG; ++q) {
        mu[q] = 0.f;
        if (live && kg + q < k) {
          mu[q] = fuzzy_mu<kM2>(w[q], rs, ls, mexp);
          ob = fmaf(mu[q], dd[q], ob);
        }
      }
#pragma unroll
      for (int q = 0; q < kKG; q += 4) {
        *reinterpret_cast<float4*>(mrow + kg + q) =
            make_float4(mu[q], mu[q + 1], mu[q + 2], mu[q + 3]);
      }
    }
    {  // the column's features, then 1 (Σμ) where d < kDR, then 0
      float xr[kDR];
#pragma unroll
      for (int f = 0; f < kDR; ++f) {
        xr[f] = f < d ? x0[f] : (f == d ? 1.f : 0.f);
      }
      *reinterpret_cast<float4*>(xsm + lane * kDR) =
          make_float4(xr[0], xr[1], xr[2], xr[3]);
      *reinterpret_cast<float4*>(xsm + lane * kDR + 4) =
          make_float4(xr[4], xr[5], xr[6], xr[7]);
    }
    if (live) obj += (double)ob;
    __syncwarp();
    // μᵀ·X over the warp's 32 columns, 8 at a time, in f32 fragments, then
    // into the f64 carries (every 32 columns of the warp).
#pragma unroll
    for (int tt = 0; tt < kTiles; ++tt) {
      if (tt < ntile) {
        const int m0 = 16 * (tt / nt);
        const bool ones = tt % nt == 1;
        // lo·hi, hi·lo and hi·hi in three chains, so their MMAs overlap.
        float acc[3][4] = {};
#pragma unroll
        for (int kk = 0; kk < 32; kk += 8) {
          unsigned ah[4], al[4], bh[2], bl[2];
          const float av[4] = {mus[(kk + t4) * ms + m0 + gq],
                               mus[(kk + t4) * ms + m0 + gq + 8],
                               mus[(kk + t4 + 4) * ms + m0 + gq],
                               mus[(kk + t4 + 4) * ms + m0 + gq + 8]};
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(av[e], ah[e], al[e]);
          const float bv[2] = {
              ones ? (gq == 0 ? 1.f : 0.f) : xsm[(kk + t4) * kDR + gq],
              ones ? (gq == 0 ? 1.f : 0.f) : xsm[(kk + t4 + 4) * kDR + gq]};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (kExactX) {
              bh[e] = __float_as_uint(bv[e]);
              bl[e] = 0u;
            } else {
              split_tf32(bv[e], bh[e], bl[e]);
            }
          }
          mma_tf32(acc[0], al, bh[0], bh[1]);
          if (!kExactX) mma_tf32(acc[1], ah, bl[0], bl[1]);
          mma_tf32(acc[2], ah, bh[0], bh[1]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // the small products first
          carry[tt][r] += (double)((acc[0][r] + acc[1][r]) + acc[2][r]);
        }
      }
    }
    __syncwarp();  // the tiles are free for the next column tile
  }

  // The warps' carries: entry (centroid j, column f ≤ d) of warp w at
  // wred[w][j·(d+1) + f], summed in warp order; column d is Σμ.
#pragma unroll
  for (int tt = 0; tt < kTiles; ++tt) {
    if (tt < ntile) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 16 * (tt / nt) + gq + (r >= 2 ? 8 : 0);
        const int f = 8 * (tt % nt) + 2 * t4 + (r & 1);
        if (j < k && f <= d) wred[warp * kPrivMax + j * d1 + f] = carry[tt][r];
      }
    }
  }
  red[t] = obj;
  __syncthreads();
  float* my_ws = ws + (long long)blockIdx.x * k * d;
  double* my_w = wpart + (long long)blockIdx.x * k;
  for (int e = t; e < k * d1; e += kCols) {
    double sum = 0.0;
    for (int w = 0; w < kCols / 32; ++w) sum += wred[w * kPrivMax + e];
    const int j = e / d1, f = e % d1;
    if (f < d) {
      my_ws[j * d + f] = (float)sum;
    } else {
      my_w[j] = sum;
    }
  }
  if (t == 0) {
    double sum = 0.0;
    for (int u = 0; u < kCols; ++u) sum += red[u];
    opart[blockIdx.x] = sum;
  }
}

// ---------------------------------------------------------------------------
// The tile form (every other shape).

// The launch geometry, the same on the host and in every thread.
struct Geo {
  long long n;  // columns (points)
  int k, d;     // centroids, features
  int dp;       // d rounded up to kDR
  int nch;      // register chunks per column, dp / kDR
  int kc;       // centroids per stage (a multiple of 4)
  int nstage;   // stages over K
};

Geo make_geo(long long n, int k, int d) {
  Geo g;
  g.n = n;
  g.k = k;
  g.d = d;
  g.dp = (d + kDR - 1) / kDR * kDR;
  g.nch = g.dp / kDR;
  const int k4 = (k + 3) / 4 * 4;
  int fit = kStageFloats / g.dp / 4 * 4;
  if (fit < 4) fit = 4;
  g.kc = k4 < fit ? k4 : fit;
  g.nstage = (k + g.kc - 1) / g.kc;
  return g;
}

// Bytes of the centroid stage: cs (kc, dp) and c2s (kc).
size_t stage_bytes(const Geo& g) {
  return (size_t)g.kc * g.dp * 4 + (size_t)g.kc * 4;
}

// Stage s: centroids [s·kc, s·kc + kn) into cs (rows padded to a multiple
// of 4, features to dp, with zeros) and their c2 into c2s. The caller
// synchronises before and after.
__device__ void stage_centroids(const float* __restrict__ c,
                                const float* __restrict__ c2, const Geo& g,
                                int s, float* cs, float* c2s) {
  const int k0 = s * g.kc;
  const int kn = min(g.kc, g.k - k0);
  const int rows = (kn + 3) / 4 * 4;
  for (int i = threadIdx.x; i < rows * g.dp; i += kCols) {
    const int r = i / g.dp, f = i % g.dp;
    cs[i] = (r < kn && f < g.d) ? c[(long long)(k0 + r) * g.d + f] : 0.f;
  }
  for (int i = threadIdx.x; i < rows; i += kCols) {
    c2s[i] = i < kn ? c2[k0 + i] : 0.f;
  }
}

// Features ch·kDR .. ch·kDR + 7 of column `col`; 0 past d or past N (an
// L1 hit after the column's first load).
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ xt,
                                           const Geo& g, long long col,
                                           int ch, float (&xr)[kDR]) {
  const bool live = col < g.n;
#pragma unroll
  for (int f = 0; f < kDR; ++f) {
    const int ff = ch * kDR + f;
    xr[f] = (live && ff < g.d) ? widen(xt[(long long)ff * g.n + col]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ float column_sq_norm(const T* __restrict__ xt,
                                                const Geo& g, long long col) {
  float x2 = 0.f;
  for (int ch = 0; ch < g.nch; ++ch) {
    float xr[kDR];
    load_chunk(xt, g, col, ch, xr);
#pragma unroll
    for (int f = 0; f < kDR; ++f) x2 = fmaf(xr[f], xr[f], x2);
  }
  return x2;
}

// cross for the 4 staged centroids at rows r .. r+3: Σ_f cs·x, f in
// increasing order (the zero padding adds exactly nothing).
template <typename T>
__device__ __forceinline__ void dots4(const T* __restrict__ xt, const Geo& g,
                                      long long col, const float* cs, int r,
                                      float (&acc)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] = 0.f;
  for (int ch = 0; ch < g.nch; ++ch) {
    float xr[kDR];
    load_chunk(xt, g, col, ch, xr);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* row = cs + (r + q) * g.dp + ch * kDR;
      const float4 a = *reinterpret_cast<const float4*>(row);
      const float4 b = *reinterpret_cast<const float4*>(row + 4);
      const float cv[kDR] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int f = 0; f < kDR; ++f) acc[q] = fmaf(cv[f], xr[f], acc[q]);
    }
  }
}

// B10's tile form. Shared memory after the centroid stage: lab (kCols)
// int, val (kCols) f32.
template <typename T>
__global__ void __launch_bounds__(kCols, 2)
    tall_lloyd_tile(const T* __restrict__ xt, const float* __restrict__ c,
                    const float* __restrict__ c2, Geo g,
                    float* __restrict__ ws, int* __restrict__ cnt,
                    double* __restrict__ sse_part,
                    int* __restrict__ labels) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);
  float* c2s = cs + g.kc * g.dp;
  int* s_lab = reinterpret_cast<int*>(c2s + g.kc);
  float* s_val = reinterpret_cast<float*>(s_lab + kCols);
  const int t = threadIdx.x;
  const long long kd = (long long)g.k * g.d;
  float* my_ws = ws + blockIdx.x * kd;
  int* my_cnt = cnt + (long long)blockIdx.x * g.k;
  for (long long i = t; i < kd; i += kCols) my_ws[i] = 0.f;
  for (int i = t; i < g.k; i += kCols) my_cnt[i] = 0;
  if (g.nstage == 1) stage_centroids(c, c2, g, 0, cs, c2s);
  __syncthreads();

  double sse = 0.0;  // thread 0's
  const long long ntiles = (g.n + kCols - 1) / kCols;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long col = tile * kCols + t;
    const float x2 = column_sq_norm(xt, g, col);
    float best = CUDART_INF_F;
    int barg = kArgSentinel;
    for (int s = 0; s < g.nstage; ++s) {
      if (g.nstage > 1) {
        __syncthreads();
        stage_centroids(c, c2, g, s, cs, c2s);
        __syncthreads();
      }
      const int k0 = s * g.kc;
      const int kn = min(g.kc, g.k - k0);
      for (int r = 0; r < kn; r += 4) {
        float cross[4];
        dots4(xt, g, col, cs, r, cross);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (r + q < kn) {
            const float v = tall_d2(x2, cross[q], c2s[r + q]);
            if (better(v, k0 + r + q, best, barg)) {
              best = v;
              barg = k0 + r + q;
            }
          }
        }
      }
    }
    const bool live = col < g.n && barg < g.k;
    if (labels != nullptr && col < g.n) labels[col] = barg;
    s_lab[t] = live ? barg : kArgSentinel;
    s_val[t] = best;
    if (live) atomicAdd(&my_cnt[barg], 1);  // integers: exact, any order
    __syncthreads();
    const long long c0 = tile * kCols;
    const int rows = (int)min((long long)kCols, g.n - c0);
    for (int f = t; f < g.d; f += kCols) {
      const T* xrow = xt + (long long)f * g.n + c0;
      for (int r = 0; r < rows; ++r) {
        const int lab = s_lab[r];
        if (lab < g.k) my_ws[(long long)lab * g.d + f] += widen(xrow[r]);
      }
    }
    if (t == 0) {
      for (int r = 0; r < rows; ++r) {
        if (s_lab[r] < g.k) sse += (double)s_val[r];
      }
    }
    __syncthreads();
  }
  if (t == 0) sse_part[blockIdx.x] = sse;
}

// B11's tile form. Shared memory after the centroid stage: mu (kKT, kPad)
// f32, xs (kDS, kPad) f32, red (kCols) f64.
size_t fuzzy_tile_smem(const Geo& g) {
  size_t b = stage_bytes(g) + (size_t)(kKT + kDS) * kPad * 4;
  return (b + 15) / 16 * 16 + (size_t)kCols * 8;
}

// s = Σ_k (d²_k + eps)^p over every centroid, for one column. Re-stages
// the centroids where there is more than one stage (every thread calls it
// in step, so the barriers are uniform); leaves the last stage in place.
template <typename T, bool kM2>
__device__ __forceinline__ float column_normalizer(
    const T* __restrict__ xt, const float* __restrict__ c,
    const float* __restrict__ c2, const Geo& g, long long col, float x2,
    float p, float eps, float* cs, float* c2s) {
  float s = 0.f;
  for (int st = 0; st < g.nstage; ++st) {
    if (g.nstage > 1) {
      __syncthreads();
      stage_centroids(c, c2, g, st, cs, c2s);
      __syncthreads();
    }
    const int kn = min(g.kc, g.k - st * g.kc);
    for (int r = 0; r < kn; r += 4) {
      float cross[4];
      dots4(xt, g, col, cs, r, cross);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (r + q < kn) {
          s += fuzzy_inv<kM2>(
              fuzzy_w<kM2>(tall_d2(x2, cross[q], c2s[r + q]) + eps, p));
        }
      }
    }
  }
  return s;
}

template <typename T, bool kM2>
__global__ void __launch_bounds__(kCols, 2)
    tall_fuzzy_tile(const T* __restrict__ xt, const float* __restrict__ c,
                    const float* __restrict__ c2, Geo g, float p, float mexp,
                    float eps, float* __restrict__ ws,
                    double* __restrict__ wpart,
                    double* __restrict__ opart) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);
  float* c2s = cs + g.kc * g.dp;
  float* mu_s = c2s + g.kc;
  float* xs = mu_s + kKT * kPad;
  double* red = reinterpret_cast<double*>(
      (reinterpret_cast<size_t>(xs + kDS * kPad) + 15) / 16 * 16);
  const int t = threadIdx.x;
  const long long kd = (long long)g.k * g.d;
  float* my_ws = ws + blockIdx.x * kd;
  double* my_w = wpart + (long long)blockIdx.x * g.k;
  for (long long i = t; i < kd; i += kCols) my_ws[i] = 0.f;
  for (int i = t; i < g.k; i += kCols) my_w[i] = 0.0;
  if (g.nstage == 1) stage_centroids(c, c2, g, 0, cs, c2s);
  __syncthreads();

  double obj = 0.0;  // this thread's columns' Σμ·d²
  const long long ntiles = (g.n + kCols - 1) / kCols;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long col = tile * kCols + t;
    const bool live = col < g.n;
    const float x2 = column_sq_norm(xt, g, col);
    const float s = column_normalizer<T, kM2>(xt, c, c2, g, col, x2, p, eps,
                                              cs, c2s);
    const float rs = 1.f / s;
    const float ls = kM2 ? 0.f : log2f(s);
    float ob = 0.f;
    for (int st = 0; st < g.nstage; ++st) {
      if (g.nstage > 1) {
        __syncthreads();
        stage_centroids(c, c2, g, st, cs, c2s);
        __syncthreads();
      }
      const int k0 = st * g.kc;
      const int kn = min(g.kc, g.k - k0);
      for (int kt = 0; kt < kn; kt += kKT) {
        // μ of this column for the kKT centroids at kt (0 past K, N).
        for (int r = 0; r < kKT; r += 4) {
          float cross[4] = {0.f, 0.f, 0.f, 0.f};
          if (kt + r < kn) dots4(xt, g, col, cs, kt + r, cross);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float mu = 0.f;
            if (live && kt + r + q < kn) {
              const float d2 = tall_d2(x2, cross[q], c2s[kt + r + q]);
              mu = fuzzy_mu<kM2>(fuzzy_w<kM2>(d2 + eps, p), rs, ls, mexp);
              ob = fmaf(mu, d2, ob);
            }
            mu_s[(r + q) * kPad + t] = mu;
          }
        }
        __syncthreads();
        if (t < kKT && kt + t < kn) {
          float w = 0.f;
          for (int r = 0; r < kCols; ++r) w += mu_s[t * kPad + r];
          my_w[k0 + kt + t] += (double)w;
        }
        // Entries of thread t: centroid kt + t/8, features f0 + 4·(t%8)
        // .. +3, summed over the tile's columns in order.
        const int kk = t / 8, f4 = (t % 8) * 4;
        for (int f0 = 0; f0 < g.d; f0 += kDS) {
          for (int f = 0; f < kDS; ++f) {
            const int ff = f0 + f;
            xs[f * kPad + t] =
                (live && ff < g.d) ? widen(xt[(long long)ff * g.n + col])
                                   : 0.f;
          }
          __syncthreads();
          float a[4] = {0.f, 0.f, 0.f, 0.f};
          for (int r = 0; r < kCols; ++r) {
            const float mu = mu_s[kk * kPad + r];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              a[q] = fmaf(mu, xs[(f4 + q) * kPad + r], a[q]);
            }
          }
          if (kt + kk < kn) {
            const long long j = k0 + kt + kk;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int ff = f0 + f4 + q;
              if (ff < g.d) my_ws[j * g.d + ff] += a[q];
            }
          }
          __syncthreads();
        }
      }
    }
    if (live) obj += (double)ob;
  }

  red[t] = obj;
  __syncthreads();
  if (t == 0) {
    double sum = 0.0;
    for (int u = 0; u < kCols; ++u) sum += red[u];
    opart[blockIdx.x] = sum;
  }
}

// B10's streaming form: sums the G f64 partials in slice order and rounds
// each sum once; counts from the (G, K) integer counts; the SSE clamped at
// 0 as the reference clamps it.
__global__ void tall_lloyd_reduce(const double* __restrict__ ws,
                                  const int* __restrict__ cnt,
                                  const double* __restrict__ sse_part,
                                  int grid, int k, int d,
                                  float* __restrict__ sums,
                                  float* __restrict__ counts,
                                  float* __restrict__ sse) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long kd = (long long)k * d;
  if (e < kd) {
    double s = 0.0;
    for (int g = 0; g < grid; ++g) s += ws[g * kd + e];
    sums[e] = (float)s;
  }
  if (e < k) {
    long long s = 0;
    for (int g = 0; g < grid; ++g) s += cnt[(long long)g * k + e];
    counts[e] = (float)s;
  }
  if (e == 0) {
    double s = 0.0;
    for (int g = 0; g < grid; ++g) s += sse_part[g];
    sse[0] = fmaxf((float)s, 0.f);
  }
}

// Sums the G partials in slice order: Σμx (K, d), Σμ (K,) and the
// objective, clamped at 0 as the reference clamps it.
__global__ void tall_fuzzy_reduce(const float* __restrict__ ws,
                                  const double* __restrict__ wpart,
                                  const double* __restrict__ opart, int grid,
                                  int k, int d, float* __restrict__ wsums,
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
    for (int g = 0; g < grid; ++g) s += opart[g];
    objective[0] = fmaxf((float)s, 0.f);
  }
}

// Raises the kernel's dynamic shared memory limit, then launches it.
template <typename Kernel, typename... Args>
int launch(Kernel* kern, int grid, size_t smem, cudaStream_t st,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kCols, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, int kD, int kW>
int launch_stream(const T* xt, const float* c, const float* c2, long long n,
                  int k, int grid, int slots, int stream_only, double* ws,
                  int* cnt, double* sse_part, int* labels, cudaStream_t st) {
  auto* kern = tall_lloyd_stream<T, kD, kW>;
  const int smem = lloyd_smem(k, kD, slots, sizeof(T), kW).total;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, 32 * kW + 32, smem, st>>>(
      xt, c, c2, n, k, slots, stream_only, ws, cnt, sse_part, labels);
  return (int)cudaGetLastError();
}

// warps > 0: the streaming form with that many consumer warps (8 or 12)
// and ring slots (the caller's plan, ops/tall.py `lloyd_plan`), its ws
// (grid, K, d) f64; 0: the tile form, its ws f32. A plan that does not
// match the shape's form, or does not fit, is refused. Then the slice
// reduce of the form's workspace.
template <typename T>
int lloyd_stats(const T* xt, const float* c, const float* c2, long long n,
                int k, int d, int grid, int warps, int slots,
                int stream_only, void* ws, int* cnt, double* sse_part,
                float* sums, float* counts, float* sse, int* labels,
                cudaStream_t st) {
  if (lloyd_stream_mode(k, d) != (warps > 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (warps == 0) {
    if (stream_only || slots != 0) return (int)cudaErrorInvalidValue;
    const Geo g = make_geo(n, k, d);
    const int err = launch(tall_lloyd_tile<T>, grid,
                           stage_bytes(g) + kCols * 8, st, xt, c, c2, g,
                           static_cast<float*>(ws), cnt, sse_part, labels);
    if (err != 0) return err;
    return tdc::launch_lloyd_reduce(static_cast<float*>(ws), cnt, nullptr,
                                    sse_part, grid, k, d, sums, counts, sse,
                                    st);
  }
  const long long tile = 32LL * warps * kLloydC;
  if ((warps != 8 && warps != 12) || slots < 2 || slots > kLloydMaxSlots ||
      lloyd_smem(k, d, slots, sizeof(T), warps).total > kSmemLimit ||
      (n + tile - 1) / tile > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  double* wsd = static_cast<double*>(ws);
  int err = (int)cudaErrorInvalidValue;
  switch (d * 16 + warps) {
#define TDC_STREAM(D, W)                                                    \
  case D * 16 + W:                                                          \
    err = launch_stream<T, D, W>(xt, c, c2, n, k, grid, slots, stream_only, \
                                 wsd, cnt, sse_part, labels, st);           \
    break;
    TDC_STREAM(1, 8)
    TDC_STREAM(2, 8)
    TDC_STREAM(3, 8)
    TDC_STREAM(4, 8)
    TDC_STREAM(5, 8)
    TDC_STREAM(6, 8)
    TDC_STREAM(7, 8)
    TDC_STREAM(8, 8)
    TDC_STREAM(1, 12)
    TDC_STREAM(2, 12)
    TDC_STREAM(3, 12)
    TDC_STREAM(4, 12)
    TDC_STREAM(5, 12)
    TDC_STREAM(6, 12)
    TDC_STREAM(7, 12)
    TDC_STREAM(8, 12)
#undef TDC_STREAM
  }
  if (err != 0) return err;
  const long long kd = (long long)k * d;
  const long long total = kd > k ? kd : (long long)k;
  tall_lloyd_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      wsd, cnt, sse_part, grid, k, d, sums, counts, sse);
  return (int)cudaGetLastError();
}

template <typename T, bool kM2>
int fuzzy_stats(const T* xt, const float* c, const float* c2, long long n,
                int k, int d, float p, float mexp, float eps, int grid,
                float* ws, double* wpart, double* opart, cudaStream_t st) {
  if (private_mode(k, d)) {
    auto kern = fuzzy_tiles(k, d) == 1 ? tall_fuzzy_private<T, kM2, 1>
                                       : tall_fuzzy_private<T, kM2, 3>;
    return launch(kern, grid, fuzzy_private_smem(k, d), st, xt, c, c2, n, k,
                  d, p, mexp, eps, ws, wpart, opart);
  }
  const Geo g = make_geo(n, k, d);
  return launch(tall_fuzzy_tile<T, kM2>, grid, fuzzy_tile_smem(g), st, xt, c,
                c2, g, p, mexp, eps, ws, wpart, opart);
}

}  // namespace

// B10. xt (d, N) f32 (bf16 = 0) or bf16 (bf16 = 1); c (K, d) f32, already
// rounded to bf16 for bf16 columns, c2 (K,) of those values. grid CTAs;
// warps and slots: the streaming form's consumer warps and ring slots, 0
// and 0 for the tile form; stream_only (streaming form): take the columns
// and nothing else, for timing. ws (grid, K, d) (f64 for the streaming
// form, f32 for the tile form), cnt (grid, K) int and sse_part (grid,) f64
// are workspace; labels (N,) int32 may be null.
extern "C" int tdc_tall_lloyd_stats(const void* xt, int bf16, const float* c,
                                    const float* c2, long long n, int k,
                                    int d, int grid, int warps, int slots,
                                    int stream_only, void* ws, int* cnt,
                                    double* sse_part, float* sums,
                                    float* counts, float* sse, int* labels,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? lloyd_stats(static_cast<const __nv_bfloat16*>(xt), c, c2, n,
                            k, d, grid, warps, slots, stream_only, ws, cnt,
                            sse_part, sums, counts, sse, labels, st)
              : lloyd_stats(static_cast<const float*>(xt), c, c2, n, k, d,
                            grid, warps, slots, stream_only, ws, cnt,
                            sse_part, sums, counts, sse, labels, st);
}

// B11. As B10, with p = −1/(m−1), mexp = m and eps; ws (grid, K, d) f32,
// wpart (grid, K) f64 and opart (grid,) f64 are workspace.
extern "C" int tdc_tall_fuzzy_stats(const void* xt, int bf16, const float* c,
                                    const float* c2, long long n, int k,
                                    int d, float p, float mexp, float eps,
                                    int grid, float* ws, double* wpart,
                                    double* opart, float* wsums,
                                    float* weights, float* objective,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool m2 = p == -1.f && mexp == 2.f;
  const auto* xf = static_cast<const float*>(xt);
  const auto* xb = static_cast<const __nv_bfloat16*>(xt);
  int err;
  if (bf16) {
    err = m2 ? fuzzy_stats<__nv_bfloat16, true>(xb, c, c2, n, k, d, p, mexp,
                                                 eps, grid, ws, wpart, opart,
                                                 st)
             : fuzzy_stats<__nv_bfloat16, false>(xb, c, c2, n, k, d, p, mexp,
                                                  eps, grid, ws, wpart, opart,
                                                  st);
  } else {
    err = m2 ? fuzzy_stats<float, true>(xf, c, c2, n, k, d, p, mexp, eps,
                                        grid, ws, wpart, opart, st)
             : fuzzy_stats<float, false>(xf, c, c2, n, k, d, p, mexp, eps,
                                         grid, ws, wpart, opart, st);
  }
  if (err != 0) return err;
  const long long kd = (long long)k * d;
  const long long total = kd > k ? kd : (long long)k;
  tall_fuzzy_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      ws, wpart, opart, grid, k, d, wsums, weights, objective);
  return (int)cudaGetLastError();
}

// B11's and B10's tile form's workspace rows G for N columns on `sms`
// SMs: two CTAs per SM, at most one per 256-column tile, at least 1 (B10's
// streaming form: ops/tall.py `lloyd_grid`).
extern "C" int tdc_tall_grid(long long n, int sms) {
  const long long tiles = (n + kCols - 1) / kCols;
  long long g = 2LL * sms;
  if (tiles < g) g = tiles;
  return g < 1 ? 1 : (int)g;
}
