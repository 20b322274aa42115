// The champion rule of the Lloyd kernels (B1, B2, B4, B5, B10), and the
// f32 tile geometry and staging of the fuzzy kernels' CUDA-core distance
// products (B6's phase 1, B8), with the accumulate-step chunk `ChunkRegs`
// at its end.
//
// Counterpart of the JAX package's `champion_tile`
// (tdc_tpu/ops/pallas_kernels.py:99) and the running (min, argmin) of
// `_distance_argmin_kernel` (:119): per row, the smallest shifted distance
// ‖c‖² − 2x·c over all K centroids, and among equal minima the smallest
// centroid index. A later K tile therefore wins only on strict `<`, which
// is what the lexicographic (value, index) order of `better` gives.
//
// Layout of the f32 tiles: a CTA of 256 threads owns BM = 128 rows. Per K
// tile of BN = 64 or 128 centroids it stages BK = 16 columns of x and of
// the centroids in shared memory at a time and accumulates the 128 x BN
// dot products in registers, 8 rows x BN/16 centroids per thread, with
// f32 FMA on the CUDA cores (no TF32). The next step's tiles are loaded
// into registers while the current step computes. Every dot product sums
// over d in increasing order, so results are bitwise repeatable. Ragged
// N, K and d are masked loads: rows past N and columns past d load as 0,
// and centroids past K are never candidates — the job of `_PAD_CENTROID`
// and the `n_fake` correction in the JAX wrappers.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

namespace tdc {

constexpr int kThreads = 256;
constexpr int BM = 128;  // rows per CTA
constexpr int BK = 16;   // columns of d staged per step
constexpr int TM = 8;    // rows per thread
constexpr int kXsStride = BM + 4;  // +4 floats: fewer bank conflicts, 16-B rows
// The K-tile width BN is a template parameter, 64 or 128: each thread
// owns BN/16 centroids of a tile, in groups of 4 that lie 64 apart so the
// 16-byte shared loads stay free of bank conflicts. 128 halves the shared
// loads per FMA but needs ~210 registers (one CTA per SM); 64 fits two.

// Index of a row with no finite candidate (a NaN row), as `_ARG_SENTINEL`
// in the JAX kernels: larger than any real K, never accumulated.
constexpr int kArgSentinel = 1 << 30;

template <int BN>
struct __align__(16) AssignSmem {
  float xs[BK][kXsStride];  // x tile, transposed: xs[col][row]
  float cs[BK][BN + 4];     // centroid tile, transposed: cs[col][centroid]
};

__device__ __forceinline__ bool better(float v, int j, float bv, int bj) {
  return v < bv || (v == bv && j < bj);
}

// One BK-column step of the x and centroid tiles, held in registers
// between its global load and its store to shared memory, so the next
// step's loads are in flight while the current step computes. kVec: 16-byte
// loads (d % 4 == 0, 16-byte aligned rows); else scalar loads.
template <bool kVec, int BN>
struct StepRegs {
  static constexpr int kX = kVec ? BM * BK / 4 / kThreads : BM * BK / kThreads;
  static constexpr int kC = kVec ? BN * BK / 4 / kThreads : BN * BK / kThreads;
  using T = typename std::conditional<kVec, float4, float>::type;
  T x[kX];
  T c[kC];

  __device__ __forceinline__ void load(const float* __restrict__ xg,
                                       const float* __restrict__ cg,
                                       long long n, int k, int d,
                                       long long row0, int kt, int dk) {
    const int tid = threadIdx.x;
    constexpr int kW = kVec ? 4 : 1;   // floats per load
    constexpr int kPer = BK / kW;      // loads per tile row
#pragma unroll
    for (int t = 0; t < kX; ++t) {
      const int i = tid + t * kThreads;
      const long long row = row0 + i / kPer;
      const int col = dk + (i % kPer) * kW;
      if (row < n && col < d) {
        x[t] = *reinterpret_cast<const T*>(xg + row * d + col);
      } else {
        x[t] = T{};
      }
    }
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      const int i = tid + t * kThreads;
      const int j = kt + i / kPer;
      const int col = dk + (i % kPer) * kW;
      if (j < k && col < d) {
        c[t] = *reinterpret_cast<const T*>(cg + (long long)j * d + col);
      } else {
        c[t] = T{};
      }
    }
  }

  __device__ __forceinline__ void store(AssignSmem<BN>& sm) const {
    const int tid = threadIdx.x;
    constexpr int kW = kVec ? 4 : 1;
    constexpr int kPer = BK / kW;
#pragma unroll
    for (int t = 0; t < kX; ++t) {
      const int i = tid + t * kThreads;
      const int r = i / kPer, kk = (i % kPer) * kW;
      const float* v = reinterpret_cast<const float*>(&x[t]);
#pragma unroll
      for (int w = 0; w < kW; ++w) sm.xs[kk + w][r] = v[w];
    }
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      const int i = tid + t * kThreads;
      const int cc = i / kPer, kk = (i % kPer) * kW;
      const float* v = reinterpret_cast<const float*>(&c[t]);
#pragma unroll
      for (int w = 0; w < kW; ++w) sm.cs[kk + w][cc] = v[w];
    }
  }
};

// Whether the 16-byte load path applies: d a multiple of 4 and both base
// pointers 16-byte aligned (then every row start is too).
inline bool vector_loads_ok(const void* x, const void* c, int d) {
  return d % 4 == 0 && reinterpret_cast<unsigned long long>(x) % 16 == 0 &&
         reinterpret_cast<unsigned long long>(c) % 16 == 0;
}

// ‖x_row‖² summed by the 16 lanes that share the row (fixed order); every
// one of them returns the total. 0 for rows past n.
__device__ __forceinline__ float row_sq_norm(const float* __restrict__ x,
                                             long long n, int d,
                                             long long row) {
  const int tx = threadIdx.x % 16;
  float s = 0.f;
  if (row < n) {
    for (int col = tx; col < d; col += 16) {
      const float v = x[row * d + col];
      s = fmaf(v, v, s);
    }
  }
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// The accumulate steps of the two-phase kernels (B6, B9): a CTA owns a
// kDC-column slice of the (K, d) sums and stages kRC rows of x at a time.
constexpr int kDC = 128;
constexpr int kRC = 16;

// Row ranges G of a two-phase kernel's accumulate: about `target_ctas`
// CTAs over `tiles` (K tile, d slice) pairs, each range at least one
// BM-row block, at least 1.
inline int accumulate_row_ranges(long long n, long long tiles,
                                 int target_ctas) {
  long long g = target_ctas / tiles;
  const long long nb = (n + BM - 1) / BM;
  if (g > nb) g = nb;
  if (g > 65535) g = 65535;
  return g < 1 ? 1 : (int)g;
}

// One kRC x kDC chunk of x (rows row0 + r0.., columns dc..), held in
// registers between its global load and its store to shared memory, so the
// next chunk's loads are in flight while the current one computes. Rows
// past n and columns past d load as 0.
template <bool kVec>
struct ChunkRegs {
  static constexpr int kW = kVec ? 4 : 1;
  static constexpr int kPer = kDC / kW;  // loads per chunk row
  static constexpr int kN = kRC * kPer / kThreads;
  using T = typename std::conditional<kVec, float4, float>::type;
  T v[kN];

  __device__ __forceinline__ void load(const float* __restrict__ x,
                                       long long n, int d, long long row0,
                                       int dc) {
#pragma unroll
    for (int t = 0; t < kN; ++t) {
      const int i = threadIdx.x + t * kThreads;
      const long long row = row0 + i / kPer;
      const int col = dc + (i % kPer) * kW;
      v[t] = (row < n && col < d)
                 ? *reinterpret_cast<const T*>(x + row * d + col)
                 : T{};
    }
  }

  __device__ __forceinline__ void store(float (&xc)[kRC][kDC]) const {
#pragma unroll
    for (int t = 0; t < kN; ++t) {
      const int i = threadIdx.x + t * kThreads;
      *reinterpret_cast<T*>(&xc[i / kPer][(i % kPer) * kW]) = v[t];
    }
  }
};

}  // namespace tdc
