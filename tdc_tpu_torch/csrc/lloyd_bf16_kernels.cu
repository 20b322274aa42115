// B5 `lloyd_stats_fused(mxu_dtype="bfloat16")` for Hopper (sm_90a): the
// port's first tensor-core kernel.
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
// d = 128, against 0.64 ms to read f32 x once. The design moves that
// product onto the tensor cores (`nvcuda::wmma` 16x16x16 bf16 fragments,
// f32 accumulate) and keeps the rest of B1: G persistent CTAs, each with
// its own (K, d) f32 slice of a (G, K, d) workspace and integer counts,
// summed in slice order by lloyd_reduce.cuh; no float atomics, bitwise
// repeatable. Per 128-row block a CTA stages the rows as bf16 in shared
// memory (f32 rows rounded to nearest even at the load; columns past d
// load as 0, which pads d to a multiple of 16 and adds exactly nothing),
// and per 64-centroid K tile the rounded centroids. Each of the 8 warps
// multiplies a 32 x 32 piece of the (128, 64) cross tile; the f32 tile
// goes to shared memory, where two threads per row fold it with
// champion.cuh's rule (a later K tile wins only on strict <). Centroids
// past K are never candidates. Where d fits one 128-column chunk the row
// block stays in shared memory across all K tiles. The accumulate phase
// is B1's (one thread per column adds the block's rows into the CTA's
// slice) taken 8 rows at a time, so 8 read-modify-writes of the slice are
// in flight instead of one. Left for later PRs: `wgmma` on TMA-fed,
// pipelined tiles (the K tile is staged with its latency exposed), the
// fold on the accumulator registers instead of a shared-memory round
// trip, and an accumulate phase that overlaps the next block's product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

#include "champion.cuh"
#include "lloyd_reduce.cuh"

namespace {

using namespace nvcuda;
using tdc::better;
using tdc::kArgSentinel;
using tdc::kThreads;

constexpr int kBM = 128;       // rows per block
constexpr int kBN = 64;        // centroids per K tile
constexpr int kBD = 128;       // columns of d per staged chunk
constexpr int kLdT = kBD + 8;  // bf16 tile stride: 272 B, conflict-free
constexpr int kLdX = kBN + 4;  // f32 cross tile stride
constexpr int kWarpRows = 32;  // each warp's piece of the cross tile
constexpr int kWarpCols = 32;
constexpr int kGroup = 8;  // rows per step of the accumulate phase

struct Bf16Smem {
  __nv_bfloat16 xs[kBM][kLdT];  // the row block, bf16
  __nv_bfloat16 cs[kBN][kLdT];  // the K tile, bf16
  float cross[kBM][kLdX];       // x·cᵀ of the tile, f32
  float c2[kBN];
  float best[kBM];
  float val[kBM];  // min + ‖x‖² per row
  int lab[kBM];
};

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

// Stages rows [0, kRows) x columns [dk, dk + kBD) of the row-major
// (nrows, d) matrix src as bf16 into dst; rows past nrows and columns past
// d are 0. kVec: 16-byte loads (d % 8 == 0, 16-byte aligned base).
template <typename T, bool kVec, int kRows>
__device__ __forceinline__ void stage_bf16(const T* __restrict__ src,
                                           long long nrows, int d, int dk,
                                           __nv_bfloat16 (*dst)[kLdT]) {
  constexpr int kW = kVec ? 16 / (int)sizeof(T) : 1;  // elements per load
  constexpr int kPer = kBD / kW;                       // loads per row
#pragma unroll 4
  for (int i = threadIdx.x; i < kRows * kPer; i += kThreads) {
    const int r = i / kPer;
    const int col = (i % kPer) * kW;
    const int gc = dk + col;
    alignas(16) T v[kW];
    alignas(16) __nv_bfloat16 out[kW];
    if (r < nrows && gc < d) {
      if constexpr (kVec) {
        *reinterpret_cast<uint4*>(v) =
            *reinterpret_cast<const uint4*>(src + (long long)r * d + gc);
      } else {
        v[0] = src[(long long)r * d + gc];
      }
#pragma unroll
      for (int w = 0; w < kW; ++w) out[w] = to_bf16(v[w]);
    } else {
#pragma unroll
      for (int w = 0; w < kW; ++w) out[w] = __float2bfloat16_rn(0.f);
    }
    if constexpr (kW == 8) {
      *reinterpret_cast<uint4*>(&dst[r][col]) =
          *reinterpret_cast<const uint4*>(out);
    } else if constexpr (kW == 4) {
      *reinterpret_cast<uint2*>(&dst[r][col]) =
          *reinterpret_cast<const uint2*>(out);
    } else {
      dst[r][col] = out[0];
    }
  }
}

// T is the row dtype (float or __nv_bfloat16); cb the rounded centroids.
// `labels` (may be null) receives each row's champion.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    lloyd_bf16_kernel(const T* __restrict__ x,
                      const __nv_bfloat16* __restrict__ cb,
                      const float* __restrict__ c2, long long n, int k, int d,
                      float* __restrict__ ws, int* __restrict__ cnt,
                      double* __restrict__ sse_part,
                      int* __restrict__ labels) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Bf16Smem& sm = *reinterpret_cast<Bf16Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * kWarpRows;  // the warp's rows in the block
  const int wn = (warp % 2) * kWarpCols;  // its columns in the K tile
  // The fold: two threads per row, each over 32 of the tile's columns in
  // a rotated order, so a warp's 32 shared loads hit 32 distinct banks
  // (better() makes the order irrelevant to the result).
  const int frow = tid >> 1, half = tid & 1;
  const int rot = (frow + 16 * half) & 31;
  const long long kd = (long long)k * d;
  float* my_ws = ws + blockIdx.x * kd;
  int* my_cnt = cnt + (long long)blockIdx.x * k;
  for (long long i = tid; i < kd; i += kThreads) my_ws[i] = 0.f;
  for (int i = tid; i < k; i += kThreads) my_cnt[i] = 0;
  double sse = 0.0;  // thread 0's copy is the CTA's partial
  const int nd = (d + kBD - 1) / kBD;
  const long long nblocks = (n + kBM - 1) / kBM;
  for (long long b = blockIdx.x; b < nblocks; b += gridDim.x) {
    const long long row0 = b * kBM;
    const T* xb = x + row0 * d;
    float best = CUDART_INF_F;
    int barg = kArgSentinel;
    for (int kt = 0; kt < k; kt += kBN) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
      for (int dk = 0; dk < d; dk += kBD) {
        if (nd > 1 || kt == 0) {
          stage_bf16<T, kVec, kBM>(xb, n - row0, d, dk, sm.xs);
        }
        stage_bf16<__nv_bfloat16, kVec, kBN>(cb + (long long)kt * d, k - kt,
                                             d, dk, sm.cs);
        if (dk == 0 && tid < kBN) {
          sm.c2[tid] = kt + tid < k ? c2[kt + tid] : CUDART_INF_F;
        }
        __syncthreads();
        const int steps = (min(kBD, d - dk) + 15) / 16;
        for (int s = 0; s < steps; ++s) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> bt[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            wmma::load_matrix_sync(a[i], &sm.xs[wm + 16 * i][16 * s], kLdT);
            wmma::load_matrix_sync(bt[i], &sm.cs[wn + 16 * i][16 * s], kLdT);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wmma::mma_sync(acc[i][j], a[i], bt[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(&sm.cross[wm + 16 * i][wn + 16 * j],
                                  acc[i][j], kLdX, wmma::mem_row_major);
      __syncthreads();
#pragma unroll 8
      for (int q = 0; q < 32; ++q) {
        const int col = half * 32 + ((q + rot) & 31);
        const int j = kt + col;
        if (j < k) {
          const float v = sm.c2[col] - 2.f * sm.cross[frow][col];
          if (better(v, j, best, barg)) {
            best = v;
            barg = j;
          }
        }
      }
      __syncthreads();
    }
    {  // the row's two fold threads are lanes 2r and 2r + 1
      const float ov = __shfl_xor_sync(0xffffffffu, best, 1);
      const int oj = __shfl_xor_sync(0xffffffffu, barg, 1);
      if (better(ov, oj, best, barg)) {
        best = ov;
        barg = oj;
      }
    }
    if (half == 0) {
      sm.best[frow] = best;
      sm.lab[frow] = barg;
    }
    __syncthreads();
    // ‖x‖² of the rows at their own dtype, 16 lanes per row in a fixed
    // order; the counts; the labels when asked for.
    {
      const int tx = tid % 16, g = tid / 16;
      for (int m = 0; m < kBM / 16; ++m) {
        const int r = g * (kBM / 16) + m;
        const long long row = row0 + r;
        float s = 0.f;
        if (row < n) {
          for (int col = tx; col < d; col += 16) {
            const float v = to_f32(xb[(long long)r * d + col]);
            s = fmaf(v, v, s);
          }
        }
#pragma unroll
        for (int off = 8; off >= 1; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (tx == 0) {
          sm.val[r] = sm.best[r] + s;
          const int lab = sm.lab[r];
          if (row < n) {
            // Integer atomics commute exactly: counts stay deterministic.
            if (lab < k) atomicAdd(&my_cnt[lab], 1);
            if (labels) labels[row] = lab;
          }
        }
      }
    }
    __syncthreads();
    const int rows = (int)min((long long)kBM, n - row0);
    // One thread per column adds the block's rows into the CTA's slice,
    // kGroup rows at a time: rows of the group that share a label are
    // first summed into the earliest of them, in row order, so the
    // group's labels are distinct and its kGroup read-modify-writes of
    // the workspace can all be in flight at once (one by one, each waits
    // for the last, the slice being too large for L2 to keep). The order
    // of every sum is fixed: the result is bitwise repeatable.
    for (int j = tid; j < d; j += kThreads) {
      for (int r0 = 0; r0 < rows; r0 += kGroup) {
        int lab[kGroup];
        float v[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int r = r0 + g;
          lab[g] = r < rows ? sm.lab[r] : k;
          v[g] = lab[g] < k ? to_f32(xb[(long long)r * d + j]) : 0.f;
        }
#pragma unroll
        for (int g = 1; g < kGroup; ++g) {
#pragma unroll
          for (int h = 0; h < g; ++h) {
            if (lab[g] < k && lab[h] == lab[g]) {
              v[h] += v[g];
              lab[g] = k;
            }
          }
        }
        float w[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (lab[g] < k) w[g] = my_ws[(long long)lab[g] * d + j];
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (lab[g] < k) my_ws[(long long)lab[g] * d + j] = w[g] + v[g];
        }
      }
    }
    if (tid == 0) {
      for (int r = 0; r < rows; ++r) sse += (double)sm.val[r];
    }
    __syncthreads();
  }
  if (tid == 0) sse_part[blockIdx.x] = sse;
}

template <typename T, bool kVec>
cudaError_t launch_main(const T* x, const __nv_bfloat16* cb, const float* c2,
                        long long n, int k, int d, int grid, float* ws,
                        int* cnt, double* sse_part, int* labels,
                        cudaStream_t s) {
  const int smem = (int)sizeof(Bf16Smem);  // past 48 KB: dynamic only
  cudaError_t err = cudaFuncSetAttribute(
      lloyd_bf16_kernel<T, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  lloyd_bf16_kernel<T, kVec><<<grid, kThreads, smem, s>>>(
      x, cb, c2, n, k, d, ws, cnt, sse_part, labels);
  return cudaGetLastError();
}

template <typename T>
int launch_bf16(const T* x, const __nv_bfloat16* cb, const float* c2,
                long long n, int k, int d, int grid, float* ws, int* cnt,
                double* sse_part, float* sums, float* counts, float* sse,
                int* labels, cudaStream_t s) {
  const bool vec = d % 8 == 0 &&
                   reinterpret_cast<unsigned long long>(x) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(cb) % 16 == 0;
  const cudaError_t err =
      vec ? launch_main<T, true>(x, cb, c2, n, k, d, grid, ws, cnt, sse_part,
                                 labels, s)
          : launch_main<T, false>(x, cb, c2, n, k, d, grid, ws, cnt,
                                  sse_part, labels, s);
  if (err != cudaSuccess) return (int)err;
  return tdc::launch_lloyd_reduce(ws, cnt, nullptr, sse_part, grid, k, d,
                                  sums, counts, sse, s);
}

}  // namespace

// B5: x is (n, d) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); cb the (k, d)
// centroids rounded to bf16; c2 (k,) f32; ws (grid, k, d) f32, cnt
// (grid, k) int32 and sse_part (grid,) f64 are the workspace; labels (n,)
// int32 or null.
extern "C" int tdc_lloyd_stats_fused_bf16(
    const void* x, int x_bf16, const void* cb, const float* c2, long long n,
    int k, int d, int grid, float* ws, int* cnt, double* sse_part,
    float* sums, float* counts, float* sse, int* labels, void* stream) {
  const auto* c = static_cast<const __nv_bfloat16*>(cb);
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16) {
    return launch_bf16(static_cast<const __nv_bfloat16*>(x), c, c2, n, k, d,
                       grid, ws, cnt, sse_part, sums, counts, sse, labels, s);
  }
  return launch_bf16(static_cast<const float*>(x), c, c2, n, k, d, grid, ws,
                     cnt, sse_part, sums, counts, sse, labels, s);
}
