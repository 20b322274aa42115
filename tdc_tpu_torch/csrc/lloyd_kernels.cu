// B1 `lloyd_stats_fused`, B2 `distance_argmin` and B4
// `lloyd_stats_fused_weighted` for Hopper (sm_90a).
//
// B2 replaces `distance_argmin` / `_distance_argmin_kernel`
// (tdc_tpu/ops/pallas_kernels.py:175, body :119). One CTA per 128-row
// block loops over all K tiles and keeps a running (min, argmin) per row
// (champion.cuh); no (N, K) buffer exists. Bound on this card: at K = 16,384
// and d = 768 the 2·N·K·d FMA work on the f32 CUDA cores outweighs reading
// x by three orders of magnitude, so it is compute-bound. The design keeps
// every operand of the inner loop in shared memory or registers (8 x 8
// register tile per thread, four 16-byte shared loads per 64 FMAs), and
// prefetches the next step's tiles into registers (16-byte loads where
// d % 4 == 0) while the current one computes; the tensor-core form
// (3xTF32 or split-bf16 `wgmma`) is later work.
//
// B1 replaces `lloyd_stats_fused` (pallas_kernels.py:414; body
// `_fused_epilogue_kernel` :301 with `_cross_mxu` :341 and `_lloyd_fold`
// :355). On the TPU the (K, d) f32 accumulator stays in VMEM for the whole
// grid; at K = 1024, d = 128 it is 512 KiB, more than a CTA's 227 KB of
// shared memory, and CTAs run in no order. So here a grid of G persistent
// CTAs each takes every G-th row block, finds its champions (the B2 fold),
// and adds its rows, in row order, into its own (K, d) slice of a (G, K, d)
// f32 workspace, with per-CTA integer counts and an f64 SSE partial. A
// second kernel sums the G slices in slice order. Every sum has a fixed
// order: no float atomics, bitwise repeatable. Bound: compute, as B2 (the
// distance product is 2·N·K·d; the accumulate adds N·d).
//
// B4 replaces `lloyd_stats_fused_weighted` (pallas_kernels.py:562; body
// `_fused_epilogue_kernel` :301 with `_lloyd_weighted_fold` :525): B1 with
// an f32 weight per row. Each row adds w·x to its champion's sums, w to its
// mass and w·(min + ‖x‖²) to the SSE. The mass is a float sum, so B1's
// integer atomics for counts do not carry over: each CTA's workspace slice
// is (K, d+1) and column d carries w, the trick the sorted route plays with
// [w·x | w]. The slices are summed in slice order as B1's are, so the mass
// has a fixed order too. A zero-weight row adds exactly nothing. w is read
// one float per row, so it needs no alignment beyond a float's: the 16-byte
// load path depends on x and the centroids alone (vector_loads_ok). Bound:
// compute, as B1.

#include <cuda_runtime.h>

#include "champion.cuh"
#include "lloyd_reduce.cuh"

namespace {

using namespace tdc;

// B2 takes the 128-wide K tile (one CTA per SM, fewer shared loads per
// FMA). B1 keeps the 64-wide one: two CTAs share an SM, so one's
// accumulate phase overlaps the other's distance product; B1 ran no
// faster with the 128-wide tile on an H100.
constexpr int kArgminBN = 128;
constexpr int kFusedBN = 64;

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    distance_argmin_kernel(const float* __restrict__ x,
                           const float* __restrict__ c,
                           const float* __restrict__ c2, long long n, int k,
                           int d, int return_dist, int* __restrict__ labels,
                           float* __restrict__ mind) {
  __shared__ AssignSmem<kArgminBN> sm;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long row0 = (long long)blockIdx.x * BM;
  float best[TM];
  int barg[TM];
  block_champion<kVec>(x, c, c2, n, k, d, row0, sm, best, barg);
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const long long row = row0 + ty * TM + m;
    float v = best[m];
    if (return_dist) v = fmaxf(v + row_sq_norm(x, n, d, row), 0.f);
    if (tx == 0 && row < n) {
      labels[row] = barg[m];
      mind[row] = v;
    }
  }
}

// kWeighted = false is B1: cols = d, integer counts in `cnt`, w unused.
// kWeighted = true is B4: cols = d + 1 (column d is the mass), cnt unused.
template <bool kVec, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
    lloyd_fused_kernel(const float* __restrict__ x, const float* __restrict__ c,
                       const float* __restrict__ c2,
                       const float* __restrict__ w, long long n, int k, int d,
                       float* __restrict__ ws, int* __restrict__ cnt,
                       double* __restrict__ sse_part) {
  __shared__ AssignSmem<kFusedBN> sm;
  __shared__ int s_lab[BM];
  __shared__ float s_val[BM];
  __shared__ float s_w[BM];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int cols = kWeighted ? d + 1 : d;
  const long long kc = (long long)k * cols;
  float* my_ws = ws + blockIdx.x * kc;
  int* my_cnt = kWeighted ? nullptr : cnt + (long long)blockIdx.x * k;
  for (long long i = tid; i < kc; i += kThreads) my_ws[i] = 0.f;
  if (!kWeighted) {
    for (int i = tid; i < k; i += kThreads) my_cnt[i] = 0;
  }
  double sse = 0.0;  // thread 0's copy is the CTA's partial
  __syncthreads();
  const long long nblocks = (n + BM - 1) / BM;
  for (long long b = blockIdx.x; b < nblocks; b += gridDim.x) {
    const long long row0 = b * BM;
    float best[TM];
    int barg[TM];
    block_champion<kVec>(x, c, c2, n, k, d, row0, sm, best, barg);
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const long long row = row0 + ty * TM + m;
      const float x2 = row_sq_norm(x, n, d, row);
      if (tx == 0) {
        s_lab[ty * TM + m] = barg[m];
        if (kWeighted) {
          const float wr = row < n ? w[row] : 0.f;
          s_w[ty * TM + m] = wr;
          s_val[ty * TM + m] = wr * (best[m] + x2);
        } else {
          s_val[ty * TM + m] = best[m] + x2;
          // Integer atomics commute exactly: counts stay deterministic.
          if (row < n && barg[m] < k) atomicAdd(&my_cnt[barg[m]], 1);
        }
      }
    }
    __syncthreads();
    const int rows = (int)min((long long)BM, n - row0);
    for (int j = tid; j < cols; j += kThreads) {
      for (int r = 0; r < rows; ++r) {
        const int lab = s_lab[r];
        if (lab < k) {
          float v;
          if (kWeighted) {
            v = j < d ? s_w[r] * x[(row0 + r) * d + j] : s_w[r];
          } else {
            v = x[(row0 + r) * d + j];
          }
          my_ws[(long long)lab * cols + j] += v;
        }
      }
    }
    if (tid == 0) {
      for (int r = 0; r < rows; ++r) sse += (double)s_val[r];
    }
    __syncthreads();
  }
  if (tid == 0) sse_part[blockIdx.x] = sse;
}

// Sums the G slices in slice order. B1 (cnt != nullptr): sums from the
// (K, d) slices, counts from the integer counts. B4 (cnt == nullptr): the
// slices are (K, d+1); column d is the mass. B5 launches it too
// (lloyd_reduce.cuh).
__global__ void lloyd_reduce_kernel(const float* __restrict__ ws,
                                    const int* __restrict__ cnt,
                                    const double* __restrict__ sse_part,
                                    int grid, int k, int d,
                                    float* __restrict__ sums,
                                    float* __restrict__ counts,
                                    float* __restrict__ sse) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int cols = cnt ? d : d + 1;
  const long long kc = (long long)k * cols;
  if (e < kc) {
    float s = 0.f;
    for (int g = 0; g < grid; ++g) s += ws[g * kc + e];
    const long long row = e / cols;
    const int j = (int)(e % cols);
    if (j < d) {
      sums[row * d + j] = s;
    } else {
      counts[row] = s;
    }
  }
  if (cnt && e < k) {
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

template <bool kWeighted>
int launch_fused(const float* x, const float* c, const float* c2,
                 const float* w, long long n, int k, int d, int grid,
                 float* ws, int* cnt, double* sse_part, float* sums,
                 float* counts, float* sse, cudaStream_t s) {
  if (vector_loads_ok(x, c, d)) {
    lloyd_fused_kernel<true, kWeighted><<<grid, kThreads, 0, s>>>(
        x, c, c2, w, n, k, d, ws, cnt, sse_part);
  } else {
    lloyd_fused_kernel<false, kWeighted><<<grid, kThreads, 0, s>>>(
        x, c, c2, w, n, k, d, ws, cnt, sse_part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_lloyd_reduce(ws, kWeighted ? nullptr : cnt, sse_part, grid,
                             k, d, sums, counts, sse, s);
}

}  // namespace

int tdc::launch_lloyd_reduce(const float* ws, const int* cnt,
                             const double* sse_part, int grid, int k, int d,
                             float* sums, float* counts, float* sse,
                             cudaStream_t s) {
  const long long kc = (long long)k * (cnt ? d : d + 1);
  const long long total = kc > k ? kc : (long long)k;
  const long long blocks = (total + 255) / 256;
  lloyd_reduce_kernel<<<(unsigned)blocks, 256, 0, s>>>(
      ws, cnt, sse_part, grid, k, d, sums, counts, sse);
  return (int)cudaGetLastError();
}

extern "C" int tdc_distance_argmin(const float* x, const float* c,
                                   const float* c2, long long n, int k, int d,
                                   int return_dist, int* labels, float* mind,
                                   void* stream) {
  const unsigned blocks = (unsigned)((n + BM - 1) / BM);
  cudaStream_t s = (cudaStream_t)stream;
  if (vector_loads_ok(x, c, d)) {
    distance_argmin_kernel<true><<<blocks, kThreads, 0, s>>>(
        x, c, c2, n, k, d, return_dist, labels, mind);
  } else {
    distance_argmin_kernel<false><<<blocks, kThreads, 0, s>>>(
        x, c, c2, n, k, d, return_dist, labels, mind);
  }
  return (int)cudaGetLastError();
}

extern "C" int tdc_lloyd_stats_fused(const float* x, const float* c,
                                     const float* c2, long long n, int k,
                                     int d, int grid, float* ws, int* cnt,
                                     double* sse_part, float* sums,
                                     float* counts, float* sse,
                                     void* stream) {
  return launch_fused<false>(x, c, c2, nullptr, n, k, d, grid, ws, cnt,
                             sse_part, sums, counts, sse,
                             (cudaStream_t)stream);
}

// B4: ws is (grid, K, d+1) f32; counts receives the mass.
extern "C" int tdc_lloyd_stats_fused_weighted(
    const float* x, const float* c, const float* c2, const float* w,
    long long n, int k, int d, int grid, float* ws, double* sse_part,
    float* sums, float* counts, float* sse, void* stream) {
  return launch_fused<true>(x, c, c2, w, n, k, d, grid, ws, nullptr,
                            sse_part, sums, counts, sse,
                            (cudaStream_t)stream);
}

extern "C" const char* tdc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
