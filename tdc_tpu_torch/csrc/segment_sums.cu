// B3: per-segment row sums of label-sorted rows, and B12: the same sums
// with the row gather fused in, for Hopper (sm_90a).
//
// B3 replaces `_windowed_stats_pallas` / `_windowed_stats_kernel`
// (tdc_tpu/ops/sorted_stats.py:94, body :63). On the TPU the kernel walks
// sorted B-row blocks in grid order and keeps two (B, d) accumulator tiles
// resident across the blocks that touch them — a pattern that relies on the
// TPU's sequential grid. Here the rows of one segment (one label) are a
// contiguous run of the sorted order, and the work is cut by rows, not by
// segments, so that one long run cannot hold the whole kernel back:
//
// - pass 1: CTA c owns the fixed chunk of kChunk sorted rows [c·kChunk,
//   (c+1)·kChunk) and adds, one thread per column and in row order, each
//   run of a segment that falls in the chunk. A segment that lies wholly in
//   the chunk is written to `out`; the chunk's first run, when its segment
//   began in an earlier chunk, goes to `head[c]`; its last run, when its
//   segment goes on into the next chunk, to `tail[c]`.
// - pass 2: a segment that crosses chunks is tail[c0] + head[c0+1] + ... +
//   head[c1], summed in that order; an empty segment is a zero row.
//
// B12 replaces `_gathered_windowed_stats_pallas` / `_gathered_windowed_kernel`
// (tdc_tpu/ops/sorted_stats.py:246, pallas_call :292, body :154): x arrives
// unsorted and sorted row r is x[order[r]]. On the TPU the kernel issues one
// DMA per row, one block ahead, because a vector load cannot index rows;
// here pass 1 reads row order[r] where B3 reads row r (the `Rows` functor),
// f32 rows or bf16 rows widened in registers (exact). Pass 2 is shared. The
// add order is B3's, so B12 is bitwise equal to B3 on x.index_select(0,
// order) (widened to f32 for bf16 rows).
//
// Every sum has a fixed order and there are no atomics: deterministic.
// Bound on this card: bytes — each row is read once (N·d·s bytes, s = 4
// for f32 and 2 for bf16; B12 also reads `order`, 4·N) for N·d adds; the
// partials add at most 2·d floats per chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;         // sorted rows per pass-1 CTA
constexpr int kThreads = 256;      // pass 1: one thread per column, strided
constexpr int kCols = 32;          // pass 2: columns per CTA
constexpr int kGroups = 8;         // pass 2: partial-sum groups per column

// First index i in [0, len) with a[i] > v, or len.
__device__ __forceinline__ int upper_bound(const int* __restrict__ a, int len,
                                           long long v) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] > v) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Where sorted row r lives in the rows pass 1 reads: B3's rows are sorted
// already, B12's are gathered through the sort permutation.
struct SortedRows {
  __device__ __forceinline__ long long operator()(long long r) const {
    return r;
  }
};
struct GatheredRows {
  const int* __restrict__ order;
  __device__ __forceinline__ long long operator()(long long r) const {
    return (long long)order[r];
  }
};

template <typename T, typename Rows>
__global__ void __launch_bounds__(kThreads)
    chunk_sums_kernel(const T* __restrict__ xs, Rows rows,
                      const int* __restrict__ starts, long long n_rows,
                      int n_seg, int d, float* __restrict__ head,
                      float* __restrict__ tail, float* __restrict__ out) {
  const long long c = blockIdx.x;
  const long long r0 = c * kChunk, r1 = r0 + kChunk;
  const long long end = r1 < n_rows ? r1 : n_rows;
  long long pos = r0;
  while (pos < end) {
    // The non-empty segment holding row `pos`: the last index whose start
    // is <= pos (empty segments before it share its start).
    const int i = upper_bound(starts, n_seg + 1, pos);
    if (i == 0) {  // rows before the first segment
      pos = starts[0];
      continue;
    }
    if (i == n_seg + 1) break;  // rows past the last segment
    const int s = i - 1;
    const long long lo = starts[s], hi = starts[i];
    const long long b = hi < end ? hi : end;
    float* dst = (lo >= r0 && hi <= r1) ? out + (long long)s * d
                 : lo < r0              ? head + c * d
                                        : tail + c * d;
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      float acc = 0.f;
#pragma unroll 8
      for (long long r = pos; r < b; ++r) acc += widen(xs[rows(r) * d + j]);
      dst[j] = acc;
    }
    pos = hi;
  }
}

__global__ void __launch_bounds__(kCols* kGroups)
    combine_kernel(const int* __restrict__ starts, int d,
                   const float* __restrict__ head,
                   const float* __restrict__ tail, float* __restrict__ out) {
  __shared__ float part[kGroups][kCols];
  const int s = blockIdx.x;
  const int j = blockIdx.y * kCols + threadIdx.x;
  const int g = threadIdx.y;
  const long long lo = starts[s], hi = starts[s + 1];
  if (hi <= lo) {
    if (g == 0 && j < d) out[(long long)s * d + j] = 0.f;
    return;
  }
  const long long c0 = lo / kChunk, c1 = (hi - 1) / kChunk;
  if (c0 == c1) return;  // written whole by pass 1
  float acc = 0.f;
  if (j < d) {
#pragma unroll 4
    for (long long c = c0 + 1 + g; c <= c1; c += kGroups) acc += head[c * d + j];
  }
  part[g][threadIdx.x] = acc;
  __syncthreads();
  if (g == 0 && j < d) {
    float total = tail[c0 * d + j];
#pragma unroll
    for (int q = 0; q < kGroups; ++q) total += part[q][threadIdx.x];
    out[(long long)s * d + j] = total;
  }
}

template <typename T, typename Rows>
int segment_sums(const T* xs, Rows rows, const int* starts, long long n_rows,
                 int n_seg, int d, float* head, float* tail, float* out,
                 cudaStream_t st) {
  if (n_seg <= 0 || d <= 0) return (int)cudaGetLastError();
  const long long chunks = (n_rows + kChunk - 1) / kChunk;
  if (chunks > 0) {
    const int threads = d < kThreads ? ((d + 31) / 32) * 32 : kThreads;
    chunk_sums_kernel<<<(unsigned)chunks, threads, 0, st>>>(
        xs, rows, starts, n_rows, n_seg, d, head, tail, out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)n_seg, (unsigned)((d + kCols - 1) / kCols));
  combine_kernel<<<grid, dim3(kCols, kGroups), 0, st>>>(starts, d, head, tail,
                                                        out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tdc_segment_chunk_rows() { return kChunk; }

extern "C" int tdc_segment_sums(const float* xs, const int* starts,
                                long long n_rows, int n_seg, int d,
                                float* head, float* tail, float* out,
                                void* stream) {
  return segment_sums(xs, SortedRows{}, starts, n_rows, n_seg, d, head, tail,
                      out, (cudaStream_t)stream);
}

// B12: x (rows of x, d) f32, or bf16 when `bf16` is non-zero; order
// (n_rows,) indexes rows of x.
extern "C" int tdc_gathered_segment_sums(const void* x, int bf16,
                                         const int* order, const int* starts,
                                         long long n_rows, int n_seg, int d,
                                         float* head, float* tail, float* out,
                                         void* stream) {
  const GatheredRows rows{order};
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    return segment_sums((const __nv_bfloat16*)x, rows, starts, n_rows, n_seg,
                        d, head, tail, out, st);
  }
  return segment_sums((const float*)x, rows, starts, n_rows, n_seg, d, head,
                      tail, out, st);
}
