// B3: per-segment row sums of label-sorted rows, and B12: the same sums
// with the row gather fused in, for Hopper (sm_90a).
//
// B3 replaces `_windowed_stats_pallas` / `_windowed_stats_kernel`
// (tdc_tpu/ops/sorted_stats.py:94, pallas_call :134, body :63). On the TPU
// the kernel walks sorted B-row blocks in grid order and keeps two (B, d)
// accumulator tiles resident across the blocks that touch them — a pattern
// that relies on the TPU's sequential grid. Here the rows of one segment
// (one label) are a contiguous run of the sorted order, and the work is
// cut by rows, not by segments, so that one long run cannot hold the whole
// kernel back.
//
// Bound on this card: bytes — each row is read once (N·d·s bytes, s = 4
// for f32 and 2 for bf16; B12 also reads `order`, 4·N) for N·d adds, and
// each segment's row written once. What the design does about it:
//
// - pass 1 (`chunk_sums_kernel`): CTA c owns the chunk of kChunk sorted
//   rows [c·kChunk, (c+1)·kChunk). One search by the whole CTA finds the
//   first segment that starts in the chunk; the CTA then walks
//   starts[s+1] forward. A segment of at most kLongRows rows is summed
//   whole by the CTA where it starts, past the chunk's end if it goes on,
//   straight into `out`: with the sorted route's short runs almost no
//   partial sums exist. A longer segment is cut at chunk edges: its
//   first chunk's run goes to `tail[c0]`, each later chunk's run to
//   `head[c]`. Rows are added in row order, a thread per 16 bytes of
//   columns (float4 of f32, 8 bf16; scalar loads where d or the base
//   pointer does not allow them), kBatch rows in flight per thread.
//   Pass 1 also records, per chunk, what pass 2 has to do there
//   (`ChunkMeta`).
// - pass 2 (`group_kernel`, `combine_kernel`): one CTA per window of
//   kWindow chunks reads those records and returns unless a long segment
//   has work there, so it launches O(chunks / kWindow) CTAs: out[s] =
//   tail[c0] + head[c0+1] + ... + head[c1], in that order. When the heads
//   outnumber the group size g (≥ kGroupMin, about √heads), `group_kernel`
//   first sums each run of g heads in order into the group's first head
//   slot, and the combine adds the group sums in order: one segment of
//   half the rows costs two short serial sums, not one of thousands of
//   rows. The combine's CTAs also write the zero rows of empty segments,
//   kEmptyStripe segments each.
//
// A pass 2 of one CTA per (segment, 32 columns), 393,216 at K=16,384,
// d=768, took 38% of the time on the card (PERF.md): hence the windows.
// A `cp.async.bulk` ring of shared-memory stages for pass 1 (a chunk of
// sorted rows is one contiguous region) measured slower there than these
// vector loads, and an L2 prefetch-size hint changed nothing; neither is
// used.
//
// B12 replaces `_gathered_windowed_stats_pallas` / `_gathered_windowed_kernel`
// (tdc_tpu/ops/sorted_stats.py:246, pallas_call :292, body :154): x arrives
// unsorted and sorted row r is x[order[r]]. On the TPU the kernel issues one
// DMA per row, one block ahead, because a vector load cannot index rows;
// here pass 1 reads row order[r] where B3 reads row r (the `Rows` functor),
// f32 rows or bf16 rows widened in registers (exact). Pass 2 is shared.
// Every column is summed in row order from 0 whatever the load width, so
// B12 is bitwise equal to B3 on x.index_select(0, order) (widened to f32).
//
// Every sum has a fixed order and there are no atomics: deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;       // sorted rows per pass-1 CTA
constexpr int kMaxThreads = 256;
constexpr int kBatch = 8;        // rows in flight per thread
constexpr int kGroupMin = 64;    // pass 2: fewest heads one group sums
// Segments longer than this are split at chunk edges; shorter ones are
// summed whole by the CTA of the chunk where they start.
constexpr int kLongRows = 4 * kChunk;

// First index i in [0, len) with a[i] >= v, or len, found by the whole
// CTA: each round every thread tests one of blockDim.x evenly spaced
// positions of the range, and the count of those below v (a prefix, as a
// is sorted) narrows it about blockDim.x-fold: 2 rounds for 16,385 starts
// at 192 threads, where a binary search takes 15 dependent loads. Every
// thread returns the same index.
__device__ __forceinline__ int cta_lower_bound(const int* __restrict__ a,
                                               int len, long long v) {
  int lo = 0, hi = len;  // the answer lies in [lo, hi]
  const int t = threadIdx.x, nt = blockDim.x;
  while (lo < hi) {
    const int span = hi - lo;
    const int p = lo + (int)((long long)span * t / nt);
    const int below = __syncthreads_count(a[p] < v);
    if (below == 0) {
      hi = lo;
    } else {
      const int last = lo + (int)((long long)span * (below - 1) / nt);
      const int next = below < nt ? lo + (int)((long long)span * below / nt)
                                  : hi;
      lo = last + 1;
      hi = next;
    }
  }
  return lo;
}

// Heads per group of pass 2 for a segment with nh heads: a power of two,
// at least kGroupMin, with g² ≥ nh. Heads are grouped only when nh > g.
__device__ __forceinline__ long long group_size(long long nh) {
  long long g = kGroupMin;
  while (g * g < nh) g *= 2;
  return g;
}

// V consecutive elements of a row, widened to f32. V = 1 is the scalar
// path; the vector forms read 16 bytes.
template <int V>
struct Vals {
  float v[V];
};
template <typename T, int V>
__device__ __forceinline__ Vals<V> load_vals(const T* __restrict__ p);
template <>
__device__ __forceinline__ Vals<1> load_vals<float, 1>(
    const float* __restrict__ p) {
  return {{__ldg(p)}};
}
template <>
__device__ __forceinline__ Vals<4> load_vals<float, 4>(
    const float* __restrict__ p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  return {{a.x, a.y, a.z, a.w}};
}
template <>
__device__ __forceinline__ Vals<1> load_vals<__nv_bfloat16, 1>(
    const __nv_bfloat16* __restrict__ p) {
  return {{__bfloat162float(p[0])}};
}
template <>
__device__ __forceinline__ Vals<8> load_vals<__nv_bfloat16, 8>(
    const __nv_bfloat16* __restrict__ p) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
  Vals<8> out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out.v[2 * i] = f.x;
    out.v[2 * i + 1] = f.y;
  }
  return out;
}

template <int V>
__device__ __forceinline__ void store_vals(float* __restrict__ p,
                                           const float (&a)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(a[i], a[i + 1], a[i + 2], a[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = a[i];
  }
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

// dst[j] = Σ rows [a, b) of column j, in row order from 0, for every
// column; a thread owns V consecutive columns at a time. kBatch rows are
// in flight per thread (their loads are independent of the adds), then
// added in row order. A row past b adds nothing (it is not loaded;
// acc + 0 leaves acc as it is, and acc is never −0). The scalar path
// (V = 1) reads kScalarBlocks column blocks of a thread in the same
// batch, so that a batch covers whole rows as the vector path's does.
constexpr int kScalarBlocks = 4;

template <typename T, int V, typename Rows>
__device__ __forceinline__ void run_sums(const T* __restrict__ x, Rows rows,
                                         long long a, long long b, int d,
                                         float* __restrict__ dst) {
  constexpr int P = V == 1 ? kScalarBlocks : 1;
  const int nv = d / V, nt = blockDim.x;
  for (int j0 = threadIdx.x; j0 < nv; j0 += P * nt) {
    float acc[P][V];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[p][e] = 0.f;
    for (long long r = a; r < b; r += kBatch) {
      Vals<V> v[kBatch][P];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const bool live = r + q < b;
        const long long row = live ? rows(r + q) : 0;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int j = j0 + p * nt;
          if (live && j < nv) {
            v[q][p] = load_vals<T, V>(x + row * d + (long long)j * V);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) v[q][p].v[e] = 0.f;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int e = 0; e < V; ++e) acc[p][e] += v[q][p].v[e];
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int j = j0 + p * nt;
      if (j < nv) store_vals<V>(dst + (long long)j * V, acc[p]);
    }
  }
}

// Pass 2's bookkeeping of one chunk, written by pass 1: the last head
// index of the group this chunk's head opens (−1 if none), and the segment
// whose tail this chunk holds (−1 if none) with its last chunk c1 and the
// stride of the heads or group sums that the combine adds.
struct __align__(16) ChunkMeta {
  int lead_end, tail_seg, c1, step;
};

template <typename T, int V, typename Rows>
__global__ void __launch_bounds__(kMaxThreads)
    chunk_sums_kernel(const T* __restrict__ x, Rows rows,
                      const int* __restrict__ starts, long long n_rows,
                      int n_seg, int d, float* __restrict__ head,
                      float* __restrict__ tail, float* __restrict__ out,
                      ChunkMeta* __restrict__ meta) {
  const long long c = blockIdx.x;
  const long long r0 = c * kChunk, r1 = r0 + kChunk;
  const long long end = r1 < n_rows ? r1 : n_rows;
  ChunkMeta info{-1, -1, 0, 1};
  // The first segment that starts at or after r0. The one before it, if
  // it holds row r0 and is long, began in an earlier chunk: its run here
  // is the head (a short one is summed whole where it starts).
  const int i = cta_lower_bound(starts, n_seg + 1, r0);
  long long lo = i <= n_seg ? starts[i] : 0;
  if (i > 0 && i <= n_seg && lo > r0 && lo - starts[i - 1] > kLongRows) {
    run_sums<T, V>(x, rows, r0, lo < end ? lo : end, d, head + c * d);
    const long long c0 = starts[i - 1] / kChunk, c1 = (lo - 1) / kChunk;
    const long long g = group_size(c1 - c0);
    if (c1 - c0 > g && (c - c0 - 1) % g == 0)
      info.lead_end = (int)(c + g - 1 < c1 ? c + g - 1 : c1);
  }
  // Segments that start in the chunk: a short one whole, past r1 if it
  // goes on; a long one (which always goes on past r1) up to r1, as the
  // tail. Empty ones get their zero rows in pass 2.
  for (int s = i; s < n_seg && lo < end; ++s) {
    const long long hi = starts[s + 1];
    if (hi - lo > kLongRows) {
      run_sums<T, V>(x, rows, lo, r1, d, tail + c * d);
      const long long c1 = (hi - 1) / kChunk, g = group_size(c1 - c);
      info.tail_seg = s;
      info.c1 = (int)c1;
      info.step = c1 - c <= g ? 1 : (int)g;
    } else if (hi > lo) {
      run_sums<T, V>(x, rows, lo, hi, d, out + (long long)s * d);
    }
    lo = hi;
  }
  if (threadIdx.x == 0) meta[c] = info;
}

// Σ of rows first, first + step, ... <= last of p (row stride d), in that
// order, added to `init` (or to 0), into dst: V columns per thread.
template <int V>
__device__ __forceinline__ void strided_sums(const float* init,
                                             const float* p, long long first,
                                             long long last, long long step,
                                             int d, float* dst) {
  const int nv = d / V;
  for (int j = threadIdx.x; j < nv; j += blockDim.x) {
    float acc[V];
    if (init != nullptr) {
      const Vals<V> v = load_vals<float, V>(init + (long long)j * V);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = v.v[e];
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
    }
    for (long long h = first; h <= last; h += kBatch * step) {
      Vals<V> v[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const long long r = h + q * step;
        if (r <= last) {
          v[q] = load_vals<float, V>(p + r * d + (long long)j * V);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) v[q].v[e] = 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] += v[q].v[e];
    }
    store_vals<V>(dst + (long long)j * V, acc);
  }
}

// Pass 2 CTAs each own a window of kWindow chunks; most windows hold no
// long segment and return after reading their records.
constexpr int kWindow = 64;

// Pass 2a. CTA w: for each chunk c of its window whose head opens a group
// (a segment with more heads than its group size g, c − c0 − 1 a multiple
// of g), in chunk order, head[c] = head[c] + ... + head[lead_end].
template <int V>
__global__ void __launch_bounds__(kMaxThreads)
    group_kernel(const ChunkMeta* __restrict__ meta, long long chunks, int d,
                 float* __restrict__ head) {
  __shared__ int lead[kWindow];
  const long long c0 = (long long)blockIdx.x * kWindow;
  for (int t = threadIdx.x; t < kWindow; t += blockDim.x)
    lead[t] = c0 + t < chunks ? meta[c0 + t].lead_end : -1;
  __syncthreads();
  for (int t = 0; t < kWindow; ++t) {
    if (lead[t] < 0) continue;
    strided_sums<V>(nullptr, head, c0 + t, lead[t], 1, d, head + (c0 + t) * d);
  }
}

// Pass 2b. CTA w: for each chunk c of its window that holds the tail of a
// segment s going on to chunk c1 > c, out[s] = tail[c] + head[c+1] + ...
// + head[c1], or tail[c] + the group sums of pass 2a in group order. Then
// the zero rows of the empty segments in its stripe of ceil(S / gridDim.x)
// segments, a warp per segment.
template <int V>
__global__ void __launch_bounds__(kMaxThreads)
    combine_kernel(const ChunkMeta* __restrict__ meta, long long chunks,
                   const int* __restrict__ starts, int n_seg, int d,
                   const float* __restrict__ head,
                   const float* __restrict__ tail, float* __restrict__ out) {
  __shared__ ChunkMeta win[kWindow];
  const long long c0 = (long long)blockIdx.x * kWindow;
  for (int t = threadIdx.x; t < kWindow; t += blockDim.x)
    win[t] = c0 + t < chunks ? meta[c0 + t] : ChunkMeta{-1, -1, 0, 1};
  __syncthreads();
  for (int t = 0; t < kWindow; ++t) {
    const ChunkMeta m = win[t];
    if (m.tail_seg < 0) continue;
    strided_sums<V>(tail + (c0 + t) * d, head, c0 + t + 1, m.c1, m.step, d,
                    out + (long long)m.tail_seg * d);
  }
  const long long per = (n_seg + gridDim.x - 1) / gridDim.x;
  const long long s0 = blockIdx.x * per;
  const long long s1 = s0 + per < n_seg ? s0 + per : n_seg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (long long s = s0 + warp; s < s1; s += blockDim.x / 32) {
    if (starts[s + 1] > starts[s]) continue;
    float* dst = out + s * d;
    for (int j = lane; j < d; j += 32) dst[j] = 0.f;
  }
}

// Threads of a CTA that owns nv vectors of columns: one warp at least,
// kMaxThreads at most.
int block_threads(int nv) {
  const int t = ((nv + 31) / 32) * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

// Segments whose zero rows one pass-2 CTA writes, at most.
constexpr int kEmptyStripe = 64;

// `passes`: bit 0 runs pass 1, bit 1 pass 2 (which reads pass 1's meta);
// 3 is the kernel, 1 and 2 time the passes apart.
template <typename T, typename Rows>
int segment_sums(const T* x, Rows rows, const int* starts, long long n_rows,
                 int n_seg, int d, float* head, float* tail, float* out,
                 ChunkMeta* meta, int passes, cudaStream_t st) {
  if (n_seg <= 0 || d <= 0) return (int)cudaGetLastError();
  const long long chunks = (n_rows + kChunk - 1) / kChunk;
  // 16-byte loads need whole vectors per row and a 16-byte aligned base;
  // head, tail and out are the wrapper's own f32 buffers (aligned).
  constexpr int kV = 16 / sizeof(T);
  const bool vec = d % kV == 0 &&
                   reinterpret_cast<unsigned long long>(x) % 16 == 0;
  if ((passes & 1) && chunks > 0) {
    const int threads = block_threads(vec ? d / kV : d);
    if (vec) {
      chunk_sums_kernel<T, kV, Rows><<<(unsigned)chunks, threads, 0, st>>>(
          x, rows, starts, n_rows, n_seg, d, head, tail, out, meta);
    } else {
      chunk_sums_kernel<T, 1, Rows><<<(unsigned)chunks, threads, 0, st>>>(
          x, rows, starts, n_rows, n_seg, d, head, tail, out, meta);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (passes & 2) {
    const bool v4 = d % 4 == 0;
    const int threads = block_threads(v4 ? d / 4 : d);
    const long long windows = (chunks + kWindow - 1) / kWindow;
    if (windows > 0) {
      if (v4) {
        group_kernel<4><<<(unsigned)windows, threads, 0, st>>>(meta, chunks, d,
                                                              head);
      } else {
        group_kernel<1><<<(unsigned)windows, threads, 0, st>>>(meta, chunks, d,
                                                              head);
      }
    }
    const long long stripes = (n_seg + kEmptyStripe - 1) / kEmptyStripe;
    const unsigned grid = (unsigned)(windows > stripes ? windows : stripes);
    if (v4) {
      combine_kernel<4><<<grid, threads, 0, st>>>(meta, chunks, starts, n_seg,
                                                  d, head, tail, out);
    } else {
      combine_kernel<1><<<grid, threads, 0, st>>>(meta, chunks, starts, n_seg,
                                                  d, head, tail, out);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tdc_segment_chunk_rows() { return kChunk; }

// Bytes of pass 2's bookkeeping per chunk (the `meta` workspace).
extern "C" int tdc_segment_meta_bytes() { return (int)sizeof(ChunkMeta); }

extern "C" int tdc_segment_sums(const float* xs, const int* starts,
                                long long n_rows, int n_seg, int d,
                                float* head, float* tail, float* out,
                                void* meta, int passes, void* stream) {
  return segment_sums(xs, SortedRows{}, starts, n_rows, n_seg, d, head, tail,
                      out, (ChunkMeta*)meta, passes, (cudaStream_t)stream);
}

// B12: x (rows of x, d) f32, or bf16 when `bf16` is non-zero; order
// (n_rows,) indexes rows of x.
extern "C" int tdc_gathered_segment_sums(const void* x, int bf16,
                                         const int* order, const int* starts,
                                         long long n_rows, int n_seg, int d,
                                         float* head, float* tail, float* out,
                                         void* meta, void* stream) {
  const GatheredRows rows{order};
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    return segment_sums((const __nv_bfloat16*)x, rows, starts, n_rows, n_seg,
                        d, head, tail, out, (ChunkMeta*)meta, 3, st);
  }
  return segment_sums((const float*)x, rows, starts, n_rows, n_seg, d, head,
                      tail, out, (ChunkMeta*)meta, 3, st);
}
