// The tensor-core accumulate shared by B6 and B9's phase 2: given a
// scratch of per-(row, component) values written by phase 1, form each
// row's weight w (B6: μ = (inv / s)^m; B9: r = exp(logp − norm)) and
// accumulate Σ_i w·x_i per component on the tensor cores, with Σ_i w.
//
// The product wᵀ·X runs as `mma.sync` m16n8k8 on TF32 operands with the
// 3xTF32 split: each f32 operand a = hi + lo, hi = rna_tf32(a), lo =
// rna_tf32(a − hi), and acc += lo·hi′ + hi·lo′ + hi·hi′ in f32 (the lo·lo′
// term, ~2^-22 of the product, is dropped). w >= 0, so the error of Σw·x
// is relative to Σw|x|, the scale of the card tolerance.
//
// Layout: a CTA of 512 threads (16 warps, each a 32 x 32 block of the
// sums as 2 x 4 m16n8 tiles) owns one K tile of components, one 128-column
// slice of x and a contiguous range of 128-row blocks of one row chunk:
// 128 components x the slice (B6), or, with kSquares, 64 components x the
// slice and its squares (B9: Σr·x and Σr·x² from one r tile, each r
// formed once). Each step stages kTcS = 32 rows of w and of the columns
// in shared memory (w split into its TF32 halves once, as it is staged),
// the next step's global loads in flight in registers while the current
// one runs its 4 x 24 MMAs per warp. The f32 MMA fragments (32 registers
// a thread) hold one 128-row block, then add to f64 carries in shared
// memory (128 KB; 183 KB in all, one CTA per SM). Two CTAs of half the
// width per SM measured slower (B6's phase 2 34.6 ms against 29.9 at the
// fuzzy route's shape, PERF.md). At the end of its row chunk the CTA
// stores (first chunk) or adds its carries to its own f64 slot of the
// (G, K, columns) workspace, so chunks sum in chunk order and the G slots
// in g order afterwards: no float atomics, two runs are bitwise equal.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "champion.cuh"

namespace tdc {

constexpr int kTcThreads = 512;  // 16 warps, one CTA per SM
constexpr int kTcK = 128;  // components per CTA (64 with x² columns)
constexpr int kTcC = 128;  // columns of x per slice
constexpr int kTcS = 32;   // rows per staging step
// Steps (128 rows) between f64 folds. The f32 fragment sums drift with
// the number of MMAs between folds: at 256 rows B9's max error on the
// "ragged soft" case went from 0.0021 to 0.0059 (PERF.md), where the f32
// FMA-pipe design had 0.00012.
constexpr int kFoldSteps = BM / kTcS;

// Phase 2's shared memory: 183 KB, one CTA per SM. Row strides of w and
// xs are ≡ 8 (mod 32) floats, so the MMA fragment loads are free of bank
// conflicts.
template <bool kSquares>
struct __align__(16) TcAccumSmem {
  static constexpr int kC = kSquares ? kTcK / 2 : kTcK;  // components
  static constexpr int kN = kSquares ? 2 * kTcC : kTcC;  // B columns
  double carry[32][kTcThreads];  // thread t's 32 fragment sums at [e][t]
  double red[kTcThreads];        // per-block Σw groups, final reductions
  unsigned wh[kTcS][kC + 8];   // one step's weights, split once: hi and
  unsigned wl[kTcS][kC + 8];   // lo TF32 halves, [row][component]
  float xs[kTcS][kN + 8];      // one step's columns: x, then x²
};

__device__ __forceinline__ unsigned tf32_rna(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// c += a·b on one m16n8k8 tile (A 16 x 8 row-major, B 8 x 8 col-major).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where phase 2 writes: the (G, K, cols) carries (cols = d, or 2d with
// x² slices), the (G, K) Σw and, where the weights have a side sum, the
// (G, K tiles) partials of it. `first`: store, else add.
struct TcOut {
  double* ws;
  double* wpart;
  double* opart;
  int first;
};

// Phase 2 of one CTA: CTA (blockIdx.x, blockIdx.y, blockIdx.z) = (K tile,
// slice of x, row range g of G) of the row chunk [row_lo, row_hi). The
// scratch holds the chunk's rows, kp values a row (kp a multiple of the
// CTA's K tile). W gives a row's value (`row`) and the weight of a
// scratch value (`operator()`, adding to a side sum where W::kSide); rows
// past row_hi and components past k weigh 0. kSquares: the CTA's K tile
// is kTcK / 2 components and its B columns are the slice of x, then its
// squares (Σw·x and Σw·x² from one weight tile). Dynamic shared memory:
// TcAccumSmem<kSquares>.
template <class W, bool kVec, bool kSquares>
__device__ __forceinline__ void tc_accumulate(
    const W& weigh, const float* __restrict__ x,
    const float* __restrict__ scr, int kp, int k, int d, long long row_lo,
    long long row_hi, TcOut out) {
  using Smem = TcAccumSmem<kSquares>;
  constexpr int kC = Smem::kC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kt = blockIdx.x * kC;
  const int dc = blockIdx.y * kTcC;
  const bool slice0 = blockIdx.y == 0;
  const int g = blockIdx.z, grid = gridDim.z;
  const long long nb = (row_hi - row_lo + BM - 1) / BM;
  const long long b0 = nb * g / grid, b1 = nb * (g + 1) / grid;
  const long long steps = (b1 - b0) * (BM / kTcS);

  // Staging: thread t takes row t / 16 of a step and components
  // (t % 16)·kW..+kW of the weights; x as float4s or scalars, kPR of them
  // a row: rows t / kPR + j·kTcThreads / kPR, column (t % kPR)·(4 or 1).
  constexpr int kTR = kTcThreads / kTcS;  // threads a row of weights
  constexpr int kW = kC / kTR;            // weights a thread stages: 4 or 8
  constexpr int kPR = kVec ? kTcC / 4 : kTcC;
  constexpr int kXN = kTcS * kPR / kTcThreads;
  using XT = typename std::conditional<kVec, float4, float>::type;
  const int wr = tid / kTR, wc = (tid % kTR) * kW;
  float4 sv[kW / 4];
  typename W::Row rv{};
  XT xv[kXN];
  auto load_step = [&](long long st) {
    const long long r0 = row_lo + (b0 + st / (BM / kTcS)) * BM +
                         (st % (BM / kTcS)) * kTcS;
    const long long row = r0 + wr;
    if (row < row_hi) {
      const float* p = scr + (row - row_lo) * kp + kt + wc;
#pragma unroll
      for (int q = 0; q < kW / 4; ++q)
        sv[q] = *reinterpret_cast<const float4*>(p + 4 * q);
      rv = weigh.row(row);
    }
#pragma unroll
    for (int j = 0; j < kXN; ++j) {
      const long long xr = r0 + tid / kPR + j * (kTcThreads / kPR);
      const int col = dc + (tid % kPR) * (kVec ? 4 : 1);
      xv[j] = (xr < row_hi && col < d)
                  ? *reinterpret_cast<const XT*>(x + xr * d + col)
                  : XT{};
    }
    return r0;
  };

  // Σw: thread t sums column t % kC over rows (t / kC)·kR..+kR of each
  // step in f32; at each fold the kG groups add in order in f64.
  constexpr int kG = kTcThreads / kC, kR = kTcS / kG;
  float side = 0.f;  // this block's side sum (f32), W::kSide only
  double sidetot = 0.0;
  float wq = 0.f;
  double wtot = 0.0;  // Σw of component kt + tid (tid < kC)
#pragma unroll 4
  for (int e = 0; e < 32; ++e) sm.carry[e][tid] = 0.0;

  // MMA mapping: warp (wm, wn) holds components wm·32..+32 (two 16-row
  // tiles) and B columns wn·32..+32 (four 8-column tiles).
  const int gq = lane / 4, t4 = lane % 4;
  constexpr int kWarpsM = kC / 32;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  long long r0 = steps > 0 ? load_step(0) : 0;
  for (long long st = 0; st < steps; ++st) {
    // The previous step's MMAs are done with the staging tiles.
    __syncthreads();
    {
      const bool live = r0 + wr < row_hi;
      const float* v = reinterpret_cast<const float*>(sv);
#pragma unroll
      for (int q4 = 0; q4 < kW / 4; ++q4) {
        unsigned hi[4], lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 4 * q4 + q;
          split_tf32((live && kt + wc + i < k) ? weigh(v[i], rv, side) : 0.f,
                     hi[q], lo[q]);
        }
        *reinterpret_cast<uint4*>(&sm.wh[wr][wc + 4 * q4]) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(&sm.wl[wr][wc + 4 * q4]) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
#pragma unroll
      for (int j = 0; j < kXN; ++j) {
        const int row = tid / kPR + j * (kTcThreads / kPR);
        const int col = (tid % kPR) * (kVec ? 4 : 1);
        *reinterpret_cast<XT*>(&sm.xs[row][col]) = xv[j];
        if (kSquares) {
          XT t = xv[j];
          float* f = reinterpret_cast<float*>(&t);
#pragma unroll
          for (int q = 0; q < (kVec ? 4 : 1); ++q) f[q] = f[q] * f[q];
          *reinterpret_cast<XT*>(&sm.xs[row][kTcC + col]) = t;
        }
      }
    }
    __syncthreads();
    if (st + 1 < steps) r0 = load_step(st + 1);
    if (slice0) {
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        const int r = (tid / kC) * kR + q;
        wq += __uint_as_float(sm.wh[r][tid % kC]) +
              __uint_as_float(sm.wl[r][tid % kC]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kTcS; kk += 8) {
      unsigned ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int cb = wm * 32 + i * 16 + gq;
        const int at[4][2] = {{kk + t4, cb}, {kk + t4, cb + 8},
                              {kk + t4 + 4, cb}, {kk + t4 + 4, cb + 8}};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[i][e] = sm.wh[at[e][0]][at[e][1]];
          al[i][e] = sm.wl[at[e][0]][at[e][1]];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nb = wn * 32 + j * 8 + gq;
        split_tf32(sm.xs[kk + t4][nb], bh[j][0], bl[j][0]);
        split_tf32(sm.xs[kk + t4 + 4][nb], bh[j][1], bl[j][1]);
      }
      // The small products first; eight independent tiles between two
      // products into the same tile.
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bh[j][0], bh[j][1]);
    }
    if ((st + 1) % kFoldSteps == 0 || st + 1 == steps) {
      // Every 128 rows, and at the end: the f32 sums into the f64 carries.
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            sm.carry[(i * 4 + j) * 4 + r][tid] += (double)acc[i][j][r];
            acc[i][j][r] = 0.f;
          }
      if (W::kSide) {
        sidetot += (double)side;
        side = 0.f;
      }
      if (slice0) {  // the block's Σw: its kG groups in order
        sm.red[tid] = (double)wq;
        wq = 0.f;
        __syncthreads();
        if (tid < kC) {
          double t = 0.0;
#pragma unroll
          for (int q = 0; q < kG; ++q) t += sm.red[tid + q * kC];
          wtot += t;
        }
        __syncthreads();
      }
    }
  }

  // This CTA's carries into its slot g: B column c of the slice is x
  // column dc + c % 128, squared where c >= 128.
  const int ncols = kSquares ? 2 * d : d;
  double* dst = out.ws + (long long)g * k * ncols;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int comp = kt + wm * 32 + i * 16 + gq + (r >= 2 ? 8 : 0);
        const int c = wn * 32 + j * 8 + 2 * t4 + (r & 1);
        const int col = dc + c % kTcC;
        if (comp < k && col < d) {
          double& o = dst[(long long)comp * ncols + (c >= kTcC ? d : 0) + col];
          const double v = sm.carry[(i * 4 + j) * 4 + r][tid];
          o = out.first ? v : o + v;
        }
      }
  if (!slice0) return;
  if (tid < kC && kt + tid < k) {
    double& o = out.wpart[(long long)g * k + kt + tid];
    o = out.first ? wtot : o + wtot;
  }
  if (W::kSide) {
    __syncthreads();  // the last block's Σw reads of red are done
    sm.red[tid] = sidetot;
    __syncthreads();
    if (tid == 0) {
      double s = 0.0;
      for (int t = 0; t < kTcThreads; ++t) s += sm.red[t];
      double& o = out.opart[(long long)g * gridDim.x + blockIdx.x];
      o = out.first ? s : o + s;
    }
  }
}

// The grid of a phase-2 launch: (K tiles, slices of x, G).
inline dim3 tc_grid(int k, int d, bool squares, int grid) {
  const int kc = squares ? kTcK / 2 : kTcK;
  return dim3((unsigned)((k + kc - 1) / kc), (unsigned)((d + kTcC - 1) / kTcC),
              (unsigned)grid);
}

}  // namespace tdc
