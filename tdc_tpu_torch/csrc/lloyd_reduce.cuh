// The second pass of the fused Lloyd kernels B1, B4 and B5: sums the G
// per-CTA workspace slices in slice order, so every sum has a fixed order
// (no float atomics, bitwise repeatable). Defined in lloyd_kernels.cu.
#pragma once

#include <cuda_runtime.h>

namespace tdc {

// B1 and B5 (cnt != nullptr): sums from the (K, d) slices of ws, counts
// from the (grid, K) integer counts. B4 (cnt == nullptr): the slices are
// (K, d+1); column d is the mass. Returns the launch's CUDA error code.
int launch_lloyd_reduce(const float* ws, const int* cnt,
                        const double* sse_part, int grid, int k, int d,
                        float* sums, float* counts, float* sse,
                        cudaStream_t s);

}  // namespace tdc
