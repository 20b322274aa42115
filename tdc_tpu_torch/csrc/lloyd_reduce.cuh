// The second pass of the fused Lloyd kernels B1, B4, B5 and B10: sums the G
// per-CTA workspace slices in slice order, so every sum has a fixed order
// (no float atomics, bitwise repeatable). Defined in lloyd_kernels.cu.
#pragma once

#include <cuda_runtime.h>

namespace tdc {

// Sums from the (grid, K, d) slices of ws; counts from the (grid, K)
// integer counts (B1, B5, B10: cnt != nullptr) or the (grid, K) f32 mass (B4:
// cnt == nullptr). Returns the launch's CUDA error code.
int launch_lloyd_reduce(const float* ws, const int* cnt, const float* mass,
                        const double* sse_part, int grid, int k, int d,
                        float* sums, float* counts, float* sse,
                        cudaStream_t s);

}  // namespace tdc
