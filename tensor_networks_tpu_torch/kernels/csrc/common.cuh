// Shared helpers for the package's CUDA kernels (plain C interface,
// loaded with ctypes; see kernels/_build.py).
#pragma once

#include <cuda_runtime.h>

// Every entry point launches on the caller's stream (PyTorch's current
// stream, passed as void*) and returns the cudaError_t of its launches:
// cudaGetLastError() right after each launch, so a refused launch (bad
// grid, too much shared memory) is reported instead of silently skipped.
#define TNT_CHECK_LAUNCH()                        \
    do {                                          \
        cudaError_t err_ = cudaGetLastError();    \
        if (err_ != cudaSuccess) return (int)err_; \
    } while (0)

namespace tnt {

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ int clamp_index(int i, int n) {
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

}  // namespace tnt
