// Shared helpers for the package's CUDA kernels (plain C interface,
// loaded with ctypes; see kernels/_build.py).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

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

// 16 bytes of T: the unit of every vector load and store
template <typename T>
struct alignas(16) Pack {
    T v[16 / sizeof(T)];
};

inline bool aligned16(const void* p) {
    return reinterpret_cast<size_t>(p) % 16 == 0;
}

// Asynchronous copy of BYTES (4, 8 or 16) from global to shared memory;
// with ok == false nothing is read and the destination is zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool ok) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    const int src_bytes = ok ? BYTES : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(gmem), "n"(BYTES), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Programmatic dependent launch: a kernel lets the next kernel on the
// stream start at once; that one stages what no kernel of the chain
// writes (the cores) before it waits for this one's results.
// griddepcontrol.wait returns when the whole preceding grid has finished
// and its writes are visible, so every kernel of a chain must wait before
// it touches a buffer that the kernel before it writes.
__device__ __forceinline__ void launch_dependents() {
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_previous_grid() {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Launch `kernel` so that it may start while the kernel before it on the
// stream still runs (it waits inside, see wait_for_previous_grid), or as
// an ordinary launch when `overlap` is false.
template <typename... Params, typename... Args>
int launch_after(void (*kernel)(Params...), dim3 grid, int threads,
                 size_t smem, cudaStream_t stream, bool overlap,
                 Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = overlap ? 1 : 0;
    cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, Params(args)...);
    if (err != cudaSuccess) return (int)err;
    TNT_CHECK_LAUNCH();
    return 0;
}

}  // namespace tnt
