// Shared helpers for the package's CUDA kernels (plain C interface,
// loaded with ctypes; see kernels/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

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

// Storage and arithmetic types.  Cores may be stored in float, double,
// __nv_bfloat16 or __half; a kernel computes in Acc<S>::type (float for
// the 2-byte types), keeps every carry and partial product in it, and
// writes its result back in the storage type.
template <typename S>
struct Acc {
    using type = S;
};
template <>
struct Acc<__half> {
    using type = float;
};
template <>
struct Acc<__nv_bfloat16> {
    using type = float;
};

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ double to_acc(double x) { return x; }
__device__ __forceinline__ float to_acc(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename S>
struct Store {
    template <typename T>
    __device__ static S from(T x) {
        return x;
    }
};
template <>
struct Store<__half> {
    __device__ static __half from(float x) { return __float2half_rn(x); }
};
template <>
struct Store<__nv_bfloat16> {
    __device__ static __nv_bfloat16 from(float x) {
        return __float2bfloat16_rn(x);
    }
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

// N consecutive values from global memory (type S) into shared memory
// (type T), zero-filled when ok == false.  When S is T this is one
// cp.async of N * sizeof(T) bytes (4, 8 or 16).  A 2-byte S converts
// on the way, so the copy is a synchronous load: one value, or four
// (one 8-byte load) into 16 aligned bytes of float.  cp.async cannot
// convert, and cannot copy the 2 bytes of one value.
template <int N, typename T, typename S>
__device__ __forceinline__ void stage(T* smem, const S* gmem, bool ok) {
    if constexpr (std::is_same<S, T>::value) {
        cp_async<N * sizeof(T)>(smem, gmem, ok);
    } else if constexpr (N == 1) {
        *smem = ok ? to_acc(*gmem) : T(0);
    } else {
        static_assert(N == 4 && sizeof(S) == 2 && sizeof(T) == 4,
                      "a packed conversion is four 2-byte values to float");
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok) {
            const uint2 raw = *reinterpret_cast<const uint2*>(gmem);
            const S* h = reinterpret_cast<const S*>(&raw);
            v = make_float4(to_acc(h[0]), to_acc(h[1]), to_acc(h[2]),
                            to_acc(h[3]));
        }
        *reinterpret_cast<float4*>(smem) = v;
    }
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
