// H2: batched TT evaluation for Hopper (sm_90a).
//
// Replaces tensor_networks_tpu/kernels/pallas_ops.py::tt_evaluate_pallas
// (K3, :424) and tensor_networks_tpu/kernels/ragged_eval.py::
// tt_evaluate_ragged (K4, :107).  Both compute
//
//   out[b] = first[i_b0, :] . mids[0][:, i_b1, :] ... mids[d-3][:, i_b(d-2), :]
//            . last[:, i_b(d-1)]
//
// K3 multiplies each (tile, r) carry by the whole (r, n*r) core and picks
// the point's column with a one-hot mask-reduce (Mosaic cannot gather);
// K4 sorts points by mode and runs grouped matmuls.  A CUDA thread can
// gather, so here each point reads exactly its own (r x r) slice
// mids[k][:, i, :] straight from global memory / L2 (rows are contiguous
// along the last axis, so a warp's loads coalesce): B*r*r FMAs per step
// instead of B*r*n*r, no identity padding, no bf16 hi/lo split.
//
// Layout: one warp per point; a block's points keep their (points, r)
// carry in shared memory (at most 8 * 512 * 8 B = 32 KB, under the 48 KB
// static limit); each lane owns carry columns lane + 32*q.  The last
// contraction with last[:, i_b(d-1)] runs in the same kernel.
//
// What bounds it on the H100: every point streams r*r values per step
// (d=50, n=32, r=100, B=8192: ~15.7 GB through L2 for ~7.9 GFLOP), so it
// is L2-bandwidth-bound; the cores themselves (~61 MB) mostly stay in the
// 50 MB L2 across points.  Sorting points by mode so a slice is read once
// per group (K4's idea) is later work.  Indices are clamped to [0, n) as
// a memory-safety guard; the public entry points clamp first.

#include "common.cuh"

namespace {

constexpr int WARPS = 8;  // points per block

template <typename T, int MAXQ>
__global__ void __launch_bounds__(WARPS * 32)
tt_evaluate_kernel(const T* __restrict__ first, const T* __restrict__ mids,
                   const T* __restrict__ last, const int* __restrict__ idx,
                   T* __restrict__ out, int B, int d, int n, int r) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* carry = reinterpret_cast<T*>(smem_raw);
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int b = blockIdx.x * WARPS + warp;
    if (b >= B) return;  // warps never synchronize across the block

    T* v = carry + (size_t)warp * r;
    const int* ib = idx + (size_t)b * d;
    const int c0 = tnt::clamp_index(ib[0], n);
    for (int j = lane; j < r; j += 32) v[j] = first[(size_t)c0 * r + j];
    __syncwarp();

    const size_t row_stride = (size_t)n * r;  // mids[k][i, c, :] -> [i+1, c, :]
    for (int k = 0; k < d - 2; ++k) {
        const int c = tnt::clamp_index(ib[k + 1], n);
        const T* slice = mids + ((size_t)k * r * n + c) * r;
        T acc[MAXQ];
#pragma unroll
        for (int q = 0; q < MAXQ; ++q) acc[q] = T(0);
#pragma unroll 4
        for (int i = 0; i < r; ++i) {
            const T vi = v[i];
            const T* row = slice + i * row_stride;
#pragma unroll
            for (int q = 0; q < MAXQ; ++q) {
                const int j = lane + 32 * q;
                if (j < r) acc[q] = fma(vi, row[j], acc[q]);
            }
        }
        __syncwarp();
#pragma unroll
        for (int q = 0; q < MAXQ; ++q) {
            const int j = lane + 32 * q;
            if (j < r) v[j] = acc[q];
        }
        __syncwarp();
    }

    const int cl = tnt::clamp_index(ib[d - 1], n);
    T s = T(0);
    for (int j = lane; j < r; j += 32) s = fma(v[j], last[(size_t)j * n + cl], s);
    s = tnt::warp_sum(s);
    if (lane == 0) out[b] = s;
}

template <typename T, int MAXQ>
int launch(const T* first, const T* mids, const T* last, const int* idx,
           T* out, int B, int d, int n, int r, cudaStream_t stream) {
    const int blocks = (B + WARPS - 1) / WARPS;
    const size_t smem = (size_t)WARPS * r * sizeof(T);
    tt_evaluate_kernel<T, MAXQ><<<blocks, WARPS * 32, smem, stream>>>(
        first, mids, last, idx, out, B, d, n, r);
    TNT_CHECK_LAUNCH();
    return 0;
}

// first (n, r), mids (d-2, r, n, r), last (r, n), idx (B, d) int32,
// out (B,).  r <= 512, B >= 1, d >= 2.
template <typename T>
int evaluate(const T* first, const T* mids, const T* last, const int* idx,
             T* out, int B, int d, int n, int r, cudaStream_t stream) {
    if (r <= 128) return launch<T, 4>(first, mids, last, idx, out, B, d, n, r, stream);
    if (r <= 256) return launch<T, 8>(first, mids, last, idx, out, B, d, n, r, stream);
    if (r <= 512) return launch<T, 16>(first, mids, last, idx, out, B, d, n, r, stream);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int tnt_evaluate_f32(const void* first, const void* mids, const void* last,
                     const void* idx, void* out, int B, int d, int n, int r,
                     void* stream) {
    return evaluate<float>((const float*)first, (const float*)mids,
                           (const float*)last, (const int*)idx, (float*)out,
                           B, d, n, r, (cudaStream_t)stream);
}

int tnt_evaluate_f64(const void* first, const void* mids, const void* last,
                     const void* idx, void* out, int B, int d, int n, int r,
                     void* stream) {
    return evaluate<double>((const double*)first, (const double*)mids,
                            (const double*)last, (const int*)idx,
                            (double*)out, B, d, n, r, (cudaStream_t)stream);
}

}  // extern "C"
