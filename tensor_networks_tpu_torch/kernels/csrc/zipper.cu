// H1: the TT inner-product zipper for Hopper (sm_90a).
//
// Replaces tensor_networks_tpu/kernels/pallas_ops.py::tt_inner_pallas
// (K1, :502) and ::tt_inner_pallas_fused (K2, :229).  The TPU kernels run
// the d-2 zipper steps as a sequential grid with the (r_a x r_b) carry W
// held in VMEM; CUDA blocks run in no fixed order, so here the step
// boundary is stream order instead: one C call runs the whole inner
// product from a host loop (one ctypes call = one inner product, as K2
// was one dispatch):
//
//   W0 = fa^T fb                                   (prologue GEMM)
//   per middle core pair (A_k, B_k):
//     t  = W^T A_k,  A_k viewed as (r_a, n*r_a)    (GEMM, r_b x n*r_a)
//     W' = t^T B_k over the (r_b*n) rows           (split-K GEMM + reduce)
//   out = sum W (.) (la lb^T)                      (one-block epilogue)
//
// What bounds it on the H100: at d=50, n=32, r=100 one inner product is
// ~6.1 GFLOP over ~123 MB of cores, i.e. FP32-FMA-bound (~90 us at
// 67 TFLOP/s against ~37 us at 3.35 TB/s).  This first version is a plain
// shared-memory-tiled FMA GEMM (64x64 tiles, 4x4 per thread) with no
// tensor cores; the second GEMM of a step has only ceil(r_a/64) *
// ceil(r_b/64) output tiles over a K of r_b*n, so it is split along K
// (deterministic two-pass reduction, no atomics) to fill the SMs.  No
// 128-padding: any r_a != r_b, any n, ranks up to 512, d_mid >= 0.

#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;  // 16 x 16, each a 4 x 4 micro-tile

// C[M x N] (row-major, ld N) = At^T B with At (K x M, ld lda) and
// B (K x N, ld ldb), both row-major.  blockIdx.z takes the K range
// [z * kchunk, (z + 1) * kchunk) and writes its partial product to the
// z-th (M x N) slab of C.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gemm_tn(const T* __restrict__ At, int lda, const T* __restrict__ B, int ldb,
        T* __restrict__ C, int M, int N, int K, int kchunk) {
    __shared__ T As[BK][BM];
    __shared__ T Bs[BK][BN];
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const int m0 = blockIdx.y * BM;
    const int n0 = blockIdx.x * BN;
    const int kbeg = blockIdx.z * kchunk;
    const int kend = min(K, kbeg + kchunk);
    C += (size_t)blockIdx.z * M * N;

    T acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

    for (int k0 = kbeg; k0 < kend; k0 += BK) {
        // coalesced tile loads: consecutive threads, consecutive m / n
        for (int e = tid; e < BK * BM; e += THREADS) {
            const int kk = e / BM, mm = e % BM;
            const int k = k0 + kk, m = m0 + mm;
            As[kk][mm] = (k < kend && m < M) ? At[(size_t)k * lda + m] : T(0);
        }
        for (int e = tid; e < BK * BN; e += THREADS) {
            const int kk = e / BN, nn = e % BN;
            const int k = k0 + kk, n = n0 + nn;
            Bs[kk][nn] = (k < kend && n < N) ? B[(size_t)k * ldb + n] : T(0);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            T a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty + 16 * i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx + 16 * j;
            if (n < N) C[(size_t)m * N + n] = acc[i][j];
        }
    }
}

// C[i] = sum_z part[z][i], summed in a fixed order (deterministic).
template <typename T>
__global__ void reduce_splits(const T* __restrict__ part, T* __restrict__ C,
                              int mn, int splits) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < mn;
         i += gridDim.x * blockDim.x) {
        T s = T(0);
        for (int z = 0; z < splits; ++z) s += part[(size_t)z * mn + i];
        C[i] = s;
    }
}

// out = sum_{a,b} W[a,b] * sum_n la[a,n] lb[b,n], one block, fixed order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
zipper_epilogue(const T* __restrict__ W, const T* __restrict__ la,
                const T* __restrict__ lb, T* __restrict__ out, int ra, int rb,
                int n) {
    __shared__ T warp_part[THREADS / 32];
    T s = T(0);
    for (int p = threadIdx.x; p < ra * rb; p += THREADS) {
        const int a = p / rb, b = p % rb;
        const T* x = la + (size_t)a * n;
        const T* y = lb + (size_t)b * n;
        T lab = T(0);
        for (int j = 0; j < n; ++j) lab = fma(x[j], y[j], lab);
        s = fma(W[p], lab, s);
    }
    s = tnt::warp_sum(s);
    if (threadIdx.x % 32 == 0) warp_part[threadIdx.x / 32] = s;
    __syncthreads();
    if (threadIdx.x < 32) {
        T v = threadIdx.x < THREADS / 32 ? warp_part[threadIdx.x] : T(0);
        v = tnt::warp_sum(v);
        if (threadIdx.x == 0) out[0] = v;
    }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// One GEMM launch; splits > 1 writes `splits` partial slabs to `part`
// and reduces them into C.
template <typename T>
int gemm(const T* At, int lda, const T* B, int ldb, T* C, T* part, int M,
         int N, int K, int splits, cudaStream_t stream) {
    int kchunk = cdiv(cdiv(K, splits), BK) * BK;
    splits = kchunk > 0 ? cdiv(K, kchunk) : 1;
    if (splits <= 1) {
        dim3 grid(cdiv(N, BN), cdiv(M, BM), 1);
        gemm_tn<T><<<grid, THREADS, 0, stream>>>(At, lda, B, ldb, C, M, N, K,
                                                 K);
        TNT_CHECK_LAUNCH();
        return 0;
    }
    dim3 grid(cdiv(N, BN), cdiv(M, BM), splits);
    gemm_tn<T><<<grid, THREADS, 0, stream>>>(At, lda, B, ldb, part, M, N, K,
                                             kchunk);
    TNT_CHECK_LAUNCH();
    const int mn = M * N;
    reduce_splits<T><<<cdiv(mn, 256), 256, 0, stream>>>(part, C, mn, splits);
    TNT_CHECK_LAUNCH();
    return 0;
}

// fa (n0, ra), ma (d_mid, ra, n, ra), la (ra, nl); likewise b with rb.
// Workspace: w (ra*rb), t (rb*n*ra), part (splits*ra*rb, unused when
// splits == 1).  Writes the scalar to out[0].
template <typename T>
int zipper(const T* fa, const T* ma, const T* la, const T* fb, const T* mb,
           const T* lb, T* w, T* t, T* part, T* out, int n0, int n, int nl,
           int ra, int rb, int d_mid, int splits, cudaStream_t stream) {
    int rc = gemm<T>(fa, ra, fb, rb, w, part, ra, rb, n0, 1, stream);
    if (rc) return rc;
    const size_t core_a = (size_t)ra * n * ra;
    const size_t core_b = (size_t)rb * n * rb;
    for (int k = 0; k < d_mid; ++k) {
        // t[b, (n a2)] = sum_a W[a, b] A_k[a, (n a2)]
        rc = gemm<T>(w, rb, ma + k * core_a, n * ra, t, part, rb, n * ra, ra,
                     1, stream);
        if (rc) return rc;
        // W'[a2, b2] = sum_{(b1 n)} t[(b1 n), a2] B_k[(b1 n), b2]
        rc = gemm<T>(t, ra, mb + k * core_b, rb, w, part, ra, rb, rb * n,
                     splits, stream);
        if (rc) return rc;
    }
    zipper_epilogue<T><<<1, THREADS, 0, stream>>>(w, la, lb, out, ra, rb, nl);
    TNT_CHECK_LAUNCH();
    return 0;
}

}  // namespace

extern "C" {

int tnt_zipper_f32(const void* fa, const void* ma, const void* la,
                   const void* fb, const void* mb, const void* lb, void* w,
                   void* t, void* part, void* out, int n0, int n, int nl,
                   int ra, int rb, int d_mid, int splits, void* stream) {
    return zipper<float>(
        (const float*)fa, (const float*)ma, (const float*)la,
        (const float*)fb, (const float*)mb, (const float*)lb, (float*)w,
        (float*)t, (float*)part, (float*)out, n0, n, nl, ra, rb, d_mid, splits,
        (cudaStream_t)stream);
}

int tnt_zipper_f64(const void* fa, const void* ma, const void* la,
                   const void* fb, const void* mb, const void* lb, void* w,
                   void* t, void* part, void* out, int n0, int n, int nl,
                   int ra, int rb, int d_mid, int splits, void* stream) {
    return zipper<double>(
        (const double*)fa, (const double*)ma, (const double*)la,
        (const double*)fb, (const double*)mb, (const double*)lb, (double*)w,
        (double*)t, (double*)part, (double*)out, n0, n, nl, ra, rb, d_mid,
        splits,
        (cudaStream_t)stream);
}

const char* tnt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
