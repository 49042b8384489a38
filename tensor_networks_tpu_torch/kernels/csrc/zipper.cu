// H1: the TT inner-product zipper for Hopper (sm_90a).
//
// Replaces tensor_networks_tpu/kernels/pallas_ops.py::tt_inner_pallas
// (K1, :502) and ::tt_inner_pallas_fused (K2, :229).  The TPU kernels run
// the d-2 zipper steps as a sequential grid with the (r_a x r_b) carry W
// held in VMEM; CUDA blocks run in no fixed order, so here the step
// boundary is stream order instead, and one C call runs the whole inner
// product from a host loop (one ctypes call = one inner product, as K2
// was one dispatch).  Two routes, chosen by rank in kernels/zipper.py:
//
// The fused route, max(r_a, r_b) <= FUSED_MAX_RANK (128):
//
//   W0 = fa^T fb                                        (gemm_tn)
//   per middle core pair (A_k, B_k), per (mode i, band of a2 rows):
//     part[i, a2, b2] = sum_b (sum_a A[a,i,a2] W[a,b]) B[b,i,b2]  (zip_step)
//   W' = sum_i part[i] in increasing i                  (zip_reduce)
//   out = sum_{a,j} la[a,j] (W lb)[a,j]                 (zip_last)
//
// 1 + 2 (d-2) + 1 launches, each after the first a programmatic dependent
// launch: a step's blocks stage their core slices while the reduce before
// them runs, and wait for it before they read W or write part.  A step
// block keeps its A slice, U = A_i^T W and two cp.async rings of K-slabs
// (W, then B_i) in shared memory, so t never goes to L2.
//
// The chain, above that rank (the first design of this kernel, and the
// yardstick of the fused route's timings):
//
//   W0 = fa^T fb                                   (prologue GEMM)
//   per middle core pair (A_k, B_k):
//     t  = W^T A_k,  A_k viewed as (r_a, n*r_a)    (GEMM, r_b x n*r_a)
//     W' = t^T B_k over the (r_b*n) rows           (split-K GEMM + reduce)
//   out = sum W (.) (la lb^T)                      (one-block epilogue)
//
// What bounds it on the H100: at d=50, n=32, r=100 one inner product is
// ~6.1 GFLOP over ~123 MB of cores, i.e. FP32-FMA-bound (~90 us at
// 67 TFLOP/s against ~37 us at 3.35 TB/s).  Both routes use FP32/FP64 FMA,
// no tensor cores (one TF32 pass does not keep f32 accuracy).  A step of
// the fused route is ~2 us of FMAs on each SM, so the chain of dependent
// launches and the reduce cost about as much as the arithmetic.  No
// atomics and a fixed summation order: two calls give the same bits.  No
// 128-padding: any r_a != r_b, any n, any rank (the chain's GEMMs tile
// every M, N and K), d_mid >= 0.
//
// Storage types: cores in float, double, __nv_bfloat16 or __half.  The
// 2-byte types are converted to float as they are loaded (tnt::stage);
// W, t, part and every product are float, and the scalar is written back
// in the cores' type.  Shared memory holds float, so the fused route's
// bands for a 2-byte type are float's.

#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;  // 16 x 16, each a 4 x 4 micro-tile

// C[M x N] (row-major, ld N) = At^T B with At (K x M, ld lda) and
// B (K x N, ld ldb), both row-major, read as T (each may be stored in
// another type).  blockIdx.z takes the K range [z * kchunk, (z + 1) *
// kchunk) and writes its partial product to the z-th (M x N) slab of C.
template <typename T, typename TA, typename TB>
__global__ void __launch_bounds__(THREADS)
gemm_tn(const TA* __restrict__ At, int lda, const TB* __restrict__ B, int ldb,
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
    // lets the fused route's first step stage its cores while this runs
    tnt::launch_dependents();

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
            As[kk][mm] =
                (k < kend && m < M) ? tnt::to_acc(At[(size_t)k * lda + m]) : T(0);
        }
        for (int e = tid; e < BK * BN; e += THREADS) {
            const int kk = e / BN, nn = e % BN;
            const int k = k0 + kk, n = n0 + nn;
            Bs[kk][nn] =
                (k < kend && n < N) ? tnt::to_acc(B[(size_t)k * ldb + n]) : T(0);
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
template <typename S, typename T>
__global__ void __launch_bounds__(THREADS)
zipper_epilogue(const T* __restrict__ W, const S* __restrict__ la,
                const S* __restrict__ lb, S* __restrict__ out, int ra, int rb,
                int n) {
    __shared__ T warp_part[THREADS / 32];
    T s = T(0);
    for (int p = threadIdx.x; p < ra * rb; p += THREADS) {
        const int a = p / rb, b = p % rb;
        const S* x = la + (size_t)a * n;
        const S* y = lb + (size_t)b * n;
        T lab = T(0);
        for (int j = 0; j < n; ++j)
            lab = fma(tnt::to_acc(x[j]), tnt::to_acc(y[j]), lab);
        s = fma(W[p], lab, s);
    }
    s = tnt::warp_sum(s);
    if (threadIdx.x % 32 == 0) warp_part[threadIdx.x / 32] = s;
    __syncthreads();
    if (threadIdx.x < 32) {
        T v = threadIdx.x < THREADS / 32 ? warp_part[threadIdx.x] : T(0);
        v = tnt::warp_sum(v);
        if (threadIdx.x == 0) out[0] = tnt::Store<S>::from(v);
    }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// One GEMM launch; splits > 1 writes `splits` partial slabs to `part`
// and reduces them into C.
template <typename T, typename TA, typename TB>
int gemm(const TA* At, int lda, const TB* B, int ldb, T* C, T* part, int M,
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

// fa (n0, ra), ma (d_mid, ra, n, ra), la (ra, nl); likewise b with rb;
// all stored as S.  Workspace, in T = Acc<S>: w (ra*rb), t (rb*n*ra),
// part (splits*ra*rb, unused when splits == 1).  Writes the scalar to
// out[0], in S.
template <typename S, typename T = typename tnt::Acc<S>::type>
int zipper(const S* fa, const S* ma, const S* la, const S* fb, const S* mb,
           const S* lb, T* w, T* t, T* part, S* out, int n0, int n, int nl,
           int ra, int rb, int d_mid, int splits, cudaStream_t stream) {
    if (ra < 1 || rb < 1 || n0 < 1 || nl < 1 || d_mid < 0 ||
        (d_mid > 0 && n < 1))
        return (int)cudaErrorInvalidValue;
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
    zipper_epilogue<S, T><<<1, THREADS, 0, stream>>>(w, la, lb, out, ra, rb,
                                                     nl);
    TNT_CHECK_LAUNCH();
    return 0;
}


// ---- the fused route (max(r_a, r_b) <= FUSED_MAX_RANK): per middle core
// pair one zip_step and one zip_reduce, chained by programmatic dependent
// launch ----
//
//   part[i, a2, b2] = sum_b (sum_a A[a, i, a2] W[a, b]) B[b, i, b2]
//   W'[a2, b2]      = sum_{i = 0..n-1} part[i, a2, b2], i in increasing order

constexpr int FUSED_MAX_RANK = 128;  // = kernels/zipper.py FUSED_MAX_RANK
constexpr int STEP_TM = 4;     // band rows per thread; bands start at multiples
constexpr int STEP_NJ = 1;     // 16-byte column packs per thread
constexpr int STEP_MAX_THREADS = 256;
constexpr int NSTAGE = 4;      // K-slabs in flight per ring
constexpr int REDUCE_THREADS = 64;
constexpr int REDUCE_CHUNK = 8;  // partial products loaded before they are summed
constexpr int LAST_THREADS = 1024;

// acc[m][c] += sum_{kk < kcount} L[kk][ty*TM + m] * R[kk][col(c)]: the
// thread's (STEP_TM x TN) tile of a block product whose left operand is
// stored k-major in shared memory (row stride ldl) and whose right
// operand is a ring stage (row stride ldr).  Both stages of zip_step use it.
template <typename T, int TN>
__device__ __forceinline__ void fma_slab(T (&acc)[STEP_TM][TN],
                                         const T* __restrict__ L, int ldl,
                                         const T* __restrict__ R, int ldr,
                                         int kcount, int ty, int tx, int txc) {
    constexpr int PK = 16 / sizeof(T);
    constexpr int NJ = TN / PK;
    constexpr int MP = STEP_TM / PK;  // packs of the thread's rows
    using P = tnt::Pack<T>;
    const T* l = L + ty * STEP_TM;
    auto step = [&](int kk) {
        P a[MP], b[NJ];
#pragma unroll
        for (int p = 0; p < MP; ++p)
            a[p] = *reinterpret_cast<const P*>(l + kk * ldl + p * PK);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
            b[j] = *reinterpret_cast<const P*>(R + kk * ldr + (j * txc + tx) * PK);
#pragma unroll
        for (int m = 0; m < STEP_TM; ++m)
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int c = 0; c < PK; ++c)
                    acc[m][j * PK + c] =
                        fma(a[m / PK].v[m % PK], b[j].v[c], acc[m][j * PK + c]);
    };
    if (kcount == BK) {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) step(kk);
    } else {
        for (int kk = 0; kk < kcount; ++kk) step(kk);
    }
}

// One middle core pair for one (mode i, band of a2 rows): blockIdx.x is
// the mode, blockIdx.y the band.  A = ma[k] (ra, n, ra), B = mb[k]
// (rb, n, rb), W (ra, rb), part (n, ra, rb).  The band's rows are whole
// units of STEP_TM rows spread as evenly as possible over nbands
// (kernels/zipper.py::band_rows); tmax is the largest band, rounded up to
// STEP_TM.  vec_a: ra is a multiple of a Pack of T and A is 16-byte
// aligned; vec_b: the same for rb, B, W and part.  A and B are stored as
// S and staged into shared memory as T (tnt::stage).
//
// Before griddepcontrol.wait the block reads only the cores: its slice
// A[:, i, band] and the first K-slabs of B[:, i, :].  W (the reduce's
// output) and part (the reduce's input) are touched only after it.
template <typename S, typename T>
__global__ void __launch_bounds__(STEP_MAX_THREADS)
zip_step(const S* __restrict__ A, const S* __restrict__ B,
         const T* __restrict__ W, T* __restrict__ part, int n, int ra, int rb,
         int nbands, int tmax, int vec_a, int vec_b) {
    constexpr int PK = 16 / sizeof(T);
    constexpr int TN = STEP_NJ * PK;
    using P = tnt::Pack<T>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int txc = (rb + TN - 1) / TN;
    const int np = txc * TN;  // a ring row: rb columns padded to whole tiles
    T* As = reinterpret_cast<T*>(smem_raw);  // [ra][tmax]  A[:, i, band]
    T* Ut = As + (size_t)ra * tmax;          // [rb][tmax]  U^T
    T* Wr = Ut + (size_t)rb * tmax;          // [NSTAGE][BK][np]
    T* Br = Wr + NSTAGE * BK * np;           // [NSTAGE][BK][np]

    tnt::launch_dependents();
    const int mode = blockIdx.x;
    const int band = blockIdx.y;
    const int units = (ra + STEP_TM - 1) / STEP_TM;
    const int base = units / nbands, extra = units % nbands;
    const int u0 = band * base + min(band, extra);
    const int band0 = u0 * STEP_TM;
    const int rows = min(ra, (u0 + base + (band < extra)) * STEP_TM) - band0;
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int tx = tid % txc;
    const int ty = tid / txc;
    const bool active = ty < tmax / STEP_TM;
    const int nslab_a = (ra + BK - 1) / BK;
    const int nslab_b = (rb + BK - 1) / BK;
    const S* Ai = A + (size_t)mode * ra + band0;  // A[a, i, band0 + m]
    const S* Bi = B + (size_t)mode * rb;          // B[b, i, c]
    const size_t lda_g = (size_t)n * ra;
    const size_t ldb_g = (size_t)n * rb;

    // rows k0 .. k0 + BK of a (K x rb) operand with row stride ld: W
    // (stored as T) or B_i (stored as S)
    auto load_slab = [&](T* stage, const auto* src, size_t ld, int k0, int K) {
        if (vec_b) {
            const int cp = np / PK;
            for (int e = tid; e < BK * cp; e += nthreads) {
                const int kk = e / cp, c = (e % cp) * PK;
                const bool ok = k0 + kk < K && c < rb;
                tnt::stage<PK>(stage + kk * np + c,
                               ok ? src + (size_t)(k0 + kk) * ld + c : src, ok);
            }
        } else {
            for (int e = tid; e < BK * np; e += nthreads) {
                const int kk = e / np, c = e % np;
                const bool ok = k0 + kk < K && c < rb;
                tnt::stage<1>(stage + kk * np + c,
                              ok ? src + (size_t)(k0 + kk) * ld + c : src, ok);
            }
        }
    };

    // the cores only, before the wait: no kernel of the chain writes them
    if (vec_a) {
        const int mp = tmax / PK;
        for (int e = tid; e < ra * mp; e += nthreads) {
            const int a = e / mp, m = (e % mp) * PK;
            const bool ok = m < rows;
            tnt::stage<PK>(As + a * tmax + m, ok ? Ai + a * lda_g + m : Ai, ok);
        }
    } else {
        for (int e = tid; e < ra * tmax; e += nthreads) {
            const int a = e / tmax, m = e % tmax;
            const bool ok = m < rows;
            tnt::stage<1>(As + a * tmax + m, ok ? Ai + a * lda_g + m : Ai, ok);
        }
    }
    for (int s = 0; s < NSTAGE - 1; ++s)
        if (s < nslab_b) load_slab(Br + s * BK * np, Bi, ldb_g, s * BK, rb);
    tnt::cp_async_commit();
    tnt::wait_for_previous_grid();
    for (int s = 0; s < NSTAGE - 1; ++s) {
        if (s < nslab_a) load_slab(Wr + s * BK * np, W, rb, s * BK, ra);
        tnt::cp_async_commit();
    }

    T acc[STEP_TM][TN];
#pragma unroll
    for (int m = 0; m < STEP_TM; ++m)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[m][c] = T(0);

    // stage 1: U = A[:, i, band]^T W (tmax x rb, K = ra), W through the ring
    for (int s = 0; s < nslab_a; ++s) {
        tnt::cp_async_wait<NSTAGE - 2>();  // slab s (and the cores) landed
        __syncthreads();                   // for every thread; s-1 consumed
        const int next = s + NSTAGE - 1;
        if (next < nslab_a)
            load_slab(Wr + (next % NSTAGE) * BK * np, W, rb, next * BK, ra);
        tnt::cp_async_commit();
        if (active)
            fma_slab<T, TN>(acc, As + (size_t)s * BK * tmax, tmax,
                            Wr + (s % NSTAGE) * BK * np, np,
                            min(BK, ra - s * BK), ty, tx, txc);
    }
    // U^T to shared memory: column c of U is row c of Ut
    if (active) {
#pragma unroll
        for (int j = 0; j < STEP_NJ; ++j)
#pragma unroll
            for (int q = 0; q < PK; ++q) {
                const int c = (j * txc + tx) * PK + q;
                if (c >= rb) continue;
#pragma unroll
                for (int p = 0; p < STEP_TM / PK; ++p) {
                    P val;
#pragma unroll
                    for (int e = 0; e < PK; ++e) val.v[e] = acc[p * PK + e][j * PK + q];
                    *reinterpret_cast<P*>(Ut + c * tmax + ty * STEP_TM + p * PK) = val;
                }
            }
#pragma unroll
        for (int m = 0; m < STEP_TM; ++m)
#pragma unroll
            for (int c = 0; c < TN; ++c) acc[m][c] = T(0);
    }
    // stage 2: P = U B[:, i, :] (tmax x rb, K = rb), B through its ring,
    // whose first slabs were staged before the wait
    for (int s = 0; s < nslab_b; ++s) {
        tnt::cp_async_wait<NSTAGE - 2>();
        __syncthreads();  // also publishes Ut before its first read
        const int next = s + NSTAGE - 1;
        if (next < nslab_b)
            load_slab(Br + (next % NSTAGE) * BK * np, Bi, ldb_g, next * BK, rb);
        tnt::cp_async_commit();
        if (active)
            fma_slab<T, TN>(acc, Ut + (size_t)s * BK * tmax, tmax,
                            Br + (s % NSTAGE) * BK * np, np,
                            min(BK, rb - s * BK), ty, tx, txc);
    }
    if (!active) return;
#pragma unroll
    for (int m = 0; m < STEP_TM; ++m) {
        const int row = ty * STEP_TM + m;
        if (row >= rows) continue;
        T* g = part + ((size_t)mode * ra + band0 + row) * rb;
#pragma unroll
        for (int j = 0; j < STEP_NJ; ++j) {
            const int c = (j * txc + tx) * PK;
            if (c >= rb) continue;
            if (vec_b) {
                P val;
#pragma unroll
                for (int q = 0; q < PK; ++q) val.v[q] = acc[m][j * PK + q];
                *reinterpret_cast<P*>(g + c) = val;
            } else {
#pragma unroll
                for (int q = 0; q < PK; ++q)
                    if (c + q < rb) g[c + q] = acc[m][j * PK + q];
            }
        }
    }
}

// W[e] = sum_{i = 0..n-1} part[i][e] in increasing i: one thread per
// 16-byte pack of W (vec) or per value; mn = ra * rb.
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
zip_reduce(const T* __restrict__ part, T* __restrict__ W, int n, int mn,
           int vec) {
    constexpr int PK = 16 / sizeof(T);
    using P = tnt::Pack<T>;
    tnt::launch_dependents();
    tnt::wait_for_previous_grid();
    const int stride = gridDim.x * blockDim.x;
    if (vec) {
        for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < mn / PK;
             e += stride) {
            P s;
#pragma unroll
            for (int q = 0; q < PK; ++q) s.v[q] = T(0);
            for (int i0 = 0; i0 < n; i0 += REDUCE_CHUNK) {
                P v[REDUCE_CHUNK];
#pragma unroll
                for (int j = 0; j < REDUCE_CHUNK; ++j)
                    if (i0 + j < n)
                        v[j] = *reinterpret_cast<const P*>(
                            part + (size_t)(i0 + j) * mn + (size_t)e * PK);
#pragma unroll
                for (int j = 0; j < REDUCE_CHUNK; ++j)
                    if (i0 + j < n)
#pragma unroll
                        for (int q = 0; q < PK; ++q) s.v[q] += v[j].v[q];
            }
            *reinterpret_cast<P*>(W + (size_t)e * PK) = s;
        }
    } else {
        for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < mn; e += stride) {
            T s = T(0);
            for (int i0 = 0; i0 < n; i0 += REDUCE_CHUNK) {
                T v[REDUCE_CHUNK];
#pragma unroll
                for (int j = 0; j < REDUCE_CHUNK; ++j)
                    if (i0 + j < n) v[j] = part[(size_t)(i0 + j) * mn + e];
#pragma unroll
                for (int j = 0; j < REDUCE_CHUNK; ++j)
                    if (i0 + j < n) s += v[j];
            }
            W[e] = s;
        }
    }
}

// out = sum_{a, j} la[a, j] sum_b W[a, b] lb[b, j], one block, fixed order:
// a thread takes the (a, j) pairs tid, tid + LAST_THREADS, ... (a warp
// shares a and reads W's row as a broadcast, lb's row coalesced).
template <typename S, typename T>
__global__ void __launch_bounds__(LAST_THREADS)
zip_last(const T* __restrict__ W, const S* __restrict__ la,
         const S* __restrict__ lb, S* __restrict__ out, int ra, int rb, int nl) {
    __shared__ T warp_part[LAST_THREADS / 32];
    tnt::wait_for_previous_grid();
    T s = T(0);
    for (int p = threadIdx.x; p < ra * nl; p += LAST_THREADS) {
        const int a = p / nl, j = p % nl;
        const T* w = W + (size_t)a * rb;
        T v[4] = {T(0), T(0), T(0), T(0)};
        int b = 0;
        for (; b + 4 <= rb; b += 4)
#pragma unroll
            for (int q = 0; q < 4; ++q)
                v[q] = fma(w[b + q], tnt::to_acc(lb[(size_t)(b + q) * nl + j]), v[q]);
        for (; b < rb; ++b)
            v[0] = fma(w[b], tnt::to_acc(lb[(size_t)b * nl + j]), v[0]);
        s = fma(tnt::to_acc(la[(size_t)a * nl + j]), (v[0] + v[1]) + (v[2] + v[3]),
                s);
    }
    s = tnt::warp_sum(s);
    if (threadIdx.x % 32 == 0) warp_part[threadIdx.x / 32] = s;
    __syncthreads();
    if (threadIdx.x < 32) {
        T v = warp_part[threadIdx.x];
        v = tnt::warp_sum(v);
        if (threadIdx.x == 0) out[0] = tnt::Store<S>::from(v);
    }
}

// The fused route: W0 = fa^T fb (one gemm_tn), then per middle core pair
// zip_step and zip_reduce, then zip_last; every launch after the first is
// a programmatic dependent launch.  1 + 2 * d_mid + 1 launches.  nbands
// and tmax come from kernels/zipper.py::band_plan, for T.  w (ra*rb) and
// part (n*ra*rb, unused when d_mid == 0) are scratch in T = Acc<S>;
// out[0] gets the scalar, in S.
template <typename S, typename T = typename tnt::Acc<S>::type>
int zipper_fused(const S* fa, const S* ma, const S* la, const S* fb,
                 const S* mb, const S* lb, T* w, T* part, S* out, int n0,
                 int n, int nl, int ra, int rb, int d_mid, int nbands,
                 int tmax, cudaStream_t stream) {
    constexpr int PK = 16 / sizeof(T);
    constexpr int TN = STEP_NJ * PK;
    if (ra < 1 || rb < 1 || ra > FUSED_MAX_RANK || rb > FUSED_MAX_RANK ||
        n0 < 1 || nl < 1 || d_mid < 0 || (d_mid > 0 && n < 1))
        return (int)cudaErrorInvalidValue;
    const int txc = cdiv(rb, TN);
    const int np = txc * TN;
    const int units = cdiv(ra, STEP_TM);
    const int threads = cdiv(txc * (tmax / STEP_TM), 32) * 32;
    if (d_mid > 0 &&
        (nbands < 1 || nbands > units || tmax % STEP_TM != 0 ||
         tmax < cdiv(units, nbands) * STEP_TM || threads > STEP_MAX_THREADS))
        return (int)cudaErrorInvalidValue;

    gemm_tn<T><<<dim3(cdiv(rb, BN), cdiv(ra, BM), 1), THREADS, 0, stream>>>(
        fa, ra, fb, rb, w, ra, rb, n0, n0);
    TNT_CHECK_LAUNCH();
    if (d_mid > 0) {
        const size_t smem =
            ((size_t)(ra + rb) * tmax + 2 * NSTAGE * BK * np) * sizeof(T);
        if (smem > 48 * 1024) {  // above 48 KB shared memory is an opt-in
            cudaError_t err = cudaFuncSetAttribute(
                zip_step<S, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem);
            if (err != cudaSuccess) return (int)err;
        }
        const int vec_a = ra % PK == 0 && tnt::aligned16(ma);
        const int vec_b = rb % PK == 0 && tnt::aligned16(mb) &&
                          tnt::aligned16(w) && tnt::aligned16(part);
        const int mn = ra * rb;
        const int vec_r =
            mn % PK == 0 && tnt::aligned16(part) && tnt::aligned16(w);
        const int reduce_blocks = cdiv(vec_r ? mn / PK : mn, REDUCE_THREADS);
        const size_t core_a = (size_t)ra * n * ra;
        const size_t core_b = (size_t)rb * n * rb;
        for (int k = 0; k < d_mid; ++k) {
            int rc = tnt::launch_after(
                zip_step<S, T>, dim3(n, nbands), threads, smem, stream, true,
                ma + k * core_a, mb + k * core_b, (const T*)w, part, n, ra, rb,
                nbands, tmax, vec_a, vec_b);
            if (rc) return rc;
            rc = tnt::launch_after(zip_reduce<T>, dim3(reduce_blocks),
                                   REDUCE_THREADS, 0, stream, true,
                                   (const T*)part, w, n, mn, vec_r);
            if (rc) return rc;
        }
    }
    return tnt::launch_after(zip_last<S, T>, dim3(1), LAST_THREADS, 0, stream,
                             true, (const T*)w, la, lb, out, ra, rb, nl);
}

}  // namespace

// One set of entry points per storage type: fa ma la fb mb lb and out in
// the cores' type, the scratch (w, t, part) in its Acc type.
#define TNT_ZIPPER_ENTRIES(SUFFIX, S)                                          \
    int tnt_zipper_##SUFFIX(const void* fa, const void* ma, const void* la,    \
                            const void* fb, const void* mb, const void* lb,    \
                            void* w, void* t, void* part, void* out, int n0,   \
                            int n, int nl, int ra, int rb, int d_mid,          \
                            int splits, void* stream) {                        \
        using T = tnt::Acc<S>::type;                                           \
        return zipper<S>((const S*)fa, (const S*)ma, (const S*)la,             \
                         (const S*)fb, (const S*)mb, (const S*)lb, (T*)w,      \
                         (T*)t, (T*)part, (S*)out, n0, n, nl, ra, rb, d_mid,   \
                         splits, (cudaStream_t)stream);                        \
    }                                                                          \
    int tnt_zipper_fused_##SUFFIX(                                             \
        const void* fa, const void* ma, const void* la, const void* fb,        \
        const void* mb, const void* lb, void* w, void* part, void* out,        \
        int n0, int n, int nl, int ra, int rb, int d_mid, int nbands,          \
        int tmax, void* stream) {                                              \
        using T = tnt::Acc<S>::type;                                           \
        return zipper_fused<S>((const S*)fa, (const S*)ma, (const S*)la,       \
                               (const S*)fb, (const S*)mb, (const S*)lb,       \
                               (T*)w, (T*)part, (S*)out, n0, n, nl, ra, rb,    \
                               d_mid, nbands, tmax, (cudaStream_t)stream);     \
    }

extern "C" {

TNT_ZIPPER_ENTRIES(f32, float)
TNT_ZIPPER_ENTRIES(f64, double)
TNT_ZIPPER_ENTRIES(bf16, __nv_bfloat16)
TNT_ZIPPER_ENTRIES(f16, __half)

const char* tnt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
