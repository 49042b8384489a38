// H1: the TT inner-product zipper for Hopper (sm_90a).
//
// Replaces tensor_networks_tpu/kernels/pallas_ops.py::tt_inner_pallas
// (K1, :502) and ::tt_inner_pallas_fused (K2, :229).  The TPU kernels run
// the d-2 zipper steps as a sequential grid with the (r_a x r_b) carry W
// held in VMEM; CUDA blocks run in no fixed order, so here the step
// boundary is stream order instead, and one C call runs the whole inner
// product from a host loop (one ctypes call = one inner product, as K2
// was one dispatch).  Every launch after a call's first is a programmatic
// dependent launch (PDL): a kernel's blocks stage their core slabs while
// the kernel before them runs, and wait for it before they touch W, t or
// part.  Two routes, chosen by rank in kernels/zipper.py:
//
// The fused route, max(r_a, r_b) <= FUSED_MAX_RANK (128):
//
//   W0 = fa^T fb                                        (gemm_tn)
//   per middle core pair (A_k, B_k), per (mode i, band of a2 rows):
//     part[i, a2, b2] = sum_b (sum_a A[a,i,a2] W[a,b]) B[b,i,b2]  (zip_step)
//   W' = sum_i part[i] in increasing i                  (zip_reduce)
//   out = sum_{a,j} la[a,j] (W lb)[a,j]                 (zip_last, one block)
//
// 1 + 2 (d-2) + 1 launches.  A step block keeps its A slice, U = A_i^T W
// and two cp.async rings of K-slabs (W, then B_i) in shared memory, so t
// never goes to L2.
//
// The chain, above that rank:
//
//   W0 = fa^T fb                                        (gemm_tn)
//   per middle core pair (A_k, B_k):
//     t  = W^T A_k,  A_k viewed as (r_a, n*r_a)         (tile_gemm)
//     W' = t^T B_k over the (r_b*n) rows, split along K (tile_gemm)
//          and the K-slabs summed in increasing z       (zip_reduce)
//   out = sum_{a,j} la[a,j] (W lb)[a,j]  (zip_last on a block per ~256
//                                        (a, j) pairs; zip_sum adds them)
//
// 1 + 3 (d-2) + 2 launches (147 at d=50; 2 a step when the second
// product is not split).  tile_gemm computes a tile of At^T B, both
// operands K-major, from a 4-stage cp.async ring of BK=16 K-slabs, the
// copies of slab s+3 in flight while slab s is multiplied.  Float (f32,
// and the 2-byte cores' f32 arithmetic) runs on the FP32 FMA pipes in
// 128 x 128 tiles, 8 x 8 outputs a thread from four 16-byte shared-memory
// reads a k, one block an SM (a second block on an SM left others idle);
// double runs on the FP64 tensor cores (mma.sync m16n8k4 .f64, DMMA; the
// m8n8k4 shape ran at half its rate) in 64 x 64 tiles of four 32 x 32
// warps.  kernels/zipper.py::chain_plan sets the K-split from the shape
// and the SM count; the C side refuses a plan it cannot run.
//
// What bounds it on the H100: at d=50, n=32, r=100 one inner product is
// ~6.1 GFLOP over ~123 MB of cores, i.e. FP32-FMA-bound (~90 us at
// 67 TFLOP/s against ~37 us at 3.35 TB/s); at r=256 ~103 GFLOP (1.5 ms).
// An 8 x 8 FMA tile needs one shared-memory wavefront for every 4 warp
// FMAs, which is what the H100's 128 FP32 lanes an SM and 128 bytes a
// cycle of shared memory allow, so float reaches ~half its bound (as
// cuBLAS's FP32 GEMM does here); one TF32 pass does not keep f32
// accuracy.  f64 products and sums stay in f64 on DMMA.  No atomics and a
// fixed summation order: two calls give the same bits.  No 128-padding:
// any r_a != r_b, any n, any rank (the GEMM tiles every M, N and K; rows
// that are not 16-byte aligned are copied 8, 4 or 2 bytes at a time),
// d_mid >= 0.
//
// Storage types: cores in float, double, __nv_bfloat16 or __half.  W, t,
// part and every product are float for the 2-byte types, and the scalar is
// written back in the cores' type.  The chain's ring holds a 2-byte core's
// raw bytes (cp.async) and converts a fragment as it reads it; the fused
// route converts as it stages (tnt::stage), so its bands are float's.

#include "common.cuh"

namespace {

constexpr int BK = 16;     // depth of a K-slab
constexpr int NSTAGE = 4;  // K-slabs in flight per ring

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---- the tile GEMM: C[z] = At[kz]^T B[kz], both operands K-major ----

// Tile codes, as kernels/zipper.py CHAIN_TILES has them: 128 x 128 in
// float on the FMA pipes, 64 x 64 in double on the FP64 tensor cores.
constexpr int TILE_FMA = 0;
constexpr int TILE_DMMA = 1;
// Dynamic shared memory a float tile's block asks for at least: more than
// half an SM's 227 KB, so one block holds an SM.  The chain's grids are
// ~1 block an SM, and where two fit they pile onto half the SMs: the H100
// ran (256, 256) 1.7x slower with the ring's own 64 KB
// (tools/chain_variants.py).
constexpr size_t EXCLUSIVE_SMEM = 116 * 1024;

// 4 values of a ring row as float: one 16-byte read, or an 8-byte read of
// four 2-byte values converted here (the ring holds the cores' raw bytes)
__device__ __forceinline__ void frag4(float* v, const float* p) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void frag4(float* v, const __half* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
    const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
__device__ __forceinline__ void frag4(float* v, const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// A BM x BN float tile on the FMA pipes: BM*BN/64 threads, each 8 x 8
// outputs (rows ty*4 + {0..3} and BM/2 + ty*4 + {0..3}, columns likewise
// with tx).  A warp is 8 threads across by 4 down, so a k reads 64 bytes
// of the A stage and 128 of the B stage: one wavefront each, no bank
// conflict, without padding.
template <typename TA, typename TB, int BM, int BN>
struct FmaTile {
    static constexpr int kThreads = BM * BN / 64;
    static constexpr int kLda = BM;
    static constexpr int kLdb = BN;
    float acc[8][8];
    int tx, ty;

    __device__ __forceinline__ explicit FmaTile(int tid) {
        constexpr int WX = BN / 64;  // warps across
        const int lane = tid % 32, warp = tid / 32;
        tx = (warp % WX) * 8 + lane % 8;
        ty = (warp / WX) * 4 + lane / 8;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }

    __device__ __forceinline__ void slab(const TA* as, const TB* bs) {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float a[8], b[8];
            frag4(a, as + kk * kLda + ty * 4);
            frag4(a + 4, as + kk * kLda + BM / 2 + ty * 4);
            frag4(b, bs + kk * kLdb + tx * 4);
            frag4(b + 4, bs + kk * kLdb + BN / 2 + tx * 4);
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
    }

    __device__ __forceinline__ void store(float* C, int M, int N, int m0, int n0,
                                          int vec) const {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int m = m0 + (i / 4) * (BM / 2) + ty * 4 + i % 4;
            if (m >= M) continue;
            float* row = C + (size_t)m * N;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int n = n0 + h * (BN / 2) + tx * 4;
                if (vec) {
                    if (n < N)
                        *reinterpret_cast<float4*>(row + n) =
                            make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                        acc[i][4 * h + 2], acc[i][4 * h + 3]);
                } else {
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        if (n + q < N) row[n + q] = acc[i][4 * h + q];
                }
            }
        }
    }
};

// D += A B for one m16n8k4 tile in f64 on the tensor cores (g = lane / 4,
// t = lane % 4): a = {A[g][t], A[g+8][t]}, b = B[t][g],
// d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}
__device__ __forceinline__ void dmma_16x8x4(double (&d)[4], const double (&a)[2],
                                            double b) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(b));
}

// A 64 x 64 double tile on the FP64 tensor cores: four warps of 32 x 32,
// each 2 x 4 m16n8k4 products a k-step of 4.  A fragment read puts lanes
// on 4 rows (t) by 8 columns (g); rows 68 doubles apart (4 mod 16) spread
// each half-warp over all 32 banks.
template <int BM, int BN>
struct DmmaTile {
    static_assert(BM == 64 && BN == 64, "the DMMA tile is 64 x 64");
    static constexpr int kThreads = 128;
    static constexpr int kLda = BM + 4;
    static constexpr int kLdb = BN + 4;
    double acc[2][4][4];
    int g, t, wm, wn;

    __device__ __forceinline__ explicit DmmaTile(int tid) {
        const int lane = tid % 32, warp = tid / 32;
        g = lane / 4;
        t = lane % 4;
        wm = (warp / 2) * 32;
        wn = (warp % 2) * 32;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0;
    }

    __device__ __forceinline__ void slab(const double* as, const double* bs) {
#pragma unroll
        for (int kk = 0; kk < BK; kk += 4) {
            const double* ar = as + (kk + t) * kLda + wm + g;
            const double* br = bs + (kk + t) * kLdb + wn + g;
            double a[2][2], b[4];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                a[i][0] = ar[16 * i];
                a[i][1] = ar[16 * i + 8];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = br[8 * j];
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) dmma_16x8x4(acc[i][j], a[i], b[j]);
        }
    }

    __device__ __forceinline__ void store(double* C, int M, int N, int m0, int n0,
                                          int vec) const {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = m0 + wm + 16 * i + 8 * h + g;
                if (m >= M) continue;
                double* row = C + (size_t)m * N;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int n = n0 + wn + 8 * j + 2 * t;
                    if (vec) {
                        if (n < N)
                            *reinterpret_cast<double2*>(row + n) =
                                make_double2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
                    } else {
                        if (n < N) row[n] = acc[i][j][2 * h];
                        if (n + 1 < N) row[n + 1] = acc[i][j][2 * h + 1];
                    }
                }
            }
    }
};

// A tile_gemm instantiation.  WIDE (float only): both operands are copied
// 16 bytes at a time (every row 16-byte aligned), with no run-time copy
// width, and the block asks for EXCLUSIVE_SMEM; otherwise each operand's
// copy width is read at run time (and a float tile's ~250 registers hold
// an SM alone for 256 threads; the DMMA tile's let two blocks share one,
// which measured fastest).
template <typename T, typename TA, typename TB, int BM, int BN, bool WIDE>
struct GemmCfg {
    using Tile = typename std::conditional<std::is_same<T, double>::value,
                                           DmmaTile<BM, BN>,
                                           FmaTile<TA, TB, BM, BN>>::type;
    static constexpr int kThreads = Tile::kThreads;
    static constexpr int kStageA = BK * Tile::kLda;  // elements of TA
    static constexpr int kStageB = BK * Tile::kLdb;  // elements of TB
    static constexpr size_t kSmem =
        NSTAGE * ((size_t)kStageA * sizeof(TA) + (size_t)kStageB * sizeof(TB));
    static constexpr size_t kRequest =
        WIDE && kSmem < EXCLUSIVE_SMEM ? EXCLUSIVE_SMEM : kSmem;
};

// Rows [k0, k0 + BK) and columns [c0, c0 + W) of a row-major operand (row
// stride ld, `cols` columns) into a ring stage [BK][LD], zero-filled at
// rows >= kend and columns >= cols.  BYTES a copy: cp.async from 4 bytes
// up; a plain 2-byte copy for a 2-byte row at an odd offset.  With more
// than one value a copy, cols is a multiple of it (copy_bytes).
template <int BYTES, int W, int LD, int NT, typename E>
__device__ __forceinline__ void copy_slab(E* stage, const E* src, size_t ld,
                                          int k0, int kend, int c0, int cols,
                                          int tid) {
    constexpr int PER = BYTES / (int)sizeof(E);
    constexpr int ROW = W / PER;
    constexpr int ITERS = (BK * ROW + NT - 1) / NT;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
        const int e = tid + it * NT;
        if (BK * ROW % NT != 0 && e >= BK * ROW) break;
        const int kk = e / ROW, c = (e % ROW) * PER;
        const bool ok = k0 + kk < kend && c0 + c < cols;
        const E* g = ok ? src + (size_t)(k0 + kk) * ld + c0 + c : src;
        E* s = stage + kk * LD + c;
        if constexpr (BYTES >= 4) {
            tnt::cp_async<BYTES>(s, g, ok);
        } else {
            *reinterpret_cast<unsigned short*>(s) =
                ok ? *reinterpret_cast<const unsigned short*>(g) : (unsigned short)0;
        }
    }
}

template <int W, int LD, int NT, typename E>
__device__ __forceinline__ void load_slab(E* stage, const E* src, size_t ld,
                                          int k0, int kend, int c0, int cols,
                                          int cp, int tid) {
    if (cp == 16) {
        copy_slab<16, W, LD, NT>(stage, src, ld, k0, kend, c0, cols, tid);
    } else if (cp == 8) {
        if constexpr (sizeof(E) <= 8)
            copy_slab<8, W, LD, NT>(stage, src, ld, k0, kend, c0, cols, tid);
    } else if (cp == 4) {
        if constexpr (sizeof(E) <= 4)
            copy_slab<4, W, LD, NT>(stage, src, ld, k0, kend, c0, cols, tid);
    } else {
        if constexpr (sizeof(E) == 2)
            copy_slab<2, W, LD, NT>(stage, src, ld, k0, kend, c0, cols, tid);
    }
}

// C[z] (M x N, row-major) = sum over k in [z*kchunk, min(K, (z+1)*kchunk))
// of At[k, m] B[k, n]: At (K x M, row stride lda) and B (K x N, ldb) are
// row-major, stored as TA and TB; blockIdx = (n tile, m tile, z).  B is a
// core, which no kernel of a chain writes: its first slabs are staged
// before griddepcontrol.wait, At (W or t) and C only after it.  cpa / cpb
// are the bytes of one copy of At / B (copy_bytes; 16 for both when WIDE);
// vec_c: N is a whole number of 16-byte packs and C is 16-byte aligned.
template <typename T, typename TA, typename TB, int BM, int BN, bool WIDE>
__global__ void __launch_bounds__(GemmCfg<T, TA, TB, BM, BN, WIDE>::kThreads)
tile_gemm(const TA* __restrict__ At, int lda, const TB* __restrict__ B, int ldb,
          T* __restrict__ C, int M, int N, int K, int kchunk, int cpa, int cpb,
          int vec_c) {
    using Cfg = GemmCfg<T, TA, TB, BM, BN, WIDE>;
    using Tile = typename Cfg::Tile;
    constexpr int NT = Cfg::kThreads;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    TA* ring_a = reinterpret_cast<TA*>(smem_raw);
    TB* ring_b = reinterpret_cast<TB*>(smem_raw + NSTAGE * Cfg::kStageA * sizeof(TA));

    tnt::launch_dependents();
    const int tid = threadIdx.x;
    const int m0 = blockIdx.y * BM;
    const int n0 = blockIdx.x * BN;
    const int kbeg = blockIdx.z * kchunk;
    const int kend = min(K, kbeg + kchunk);
    const int nslab = cdiv(kend - kbeg, BK);
    auto load_a = [&](int s) {
        TA* stage = ring_a + (s % NSTAGE) * Cfg::kStageA;
        if constexpr (WIDE)
            copy_slab<16, BM, Tile::kLda, NT>(stage, At, lda, kbeg + s * BK, kend,
                                              m0, M, tid);
        else
            load_slab<BM, Tile::kLda, NT>(stage, At, lda, kbeg + s * BK, kend, m0,
                                          M, cpa, tid);
    };
    auto load_b = [&](int s) {
        TB* stage = ring_b + (s % NSTAGE) * Cfg::kStageB;
        if constexpr (WIDE)
            copy_slab<16, BN, Tile::kLdb, NT>(stage, B, ldb, kbeg + s * BK, kend,
                                              n0, N, tid);
        else
            load_slab<BN, Tile::kLdb, NT>(stage, B, ldb, kbeg + s * BK, kend, n0,
                                          N, cpb, tid);
    };

    // group 0: the core's first slabs, before the wait; groups 1..NSTAGE-1:
    // At's first slabs; then one group a slab, A and B together
    for (int s = 0; s < NSTAGE - 1; ++s)
        if (s < nslab) load_b(s);
    tnt::cp_async_commit();
    tnt::wait_for_previous_grid();
    for (int s = 0; s < NSTAGE - 1; ++s) {
        if (s < nslab) load_a(s);
        tnt::cp_async_commit();
    }

    Tile tile(tid);
    for (int s = 0; s < nslab; ++s) {
        tnt::cp_async_wait<NSTAGE - 2>();  // slab s landed (this thread's copies)
        __syncthreads();                   // every thread's; slab s-1 consumed
        const int next = s + NSTAGE - 1;
        if (next < nslab) {
            load_a(next);
            load_b(next);
        }
        tnt::cp_async_commit();
        tile.slab(ring_a + (s % NSTAGE) * Cfg::kStageA,
                  ring_b + (s % NSTAGE) * Cfg::kStageB);
    }
    tile.store(C + (size_t)blockIdx.z * M * N, M, N, m0, n0, vec_c);
}

// The widest copy (16, 8, 4 bytes, or one value) that every row of a
// (rows x cols, row stride ld) operand at p allows.
template <typename E>
int copy_bytes(const E* p, size_t ld, int cols) {
    const size_t addr = reinterpret_cast<size_t>(p);
    for (int b = 16; b >= 4 && b >= (int)sizeof(E); b /= 2)
        if (addr % b == 0 && ld * sizeof(E) % b == 0 && cols * sizeof(E) % b == 0)
            return b;
    return (int)sizeof(E);
}

// One tile_gemm launch: `splits` K-ranges of kchunk rows, each to its own
// (M x N) slab of C; a programmatic dependent launch when `overlap`.
template <typename T, typename TA, typename TB, int BM, int BN, bool WIDE>
int launch_tile(const TA* At, int lda, const TB* B, int ldb, T* C, int M, int N,
                int K, int kchunk, int splits, int cpa, int cpb, bool overlap,
                cudaStream_t stream) {
    using Cfg = GemmCfg<T, TA, TB, BM, BN, WIDE>;
    auto kernel = tile_gemm<T, TA, TB, BM, BN, WIDE>;
    // above 48 KB shared memory is an opt-in, once a device (bit d of
    // opted_in); a chain call makes ~100 of these launches
    static unsigned long long opted_in = 0;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    const bool known = device < 64 && (opted_in >> device & 1ull);
    if (Cfg::kRequest > 48 * 1024 && !known) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)Cfg::kRequest);
        if (err != cudaSuccess) return (int)err;
        if (device < 64) opted_in |= 1ull << device;
    }
    const int vec_c = N % (16 / (int)sizeof(T)) == 0 && tnt::aligned16(C);
    return tnt::launch_after(kernel, dim3(cdiv(N, BN), cdiv(M, BM), splits),
                             Cfg::kThreads, Cfg::kRequest, stream, overlap, At, lda,
                             B, ldb, C, M, N, K, kchunk, cpa, cpb, vec_c);
}

template <typename T, typename TA, typename TB, int BM, int BN>
int launch_gemm(const TA* At, int lda, const TB* B, int ldb, T* C, int M, int N,
                int K, int kchunk, int splits, bool overlap, cudaStream_t stream) {
    const int cpa = copy_bytes(At, lda, M), cpb = copy_bytes(B, ldb, N);
    if constexpr (!std::is_same<T, double>::value) {
        if (cpa == 16 && cpb == 16)
            return launch_tile<T, TA, TB, BM, BN, true>(At, lda, B, ldb, C, M, N, K,
                                                        kchunk, splits, cpa, cpb,
                                                        overlap, stream);
    }
    return launch_tile<T, TA, TB, BM, BN, false>(At, lda, B, ldb, C, M, N, K,
                                                 kchunk, splits, cpa, cpb, overlap,
                                                 stream);
}

// W0 = fa^T fb, the first launch of either route: a minimal GEMM, 64 x 64
// tiles of 256 threads each 4 x 4, K-slabs loaded between two barriers
// (K = n0 is short), the 2-byte cores converted as they are loaded.  An
// ordinary launch: the caller's previous kernels may still read memory
// that w reuses.  (With tile_gemm as its prologue the fused route took
// 0.84 ms a call instead of 0.80 on the H100: tools/chain_variants.py.)
constexpr int PRO_TILE = 64;
constexpr int PRO_THREADS = 256;

template <typename T, typename S>
__global__ void __launch_bounds__(PRO_THREADS)
gemm_tn(const S* __restrict__ At, int lda, const S* __restrict__ B, int ldb,
        T* __restrict__ C, int M, int N, int K) {
    __shared__ T As[BK][PRO_TILE];
    __shared__ T Bs[BK][PRO_TILE];
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const int m0 = blockIdx.y * PRO_TILE;
    const int n0 = blockIdx.x * PRO_TILE;
    // lets the first step stage its cores while this runs
    tnt::launch_dependents();

    T acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

    for (int k0 = 0; k0 < K; k0 += BK) {
        // coalesced tile loads: consecutive threads, consecutive m / n
        for (int e = tid; e < BK * PRO_TILE; e += PRO_THREADS) {
            const int kk = e / PRO_TILE, c = e % PRO_TILE;
            const int k = k0 + kk;
            As[kk][c] = (k < K && m0 + c < M) ? tnt::to_acc(At[(size_t)k * lda + m0 + c])
                                              : T(0);
            Bs[kk][c] = (k < K && n0 + c < N) ? tnt::to_acc(B[(size_t)k * ldb + n0 + c])
                                              : T(0);
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

template <typename T, typename S>
int prologue_gemm(const S* fa, const S* fb, T* w, int n0, int ra, int rb,
                  cudaStream_t stream) {
    return tnt::launch_after(gemm_tn<T, S>, dim3(cdiv(rb, PRO_TILE), cdiv(ra, PRO_TILE)),
                             PRO_THREADS, 0, stream, false, fa, ra, fb, rb, w, ra,
                             rb, n0);
}

// One product of a chain step, on its dtype's tile, chained by PDL
template <typename T, typename S>
int step_gemm(const T* At, int lda, const S* B, int ldb, T* C, int M, int N,
              int K, int kchunk, int splits, cudaStream_t stream) {
    constexpr int E = std::is_same<T, double>::value ? 64 : 128;
    return launch_gemm<T, T, S, E, E>(At, lda, B, ldb, C, M, N, K, kchunk, splits,
                                      true, stream);
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
constexpr int REDUCE_THREADS = 64;
constexpr int REDUCE_CHUNK = 8;  // partial products loaded before they are summed
constexpr int CHAIN_REDUCE_CHUNK = 16;  // the chain's K-split slabs: a deeper load
constexpr int LAST_THREADS = 1024;
constexpr int LAST_CHAIN_THREADS = 256;  // a chain zip_last block: ~1 (a, j) pair a thread

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

// W[e] = sum_{i = 0..n-1} part[i][e] in increasing i: the fused step's
// modes, or the chain's K-splits (n = splits).  One thread per 16-byte
// pack of W (vec) or per value; mn = ra * rb.
template <typename T, int CHUNK = REDUCE_CHUNK>
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
            for (int i0 = 0; i0 < n; i0 += CHUNK) {
                P v[CHUNK];
#pragma unroll
                for (int j = 0; j < CHUNK; ++j)
                    if (i0 + j < n)
                        v[j] = *reinterpret_cast<const P*>(
                            part + (size_t)(i0 + j) * mn + (size_t)e * PK);
#pragma unroll
                for (int j = 0; j < CHUNK; ++j)
                    if (i0 + j < n)
#pragma unroll
                        for (int q = 0; q < PK; ++q) s.v[q] += v[j].v[q];
            }
            *reinterpret_cast<P*>(W + (size_t)e * PK) = s;
        }
    } else {
        for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < mn; e += stride) {
            T s = T(0);
            for (int i0 = 0; i0 < n; i0 += CHUNK) {
                T v[CHUNK];
#pragma unroll
                for (int j = 0; j < CHUNK; ++j)
                    if (i0 + j < n) v[j] = part[(size_t)(i0 + j) * mn + e];
#pragma unroll
                for (int j = 0; j < CHUNK; ++j)
                    if (i0 + j < n) s += v[j];
            }
            W[e] = s;
        }
    }
}

// out = sum_{a, j} la[a, j] sum_b W[a, b] lb[b, j] over the rows a of this
// block, [x * rows, min(ra, (x + 1) * rows)) for block x, in a fixed
// order: a thread takes the (a, j) pairs tid, tid + blockDim.x, ... of
// them (a warp shares a and reads W's row as a broadcast, lb's row
// coalesced).  With partial null (the fused route: one block, rows = ra,
// 1024 threads) the block writes out[0] in S; otherwise (the chain) each
// block writes its sum to partial[x], which zip_sum adds in increasing x.
template <typename S, typename T>
__global__ void __launch_bounds__(LAST_THREADS)
zip_last(const T* __restrict__ W, const S* __restrict__ la,
         const S* __restrict__ lb, S* __restrict__ out, T* __restrict__ partial,
         int ra, int rb, int nl, int rows) {
    __shared__ T warp_part[LAST_THREADS / 32];
    tnt::wait_for_previous_grid();
    const int a0 = blockIdx.x * rows;
    const int pairs = (min(ra, a0 + rows) - a0) * nl;
    T s = T(0);
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
        const int a = a0 + p / nl, j = p % nl;
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
        T v = threadIdx.x < blockDim.x / 32 ? warp_part[threadIdx.x] : T(0);
        v = tnt::warp_sum(v);
        if (threadIdx.x == 0) {
            if (partial == nullptr)
                out[0] = tnt::Store<S>::from(v);
            else
                partial[blockIdx.x] = v;
        }
    }
}

// out = sum_x partial[x] over zip_last's blocks, one warp, a fixed order
template <typename S, typename T>
__global__ void zip_sum(const T* __restrict__ partial, S* __restrict__ out,
                        int blocks) {
    tnt::wait_for_previous_grid();
    T s = T(0);
    for (int x = threadIdx.x; x < blocks; x += 32) s += partial[x];
    s = tnt::warp_sum(s);
    if (threadIdx.x == 0) out[0] = tnt::Store<S>::from(s);
}

// ---- the chain (max(r_a, r_b) > FUSED_MAX_RANK, or any rank through
// tt_inner_chain_cuda) ----

// W0 = fa^T fb, then per middle core pair t = W^T A_k and W' = t^T B_k on
// the dtype's tile (`tile` says which the plan assumed), the second split
// along its K = rb*n into `splits` ranges of
// kchunk rows (kernels/zipper.py::chain_plan) whose slabs zip_reduce sums
// in increasing z; then zip_last on several blocks and zip_sum.  Every
// launch after the first is a programmatic dependent launch: 1 + 3 * d_mid
// + 2 launches, or 1 + 2 * d_mid + 2 when splits == 1 (the second product
// then writes W).  fa (n0, ra), ma (d_mid, ra, n, ra), la (ra, nl);
// likewise b with rb; all stored as S.  Workspace, in T = Acc<S>: w
// (ra*rb), t (max(rb*n*ra, ra)), part (splits*ra*rb, unused when
// splits == 1).  Writes the scalar to
// out[0], in S.
template <typename S, typename T = typename tnt::Acc<S>::type>
int zipper_chain(const S* fa, const S* ma, const S* la, const S* fb,
                 const S* mb, const S* lb, T* w, T* t, T* part, S* out, int n0,
                 int n, int nl, int ra, int rb, int d_mid, int tile, int splits,
                 int kchunk, cudaStream_t stream) {
    constexpr int PK = 16 / sizeof(T);
    constexpr int own_tile = std::is_same<T, double>::value ? TILE_DMMA : TILE_FMA;
    if (ra < 1 || rb < 1 || n0 < 1 || nl < 1 || d_mid < 0 || (d_mid > 0 && n < 1))
        return (int)cudaErrorInvalidValue;
    if (d_mid > 0 && (tile != own_tile || kchunk < BK || kchunk % BK != 0 ||
                      splits != cdiv(rb * n, kchunk)))
        return (int)cudaErrorInvalidValue;
    int rc = prologue_gemm<T>(fa, fb, w, n0, ra, rb, stream);
    if (rc) return rc;
    const int mn = ra * rb;
    const int vec_r = mn % PK == 0 && tnt::aligned16(part) && tnt::aligned16(w);
    const int reduce_blocks = cdiv(vec_r ? mn / PK : mn, REDUCE_THREADS);
    const size_t core_a = (size_t)ra * n * ra;
    const size_t core_b = (size_t)rb * n * rb;
    for (int k = 0; k < d_mid; ++k) {
        // t[b, (i a2)] = sum_a W[a, b] A_k[a, (i a2)]
        rc = step_gemm<T>((const T*)w, rb, ma + k * core_a, n * ra, t, rb, n * ra,
                          ra, ra, 1, stream);
        if (rc) return rc;
        // W'[a2, b2] = sum_{(b1 i)} t[(b1 i), a2] B_k[(b1 i), b2]
        rc = step_gemm<T>((const T*)t, ra, mb + k * core_b, rb,
                          splits > 1 ? part : w, ra, rb, rb * n, kchunk, splits,
                          stream);
        if (rc) return rc;
        if (splits > 1) {
            rc = tnt::launch_after(zip_reduce<T, CHAIN_REDUCE_CHUNK>, dim3(reduce_blocks),
                                   REDUCE_THREADS, 0, stream, true,
                                   (const T*)part, w, splits, mn, vec_r);
            if (rc) return rc;
        }
    }
    // the epilogue over one block per LAST_CHAIN_THREADS (a, j) pairs; the
    // blocks' sums go to t (dead by now, at least ra values) and zip_sum
    const int rows = cdiv(ra, min(ra, cdiv(ra * nl, LAST_CHAIN_THREADS)));
    const int blocks = cdiv(ra, rows);
    rc = tnt::launch_after(zip_last<S, T>, dim3(blocks), LAST_CHAIN_THREADS, 0,
                           stream, true, (const T*)w, la, lb, out, t, ra, rb, nl,
                           rows);
    if (rc) return rc;
    return tnt::launch_after(zip_sum<S, T>, dim3(1), 32, 0, stream, true,
                             (const T*)t, out, blocks);
}

// The fused route: W0 = fa^T fb (prologue_gemm), then per middle core pair
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

    int rc = prologue_gemm<T>(fa, fb, w, n0, ra, rb, stream);
    if (rc) return rc;
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
            rc = tnt::launch_after(
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
                             true, (const T*)w, la, lb, out, (T*)nullptr, ra, rb,
                             nl, ra);
}

}  // namespace

// One set of entry points per storage type: fa ma la fb mb lb and out in
// the cores' type, the scratch (w, t, part) in its Acc type.
#define TNT_ZIPPER_ENTRIES(SUFFIX, S)                                          \
    int tnt_zipper_##SUFFIX(const void* fa, const void* ma, const void* la,    \
                            const void* fb, const void* mb, const void* lb,    \
                            void* w, void* t, void* part, void* out, int n0,   \
                            int n, int nl, int ra, int rb, int d_mid,          \
                            int tile, int splits, int kchunk, void* stream) {  \
        using T = tnt::Acc<S>::type;                                           \
        return zipper_chain<S>((const S*)fa, (const S*)ma, (const S*)la,       \
                               (const S*)fb, (const S*)mb, (const S*)lb,       \
                               (T*)w, (T*)t, (T*)part, (S*)out, n0, n, nl, ra, \
                               rb, d_mid, tile, splits, kchunk,                \
                               (cudaStream_t)stream);                          \
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
