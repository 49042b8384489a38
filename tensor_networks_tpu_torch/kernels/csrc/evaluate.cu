// H2: batched TT evaluation for Hopper (sm_90a), grouped by mode.
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
// K4 sorts the points by mode and runs grouped matmuls.  This kernel
// takes K4's idea.  At step k the points that share mode i form a group;
// their carries, stacked, are a (g, r) matrix V, and the step is V . S
// with S = mids[k][:, i, :].  The wrapper (kernels/evaluate.py) sorts each
// middle index column with torch.sort, and the group_tiles kernel below
// cuts the groups into tiles of at most TILE_P points (K4 takes its
// group counts from XLA ops; as ~25 torch ops they cost the host more
// than the evaluation costs the card).  In a step, one block owns one
// tile and one 64-column band of S.  It
// gathers its rows of V through the sort permutation, streams V and S
// through a ring of shared-memory K-slabs filled by cp.async, keeps a
// (TM x TN) accumulator per thread and writes its rows back to the same
// rows of the other carry buffer, so the carries stay in point order and
// are never permuted.
//
// One launch per step from the host loop below: step k+1 needs step k's
// carries, and stream order is the step boundary (blocks run in no
// order).  Steps after the first are programmatic dependent launches: a
// step's blocks start while the step before still runs, stage their
// slice, which no step writes, and only then wait for its carries.  The
// first step reads its rows from first[i_b0, :] instead of a carry
// buffer; a warp-per-point kernel takes the final dot with
// last[:, i_b(d-1)] (and the whole product when d == 2).  No atomics and a
// fixed summation order: two calls give the same bits.
//
// What bounds it on the H100: at d=50, n=32, r=100, B=8192 one call is
// 7.86 GFLOP of FP32 FMA (117 us at 67 TFLOP/s) over 61 MB of cores
// (18 us at 3.35 TB/s), so it is operation-bound.  Each slice is read
// once per tile, ~0.5 GB per call through L2, where a kernel that gives
// each point its own slice reads ~15.7 GB.  What holds it under the
// bound: one step is only 164 MFLOP over ~270 tiles, so the chain of 48
// dependent launches costs as much as the arithmetic, and at the
// register tiles such small steps allow (8 x 4) the inner loop waits on
// shared-memory reads, not on FMAs.  Tensor cores (wgmma) would need
// TF32, which does not keep f32 accuracy.
//
// Any rank: a block's shared memory does not depend on r, and the
// columns are tiled over grid.y.  The end cores keep their own mode
// sizes, first (n0, r) and last (r, nl).  Cores may be stored in float,
// double, __nv_bfloat16 or __half; a 2-byte type is converted to float
// as it is staged (tnt::stage), the carries and products are float, and
// the values are written in the cores' type.
//
// The per-point kernel this design replaced (one warp per point) stays
// at the end of the file as the yardstick chip_smoke.py times the
// grouped kernel against; no entry point of the package routes to it.

#include "common.cuh"

namespace {

constexpr int TX = 16;     // thread columns of a block
constexpr int BK = 16;     // depth of a K-slab
constexpr int NSTAGE = 4;  // K-slabs in flight in shared memory

template <typename T, int TM, int TN, int TY>
constexpr size_t step_smem_bytes() {
    return (size_t)NSTAGE * (TY * TM * (BK + 16 / sizeof(T)) + BK * TX * TN) *
           sizeof(T);
}

// One step for one tile: dst[pt, c0:c0+TILE_N] = src_row(pt) . S[:, c0:...]
// for the tile's points pt = perm[start : start + count].
//
// src_row(pt) is first[idx[pt, 0], :] when first_rows > 0 (first is
// (first_rows, r), the step reads from it), else src[pt, :] (a carry).
// n0 rides in first_rows rather than in a parameter of its own: with one
// more int parameter ptxas gave the f32 instantiation 128 registers
// instead of 142, and the step took 17.4 us instead of 14.4 on the H100
// (PERF.md).  core is mids[k], (r, n, r); tiles holds
// (step, mode, start, count) per tile of this step, count == 0 past the
// step's last tile.  vec says that r is a multiple of a Pack of T and
// every pointer is 16-byte aligned.  The K-slabs of V and S go through a
// ring of NSTAGE shared-memory stages filled by cp.async (for a 2-byte
// storage type, by converting loads), so the loads of later slabs overlap
// the FMAs.  src is stored as TS (the cores' type for the first step, T
// after it), core as S.
template <typename T, int TM, int TN, int TY, typename TS, typename S>
__global__ void __launch_bounds__(TX * TY)
grouped_step(const TS* __restrict__ src, const int* __restrict__ idx,
             int first_rows, const S* __restrict__ core,
             const int* __restrict__ perm, const int4* __restrict__ tiles,
             T* __restrict__ dst, int B, int d, int n, int r, int vec) {
    constexpr int PK = 16 / sizeof(T);
    constexpr int TILE_P = TY * TM;
    constexpr int TILE_N = TX * TN;
    constexpr int THREADS = TX * TY;
    constexpr int LDA = BK + PK;  // row stride of As, a multiple of a Pack
    constexpr int NJ = TN / PK;   // column packs per thread
    static_assert(TN % PK == 0 && BK % PK == 0, "tile must hold whole packs");
    using P = tnt::Pack<T>;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* As = reinterpret_cast<T*>(smem_raw);  // [NSTAGE][TILE_P][LDA]
    T* Bs = As + NSTAGE * TILE_P * LDA;      // [NSTAGE][BK][TILE_N]
    __shared__ int src_row[TILE_P];
    __shared__ int dst_row[TILE_P];

    tnt::launch_dependents();
    const int4 tile = tiles[blockIdx.x];
    const int start = tile.z;
    if (tile.w <= 0 || start < 0 || start >= B) return;  // whole block
    const int count = min(min(tile.w, TILE_P), B - start);
    const int mode = tnt::clamp_index(tile.y, n);
    const int tid = threadIdx.x;
    const int tx = tid % TX;
    const int ty = tid / TX;
    const int col0 = blockIdx.y * TILE_N;
    const int nslab = (r + BK - 1) / BK;

    const S* slice = core + (size_t)mode * r;  // S[k, c] = slice[k * n * r + c]
    const size_t slice_ld = (size_t)n * r;

    // S slab: BK rows of TILE_N columns, coalesced along the columns
    auto load_s = [&](int slab) {
        T* stage = Bs + (slab % NSTAGE) * BK * TILE_N;
        const int k0 = slab * BK;
        if (vec) {
            for (int e = tid; e < BK * (TILE_N / PK); e += THREADS) {
                const int kk = e / (TILE_N / PK);
                const int cp = (e % (TILE_N / PK)) * PK;
                const bool ok = k0 + kk < r && col0 + cp < r;
                const S* g = ok ? slice + (size_t)(k0 + kk) * slice_ld + col0 + cp
                                : slice;
                tnt::stage<PK>(stage + kk * TILE_N + cp, g, ok);
            }
        } else {
            for (int e = tid; e < BK * TILE_N; e += THREADS) {
                const int kk = e / TILE_N;
                const int c = e % TILE_N;
                const bool ok = k0 + kk < r && col0 + c < r;
                const S* g = ok ? slice + (size_t)(k0 + kk) * slice_ld + col0 + c
                                : slice;
                tnt::stage<1>(stage + kk * TILE_N + c, g, ok);
            }
        }
    };
    // V slab: TILE_P gathered rows of BK values
    auto load_v = [&](int slab) {
        T* stage = As + (slab % NSTAGE) * TILE_P * LDA;
        const int k0 = slab * BK;
        if (vec) {
            for (int e = tid; e < TILE_P * (BK / PK); e += THREADS) {
                const int p = e / (BK / PK);
                const int kp = (e % (BK / PK)) * PK;
                const int row = src_row[p];
                const bool ok = row >= 0 && k0 + kp < r;
                const TS* g = ok ? src + (size_t)row * r + k0 + kp : src;
                tnt::stage<PK>(stage + p * LDA + kp, g, ok);
            }
        } else {
            for (int e = tid; e < TILE_P * BK; e += THREADS) {
                const int p = e / BK;
                const int kk = e % BK;
                const int row = src_row[p];
                const bool ok = row >= 0 && k0 + kk < r;
                const TS* g = ok ? src + (size_t)row * r + k0 + kk : src;
                tnt::stage<1>(stage + p * LDA + kk, g, ok);
            }
        }
    };

    // nothing up to here depends on the previous step
    for (int s = 0; s < NSTAGE - 1; ++s)
        if (s < nslab) load_s(s);
    for (int p = tid; p < TILE_P; p += THREADS) {
        int pt = -1, row = -1;
        if (p < count) {
            pt = tnt::clamp_index(perm[start + p], B);
            row = first_rows ? tnt::clamp_index(idx[(size_t)pt * d], first_rows)
                             : pt;
        }
        dst_row[p] = pt;
        src_row[p] = row;
    }
    __syncthreads();
    tnt::wait_for_previous_grid();
    // group s holds V slab s (group 0 also every S slab staged above)
    for (int s = 0; s < NSTAGE - 1; ++s) {
        if (s < nslab) load_v(s);
        tnt::cp_async_commit();
    }

    T acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = T(0);
    for (int s = 0; s < nslab; ++s) {
        tnt::cp_async_wait<NSTAGE - 2>();  // this thread's part of slab s landed
        __syncthreads();  // everyone's did, and slab s-1 is consumed
        if (s + NSTAGE - 1 < nslab) {
            load_s(s + NSTAGE - 1);
            load_v(s + NSTAGE - 1);
        }
        tnt::cp_async_commit();

        const T* Ast = As + (s % NSTAGE) * TILE_P * LDA;
        const T* Bst = Bs + (s % NSTAGE) * BK * TILE_N;
        // the slab's last packs past r hold zeros and are skipped
        const int kend = min(BK, (r - s * BK + PK - 1) / PK * PK);
        for (int kk = 0; kk < kend; kk += PK) {
            P a[TM];
#pragma unroll
            for (int i = 0; i < TM; ++i)
                a[i] = *reinterpret_cast<const P*>(
                    Ast + (ty * TM + i) * LDA + kk);
#pragma unroll
            for (int q = 0; q < PK; ++q) {
                P b[NJ];
#pragma unroll
                for (int j = 0; j < NJ; ++j)
                    b[j] = *reinterpret_cast<const P*>(
                        Bst + (kk + q) * TILE_N + (j * TX + tx) * PK);
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < NJ; ++j)
#pragma unroll
                        for (int c = 0; c < PK; ++c)
                            acc[i][j * PK + c] =
                                fma(a[i].v[q], b[j].v[c], acc[i][j * PK + c]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int pt = dst_row[ty * TM + i];
        if (pt < 0) continue;
        T* g = dst + (size_t)pt * r;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int c = col0 + (j * TX + tx) * PK;
            if (c >= r) continue;
            if (vec) {
                P val;
#pragma unroll
                for (int q = 0; q < PK; ++q) val.v[q] = acc[i][j * PK + q];
                *reinterpret_cast<P*>(g + c) = val;
            } else {
#pragma unroll
                for (int q = 0; q < PK; ++q)
                    if (c + q < r) g[c + q] = acc[i][j * PK + q];
            }
        }
    }
}

constexpr int FINISH_WARPS = 8;

// out[b] = src_row(b) . last[:, idx[b, d-1]], one warp per point; last
// is (r, nl), first (n0, r); src is stored as TS, last and out as S.
template <typename T, typename TS, typename S>
__global__ void __launch_bounds__(FINISH_WARPS * 32)
grouped_finish(const TS* __restrict__ src, const int* __restrict__ idx,
               int from_first, const S* __restrict__ last,
               S* __restrict__ out, int B, int d, int n0, int nl, int r) {
    const int b = blockIdx.x * FINISH_WARPS + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    tnt::wait_for_previous_grid();
    if (b >= B) return;
    const int* ib = idx + (size_t)b * d;
    const int row = from_first ? tnt::clamp_index(ib[0], n0) : b;
    const int cl = tnt::clamp_index(ib[d - 1], nl);
    const TS* v = src + (size_t)row * r;
    T s = T(0);
    for (int j = lane; j < r; j += 32)
        s = fma(T(tnt::to_acc(v[j])), T(tnt::to_acc(last[(size_t)j * nl + cl])), s);
    s = tnt::warp_sum(s);
    if (lane == 0) out[b] = tnt::Store<S>::from(s);
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The tile a block owns, per type: 32 points by 64 columns, with
// (8 x 4) accumulators per thread in float (64 threads) and (4 x 4) in
// double (128 threads).  Shared-memory reads, not FMAs, bound the inner
// loop at these register tiles; larger ones leave too few warps at the
// sizes a step has (8192 points x 100 columns).
template <typename T>
struct StepTile;
template <>
struct StepTile<float> {
    static constexpr int TM = 8, TN = 4, TY = 4;
};
template <>
struct StepTile<double> {
    static constexpr int TM = 4, TN = 4, TY = 8;
};

constexpr int TILE_P = 32;  // points per tile, = TM * TY for both types
static_assert(StepTile<float>::TM * StepTile<float>::TY == TILE_P, "");
static_assert(StepTile<double>::TM * StepTile<double>::TY == TILE_P, "");

// Sets the opt-in shared-memory size of one step instantiation.
template <typename K>
int allow_smem(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;  // above 48 KB shared memory is an opt-in
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    return (int)err;
}

// first (n0, r), mids (d-2, r, n, r), last (r, nl), all stored as S;
// idx (B, d) int32; perm (d-2, B) int32 and tiles (d-2, max_tiles, 4)
// int32 from the wrapper's grouping tables, cut for tiles of tile_p
// points; carry0 and carry1 (B, r) scratch in T = Acc<S>; out (B,) in S.
// Any r >= 1, B >= 1, d >= 2.
template <typename S, typename T = typename tnt::Acc<S>::type>
int evaluate_grouped(const S* first, const S* mids, const S* last,
                     const int* idx, const int* perm, const int* tiles,
                     T* carry0, T* carry1, S* out, int B, int d, int n0,
                     int n, int nl, int r, int max_tiles, int tile_p,
                     cudaStream_t stream) {
    if (r < 1 || B < 1 || d < 2 || n0 < 1 || nl < 1 || (d > 2 && n < 1) ||
        tile_p != TILE_P)
        return (int)cudaErrorInvalidValue;
    constexpr int PK = 16 / sizeof(T);
    constexpr int TM = StepTile<T>::TM, TN = StepTile<T>::TN,
                  TY = StepTile<T>::TY;
    constexpr size_t smem = step_smem_bytes<T, TM, TN, TY>();
    const int d_mid = d - 2;
    const int vec = r % PK == 0 && tnt::aligned16(first) &&
                    tnt::aligned16(mids) && tnt::aligned16(carry0) &&
                    tnt::aligned16(carry1);
    // the first step reads its rows from first (S), the later ones from a
    // carry (T); for float and double the two are one instantiation
    auto first_step = grouped_step<T, TM, TN, TY, S, S>;
    auto next_step = grouped_step<T, TM, TN, TY, T, S>;
    if (d_mid > 0) {
        if (!tnt::aligned16(tiles)) return (int)cudaErrorInvalidValue;
        int rc = allow_smem(first_step, smem);
        if (!rc) rc = allow_smem(next_step, smem);
        if (rc) return rc;
    }
    T* bufs[2] = {carry0, carry1};
    const size_t core_sz = (size_t)r * n * r;
    const dim3 grid(max_tiles, cdiv(r, TX * TN));
    for (int k = 0; k < d_mid; ++k) {
        T* dst = bufs[k & 1];
        const int* perm_k = perm + (size_t)k * B;
        const int4* tiles_k =
            reinterpret_cast<const int4*>(tiles + (size_t)k * max_tiles * 4);
        // the first step is an ordinary launch: the kernel before it on
        // the stream may be the one that writes the grouping tables
        const int rc =
            k == 0 ? tnt::launch_after(first_step, grid, TX * TY, smem, stream,
                                       false, first, idx, n0, mids, perm_k,
                                       tiles_k, dst, B, d, n, r, vec)
                   : tnt::launch_after(next_step, grid, TX * TY, smem, stream,
                                       true, (const T*)bufs[(k - 1) & 1], idx,
                                       0, mids + k * core_sz, perm_k, tiles_k,
                                       dst, B, d, n, r, vec);
        if (rc) return rc;
    }
    const dim3 fgrid(cdiv(B, FINISH_WARPS));
    if (d_mid == 0)
        return tnt::launch_after(grouped_finish<T, S, S>, fgrid,
                                 FINISH_WARPS * 32, 0, stream, false, first,
                                 idx, 1, last, out, B, d, n0, nl, r);
    return tnt::launch_after(grouped_finish<T, T, S>, fgrid, FINISH_WARPS * 32,
                             0, stream, true, (const T*)bufs[(d_mid - 1) & 1],
                             idx, 0, last, out, B, d, n0, nl, r);
}

// ---- the tile list: from each step's sorted modes, the tiles as
// (step, mode, first row, row count); kernels/evaluate.py has the same
// in torch ops (group_tiles_plain), ~25 dispatches that cost the host
// more than the evaluation costs the card ----

constexpr int TILES_THREADS = 256;

// first position of the sorted row that holds a value >= m
__device__ __forceinline__ int first_at_least(const int* __restrict__ row,
                                              int len, int m) {
    int lo = 0, hi = len;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (row[mid] < m) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// One block per step.  A thread takes a mode: its group's bounds by two
// binary searches, its first tile slot by a block-wide scan of the
// tile counts (modes in chunks of the block, the running total carried
// over), then its tiles.  Slots past the step's last tile become zeros.
__global__ void __launch_bounds__(TILES_THREADS)
group_tiles(const int* __restrict__ vals, int4* __restrict__ tiles, int B,
            int n, int max_tiles, int tile_p) {
    __shared__ int warp_total[TILES_THREADS / 32];
    __shared__ int carried;  // tiles of the modes before this chunk
    const int k = blockIdx.x;
    const int* row = vals + (size_t)k * B;
    int4* out = tiles + (size_t)k * max_tiles;
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    if (tid == 0) carried = 0;
    __syncthreads();
    for (int m0 = 0; m0 < n; m0 += TILES_THREADS) {
        const int m = m0 + tid;
        int start = 0, size = 0;
        if (m < n) {
            start = first_at_least(row, B, m);
            size = first_at_least(row, B, m + 1) - start;
        }
        const int mine = (size + tile_p - 1) / tile_p;
        int upto = mine;  // inclusive scan over the warp, then the block
        for (int off = 1; off < 32; off <<= 1) {
            const int below = __shfl_up_sync(0xffffffffu, upto, off);
            if (lane >= off) upto += below;
        }
        if (lane == 31) warp_total[warp] = upto;
        __syncthreads();
        int before = carried;
        for (int w = 0; w < warp; ++w) before += warp_total[w];
        const int first_slot = before + upto - mine;
        for (int t = 0; t < mine; ++t)
            if (first_slot + t < max_tiles)
                out[first_slot + t] = make_int4(
                    k, m, start + t * tile_p, min(tile_p, size - t * tile_p));
        __syncthreads();  // every thread has read carried and warp_total
        if (tid == TILES_THREADS - 1) carried = before + upto;
        __syncthreads();
    }
    for (int slot = carried + tid; slot < max_tiles; slot += TILES_THREADS)
        out[slot] = make_int4(0, 0, 0, 0);
}

// ---- the per-point kernel (the yardstick): one warp per point, each
// reading its own (r x r) slice per step, ~15.7 GB through L2 at the
// sizes above; its block's carries sit in shared memory ----

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

template <typename T>
int evaluate(const T* first, const T* mids, const T* last, const int* idx,
             T* out, int B, int d, int n, int r, cudaStream_t stream) {
    if (r <= 128) return launch<T, 4>(first, mids, last, idx, out, B, d, n, r, stream);
    if (r <= 256) return launch<T, 8>(first, mids, last, idx, out, B, d, n, r, stream);
    if (r <= 512) return launch<T, 16>(first, mids, last, idx, out, B, d, n, r, stream);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// One entry point per storage type: the cores and out in S, the carries
// in Acc<S>.
#define TNT_EVALUATE_GROUPED_ENTRY(SUFFIX, S)                                  \
    int tnt_evaluate_grouped_##SUFFIX(                                         \
        const void* first, const void* mids, const void* last,                 \
        const void* idx, const void* perm, const void* tiles, void* carry0,    \
        void* carry1, void* out, int B, int d, int n0, int n, int nl, int r,   \
        int max_tiles, int tile_p, void* stream) {                             \
        using T = tnt::Acc<S>::type;                                           \
        return evaluate_grouped<S>(                                            \
            (const S*)first, (const S*)mids, (const S*)last, (const int*)idx,  \
            (const int*)perm, (const int*)tiles, (T*)carry0, (T*)carry1,       \
            (S*)out, B, d, n0, n, nl, r, max_tiles, tile_p,                    \
            (cudaStream_t)stream);                                             \
    }

extern "C" {

TNT_EVALUATE_GROUPED_ENTRY(f32, float)
TNT_EVALUATE_GROUPED_ENTRY(f64, double)
TNT_EVALUATE_GROUPED_ENTRY(bf16, __nv_bfloat16)
TNT_EVALUATE_GROUPED_ENTRY(f16, __half)

// vals (d_mid, B) int32, each row sorted, values in [0, n);
// tiles (d_mid, max_tiles, 4) int32 out.
int tnt_group_tiles(const void* vals, void* tiles, int B, int d_mid, int n,
                    int max_tiles, int tile_p, void* stream) {
    if (B < 1 || d_mid < 1 || n < 1 || tile_p < 1 || max_tiles < 1 ||
        !tnt::aligned16(tiles))
        return (int)cudaErrorInvalidValue;
    group_tiles<<<d_mid, TILES_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)vals, (int4*)tiles, B, n, max_tiles, tile_p);
    TNT_CHECK_LAUNCH();
    return 0;
}

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
