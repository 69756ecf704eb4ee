// K4: per-mask top-k emit selection.
//
// Replaces colormipsearch_tpu/ops/pixel_match.py
// `score_query_batch_union_keys_topk` (its `jax.lax.top_k(best, k)` and
// the mirrored gather at the chosen columns) and the per-shard tail of
// colormipsearch_tpu/parallel/mesh.py `_finish_batched_step`, which also
// gathers the int32 pair flags at the chosen columns (pass a null
// `pair_flags` to skip that gather). Order: score descending,
// lower column first on ties — jax.lax.top_k's order, so the kernel,
// its plain version and the JAX package agree index for index.
//
// Bound on the H100: neither bytes (5*T + 9*k a mask: 16 KB at the
// engine's T 2,048) nor operations; a launch at the engine's batch of 8
// masks is set by the latency of its dependent steps (barriers, shared
// memory round trips). Sorting the whole row, as a first version did,
// costs log2(T)^2 / 2 barrier steps for k << T winners. Design: select,
// then order only the winners.
//  * Each column's key is ~(score ^ 2^31) << 32 | column; the keys are
//    distinct and ascend in the wanted order. A radix select over the
//    score bits that differ within the row (an AND and an OR over it
//    first: scores under 2^16 leave two passes), 8 bits a pass (256-bin
//    histograms in shared memory), finds the prefix of the k-th smallest
//    key and how many keys of that prefix to take; it stops early once
//    the whole bucket is taken.
//    Keys of that prefix are taken lowest column first, by a scan in
//    column order, so ties on the score never need the column bits (a
//    bucket taken whole before the last pass joins the keys below it).
//  * A row is split over a thread-block cluster of up to 8 blocks on
//    neighbouring SMs (T / 512 of them: 4 at T 2,048, so the engine's 8
//    masks run on 32 SMs, not 8); each block keeps at most 8 columns a
//    thread in registers, up to the 16,384-column cap, counts them into
//    its own histogram and reads the others' through distributed shared
//    memory (double-buffered, so one cluster barrier a pass). At the
//    engine's T the launch is bound by its barriers, not by work: one
//    block a row ran as fast on the H100, so the cluster grows only with
//    T, and what it buys is the cap without 64 keys a thread.
//  * Block-wide scans place the winners: keys below the prefix (L of
//    them) go to the first block's shared memory, the taken ties, which
//    already come last and in column order, straight to their outputs.
//  * The first block orders the L keys: by counting, for each key, the
//    keys below it (a broadcast read of every key, no barrier) when L <=
//    512, else by a bitonic sort in shared memory (the branch for k a
//    large share of the row: k = T at the engine's T of 2,048).
#include <algorithm>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_COLS = 16384;
constexpr int MAX_CLUSTER = 8;
constexpr int COLS_A_BLOCK = 512;   // the cluster grows by T / 512
constexpr int MAX_PER = 8;          // columns a thread: 16,384 / 8 / 256
constexpr int RANK_MAX = 512;       // order by counting up to this many

__device__ __forceinline__ uint32_t ordered(int32_t score) {
    return ~(static_cast<uint32_t>(score) ^ 0x80000000u);
}

__device__ __forceinline__ int32_t score_of(uint32_t o) {
    return static_cast<int32_t>(~o ^ 0x80000000u);
}

// exclusive block-wide scan of v over THREADS threads; *total gets the
// sum. `warp_sums` holds THREADS / 32 ints.
__device__ uint32_t block_scan(uint32_t v, uint32_t* warp_sums,
                               uint32_t* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint32_t x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
        uint32_t w = lane < THREADS / 32 ? warp_sums[lane] : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const uint32_t y = __shfl_up_sync(0xffffffffu, w, d);
            if (lane >= d) w += y;
        }
        if (lane < THREADS / 32) warp_sums[lane] = w;  // inclusive
    }
    __syncthreads();
    const uint32_t before = warp ? warp_sums[warp - 1] : 0;
    *total = warp_sums[THREADS / 32 - 1];
    __syncthreads();   // warp_sums may be reused
    return before + x - v;
}

__global__ void __launch_bounds__(THREADS)
topk_kernel(const int32_t* __restrict__ best,
            const uint8_t* __restrict__ mirrored, int64_t n_cols, int per,
            int k, int32_t* __restrict__ scores_k,
            int32_t* __restrict__ idx_k, uint8_t* __restrict__ mirr_k,
            const int32_t* __restrict__ pair_flags,
            int32_t* __restrict__ flags_k) {
    extern __shared__ unsigned long long s_sel[];   // the first block's
    __shared__ uint32_t hist[2][256];
    __shared__ uint32_t warp_sums[THREADS / 32];
    __shared__ uint32_t counts[2];                   // this block's L, ties
    __shared__ uint32_t pick[3];                     // digit, below, in it
    __shared__ uint32_t span[THREADS / 32][2];       // AND, OR a warp

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int cs = static_cast<int>(cluster.num_blocks());
    const int64_t b = blockIdx.x / cs;
    const int32_t* row = best + b * n_cols;
    const int64_t first = (static_cast<int64_t>(rank) * THREADS
                           + threadIdx.x) * per;     // my first column

    uint32_t o[MAX_PER];
#pragma unroll
    for (int e = 0; e < MAX_PER; ++e)
        o[e] = (e < per && first + e < n_cols) ? ordered(row[first + e]) : 0;
    const int64_t left = n_cols - first;
    const int mine = left <= 0 ? 0 : left < per ? static_cast<int>(left)
                                                : per;

    // the bits every key of the row shares (an AND and an OR over the
    // cluster): the select starts below them, so a row of scores under
    // 2^16 takes two passes, not four, and a row of equal scores none
    uint32_t all_and = ~0u, all_or = 0;
#pragma unroll
    for (int e = 0; e < MAX_PER; ++e)
        if (e < mine) {
            all_and &= o[e];
            all_or |= o[e];
        }
    all_and = __reduce_and_sync(0xffffffffu, all_and);
    all_or = __reduce_or_sync(0xffffffffu, all_or);
    if ((threadIdx.x & 31) == 0) {
        span[threadIdx.x >> 5][0] = all_and;
        span[threadIdx.x >> 5][1] = all_or;
    }
    __syncthreads();
    if (threadIdx.x == 0)
        for (int w = 1; w < THREADS / 32; ++w) {
            span[0][0] &= span[w][0];
            span[0][1] |= span[w][1];
        }
    cluster.sync();
    all_and = ~0u;
    all_or = 0;
    for (int r = 0; r < cs; ++r) {
        const uint32_t* rs = cluster.map_shared_rank(&span[0][0], r);
        all_and &= rs[0];
        all_or |= rs[1];
    }
    // radix select over the score bits: `prefix` of the top 32 - shift
    // bits, `need` keys of that prefix still to take
    const int differ = 32 - __clz(all_and ^ all_or);   // 0: all equal
    int shift = (differ + 7) / 8 * 8;
    uint32_t prefix = shift == 32 ? 0 : all_and >> shift;
    uint32_t need = static_cast<uint32_t>(k);
    bool whole = false;
    while (shift > 0) {
        const int pass = (32 - shift) / 8;
        uint32_t* h = hist[pass & 1];
        // no block reads this buffer any more: they read it before the
        // last pass's cluster barrier
        h[threadIdx.x] = 0;
        __syncthreads();
        const int sh = shift - 8;
#pragma unroll
        for (int e = 0; e < MAX_PER; ++e)
            if (e < mine && (shift == 32 || (o[e] >> shift) == prefix))
                atomicAdd(&h[(o[e] >> sh) & 255u], 1u);
        cluster.sync();
        uint32_t c = 0;
        for (int r = 0; r < cs; ++r)
            c += cluster.map_shared_rank(h, r)[threadIdx.x];
        // which bucket holds the need-th key: one scan of 256 counts
        uint32_t total;
        const uint32_t below = block_scan(c, warp_sums, &total);
        if (below < need && need <= below + c) {
            pick[0] = threadIdx.x;
            pick[1] = below;
            pick[2] = c;
        }
        __syncthreads();
        need -= pick[1];
        prefix = (prefix << 8) | pick[0];
        shift = sh;
        whole = pick[2] == need;
        __syncthreads();   // pick is rewritten next pass
        if (whole) break;
    }
    if (whole && shift > 0) {
        // the bucket is taken whole but its keys differ below the
        // prefix: they are ordered with the keys below it
        prefix += 1;
        need = 0;
    }

    // this block's winners: below the prefix (sorted later) and the
    // prefix's first `need` keys in column order (already in place)
    uint32_t n_less = 0, n_tie = 0;
#pragma unroll
    for (int e = 0; e < MAX_PER; ++e) {
        if (e >= mine) continue;
        const uint32_t hi = shift == 32 ? 0 : o[e] >> shift;
        n_less += hi < prefix;
        n_tie += hi == prefix;
    }
    uint32_t tot_less, tot_tie;
    const uint32_t my_less = block_scan(n_less, warp_sums, &tot_less);
    const uint32_t my_tie = block_scan(n_tie, warp_sums, &tot_tie);
    if (threadIdx.x == 0) {
        counts[0] = tot_less;
        counts[1] = tot_tie;
    }
    cluster.sync();
    uint32_t less_base = 0, tie_base = 0, all_less = 0;
    for (int r = 0; r < cs; ++r) {
        const uint32_t* rc = cluster.map_shared_rank(counts, r);
        const uint32_t l = rc[0], t = rc[1];
        if (r < rank) {
            less_base += l;
            tie_base += t;
        }
        all_less += l;
    }
    unsigned long long* sel = cluster.map_shared_rank(s_sel, 0);
    uint32_t at_less = less_base + my_less, at_tie = tie_base + my_tie;
    const int64_t out0 = b * k;
#pragma unroll
    for (int e = 0; e < MAX_PER; ++e) {
        if (e >= mine) continue;
        const uint32_t hi = shift == 32 ? 0 : o[e] >> shift;
        const int64_t col = first + e;
        if (hi < prefix) {
            sel[at_less++] = (static_cast<unsigned long long>(o[e]) << 32)
                | static_cast<uint32_t>(col);
        } else if (hi == prefix) {
            if (at_tie < need) {
                const int64_t at = out0 + all_less + at_tie;
                scores_k[at] = score_of(o[e]);
                idx_k[at] = static_cast<int32_t>(col);
                mirr_k[at] = mirrored[b * n_cols + col];
                if (pair_flags != nullptr)
                    flags_k[at] = pair_flags[b * n_cols + col];
            }
            ++at_tie;
        }
    }
    cluster.sync();   // every winner is in the first block
    if (rank != 0) return;

    const uint32_t n_sel = all_less;
    auto emit = [&](uint32_t at, unsigned long long key) {
        const int64_t col = static_cast<int64_t>(key & 0xFFFFFFFFull);
        scores_k[out0 + at] = score_of(static_cast<uint32_t>(key >> 32));
        idx_k[out0 + at] = static_cast<int32_t>(col);
        mirr_k[out0 + at] = mirrored[b * n_cols + col];
        if (pair_flags != nullptr)
            flags_k[out0 + at] = pair_flags[b * n_cols + col];
    };
    if (n_sel <= RANK_MAX) {
        // each key's place is the count of keys below it (distinct keys)
        for (uint32_t i = threadIdx.x; i < n_sel; i += THREADS) {
            const unsigned long long key = s_sel[i];
            uint32_t at = 0;
            for (uint32_t j = 0; j < n_sel; ++j) at += s_sel[j] < key;
            emit(at, key);
        }
        return;
    }
    uint32_t n_pow2 = 1;
    while (n_pow2 < n_sel) n_pow2 <<= 1;
    for (uint32_t i = n_sel + threadIdx.x; i < n_pow2; i += THREADS)
        s_sel[i] = ~0ull;
    for (uint32_t size = 2; size <= n_pow2; size <<= 1) {
        for (uint32_t stride = size >> 1; stride > 0; stride >>= 1) {
            __syncthreads();
            for (uint32_t i = threadIdx.x; i < n_pow2 / 2; i += THREADS) {
                const uint32_t lo = 2 * i - (i & (stride - 1));
                const uint32_t hi = lo + stride;
                const bool ascending = (lo & size) == 0;
                const unsigned long long a = s_sel[lo], c = s_sel[hi];
                if ((a > c) == ascending) {
                    s_sel[lo] = c;
                    s_sel[hi] = a;
                }
            }
        }
    }
    __syncthreads();
    for (uint32_t i = threadIdx.x; i < n_sel; i += THREADS)
        emit(i, s_sel[i]);
}

}  // namespace

extern "C" int64_t cmst_topk_max_cols() { return MAX_COLS; }

// pair_flags int32 [batch, n_cols] and flags_k int32 [batch, k] are
// optional: both null, or both set.
extern "C" int cmst_topk(const void* best, const void* mirrored,
                         const void* pair_flags, int batch, int64_t n_cols,
                         int k, void* scores_k, void* idx_k, void* mirr_k,
                         void* flags_k, void* stream) {
    if (n_cols < 1 || n_cols > MAX_COLS || k < 1 || k > n_cols
        || batch < 0 || (pair_flags == nullptr) != (flags_k == nullptr))
        return cudaErrorInvalidValue;
    if (batch == 0) return cudaGetLastError();
    const int cs = static_cast<int>(std::min<int64_t>(
        MAX_CLUSTER, std::max<int64_t>(1, n_cols / COLS_A_BLOCK)));
    const int per = static_cast<int>(
        (n_cols + static_cast<int64_t>(cs) * THREADS - 1)
        / (static_cast<int64_t>(cs) * THREADS));
    // the first block holds every key below the k-th's prefix (< k), and
    // the bitonic branch pads them to a power of two
    int64_t n_pow2 = 1;
    while (n_pow2 < k) n_pow2 <<= 1;
    const size_t smem = static_cast<size_t>(n_pow2) * sizeof(
        unsigned long long);
    // the kernel's raised limit on each device
    static size_t smem_set[cmst::MAX_DEVICES] = {};
    const int dev = cmst::current_device();
    cudaError_t err = cudaSuccess;
    if (dev >= cmst::MAX_DEVICES || smem > smem_set[dev]) {
        err = cudaFuncSetAttribute(
            topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return err;
        if (dev < cmst::MAX_DEVICES) smem_set[dev] = smem;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(batch) * cs);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(
        &cfg, topk_kernel, static_cast<const int32_t*>(best),
        static_cast<const uint8_t*>(mirrored), n_cols, per, k,
        static_cast<int32_t*>(scores_k), static_cast<int32_t*>(idx_k),
        static_cast<uint8_t*>(mirr_k),
        static_cast<const int32_t*>(pair_flags),
        static_cast<int32_t*>(flags_k));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}
