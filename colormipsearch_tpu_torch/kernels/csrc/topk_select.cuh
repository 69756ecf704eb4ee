// The per-row top-k selection of K4 (topk.cu), shared with the mesh's
// finish kernel (mesh_finish.cu): one template, two instantiations.
//
// select_kernel<false> is K4 exactly: outputs [B, k] at row stride k,
// the chosen columns as they are, the flags gathered when pair_flags is
// set. select_kernel<true> is the mesh finish: the same selection
// written at any row stride (a shard's column slice of the merged
// [B, D*k] outputs), the columns offset by the shard's first global
// column, the mirrored bits and flags optional (flags written as zeros
// when the step has none), and beside them the row's largest score and
// its count of flagged pairs (pair_flags > 0), reduced in the same pass
// as the select's AND / OR of the keys; with k = 0 it writes only those
// two. The design notes are topk.cu's.
#pragma once

#include <algorithm>

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int64_t MAX_COLS = 16384;
constexpr int MAX_CLUSTER = 8;
constexpr int COLS_A_BLOCK = 512;   // the cluster grows by T / 512
constexpr int MAX_PER = 8;          // columns a thread: 16,384 / 8 / 256
constexpr int RANK_MAX = 512;       // order by counting up to this many

// Where a launch writes. K4: every pointer but row_max and row_flagged
// set (flags iff pair_flags), ld = k, col_offset 0.
struct SelectOut {
    int32_t* scores;       // [B, ld]: the k winners at the front of a row
    int32_t* idx;          // their columns + col_offset
    uint8_t* mirr;         // their mirrored bits, or null
    int32_t* flags;        // their pair_flags (0 without), or null
    int64_t ld;            // row stride of the four outputs
    int32_t col_offset;
    int32_t* row_max;      // [B] the row's largest score, or null
    int32_t* row_flagged;  // [B] the row's pair_flags > 0, or null
};

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

template <bool MESH>
__global__ void __launch_bounds__(THREADS)
select_kernel(const int32_t* __restrict__ best,
              const uint8_t* __restrict__ mirrored, int64_t n_cols, int per,
              int k, const int32_t* __restrict__ pair_flags, SelectOut out) {
    extern __shared__ unsigned long long s_sel[];   // the first block's
    __shared__ uint32_t hist[2][256];
    __shared__ uint32_t warp_sums[THREADS / 32];
    __shared__ uint32_t counts[2];                   // this block's L, ties
    __shared__ uint32_t pick[3];                     // digit, below, in it
    // AND, OR (and for the mesh: MIN of the keys, flagged pairs) a warp
    __shared__ uint32_t span[THREADS / 32][4];

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
    uint32_t all_and = ~0u, all_or = 0, all_min = ~0u, n_flag = 0;
#pragma unroll
    for (int e = 0; e < MAX_PER; ++e)
        if (e < mine) {
            all_and &= o[e];
            all_or |= o[e];
            if constexpr (MESH) {
                all_min = min(all_min, o[e]);
                if (pair_flags != nullptr)
                    n_flag += pair_flags[b * n_cols + first + e] > 0;
            }
        }
    all_and = __reduce_and_sync(0xffffffffu, all_and);
    all_or = __reduce_or_sync(0xffffffffu, all_or);
    if constexpr (MESH) {
        all_min = __reduce_min_sync(0xffffffffu, all_min);
        n_flag = __reduce_add_sync(0xffffffffu, n_flag);
    }
    if ((threadIdx.x & 31) == 0) {
        span[threadIdx.x >> 5][0] = all_and;
        span[threadIdx.x >> 5][1] = all_or;
        span[threadIdx.x >> 5][2] = all_min;
        span[threadIdx.x >> 5][3] = n_flag;
    }
    __syncthreads();
    if (threadIdx.x == 0)
        for (int w = 1; w < THREADS / 32; ++w) {
            span[0][0] &= span[w][0];
            span[0][1] |= span[w][1];
            if constexpr (MESH) {
                span[0][2] = min(span[0][2], span[w][2]);
                span[0][3] += span[w][3];
            }
        }
    cluster.sync();
    all_and = ~0u;
    all_or = 0;
    all_min = ~0u;
    n_flag = 0;
    for (int r = 0; r < cs; ++r) {
        const uint32_t* rs = cluster.map_shared_rank(&span[0][0], r);
        all_and &= rs[0];
        all_or |= rs[1];
        if constexpr (MESH) {
            all_min = min(all_min, rs[2]);
            n_flag += rs[3];
        }
    }
    if constexpr (MESH) {
        if (rank == 0 && threadIdx.x == 0) {
            if (out.row_max != nullptr) out.row_max[b] = score_of(all_min);
            if (out.row_flagged != nullptr)
                out.row_flagged[b] = static_cast<int32_t>(n_flag);
        }
        if (k == 0) {
            cluster.sync();   // no block leaves while another reads span
            return;
        }
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
    const int64_t out0 = b * out.ld;
    // one winner at place `at` of its row
    auto put = [&](int64_t at, int32_t score, int64_t col) {
        out.scores[out0 + at] = score;
        out.idx[out0 + at] = static_cast<int32_t>(col) + out.col_offset;
        if (!MESH || out.mirr != nullptr)
            out.mirr[out0 + at] = mirrored[b * n_cols + col];
        if (out.flags != nullptr)
            out.flags[out0 + at] = MESH && pair_flags == nullptr
                ? 0 : pair_flags[b * n_cols + col];
    };
#pragma unroll
    for (int e = 0; e < MAX_PER; ++e) {
        if (e >= mine) continue;
        const uint32_t hi = shift == 32 ? 0 : o[e] >> shift;
        const int64_t col = first + e;
        if (hi < prefix) {
            sel[at_less++] = (static_cast<unsigned long long>(o[e]) << 32)
                | static_cast<uint32_t>(col);
        } else if (hi == prefix) {
            if (at_tie < need) put(all_less + at_tie, score_of(o[e]), col);
            ++at_tie;
        }
    }
    cluster.sync();   // every winner is in the first block
    if (rank != 0) return;

    const uint32_t n_sel = all_less;
    auto emit = [&](uint32_t at, unsigned long long key) {
        put(at, score_of(static_cast<uint32_t>(key >> 32)),
            static_cast<int64_t>(key & 0xFFFFFFFFull));
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

// Launch select_kernel<MESH> over `batch` rows of n_cols columns on
// `stream` (1 <= n_cols <= MAX_COLS, 0 <= k <= n_cols, k >= 1 for K4;
// the caller checks): a cluster of up to 8 blocks a row.
template <bool MESH>
cudaError_t launch_select(const int32_t* best, const uint8_t* mirrored,
                          const int32_t* pair_flags, int batch,
                          int64_t n_cols, int k, const SelectOut& out,
                          cudaStream_t stream) {
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
            select_kernel<MESH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return err;
        if (dev < cmst::MAX_DEVICES) smem_set[dev] = smem;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(batch) * cs);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, select_kernel<MESH>, best, mirrored,
                             n_cols, per, k, pair_flags, out);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace
