// K3, K13 and the qkey kernel: full-union rank-key scoring with the
// variant reduction fused in, on int32 key planes (K3, qkey) or on split
// key planes (K13).
//
// K3 replaces colormipsearch_tpu/ops/pixel_match.py
// `score_query_union_keys_raw` + `score_query_batch_union_keys` +
// `reduce_variants_device`; K13 replaces
// `score_query_union_keys_splitk_raw` + `score_query_batch_union_keys_
// splitk` (row 12 of the kernel table), which gathers the key as
// (cls << 15) | rank from a uint16 rank plane and a uint8 class plane
// (ops/pixel_match.split_key_planes). The two differ only in the key
// loader, a template argument. The qkey kernel (row 14) replaces
// `score_query_union_qkeys_raw` + `score_query_batch_union_qkeys`
// (:1806, :1850): K3's walk whose lane tables are not read from expanded
// [B, L, 2, U] arrays but gathered while they are staged, from the
// factored wire form (qk = key_list[b, qidx[b, l, u]], then the shared
// per-tolerance tables at qk), the table source being a second template
// argument; it is always the segmented form (two slots, slot 2 added on
// the prefix u < u2, which may be U). For mask b and target column t, every
// union element u gathers key = planes[pos[u], t]; lane j counts the u whose
// key lies in one of its interval windows, (key - lo) mod 2^32 <= span.
// Segmented tables (two slots, 0 <= u2 < U) ADD the slot-2 hits on the
// prefix u < u2; otherwise the slots are ORed at full width. The
// mirrored orientation reuses the same lane tables over mu_pos. The
// result is best = max(straight max, mirror max) and
// mirrored = mirror max > straight max.
//
// Why the first design was slow: one thread per target column and one
// grid row per mask, each thread walking the whole union (2 orientations
// x 49,152 elements at the main path's shapes) with one dependent key
// gather an element. At T 2,048 and 8 masks that grid is 64 blocks of
// 256 threads on a 132-SM card: half the SMs idle, 8 warps on each busy
// one, and every warp waiting on its gathers' latency (~770 ns an
// element, 80 ms a batch). A mesh shard of 512 columns had 16 blocks.
//
// Design now: the union is split over the grid as well. A block takes
// (column block, union chunk, mask); the chunk is chosen on the host so
// that the grid has ~TARGET_BLOCKS blocks whatever the column count
// (at T 2,048 and B 8: 8 x 192 x 8 = 12,288 blocks). The
// block stages its chunk TILE_U elements at a time (positions, and the
// lane windows as (lo, span) pairs, every thread reading the same pair: a
// broadcast), each thread keeps the LANE_GROUP lane counters of one
// (orientation, set, lane group) in registers and loads KEYS_IN_FLIGHT
// keys before it compares any, then adds its counters into a zeroed int32
// scratch [B, 2, S, L, T] with atomicAdd. Integer addition is order-free,
// so the sums are exact and the same on every run. A second small kernel
// takes the max over lanes and sets of each orientation (lane counts are
// summed over the whole union before any max) and writes best and
// mirrored. The segmented prefix u < u2 is tested on the absolute element
// index, so a chunk boundary inside it changes nothing.
//
// Bound on the H100: per (mask, orientation, element, column) one 4-byte
// gather (K13: 2 + 1 bytes), coalesced across the block's columns, and
// ~3 integer operations per live (lane, slot) window: 1.6e9 elements and
// ~6.8e10 integer operations at the main path's shapes, which issue at
// the integer rate (64 lanes an SM a clock), 4.1 ms; each window also
// costs a shared-memory load of its (lo, span) pair, so the practical
// floor is nearer 5.5 ms. Plane offsets are 64-bit.
#include "common.cuh"

namespace {

constexpr int LANE_GROUP = 9;      // xyShift 2 = 9 lanes in one pass
constexpr int TILE_U = 128;        // union elements staged per tile
constexpr int MAX_SLOTS = 3;
constexpr int THREADS = 256;
constexpr int KEYS_IN_FLIGHT = 8;  // key gathers issued before compares
// grid size the automatic chunk aims at: chunks of 2 tiles at T 2,048 and
// B 8, 1 tile on a 512-column shard (chip_smoke.py phase 2 times K3 at
// chunks of 1 to 24 tiles; 1-2 tiles were fastest on the H100, PERF.md)
constexpr int TARGET_BLOCKS = 16384;

// Loaders read the planes through the read-only cache (__ldg).

// K3's loader: the int32 key itself
struct KeyPlanes {
    const int32_t* planes;
    __device__ __forceinline__ uint32_t load(int64_t i) const {
        return static_cast<uint32_t>(__ldg(planes + i));
    }
};

// K13's loader: (cls << 15) | rank, as the JAX function rebuilds it
struct SplitKeyPlanes {
    const uint16_t* rank;
    const uint8_t* cls;
    __device__ __forceinline__ uint32_t load(int64_t i) const {
        return (static_cast<uint32_t>(__ldg(cls + i)) << cmst::KEY_RANK_BITS)
            | __ldg(rank + i);
    }
};

// Table sources: the (lo, span) window of (mask b, lane j, slot s,
// element u).

// K3's and K13's: expanded uint32 [B, L, n_slots, U] arrays
struct ExpandedTables {
    const uint32_t* lo;
    const uint32_t* span;
    int n_lanes, n_slots, n_u;
    __device__ __forceinline__ uint2 load(int b, int j, int s, int u) const {
        const int64_t i = ((static_cast<int64_t>(b) * n_lanes + j) * n_slots
                           + s) * n_u + u;
        return make_uint2(lo[i], span[i]);
    }
};

// the qkey kernel's: qidx int32 [B, L, U] into key_list int32 [B, KL],
// then the shared uint32 [2, n_keys] tables (indices and keys clamped)
struct QkeyTables {
    const int32_t* qidx;
    const int32_t* key_list;
    const uint32_t* tab_lo;
    const uint32_t* tab_span;
    int64_t n_kl, n_keys;
    int n_lanes, n_u;
    __device__ __forceinline__ uint2 load(int b, int j, int s, int u) const {
        int64_t row = qidx[(static_cast<int64_t>(b) * n_lanes + j) * n_u
                           + u];
        row = row < 0 ? 0 : (row >= n_kl ? n_kl - 1 : row);
        int64_t key = key_list[b * n_kl + row];
        key = key < 0 ? 0 : (key >= n_keys ? n_keys - 1 : key);
        return make_uint2(tab_lo[s * n_keys + key],
                          tab_span[s * n_keys + key]);
    }
};

// the lane hits of one key against staged element k's windows
template <bool SEG>
__device__ __forceinline__ void count_key(uint32_t key, int k, bool second,
                                          int lg, int n_slots,
                                          const uint2* s_tab,
                                          int (&cnt)[LANE_GROUP]) {
#pragma unroll
    for (int j = 0; j < LANE_GROUP; ++j) {
        if (j >= lg) continue;
        const uint2* w = s_tab + j * MAX_SLOTS * TILE_U + k;
        if (SEG) {
            int c = (key - w[0].x) <= w[0].y;
            if (second) c += (key - w[TILE_U].x) <= w[TILE_U].y;
            cnt[j] += c;
        } else {
            bool m = (key - w[0].x) <= w[0].y;
            for (int s = 1; s < n_slots; ++s)
                m |= (key - w[s * TILE_U].x) <= w[s * TILE_U].y;
            cnt[j] += m;
        }
    }
}

// the lane counts of one union chunk, added into scratch [B, 2, S, L, T]
template <bool SEG, class Planes, class Tables>
__global__ void union_chunk_kernel(const Planes planes, int64_t n_cols,
                                   const int32_t* __restrict__ u_pos,
                                   const int32_t* __restrict__ mu_pos,
                                   int n_sets, int n_msets,
                                   const Tables tables, int n_lanes,
                                   int n_slots, int n_u, int u2, int chunk,
                                   int32_t* __restrict__ scratch) {
    __shared__ int32_t s_pos[TILE_U];
    __shared__ uint2 s_tab[LANE_GROUP * MAX_SLOTS * TILE_U];

    const int b = blockIdx.z;
    const int cu0 = blockIdx.y * chunk;
    const int cu1 = min(n_u, cu0 + chunk);
    const int64_t t = blockIdx.x * static_cast<int64_t>(THREADS)
        + threadIdx.x;
    const bool active = t < n_cols;
    const int64_t tc = active ? t : 0;

    for (int o = 0; o < 2; ++o) {
        const int sets = o == 0 ? n_sets : n_msets;
        const int32_t* pos_b = (o == 0 ? u_pos : mu_pos)
            + static_cast<int64_t>(b) * sets * n_u;
        for (int si = 0; si < sets; ++si) {
            const int32_t* pos = pos_b + static_cast<int64_t>(si) * n_u;
            for (int g0 = 0; g0 < n_lanes; g0 += LANE_GROUP) {
                const int lg = min(LANE_GROUP, n_lanes - g0);
                int cnt[LANE_GROUP];
#pragma unroll
                for (int j = 0; j < LANE_GROUP; ++j) cnt[j] = 0;
                for (int u0 = cu0; u0 < cu1; u0 += TILE_U) {
                    const int n = min(TILE_U, cu1 - u0);
                    __syncthreads();
                    for (int k = threadIdx.x; k < n; k += THREADS)
                        s_pos[k] = pos[u0 + k];
                    const int n_tab = lg * n_slots * n;
                    for (int e = threadIdx.x; e < n_tab; e += THREADS) {
                        const int k = e % n;
                        const int js = e / n;  // (lane in group, slot)
                        const int j = js / n_slots;
                        const int sl = js - j * n_slots;
                        s_tab[(j * MAX_SLOTS + sl) * TILE_U + k] =
                            tables.load(b, g0 + j, sl, u0 + k);
                    }
                    __syncthreads();
                    if (!active) continue;
                    int k = 0;
                    for (; k + KEYS_IN_FLIGHT <= n; k += KEYS_IN_FLIGHT) {
                        uint32_t key[KEYS_IN_FLIGHT];
#pragma unroll
                        for (int i = 0; i < KEYS_IN_FLIGHT; ++i)
                            key[i] = planes.load(
                                static_cast<int64_t>(s_pos[k + i]) * n_cols
                                + tc);
#pragma unroll
                        for (int i = 0; i < KEYS_IN_FLIGHT; ++i)
                            count_key<SEG>(key[i], k + i,
                                           SEG && u0 + k + i < u2, lg,
                                           n_slots, s_tab, cnt);
                    }
                    for (; k < n; ++k)
                        count_key<SEG>(
                            planes.load(static_cast<int64_t>(s_pos[k])
                                        * n_cols + tc),
                            k, SEG && u0 + k < u2, lg, n_slots, s_tab, cnt);
                }
                if (!active) continue;
                int32_t* out = scratch
                    + (((static_cast<int64_t>(b) * 2 + o) * n_sets + si)
                       * n_lanes + g0) * n_cols + t;
#pragma unroll
                for (int j = 0; j < LANE_GROUP; ++j)
                    if (j < lg && cnt[j]) atomicAdd(out + j * n_cols, cnt[j]);
            }
        }
    }
}

// best and mirrored from the summed lane counts: the max over lanes and
// sets of each orientation. One thread per (mask, column).
__global__ void union_finish_kernel(const int32_t* __restrict__ scratch,
                                    int batch, int n_sets, int n_msets,
                                    int n_lanes, int64_t n_cols,
                                    int32_t* __restrict__ best,
                                    uint8_t* __restrict__ mirrored) {
    const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x)
        + threadIdx.x;
    if (i >= batch * n_cols) return;
    const int64_t b = i / n_cols;
    const int64_t t = i - b * n_cols;
    int orient_max[2] = {0, 0};
    for (int o = 0; o < 2; ++o) {
        const int sets = o == 0 ? n_sets : n_msets;
        const int32_t* c = scratch + (b * 2 + o) * n_sets * n_lanes * n_cols
            + t;
        for (int e = 0; e < sets * n_lanes; ++e)
            orient_max[o] = max(orient_max[o], c[e * n_cols]);
    }
    if (n_msets > 0) {
        best[i] = max(orient_max[0], orient_max[1]);
        mirrored[i] = orient_max[1] > orient_max[0];
    } else {
        best[i] = orient_max[0];
        mirrored[i] = 0;
    }
}

template <class Planes, class Tables>
int run(const Planes& planes, int64_t n_cols, const void* u_pos,
        const void* mu_pos, int n_sets, int n_msets, const Tables& tables,
        int batch, int n_lanes, int n_slots, int n_u, int u2, int segmented,
        int chunk, void* scratch, void* best, void* mirrored, void* stream) {
    if (n_slots < 1 || n_slots > MAX_SLOTS || batch > 65535 || n_u < 0
        || chunk < 0)
        return cudaErrorInvalidValue;
    if (batch == 0 || n_cols == 0) return cudaGetLastError();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int32_t* sc = static_cast<int32_t*>(scratch);
    if (n_u > 0) {
        if (chunk == 0) {
            // chunks of whole tiles, as many as bring the grid to
            // ~TARGET_BLOCKS blocks
            const int64_t base = static_cast<int64_t>(
                cmst::blocks_for(n_cols, THREADS)) * batch;
            const int tiles = (n_u + TILE_U - 1) / TILE_U;
            const int64_t want = (TARGET_BLOCKS + base - 1) / base;
            const int n_chunks = static_cast<int>(
                want < tiles ? (want < 1 ? 1 : want) : tiles);
            chunk = (tiles + n_chunks - 1) / n_chunks * TILE_U;
        }
        if ((n_u + chunk - 1) / chunk > 65535) return cudaErrorInvalidValue;
        const dim3 grid(cmst::blocks_for(n_cols, THREADS),
                        (n_u + chunk - 1) / chunk, batch);
        const int32_t* up = static_cast<const int32_t*>(u_pos);
        const int32_t* mp = static_cast<const int32_t*>(mu_pos);
        if (segmented)
            union_chunk_kernel<true, Planes, Tables>
                <<<grid, THREADS, 0, st>>>(
                planes, n_cols, up, mp, n_sets, n_msets, tables, n_lanes,
                n_slots, n_u, u2, chunk, sc);
        else
            union_chunk_kernel<false, Planes, Tables>
                <<<grid, THREADS, 0, st>>>(
                planes, n_cols, up, mp, n_sets, n_msets, tables, n_lanes,
                n_slots, n_u, u2, chunk, sc);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    constexpr int threads = 256;
    union_finish_kernel<<<cmst::blocks_for(
        static_cast<int64_t>(batch) * n_cols, threads), threads, 0, st>>>(
        sc, batch, n_sets, n_msets, n_lanes, n_cols,
        static_cast<int32_t*>(best), static_cast<uint8_t*>(mirrored));
    return cudaGetLastError();
}

ExpandedTables expanded(const void* lane_lo, const void* lane_span,
                        int n_lanes, int n_slots, int n_u) {
    return ExpandedTables{static_cast<const uint32_t*>(lane_lo),
                          static_cast<const uint32_t*>(lane_span), n_lanes,
                          n_slots, n_u};
}

}  // namespace

// K3: planes int32 [rows, n_cols]; u_pos int32 [batch, n_sets, n_u],
// mu_pos [batch, n_msets, n_u]; lane_lo / lane_span uint32 [batch,
// n_lanes, n_slots, n_u]; scratch int32 [batch, 2, n_sets, n_lanes,
// n_cols], zeroed by the caller; chunk: union elements a block (0:
// chosen here) -> best int32, mirrored uint8 [batch, n_cols].
extern "C" int cmst_union_score(const void* planes, int64_t n_cols,
                                const void* u_pos, const void* mu_pos,
                                int n_sets, int n_msets,
                                const void* lane_lo, const void* lane_span,
                                int batch, int n_lanes, int n_slots,
                                int n_u, int u2, int segmented, int chunk,
                                void* scratch, void* best, void* mirrored,
                                void* stream) {
    return run(KeyPlanes{static_cast<const int32_t*>(planes)}, n_cols,
               u_pos, mu_pos, n_sets, n_msets,
               expanded(lane_lo, lane_span, n_lanes, n_slots, n_u), batch,
               n_lanes, n_slots, n_u, u2, segmented, chunk, scratch, best,
               mirrored, stream);
}

// K13: rank uint16 and cls uint8 [rows, n_cols]; every other argument as
// cmst_union_score's.
extern "C" int cmst_union_score_splitk(const void* rank, const void* cls,
                                       int64_t n_cols, const void* u_pos,
                                       const void* mu_pos, int n_sets,
                                       int n_msets, const void* lane_lo,
                                       const void* lane_span, int batch,
                                       int n_lanes, int n_slots, int n_u,
                                       int u2, int segmented, int chunk,
                                       void* scratch, void* best,
                                       void* mirrored, void* stream) {
    return run(SplitKeyPlanes{static_cast<const uint16_t*>(rank),
                              static_cast<const uint8_t*>(cls)},
               n_cols, u_pos, mu_pos, n_sets, n_msets,
               expanded(lane_lo, lane_span, n_lanes, n_slots, n_u), batch,
               n_lanes, n_slots, n_u, u2, segmented, chunk, scratch, best,
               mirrored, stream);
}

// Row 14: planes int32 [rows, n_cols]; u_pos / mu_pos as cmst_union_score's;
// qidx int32 [batch, n_lanes, n_u], key_list int32 [batch, n_kl], tab_lo /
// tab_span uint32 [2, n_keys]; chunk and scratch as cmst_union_score's;
// slot 2 counts on the prefix u < u2 (0 <= u2 <= n_u).
extern "C" int cmst_union_score_qkeys(const void* planes, int64_t n_cols,
                                      const void* u_pos, const void* mu_pos,
                                      int n_sets, int n_msets,
                                      const void* qidx, const void* key_list,
                                      int64_t n_kl, const void* tab_lo,
                                      const void* tab_span, int64_t n_keys,
                                      int batch, int n_lanes, int n_u,
                                      int u2, int chunk, void* scratch,
                                      void* best, void* mirrored,
                                      void* stream) {
    if (n_kl < 1 || n_keys < 1 || u2 < 0 || u2 > n_u)
        return cudaErrorInvalidValue;
    const QkeyTables tables{static_cast<const int32_t*>(qidx),
                            static_cast<const int32_t*>(key_list),
                            static_cast<const uint32_t*>(tab_lo),
                            static_cast<const uint32_t*>(tab_span), n_kl,
                            n_keys, n_lanes, n_u};
    return run(KeyPlanes{static_cast<const int32_t*>(planes)}, n_cols,
               u_pos, mu_pos, n_sets, n_msets, tables, batch, n_lanes, 2,
               n_u, u2, 1, chunk, scratch, best, mirrored, stream);
}
