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
// Bound on the H100: the key gathers. Each element reads one int32 (K13:
// a uint16 and a uint8) per target column from row pos[u] — T*4 (T*3)
// contiguous bytes, coalesced across the block's threads — so a mask
// costs 4*U*T (3*U*T) bytes per orientation,
// mostly from HBM (the planes are GBs; the rows a mask touches are
// scattered). The range tests are ~2-3 integer ops per (lane, slot) on
// data already in registers. Design: one thread per target column, one
// grid row per mask; the union is walked in tiles whose positions and
// lane tables are staged in shared memory (every thread of the block
// reads the same table word: a broadcast), and up to LANE_GROUP lane
// counters live in registers; lane counts above LANE_GROUP (xyShift > 2)
// take further passes over the union. Plane offsets are 64-bit.
#include "common.cuh"

namespace {

constexpr int LANE_GROUP = 9;   // xyShift 2 = 9 lanes in one pass
constexpr int TILE_U = 128;     // union elements staged per tile
constexpr int MAX_SLOTS = 3;
constexpr int THREADS = 256;

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
    __device__ __forceinline__ void load(int b, int j, int s, int u,
                                         uint32_t& l, uint32_t& w) const {
        const int64_t i = ((static_cast<int64_t>(b) * n_lanes + j) * n_slots
                           + s) * n_u + u;
        l = lo[i];
        w = span[i];
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
    __device__ __forceinline__ void load(int b, int j, int s, int u,
                                         uint32_t& l, uint32_t& w) const {
        int64_t row = qidx[(static_cast<int64_t>(b) * n_lanes + j) * n_u
                           + u];
        row = row < 0 ? 0 : (row >= n_kl ? n_kl - 1 : row);
        int64_t key = key_list[b * n_kl + row];
        key = key < 0 ? 0 : (key >= n_keys ? n_keys - 1 : key);
        l = tab_lo[s * n_keys + key];
        w = tab_span[s * n_keys + key];
    }
};

template <bool SEG, class Planes, class Tables>
__global__ void union_score_kernel(const Planes planes, int64_t n_cols,
                                   const int32_t* __restrict__ u_pos,
                                   const int32_t* __restrict__ mu_pos,
                                   int n_sets, int n_msets,
                                   const Tables tables, int n_lanes,
                                   int n_slots, int n_u, int u2,
                                   int32_t* __restrict__ best,
                                   uint8_t* __restrict__ mirrored) {
    __shared__ int32_t s_pos[TILE_U];
    __shared__ uint32_t s_lo[LANE_GROUP * MAX_SLOTS * TILE_U];
    __shared__ uint32_t s_span[LANE_GROUP * MAX_SLOTS * TILE_U];

    const int b = blockIdx.y;
    const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x)
        + threadIdx.x;
    const bool active = t < n_cols;
    const int64_t tc = active ? t : 0;

    int orient_max[2] = {0, 0};
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
                for (int u0 = 0; u0 < n_u; u0 += TILE_U) {
                    const int n = min(TILE_U, n_u - u0);
                    __syncthreads();
                    for (int k = threadIdx.x; k < n; k += blockDim.x)
                        s_pos[k] = pos[u0 + k];
                    const int n_tab = lg * n_slots * n;
                    for (int e = threadIdx.x; e < n_tab; e += blockDim.x) {
                        const int k = e % n;
                        const int js = e / n;  // (lane in group, slot)
                        const int j = js / n_slots;
                        const int s = js - j * n_slots;
                        const int d = (j * MAX_SLOTS + s) * TILE_U + k;
                        tables.load(b, g0 + j, s, u0 + k, s_lo[d],
                                    s_span[d]);
                    }
                    __syncthreads();
                    if (!active) continue;
                    for (int k = 0; k < n; ++k) {
                        const uint32_t key = planes.load(
                            static_cast<int64_t>(s_pos[k]) * n_cols + tc);
                        const bool second = SEG && (u0 + k < u2);
#pragma unroll
                        for (int j = 0; j < LANE_GROUP; ++j) {
                            if (j >= lg) continue;
                            const int base = j * MAX_SLOTS * TILE_U + k;
                            if (SEG) {
                                int c = (key - s_lo[base]) <= s_span[base];
                                if (second)
                                    c += (key - s_lo[base + TILE_U])
                                        <= s_span[base + TILE_U];
                                cnt[j] += c;
                            } else {
                                bool m = (key - s_lo[base]) <= s_span[base];
                                for (int s = 1; s < n_slots; ++s)
                                    m |= (key - s_lo[base + s * TILE_U])
                                        <= s_span[base + s * TILE_U];
                                cnt[j] += m;
                            }
                        }
                    }
                }
#pragma unroll
                for (int j = 0; j < LANE_GROUP; ++j)
                    if (j < lg) orient_max[o] = max(orient_max[o], cnt[j]);
            }
        }
    }
    if (!active) return;
    const int64_t out = static_cast<int64_t>(b) * n_cols + t;
    if (n_msets > 0) {
        best[out] = max(orient_max[0], orient_max[1]);
        mirrored[out] = orient_max[1] > orient_max[0];
    } else {
        best[out] = orient_max[0];
        mirrored[out] = 0;
    }
}

template <class Planes, class Tables>
int run(const Planes& planes, int64_t n_cols, const void* u_pos,
        const void* mu_pos, int n_sets, int n_msets, const Tables& tables,
        int batch, int n_lanes, int n_slots, int n_u, int u2, int segmented,
        void* best, void* mirrored, void* stream) {
    if (n_slots < 1 || n_slots > MAX_SLOTS) return cudaErrorInvalidValue;
    if (batch == 0 || n_cols == 0) return cudaGetLastError();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(cmst::blocks_for(n_cols, THREADS), batch);
    const int32_t* up = static_cast<const int32_t*>(u_pos);
    const int32_t* mp = static_cast<const int32_t*>(mu_pos);
    int32_t* b = static_cast<int32_t*>(best);
    uint8_t* m = static_cast<uint8_t*>(mirrored);
    if (segmented)
        union_score_kernel<true, Planes, Tables><<<grid, THREADS, 0, st>>>(
            planes, n_cols, up, mp, n_sets, n_msets, tables, n_lanes,
            n_slots, n_u, u2, b, m);
    else
        union_score_kernel<false, Planes, Tables><<<grid, THREADS, 0, st>>>(
            planes, n_cols, up, mp, n_sets, n_msets, tables, n_lanes,
            n_slots, n_u, u2, b, m);
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
// n_lanes, n_slots, n_u] -> best int32, mirrored uint8 [batch, n_cols].
extern "C" int cmst_union_score(const void* planes, int64_t n_cols,
                                const void* u_pos, const void* mu_pos,
                                int n_sets, int n_msets,
                                const void* lane_lo, const void* lane_span,
                                int batch, int n_lanes, int n_slots,
                                int n_u, int u2, int segmented,
                                void* best, void* mirrored, void* stream) {
    return run(KeyPlanes{static_cast<const int32_t*>(planes)}, n_cols,
               u_pos, mu_pos, n_sets, n_msets,
               expanded(lane_lo, lane_span, n_lanes, n_slots, n_u), batch,
               n_lanes, n_slots, n_u, u2, segmented, best, mirrored, stream);
}

// K13: rank uint16 and cls uint8 [rows, n_cols]; every other argument as
// cmst_union_score's.
extern "C" int cmst_union_score_splitk(const void* rank, const void* cls,
                                       int64_t n_cols, const void* u_pos,
                                       const void* mu_pos, int n_sets,
                                       int n_msets, const void* lane_lo,
                                       const void* lane_span, int batch,
                                       int n_lanes, int n_slots, int n_u,
                                       int u2, int segmented, void* best,
                                       void* mirrored, void* stream) {
    return run(SplitKeyPlanes{static_cast<const uint16_t*>(rank),
                              static_cast<const uint8_t*>(cls)},
               n_cols, u_pos, mu_pos, n_sets, n_msets,
               expanded(lane_lo, lane_span, n_lanes, n_slots, n_u), batch,
               n_lanes, n_slots, n_u, u2, segmented, best, mirrored, stream);
}

// Row 14: planes int32 [rows, n_cols]; u_pos / mu_pos as cmst_union_score's;
// qidx int32 [batch, n_lanes, n_u], key_list int32 [batch, n_kl], tab_lo /
// tab_span uint32 [2, n_keys]; slot 2 counts on the prefix u < u2
// (0 <= u2 <= n_u).
extern "C" int cmst_union_score_qkeys(const void* planes, int64_t n_cols,
                                      const void* u_pos, const void* mu_pos,
                                      int n_sets, int n_msets,
                                      const void* qidx, const void* key_list,
                                      int64_t n_kl, const void* tab_lo,
                                      const void* tab_span, int64_t n_keys,
                                      int batch, int n_lanes, int n_u,
                                      int u2, void* best, void* mirrored,
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
               n_u, u2, 1, best, mirrored, stream);
}
