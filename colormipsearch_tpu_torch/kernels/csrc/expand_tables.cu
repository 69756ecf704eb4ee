// K2: positional wire form -> per-lane interval tables; and its qkey
// mode (row 13 of the kernel table): the factored wire form -> the same
// tables.
//
// K2 replaces colormipsearch_tpu/ops/pixel_match.py
// `expand_union_tables_from_pos` (+ its `_map_vmap_chunks` batching); the
// qkey mode replaces `expand_union_tables` (:1633), which is K2 without
// the positional derivation: qk = key_list[b, qidx[b, l, u]], then one
// row of (tab_lo[0], tab_lo[1], tab_span[0], tab_span[1])[qk]. The qkey
// mode is one launch, one thread per (mask, lane, element): it reads
// 4 bytes of qidx and writes 16 bytes of tables per element, coalesced
// along u, and its gathers hit L2 (the key lists and the 1.8 MB tables),
// so it is bound by bytes like K2.
// Per mask b: a pos_index [P+1] scratch maps a flat pixel to its row in
// the mask's query-pixel list (default KL-1, the inactive key slot);
// then every (lane (dx, dy), union element u) reads query pixel
// src = u - dx - dy*w, takes its key from key_list, and gathers that
// key's two (lo, span) interval windows from the shared per-tolerance
// tables into lane_lo / lane_span [B, L, 2, U].
//
// Bound on the H100: memory. The fill writes 4*B*(P+1) bytes (22 MB at
// B=8 and production P); the expansion reads pos_index / key_list / the
// tables at scattered addresses (L2-resident: the tables are 1.8 MB)
// and writes 16*B*L*U bytes coalesced along u. Three launches (fill,
// scatter, expand) stand in for the TPU function's per-mask scan; the
// scratch is allocated by the wrapper. Padded q_pos entries (= P)
// scatter into slot P, which no clipped src ever reads.
#include "common.cuh"

namespace {

__global__ void fill_kernel(int32_t* __restrict__ out, int64_t n,
                            int32_t value) {
    const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x)
        + threadIdx.x;
    if (i < n) out[i] = value;
}

__global__ void scatter_pos_kernel(int32_t* __restrict__ pos_index,
                                   const int32_t* __restrict__ q_pos,
                                   int64_t batch, int64_t n_q,
                                   int64_t n_px) {
    const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x)
        + threadIdx.x;
    if (i >= batch * n_q) return;
    const int64_t b = i / n_q;
    const int32_t q = q_pos[i];
    // out-of-range positions are dropped, like the TPU scatter
    if (q >= 0 && q <= n_px)
        pos_index[b * (n_px + 1) + q] = static_cast<int32_t>(i - b * n_q);
}

__global__ void expand_kernel(const int32_t* __restrict__ u_pos,
                              int64_t u_stride_b,
                              const int32_t* __restrict__ pos_index,
                              const int32_t* __restrict__ key_list,
                              int64_t n_kl,
                              const uint32_t* __restrict__ tab_lo,
                              const uint32_t* __restrict__ tab_span,
                              int64_t n_keys,
                              const int32_t* __restrict__ offsets,
                              int64_t batch, int64_t n_lanes, int64_t n_u,
                              int32_t w, int32_t h,
                              uint32_t* __restrict__ lane_lo,
                              uint32_t* __restrict__ lane_span) {
    const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x)
        + threadIdx.x;
    if (i >= batch * n_lanes * n_u) return;
    const int64_t u_idx = i % n_u;
    const int64_t j = (i / n_u) % n_lanes;
    const int64_t b = i / (n_u * n_lanes);
    const int64_t n_px = static_cast<int64_t>(w) * h;
    const int32_t u = u_pos[b * u_stride_b + u_idx];  // sentinel = n_px
    const int32_t dx = offsets[2 * j];
    const int32_t dy = offsets[2 * j + 1];
    const int32_t ux = u % w;
    const int32_t uy = u / w;
    const int32_t qx = ux - dx;
    const int32_t qy = uy - dy;
    const bool ok = u < n_px && qx >= 0 && qx < w && qy >= 0 && qy < h;
    int64_t src = static_cast<int64_t>(u) - dx
        - static_cast<int64_t>(dy) * w;
    src = src < 0 ? 0 : (src > n_px - 1 ? n_px - 1 : src);
    const int64_t row = ok ? pos_index[b * (n_px + 1) + src] : n_kl - 1;
    int64_t key = key_list[b * n_kl + row];
    key = key < 0 ? 0 : (key >= n_keys ? n_keys - 1 : key);
    const int64_t o = ((b * n_lanes + j) * 2) * n_u + u_idx;
    lane_lo[o] = tab_lo[key];
    lane_lo[o + n_u] = tab_lo[n_keys + key];
    lane_span[o] = tab_span[key];
    lane_span[o + n_u] = tab_span[n_keys + key];
}

// qkey mode: qidx int32 [batch, n_lanes, n_u] (the uint16 indices,
// widened), key_list int32 [batch, n_kl]; out-of-range indices and keys
// are clamped, as the gathers of the JAX function clamp them.
__global__ void expand_qkeys_kernel(const int32_t* __restrict__ qidx,
                                    const int32_t* __restrict__ key_list,
                                    int64_t n_kl,
                                    const uint32_t* __restrict__ tab_lo,
                                    const uint32_t* __restrict__ tab_span,
                                    int64_t n_keys, int64_t batch,
                                    int64_t n_lanes, int64_t n_u,
                                    uint32_t* __restrict__ lane_lo,
                                    uint32_t* __restrict__ lane_span) {
    const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x)
        + threadIdx.x;
    if (i >= batch * n_lanes * n_u) return;
    const int64_t u_idx = i % n_u;
    const int64_t bj = i / n_u;  // b * n_lanes + j
    const int64_t b = bj / n_lanes;
    int64_t row = qidx[i];
    row = row < 0 ? 0 : (row >= n_kl ? n_kl - 1 : row);
    int64_t key = key_list[b * n_kl + row];
    key = key < 0 ? 0 : (key >= n_keys ? n_keys - 1 : key);
    const int64_t o = bj * 2 * n_u + u_idx;
    lane_lo[o] = tab_lo[key];
    lane_lo[o + n_u] = tab_lo[n_keys + key];
    lane_span[o] = tab_span[key];
    lane_span[o + n_u] = tab_span[n_keys + key];
}

}  // namespace

// Row 13: (qidx, key_list) -> lane_lo / lane_span uint32 [batch, n_lanes,
// 2, n_u].
extern "C" int cmst_expand_qkeys(const void* qidx, const void* key_list,
                                 int64_t n_kl, const void* tab_lo,
                                 const void* tab_span, int64_t n_keys,
                                 int64_t batch, int64_t n_lanes, int64_t n_u,
                                 void* lane_lo, void* lane_span,
                                 void* stream) {
    if (n_kl < 1 || n_keys < 1) return cudaErrorInvalidValue;
    constexpr int threads = 256;
    const int64_t n_out = batch * n_lanes * n_u;
    if (n_out > 0) {
        expand_qkeys_kernel<<<cmst::blocks_for(n_out, threads), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int32_t*>(qidx),
            static_cast<const int32_t*>(key_list), n_kl,
            static_cast<const uint32_t*>(tab_lo),
            static_cast<const uint32_t*>(tab_span), n_keys, batch, n_lanes,
            n_u, static_cast<uint32_t*>(lane_lo),
            static_cast<uint32_t*>(lane_span));
    }
    return cudaGetLastError();
}

extern "C" int cmst_expand_tables(const void* u_pos, int64_t u_stride_b,
                                  const void* q_pos, int64_t n_q,
                                  const void* key_list, int64_t n_kl,
                                  const void* tab_lo, const void* tab_span,
                                  int64_t n_keys, const void* offsets,
                                  int64_t batch, int64_t n_lanes,
                                  int64_t n_u, int32_t w, int32_t h,
                                  void* pos_index, void* lane_lo,
                                  void* lane_span, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    constexpr int threads = 256;
    const int64_t n_px = static_cast<int64_t>(w) * h;
    const int64_t n_index = batch * (n_px + 1);
    int32_t* index = static_cast<int32_t*>(pos_index);
    fill_kernel<<<cmst::blocks_for(n_index, threads), threads, 0, st>>>(
        index, n_index, static_cast<int32_t>(n_kl - 1));
    if (batch * n_q > 0) {
        scatter_pos_kernel<<<cmst::blocks_for(batch * n_q, threads),
                             threads, 0, st>>>(
            index, static_cast<const int32_t*>(q_pos), batch, n_q, n_px);
    }
    const int64_t n_out = batch * n_lanes * n_u;
    if (n_out > 0) {
        expand_kernel<<<cmst::blocks_for(n_out, threads), threads, 0,
                        st>>>(
            static_cast<const int32_t*>(u_pos), u_stride_b, index,
            static_cast<const int32_t*>(key_list), n_kl,
            static_cast<const uint32_t*>(tab_lo),
            static_cast<const uint32_t*>(tab_span), n_keys,
            static_cast<const int32_t*>(offsets), batch, n_lanes, n_u, w,
            h, static_cast<uint32_t*>(lane_lo),
            static_cast<uint32_t*>(lane_span));
    }
    return cudaGetLastError();
}
