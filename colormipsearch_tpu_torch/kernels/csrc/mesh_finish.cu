// The mesh finish: the per-shard tail of the batched sharded steps and
// of the one-mask search step, in one launch a shard, and the reduction
// of the shards' per-mask maxima and flagged-pair counts in one launch a
// step.
//
// Replaces the tail of colormipsearch_tpu/parallel/mesh.py
// `_finish_batched_step` (:230-257: pmax of the row maxima, jax.lax.top_k
// of each shard's scores, the mirrored and flag gathers at the chosen
// columns, the shard offset of the indices, the psum of the flagged-pair
// counts, the tiled all_gather of the D*k candidates) and the tail of
// `make_sharded_search_step` (:89-130) for one process's shards. The
// port's mesh ran it as a chain of PyTorch calls a shard (~40 launches
// and allocations at D = 4) and K4 a shard; here:
//  * cmst_mesh_finish: one shard's best int32 [B, w], mirrored bool
//    [B, w] and, when the step has them, pair_flags int32 [B, w] ->
//    straight into that shard's column slice of the step's merged
//    [B, D*k] outputs (any row stride): the top-k scores in
//    jax.lax.top_k's order (score descending, lower column first), their
//    columns + the shard's first global column, their mirrored bits and
//    flags (zeros when the step has none: no [B, w] zero tensor is
//    made), and the shard's per-mask max and flagged count into its slot
//    of [D, B]. With k = 0 (the dense steps) only the two slots. The
//    selection is K4's (topk_select.cuh, select_kernel<true>), so its tie
//    order is K4's, held to jax.lax.top_k.
//  * cmst_mesh_reduce: the [D, B] slots -> global_max [B] (a max) and
//    n_flagged [B] (a sum), one thread a mask.
//
// Bound on the H100: bytes, B*w*(4 + 1 + 4) read and B*k*13 written a
// shard (~40 KB at 8 masks x 512 columns): far below the launch floor,
// like K4. What the design buys is the launches it removes and that it
// runs on the shard's own stream (parallel/mesh.py), beside the other
// shards' kernels, with no host round trip.
#include "topk_select.cuh"

namespace {

__global__ void reduce_kernel(const int32_t* __restrict__ slot_max,
                              const int32_t* __restrict__ slot_flagged,
                              int n_shards, int batch,
                              int32_t* __restrict__ global_max,
                              int32_t* __restrict__ n_flagged) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= batch) return;
    int32_t m = slot_max[b];
    int32_t c = slot_flagged != nullptr ? slot_flagged[b] : 0;
    for (int s = 1; s < n_shards; ++s) {
        m = max(m, slot_max[static_cast<int64_t>(s) * batch + b]);
        if (slot_flagged != nullptr)
            c += slot_flagged[static_cast<int64_t>(s) * batch + b];
    }
    global_max[b] = m;
    if (n_flagged != nullptr) n_flagged[b] = c;
}

}  // namespace

// best int32 [batch, n_cols], mirrored bool [batch, n_cols] and
// pair_flags int32 [batch, n_cols] (or null) contiguous; scores, idx and
// flags int32, mirr bool, each [batch, >= k] at row stride ld (with k >
// 0: scores and idx set; mirr and flags may be null); row_max and
// row_flagged int32 [batch] or null.
extern "C" int cmst_mesh_finish(const void* best, const void* mirrored,
                                const void* pair_flags, int batch,
                                int64_t n_cols, int k, int64_t ld,
                                int col_offset, void* scores, void* idx,
                                void* mirr, void* flags, void* row_max,
                                void* row_flagged, void* stream) {
    if (n_cols < 1 || n_cols > MAX_COLS || k < 0 || k > n_cols
        || batch < 0)
        return cudaErrorInvalidValue;
    if (batch == 0) return cudaGetLastError();   // empty outputs: no data
    if (k > 0 && (scores == nullptr || idx == nullptr || ld < k))
        return cudaErrorInvalidValue;
    SelectOut out = {};
    out.scores = static_cast<int32_t*>(scores);
    out.idx = static_cast<int32_t*>(idx);
    out.mirr = static_cast<uint8_t*>(mirr);
    out.flags = static_cast<int32_t*>(flags);
    out.ld = ld;
    out.col_offset = col_offset;
    out.row_max = static_cast<int32_t*>(row_max);
    out.row_flagged = static_cast<int32_t*>(row_flagged);
    return launch_select<true>(
        static_cast<const int32_t*>(best),
        static_cast<const uint8_t*>(mirrored),
        static_cast<const int32_t*>(pair_flags), batch, n_cols, k, out,
        static_cast<cudaStream_t>(stream));
}

// slot_max int32 [n_shards, batch], slot_flagged the same or null;
// global_max int32 [batch], n_flagged int32 [batch] or null.
extern "C" int cmst_mesh_reduce(const void* slot_max,
                                const void* slot_flagged, int n_shards,
                                int batch, void* global_max,
                                void* n_flagged, void* stream) {
    if (n_shards < 1 || batch < 0) return cudaErrorInvalidValue;
    if (batch == 0) return cudaGetLastError();   // empty: no data
    if ((slot_flagged == nullptr) != (n_flagged == nullptr))
        return cudaErrorInvalidValue;
    constexpr int threads = 128;
    reduce_kernel<<<cmst::blocks_for(batch, threads), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(slot_max),
        static_cast<const int32_t*>(slot_flagged), n_shards, batch,
        static_cast<int32_t*>(global_max), static_cast<int32_t*>(n_flagged));
    return cudaGetLastError();
}
