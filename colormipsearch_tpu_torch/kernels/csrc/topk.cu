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
//
// The kernel itself is topk_select.cuh's select_kernel<false>; the
// mesh's finish kernel (mesh_finish.cu) is its other instantiation.
#include "topk_select.cuh"

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
    SelectOut out = {};
    out.scores = static_cast<int32_t*>(scores_k);
    out.idx = static_cast<int32_t*>(idx_k);
    out.mirr = static_cast<uint8_t*>(mirr_k);
    out.flags = static_cast<int32_t*>(flags_k);
    out.ld = k;
    return launch_select<false>(
        static_cast<const int32_t*>(best),
        static_cast<const uint8_t*>(mirrored),
        static_cast<const int32_t*>(pair_flags), batch, n_cols, k, out,
        static_cast<cudaStream_t>(stream));
}
