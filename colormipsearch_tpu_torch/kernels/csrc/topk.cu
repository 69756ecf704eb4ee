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
// Bound on the H100: shared-memory bandwidth and barriers of the sort;
// device-memory traffic is only 5*T + 9*k bytes per mask. Design: one
// block per mask; each column becomes one 64-bit word
// (~(score ^ 2^31) << 32 | column) whose ascending order is the wanted
// total order, and a bitonic sort over the next power of two >= T runs
// in dynamic shared memory (8 bytes per column: 64 KB at T = 8,192,
// 128 KB at the supported maximum of 16,384, above the 48 KB default,
// so the entry point raises the kernel's dynamic shared-memory limit).
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int64_t MAX_COLS = 16384;

__global__ void topk_kernel(const int32_t* __restrict__ best,
                            const uint8_t* __restrict__ mirrored,
                            int64_t n_cols, int n_pow2, int k,
                            int32_t* __restrict__ scores_k,
                            int32_t* __restrict__ idx_k,
                            uint8_t* __restrict__ mirr_k,
                            const int32_t* __restrict__ pair_flags,
                            int32_t* __restrict__ flags_k) {
    extern __shared__ unsigned long long s_keys[];
    const int64_t b = blockIdx.x;
    const int32_t* row = best + b * n_cols;
    for (int i = threadIdx.x; i < n_pow2; i += blockDim.x) {
        unsigned long long v = ~0ull;
        if (i < n_cols) {
            const uint32_t ordered =
                ~(static_cast<uint32_t>(row[i]) ^ 0x80000000u);
            v = (static_cast<unsigned long long>(ordered) << 32)
                | static_cast<uint32_t>(i);
        }
        s_keys[i] = v;
    }
    for (int size = 2; size <= n_pow2; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            __syncthreads();
            for (int i = threadIdx.x; i < n_pow2 / 2; i += blockDim.x) {
                const int lo = 2 * i - (i & (stride - 1));
                const int hi = lo + stride;
                const bool ascending = (lo & size) == 0;
                const unsigned long long a = s_keys[lo];
                const unsigned long long c = s_keys[hi];
                if ((a > c) == ascending) {
                    s_keys[lo] = c;
                    s_keys[hi] = a;
                }
            }
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
        const int32_t col = static_cast<int32_t>(s_keys[i] & 0xFFFFFFFFull);
        scores_k[b * k + i] = row[col];
        idx_k[b * k + i] = col;
        mirr_k[b * k + i] = mirrored[b * n_cols + col];
        if (pair_flags != nullptr)
            flags_k[b * k + i] = pair_flags[b * n_cols + col];
    }
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
        || (pair_flags == nullptr) != (flags_k == nullptr))
        return cudaErrorInvalidValue;
    if (batch == 0) return cudaGetLastError();
    int n_pow2 = 1;
    while (n_pow2 < n_cols) n_pow2 <<= 1;
    const size_t smem = static_cast<size_t>(n_pow2) * sizeof(
        unsigned long long);
    cudaError_t err = cudaFuncSetAttribute(
        topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    topk_kernel<<<batch, THREADS, smem,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(best),
        static_cast<const uint8_t*>(mirrored), n_cols, n_pow2, k,
        static_cast<int32_t*>(scores_k), static_cast<int32_t*>(idx_k),
        static_cast<uint8_t*>(mirr_k),
        static_cast<const int32_t*>(pair_flags),
        static_cast<int32_t*>(flags_k));
    return cudaGetLastError();
}
