// K10: the classic rank-key kernel.
//
// Replaces colormipsearch_tpu/ops/pixel_match.py
// `score_query_against_key_planes_raw` + `score_query_batch_keys` (with
// `reduce_variants_device`). For mask b, variant v and target column t
// it counts the query pixels q whose target key planes[pos[b, v, q], t]
// lies in one of q's three interval windows, (key - lo) mod 2^32 <= span,
// tested in uint32. Positions are sentinel-encoded (padded or shifted
// out of the image = row P, all zero keys), so no element is skipped.
// There are no flags: the windows are the float64 verdict's exact
// edges.
//
// Bound on the H100: one 4-byte key gather and three unsigned range
// tests per (mask, variant, query pixel, column) element. The grid and
// the accumulation are K9's (kernels/csrc/banded_score.cu): blocks over
// (column block, query chunk, mask x variant), the chunk's positions and
// windows staged in shared memory, one column per thread with its count
// in a register, int32 atomics into a zeroed [B, V, T] scratch (exact
// and deterministic), then the variant reduction.
#include "common.cuh"

namespace {

constexpr int QC = 256;       // query pixels staged per block
constexpr int THREADS = 256;  // columns per block

__global__ void key_score_kernel(const int32_t* __restrict__ planes,
                                 int64_t n_cols,
                                 const int32_t* __restrict__ pos, int n_var,
                                 int n_q, const uint32_t* __restrict__ lo,
                                 const uint32_t* __restrict__ span,
                                 int32_t* __restrict__ match_out) {
    __shared__ int32_t s_pos[QC];
    __shared__ uint32_t s_lo[3][QC];
    __shared__ uint32_t s_span[3][QC];

    const int bv = blockIdx.z;          // b * n_var + v
    const int b = bv / n_var;
    const int q0 = blockIdx.y * QC;
    const int n = min(QC, n_q - q0);
    const int64_t t = blockIdx.x * static_cast<int64_t>(THREADS)
        + threadIdx.x;

    const int32_t* pos_c = pos + static_cast<int64_t>(bv) * n_q + q0;
    const int64_t wb = static_cast<int64_t>(b) * 3 * n_q + q0;
    for (int k = threadIdx.x; k < n; k += THREADS) {
        s_pos[k] = pos_c[k];
        for (int r = 0; r < 3; ++r) {
            s_lo[r][k] = lo[wb + r * n_q + k];
            s_span[r][k] = span[wb + r * n_q + k];
        }
    }
    __syncthreads();
    if (t >= n_cols) return;

    int n_match = 0;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
        const uint32_t key = static_cast<uint32_t>(
            planes[static_cast<int64_t>(s_pos[k]) * n_cols + t]);
        n_match += ((key - s_lo[0][k]) <= s_span[0][k])
            | ((key - s_lo[1][k]) <= s_span[1][k])
            | ((key - s_lo[2][k]) <= s_span[2][k]);
    }
    if (n_match)
        atomicAdd(match_out + static_cast<int64_t>(bv) * n_cols + t,
                  n_match);
}

}  // namespace

// planes int32 [P+1, n_cols]; pos int32 [batch, n_var, n_q]; lo / span
// uint32 [batch, 3, n_q]; scratch int32 [batch, n_var, n_cols], zeroed
// by the caller -> best int32, mirrored uint8 [batch, n_cols].
extern "C" int cmst_key_score(const void* planes, int64_t n_cols,
                              const void* pos, int batch, int n_var,
                              int n_q, int n_straight, const void* lo,
                              const void* span, void* scratch, void* best,
                              void* mirrored, void* stream) {
    if (n_straight < 1 || n_straight > n_var
        || static_cast<int64_t>(batch) * n_var > 65535
        || (n_q + QC - 1) / QC > 65535)
        return cudaErrorInvalidValue;
    if (batch == 0 || n_cols == 0) return cudaGetLastError();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int32_t* match = static_cast<int32_t*>(scratch);
    if (n_q > 0) {
        const dim3 grid(cmst::blocks_for(n_cols, THREADS),
                        (n_q + QC - 1) / QC, batch * n_var);
        key_score_kernel<<<grid, THREADS, 0, st>>>(
            static_cast<const int32_t*>(planes), n_cols,
            static_cast<const int32_t*>(pos), n_var, n_q,
            static_cast<const uint32_t*>(lo),
            static_cast<const uint32_t*>(span), match);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    constexpr int threads = 256;
    cmst::reduce_variants_kernel<false>
        <<<cmst::blocks_for(static_cast<int64_t>(batch) * n_cols, threads),
           threads, 0, st>>>(match, nullptr, batch, n_var, n_straight,
                             n_cols, static_cast<int32_t*>(best),
                             static_cast<uint8_t*>(mirrored), nullptr);
    return cudaGetLastError();
}
