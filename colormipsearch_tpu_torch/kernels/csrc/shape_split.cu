// K5: split-row shape scoring of one query against T target columns.
//
// Replaces colormipsearch_tpu/ops/shape_score.py
// `shape_score_pairs_split_raw` / `shape_score_pairs_split`. For each
// orientation o (straight, mirror) and target column t:
//   gap rows  (t_gap uint32 [n_or, Sg, T], q_gap int32 [n_or, Sg]):
//     z_sl = w >> 16 (int32 shift), grad = w & 0xFFFF;
//     val = (q_nz && z_sl > 0 && |q_sl - z_sl| >= 80) ? |q_sl - z_sl| - 40
//                                                     : (q_sig ? grad : 0)
//     gap_lo += val & 0x3FF, gap_hi += val >> 10
//   he rows   (t_he uint32 [n_or, W, T], q_he uint32 [n_or, W]):
//     high_expr += popcount(t_he & q_he)   (32 ring rows per word)
// with the same int32 arithmetic as the JAX function, so the outputs are
// equal element for element.
//
// Bound on the H100: the plane reads. A 2,048-column dispatch reads
// 2 x (Sg + W) x T x 4 bytes, ~285 MB at a production mask's support
// (Sg 10,240, W 7,168), against a few integer operations per word: HBM
// bandwidth bounds it (~0.09 ms at 3.35 TB/s). The pixel-match kernel K3
// showed that one thread walking a whole row range is latency-bound, and
// T 2,048 x n_or 2 is only 16 blocks of 256 columns on 132 SMs. So the
// rows are split over the grid's y dimension (ROWS_PER_BLOCK each), the
// chunk's query words are staged in shared memory (one broadcast read
// per row; an all-zero query word contributes nothing and is skipped for
// the whole warp), each thread reads its column coalesced row by row,
// and the partial sums are added into the zeroed outputs with 32-bit
// atomics. Integer addition modulo 2^32 does not depend on order, so the
// result is exact and deterministic, and wraps exactly like JAX's int32
// sums. Overflow bound: gap_lo <= 1,023 x Sg, below 2^31 up to 2.1M gap
// rows; the whole 566x1210 plane has 685k pixels.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = 256;
constexpr int SL_SHIFT = 16;
constexpr int Q_SL_MASK = 0x1FF;
constexpr int Q_NZ_SHIFT = 9;
constexpr int Q_SIG_SHIFT = 10;
constexpr int COLOR_FLUX = 40;  // DEFAULT_COLOR_FLUX

__global__ void gap_rows_kernel(const int32_t* __restrict__ t_gap,
                                const int32_t* __restrict__ q_gap,
                                int64_t n_rows, int64_t n_cols,
                                uint32_t* __restrict__ gap_hi,
                                uint32_t* __restrict__ gap_lo) {
    __shared__ int32_t s_q[ROWS_PER_BLOCK];
    const int o = blockIdx.z;
    const int64_t r0 = static_cast<int64_t>(blockIdx.y) * ROWS_PER_BLOCK;
    const int64_t left = n_rows - r0;
    const int n = left < ROWS_PER_BLOCK ? static_cast<int>(left)
                                        : ROWS_PER_BLOCK;
    for (int k = threadIdx.x; k < n; k += blockDim.x)
        s_q[k] = q_gap[o * n_rows + r0 + k];
    __syncthreads();
    const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x)
        + threadIdx.x;
    if (t >= n_cols) return;
    const int32_t* col = t_gap + (o * n_rows + r0) * n_cols + t;
    uint32_t lo = 0, hi = 0;
    for (int k = 0; k < n; ++k) {
        const int q = s_q[k];
        if (q == 0) continue;  // pad row or no query term: val == 0
        const int w = col[k * n_cols];
        const int grad = w & 0xFFFF;
        const int z_sl = w >> SL_SHIFT;
        const int d = abs((q & Q_SL_MASK) - z_sl);
        const bool gap = ((q >> Q_NZ_SHIFT) & 1) && z_sl > 0
            && d >= 2 * COLOR_FLUX;
        const int val = gap ? d - COLOR_FLUX
                            : (((q >> Q_SIG_SHIFT) & 1) ? grad : 0);
        lo += static_cast<uint32_t>(val & 0x3FF);
        hi += static_cast<uint32_t>(val >> 10);
    }
    atomicAdd(gap_lo + o * n_cols + t, lo);
    atomicAdd(gap_hi + o * n_cols + t, hi);
}

__global__ void he_rows_kernel(const uint32_t* __restrict__ t_he,
                               const uint32_t* __restrict__ q_he,
                               int64_t n_words, int64_t n_cols,
                               uint32_t* __restrict__ high_expr) {
    __shared__ uint32_t s_q[ROWS_PER_BLOCK];
    const int o = blockIdx.z;
    const int64_t r0 = static_cast<int64_t>(blockIdx.y) * ROWS_PER_BLOCK;
    const int64_t left = n_words - r0;
    const int n = left < ROWS_PER_BLOCK ? static_cast<int>(left)
                                        : ROWS_PER_BLOCK;
    for (int k = threadIdx.x; k < n; k += blockDim.x)
        s_q[k] = q_he[o * n_words + r0 + k];
    __syncthreads();
    const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x)
        + threadIdx.x;
    if (t >= n_cols) return;
    const uint32_t* col = t_he + (o * n_words + r0) * n_cols + t;
    uint32_t cnt = 0;
    for (int k = 0; k < n; ++k) {
        const uint32_t q = s_q[k];
        if (q == 0) continue;
        cnt += __popc(col[k * n_cols] & q);
    }
    atomicAdd(high_expr + o * n_cols + t, cnt);
}

}  // namespace

// out: int32 [3, n_or, n_cols] = (gap_hi, gap_lo, high_expr), zeroed here.
extern "C" int cmst_shape_split(const void* t_gap, const void* q_gap,
                                const void* t_he, const void* q_he,
                                int n_or, int64_t n_rows, int64_t n_words,
                                int64_t n_cols, void* out, void* stream) {
    if (n_or < 1 || n_or > 2) return cudaErrorInvalidValue;
    if ((n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK > 65535
        || (n_words + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK > 65535)
        return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int64_t plane = static_cast<int64_t>(n_or) * n_cols;
    cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(3 * plane) * sizeof(int32_t), st);
    if (err != cudaSuccess) return err;
    if (n_cols == 0) return cudaGetLastError();
    uint32_t* o = static_cast<uint32_t*>(out);
    const int col_blocks = cmst::blocks_for(n_cols, THREADS);
    if (n_rows > 0) {
        const dim3 grid(col_blocks, cmst::blocks_for(n_rows, ROWS_PER_BLOCK),
                        n_or);
        gap_rows_kernel<<<grid, THREADS, 0, st>>>(
            static_cast<const int32_t*>(t_gap),
            static_cast<const int32_t*>(q_gap), n_rows, n_cols, o,
            o + plane);
    }
    if (n_words > 0) {
        const dim3 grid(col_blocks,
                        cmst::blocks_for(n_words, ROWS_PER_BLOCK), n_or);
        he_rows_kernel<<<grid, THREADS, 0, st>>>(
            static_cast<const uint32_t*>(t_he),
            static_cast<const uint32_t*>(q_he), n_words, n_cols,
            o + 2 * plane);
    }
    return cudaGetLastError();
}
