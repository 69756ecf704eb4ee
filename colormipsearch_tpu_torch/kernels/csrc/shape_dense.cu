// Row 18b: dense-row shape scoring of one query against T target columns,
// one orientation or both.
//
// Replaces colormipsearch_tpu/ops/shape_score.py `shape_score_pairs_raw` /
// `shape_score_pairs` (:764, :803) and `shape_score_pairs_both_raw` /
// `shape_score_pairs_both` (:806, :813; the leading orientation axis is
// the grid's z). For each orientation o and target column t, over the
// rows r of t_pack uint32 [n_or, S, T] and q_pack int32 [n_or, S]:
//   w = t_pack (int32 bits): grad = w & 0xFFFF, z_sl = (w >> 16) & 0x1FF,
//     z_nz = (w >> 25) & 1, t_fg = (w >> 26) & 1;
//   q: q_sl = q & 0x1FF, q_nz = (q >> 9) & 1, q_sig = (q >> 10) & 1,
//     q_he = (q >> 11) & 1;
//   sg = (q_sl == 0 || z_sl == 0) ? z_sl : |q_sl - z_sl|;
//   val = (q_nz && z_nz && sg >= 80) ? sg - 40 : (q_sig ? grad : 0);
//   gap_lo += val & 0x3FF, gap_hi += val >> 10, high_expr += q_he & t_fg
// in int32 arithmetic, so the outputs equal the JAX function's element
// for element (its sums wrap modulo 2^32, as do these).
//
// Bound on the H100: the plane reads. Every term has a query-side factor,
// so a row whose query word is 0 contributes nothing, and the bytes that
// must move are 4 x T for each row with a nonzero query word (the mask's
// support; a dense [P, T] pack is ~95% zero-query rows), against ~15
// integer operations a word. Design: K5's (shape_split.cu). Rows are
// split over the grid's y dimension (ROWS_PER_BLOCK each); a block stages
// its rows' query words in shared memory, skips the zero ones for the
// whole warp (never reading their plane row), reads its column coalesced
// row by row and adds its partial sums into the zeroed outputs with
// 32-bit atomics. Integer addition modulo 2^32 does not depend on order,
// so the result is exact and deterministic.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = 256;
constexpr int COLOR_FLUX = 40;  // DEFAULT_COLOR_FLUX

__global__ void dense_rows_kernel(const int32_t* __restrict__ t_pack,
                                  const int32_t* __restrict__ q_pack,
                                  int64_t n_rows, int64_t n_cols,
                                  uint32_t* __restrict__ gap_hi,
                                  uint32_t* __restrict__ gap_lo,
                                  uint32_t* __restrict__ high_expr) {
    __shared__ int32_t s_q[ROWS_PER_BLOCK];
    const int o = blockIdx.z;
    const int64_t r0 = static_cast<int64_t>(blockIdx.y) * ROWS_PER_BLOCK;
    const int64_t left = n_rows - r0;
    const int n = left < ROWS_PER_BLOCK ? static_cast<int>(left)
                                        : ROWS_PER_BLOCK;
    for (int k = threadIdx.x; k < n; k += blockDim.x)
        s_q[k] = q_pack[o * n_rows + r0 + k];
    __syncthreads();
    const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x)
        + threadIdx.x;
    if (t >= n_cols) return;
    const int32_t* col = t_pack + (o * n_rows + r0) * n_cols + t;
    uint32_t lo = 0, hi = 0, he = 0;
    for (int k = 0; k < n; ++k) {
        const int q = s_q[k];
        if (q == 0) continue;  // no query term: every sum adds 0
        const int w = col[k * n_cols];
        const int grad = w & 0xFFFF;
        const int z_sl = (w >> 16) & 0x1FF;
        const int z_nz = (w >> 25) & 1;
        const int t_fg = (w >> 26) & 1;
        const int q_sl = q & 0x1FF;
        const int sg = (q_sl == 0 || z_sl == 0) ? z_sl : abs(q_sl - z_sl);
        const bool overlap = ((q >> 9) & 1) && z_nz;
        const int val = (overlap && sg >= 2 * COLOR_FLUX)
            ? sg - COLOR_FLUX : (((q >> 10) & 1) ? grad : 0);
        lo += static_cast<uint32_t>(val & 0x3FF);
        hi += static_cast<uint32_t>(val >> 10);
        he += static_cast<uint32_t>(((q >> 11) & 1) & t_fg);
    }
    atomicAdd(gap_lo + o * n_cols + t, lo);
    atomicAdd(gap_hi + o * n_cols + t, hi);
    atomicAdd(high_expr + o * n_cols + t, he);
}

}  // namespace

// t_pack int32 [n_or, n_rows, n_cols] (uint32 bits), q_pack int32
// [n_or, n_rows] -> out int32 [3, n_or, n_cols] = (gap_hi, gap_lo,
// high_expr), zeroed here.
extern "C" int cmst_shape_dense(const void* t_pack, const void* q_pack,
                                int n_or, int64_t n_rows, int64_t n_cols,
                                void* out, void* stream) {
    if (n_or < 1 || n_or > 2
        || (n_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK > 65535)
        return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int64_t plane = static_cast<int64_t>(n_or) * n_cols;
    cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(3 * plane) * sizeof(int32_t), st);
    if (err != cudaSuccess) return err;
    if (n_cols == 0 || n_rows == 0) return cudaGetLastError();
    uint32_t* o = static_cast<uint32_t*>(out);
    const dim3 grid(cmst::blocks_for(n_cols, THREADS),
                    cmst::blocks_for(n_rows, ROWS_PER_BLOCK), n_or);
    dense_rows_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const int32_t*>(t_pack),
        static_cast<const int32_t*>(q_pack), n_rows, n_cols, o, o + plane,
        o + 2 * plane);
    return cudaGetLastError();
}
