// K6: dispatch planes of the shape kernel from device-resident store
// fields.
//
// Replaces colormipsearch_tpu/ops/shape_score.py `_shape_tile_device` /
// `shape_tile_device`. The store's query-independent fields live on the
// card pixel-major: zsl uint16 [n_px, R] (z-gap slice numbers), grad
// uint16 [n_px, R] (pre-thresholded gradient), tfg uint8
// [ceil(n_px/8), R] (bitpacked target foreground). For T selected store
// rows (rows_sel) and one mask's padded support positions the kernel
// writes
//   t_gap[o, i, t] = i < sg ? zsl[pos_gap[i], r] << 16
//                             | grad[g_pos[o*Sgp + i], r] : 0
//   t_he[o, k, t]  = sum_b (j = 32k + b < sh) * keep[o*Shp + j]
//                    * bit(tfg[h_pos[o*Shp + j] >> 3, r], h_pos & 7) << b
// with r = rows_sel[t]: the planes `select_target_tile_from_store`
// assembles on the host, bit for bit, with pad rows zero.
//
// Bound on the H100: the field gathers. One output word per thread, the
// target column t fastest, so a warp's 32 threads read 32 neighbouring
// store rows of ONE pixel row (rows_sel ascending: consecutive 2-byte
// addresses) and write 32 consecutive words. The gap planes read ~4
// bytes per output word and the he planes 32 bytes per word (one byte
// per ring row), ~100 MB for a production mask at T 2,048, far below the
// planes K5 then reads. Each thread's positions are the same across the
// warp (a broadcast). Field offsets are int64_t: n_px * R is 1.4e9 at
// R 2,048 and passes 2^31 at R 4,096 (the lesson of K1).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SL_SHIFT = 16;
constexpr int64_t MAX_GRID_Y = 65535;  // output rows beyond it: grid-stride

inline unsigned grid_rows(int64_t rows) {
    return static_cast<unsigned>(rows < MAX_GRID_Y ? rows : MAX_GRID_Y);
}

__global__ void tile_gap_kernel(const uint16_t* __restrict__ zsl,
                                const uint16_t* __restrict__ grad,
                                int64_t n_r,
                                const int32_t* __restrict__ rows_sel,
                                int64_t n_cols,
                                const int32_t* __restrict__ pos_gap,
                                const int32_t* __restrict__ g_pos,
                                int n_gap_pad, int sg, int64_t n_out_rows,
                                uint32_t* __restrict__ t_gap) {
    const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x)
        + threadIdx.x;
    if (t >= n_cols) return;
    const int64_t r = rows_sel[t];
    for (int64_t row = blockIdx.y; row < n_out_rows; row += gridDim.y) {
        const int o = static_cast<int>(row / n_gap_pad);
        const int i = static_cast<int>(row - static_cast<int64_t>(o)
                                       * n_gap_pad);
        uint32_t word = 0;
        if (i < sg) {
            const uint32_t z = zsl[static_cast<int64_t>(pos_gap[i]) * n_r
                                   + r];
            const uint32_t g = grad[static_cast<int64_t>(g_pos[row]) * n_r
                                    + r];
            word = (z << SL_SHIFT) | g;
        }
        t_gap[row * n_cols + t] = word;
    }
}

__global__ void tile_he_kernel(const uint8_t* __restrict__ tfg,
                               int64_t n_r,
                               const int32_t* __restrict__ rows_sel,
                               int64_t n_cols,
                               const int32_t* __restrict__ h_pos,
                               const uint8_t* __restrict__ keep,
                               int n_words, int sh, int64_t n_out_rows,
                               uint32_t* __restrict__ t_he) {
    const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x)
        + threadIdx.x;
    if (t >= n_cols) return;
    const int64_t r = rows_sel[t];
    for (int64_t row = blockIdx.y; row < n_out_rows; row += gridDim.y) {
        // row = o * n_words + k; its ring rows j = 32k .. 32k + 31
        const int o = static_cast<int>(row / n_words);
        const int k = static_cast<int>(row - static_cast<int64_t>(o)
                                       * n_words);
        const int64_t base = static_cast<int64_t>(o) * n_words * 32
            + 32 * static_cast<int64_t>(k);
        const int live = min(32, sh - 32 * k);
        uint32_t word = 0;
        for (int b = 0; b < live; ++b) {
            if (!keep[base + b]) continue;
            const int hp = h_pos[base + b];
            const uint32_t byte = tfg[static_cast<int64_t>(hp >> 3) * n_r
                                      + r];
            word |= ((byte >> (hp & 7)) & 1u) << b;
        }
        t_he[row * n_cols + t] = word;
    }
}

}  // namespace

extern "C" int cmst_shape_tile(const void* zsl, const void* grad,
                               const void* tfg, int64_t n_r,
                               const void* rows_sel, int64_t n_cols,
                               const void* pos_gap, const void* g_pos,
                               const void* h_pos, const void* keep,
                               int n_or, int n_gap_pad, int n_words, int sg,
                               int sh, void* t_gap, void* t_he,
                               void* stream) {
    if (n_or < 1 || n_or > 2 || sg < 0 || sg > n_gap_pad || sh < 0
        || static_cast<int64_t>(sh) > 32 * static_cast<int64_t>(n_words))
        return cudaErrorInvalidValue;
    if (n_cols == 0) return cudaGetLastError();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int col_blocks = cmst::blocks_for(n_cols, THREADS);
    const int64_t gap_rows = static_cast<int64_t>(n_or) * n_gap_pad;
    if (gap_rows > 0) {
        const dim3 grid(col_blocks, grid_rows(gap_rows));
        tile_gap_kernel<<<grid, THREADS, 0, st>>>(
            static_cast<const uint16_t*>(zsl),
            static_cast<const uint16_t*>(grad), n_r,
            static_cast<const int32_t*>(rows_sel), n_cols,
            static_cast<const int32_t*>(pos_gap),
            static_cast<const int32_t*>(g_pos), n_gap_pad, sg, gap_rows,
            static_cast<uint32_t*>(t_gap));
    }
    const int64_t he_rows = static_cast<int64_t>(n_or) * n_words;
    if (he_rows > 0) {
        const dim3 grid(col_blocks, grid_rows(he_rows));
        tile_he_kernel<<<grid, THREADS, 0, st>>>(
            static_cast<const uint8_t*>(tfg), n_r,
            static_cast<const int32_t*>(rows_sel), n_cols,
            static_cast<const int32_t*>(h_pos),
            static_cast<const uint8_t*>(keep), n_words, sh, he_rows,
            static_cast<uint32_t*>(t_he));
    }
    return cudaGetLastError();
}
