// K7: one row slice of a shape-store field, transposed into the
// pixel-major device buffer.
//
// Replaces colormipsearch_tpu/ops/shape_score.py `_upload_pixel_major` /
// `_write_rows` (driven by `device_store_fields`). The store keeps each
// field row-major, [R targets, n_px pixels]; the shape tile kernel (K6)
// wants it pixel-major, [n_px, R], so that one pixel row of all targets
// is contiguous. The JAX function transposed every chunk on the host
// and streamed it into a donated device buffer. Here the host copies
// each [R, n] row slice to the card as it is, and this kernel writes
//   dst[p0 + c, r] = src[r, c]      (r < R, c < n)
// templated on the element type (uint16 for zsl/grad, uint8 for tfg).
//
// Bound on the H100: memory traffic, 2 x R x n x sizeof(T) bytes per
// slice; a naive transpose makes one of the two sides strided (one
// sector per element). The design is the classic tiled transpose: a
// 32 x 8 thread block moves a 32 x 32 tile through shared memory, read
// coalesced along src rows and written coalesced along dst rows, the
// tile padded by one element per row so the column reads do not all hit
// one bank. Offsets are 64-bit: n_px * R passes 2^31 at R 4,096.
#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;

template <typename T>
__global__ void pixel_major_kernel(const T* __restrict__ src, int64_t n_r,
                                   int64_t n, T* __restrict__ dst,
                                   int64_t p0) {
    __shared__ T tile[TILE][TILE + 1];
    const int64_t c0 = static_cast<int64_t>(blockIdx.x) * TILE;  // pixel
    const int64_t r0 = static_cast<int64_t>(blockIdx.y) * TILE;  // target
    for (int j = threadIdx.y; j < TILE; j += ROWS) {
        const int64_t r = r0 + j;
        const int64_t c = c0 + threadIdx.x;
        if (r < n_r && c < n) tile[j][threadIdx.x] = src[r * n + c];
    }
    __syncthreads();
    for (int j = threadIdx.y; j < TILE; j += ROWS) {
        const int64_t c = c0 + j;
        const int64_t r = r0 + threadIdx.x;
        if (c < n && r < n_r) dst[(p0 + c) * n_r + r] = tile[threadIdx.x][j];
    }
}

template <typename T>
void launch(const void* src, int64_t n_r, int64_t n, void* dst, int64_t p0,
            cudaStream_t st) {
    const dim3 grid(cmst::blocks_for(n, TILE), cmst::blocks_for(n_r, TILE));
    pixel_major_kernel<T><<<grid, dim3(TILE, ROWS), 0, st>>>(
        static_cast<const T*>(src), n_r, n, static_cast<T*>(dst), p0);
}

}  // namespace

// src [n_r, n] -> rows [p0, p0 + n) of dst [n_px, n_r]; elem_size 1 or 2.
extern "C" int cmst_pixel_major(const void* src, int64_t n_r, int64_t n,
                                void* dst, int64_t n_px, int64_t p0,
                                int elem_size, void* stream) {
    if (p0 < 0 || n < 0 || p0 + n > n_px
        || (n_r + TILE - 1) / TILE > 65535)
        return cudaErrorInvalidValue;
    if (n == 0 || n_r == 0) return cudaGetLastError();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (elem_size == 2)
        launch<uint16_t>(src, n_r, n, dst, p0, st);
    else if (elem_size == 1)
        launch<uint8_t>(src, n_r, n, dst, p0, st);
    else
        return cudaErrorInvalidValue;
    return cudaGetLastError();
}
