// Row 15: z-slice numbers of RGB pixels by the exact integer LUT scan.
//
// Replaces colormipsearch_tpu/ops/shape_score.py `slice_numbers_device`
// (:96). Per pixel (uint8 r, g, b): the >=-tie dominance class with R, G,
// B priority (class 1..6 of SLICE_LUT_RANGES), its primary p and secondary
// s channel, then the first minimum over the class's LUT row of
// |255*s - sec[i]*p| (int32: every in-range LUT entry's dominant channel
// is 255, so this equals the nearest-ratio scan; pad entries hold 2^20 and
// never win for p >= 1); slice = start[cls] + i + 1, and 0 for black.
//
// Bound on the H100: a pixel reads 3 bytes and writes 4; a non-black one
// also scans up to 56 LUT entries at ~4 integer operations each (~220
// operations against 7 bytes). A color depth MIP is ~95% black, so over
// a stack the bytes are the larger term (3.35 TB/s against 67 Tops/s);
// a dense image would be bound by the operations. Design: one thread a
// pixel, black pixels out first, the six padded LUT rows (6 x 56 int32)
// staged in shared memory by each block, so the threads of a warp that
// share a class read the same entry in the same step (a broadcast) and
// the scan's loads never reach device memory.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ROW = 64;  // >= the longest LUT range (56)

__global__ void slice_numbers_kernel(const uint8_t* __restrict__ rgb,
                                     int64_t n, const int32_t* __restrict__ rows,
                                     const int32_t* __restrict__ starts,
                                     int row_len,
                                     int32_t* __restrict__ out) {
    __shared__ int32_t s_rows[6 * MAX_ROW];
    __shared__ int32_t s_starts[6];
    for (int i = threadIdx.x; i < 6 * row_len; i += blockDim.x)
        s_rows[(i / row_len) * MAX_ROW + i % row_len] = rows[i];
    if (threadIdx.x < 6) s_starts[threadIdx.x] = starts[threadIdx.x];
    __syncthreads();
    const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x)
        + threadIdx.x;
    if (i >= n) return;
    const int r = rgb[3 * i];
    const int g = rgb[3 * i + 1];
    const int b = rgb[3 * i + 2];
    if (r == 0 && g == 0 && b == 0) {
        out[i] = 0;
        return;
    }
    const bool r_dom = r >= g && r >= b;
    const bool g_dom = !r_dom && g >= r && g >= b;
    int cls, p, s;
    if (r_dom) {
        cls = g >= b ? 5 : 6;
        p = r;
        s = max(g, b);
    } else if (g_dom) {
        cls = r >= b ? 4 : 3;
        p = g;
        s = max(r, b);
    } else {
        cls = r >= g ? 1 : 2;
        p = b;
        s = max(r, g);
    }
    const int32_t* row = s_rows + (cls - 1) * MAX_ROW;
    const int target = 255 * s;
    int best = abs(target - row[0] * p);
    int idx = 0;
    for (int k = 1; k < row_len; ++k) {
        const int key = abs(target - row[k] * p);
        if (key < best) {  // strict: the first minimum wins
            best = key;
            idx = k;
        }
    }
    out[i] = s_starts[cls - 1] + idx + 1;
}

}  // namespace

// rgb uint8 [n, 3]; rows int32 [6, row_len] (secondaries, padded with
// 2^20); starts int32 [6] -> out int32 [n].
extern "C" int cmst_slice_numbers(const void* rgb, int64_t n,
                                  const void* rows, const void* starts,
                                  int row_len, void* out, void* stream) {
    if (row_len < 1 || row_len > MAX_ROW) return cudaErrorInvalidValue;
    if (n == 0) return cudaGetLastError();
    slice_numbers_kernel<<<cmst::blocks_for(n, THREADS), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(rgb), n,
        static_cast<const int32_t*>(rows),
        static_cast<const int32_t*>(starts), row_len,
        static_cast<int32_t*>(out));
    return cudaGetLastError();
}
