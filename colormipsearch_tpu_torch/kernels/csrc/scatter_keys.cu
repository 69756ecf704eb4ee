// K1: sparse rank-key plane pack.
//
// Replaces colormipsearch_tpu/ops/common.py `_scatter_key_chunk`
// (driven by `pack_target_planes_keys_sparse`): every foreground pixel
// of a target shard arrives as a COO element (pixel position, RGB),
// target-major, and the kernel writes the int32 [P+1, T_pad] rank-key
// planes, zero where no element lands (row P stays the all-zero
// sentinel).
//
// Bound on the H100: writing the planes, 4*(P+1)*T_pad bytes (5.6 GB
// for a 2,048-target shard), plus reading the ~7-byte elements once.
// A store per element would land T_pad*4 bytes from its neighbour's (an
// element's neighbours are the same column's next rows), one partial
// 32-byte sector each, on top of a memset of the whole planes. Instead
// every plane byte is written once, in whole lines: a block owns a
// column tile of TILE_C = 32 columns (one 128-byte line a row) and a
// range of rows, which it walks in tiles of TILE_R = 256 rows. For each
// row tile it writes its columns' keys into a zeroed tile in shared
// memory and then stores the tile with coalesced 16-byte streaming
// stores, so zero rows cost nothing extra and no sector is written in
// part.
//
// Precondition: within each target's segment [cum[t-1], cum[t]) `pos`
// rises strictly (coo_foreground's order). Then a column's elements that
// fall in a row tile are a run that starts where the previous tile's
// ended: each column keeps one cursor, found once per block by a binary
// search (a lane's four searches side by side), not a search per
// element. A warp serves four columns: each round, for every column, its
// 32 lanes read the column's next 32 elements (pos and RGB, coalesced;
// the four columns' loads in flight together), store the keys of those
// inside the tile and advance the cursor by how many were (a ballot),
// looping while any column took all 32. The first round of the next
// tile is loaded before the current tile's stores, so its latency hides
// behind them. The grid is WAVES waves of the blocks the card holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor): few searches and
// a short last wave. Classification and the rank lookup are those of
// common.cuh and the 256 KB LUT, read through L2. Element indices are
// 32-bit (the wrapper refuses 2^31 elements); plane offsets 64-bit.
#include "common.cuh"

namespace {

constexpr int TILE_C = 32;            // columns a block owns: 128 bytes
constexpr int TILE_R = 256;           // rows a shared-memory tile holds
constexpr int THREADS = 256;          // 8 warps of 4 columns
constexpr int COLS = TILE_C / (THREADS / 32);
constexpr int WAVES = 4;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int NONE = 0x7FFFFFFF;

// The next 32 elements of each of a lane's columns: pos (NONE past the
// segment) and RGB.
struct Round {
    int p[COLS];
    uint8_t r[COLS], g[COLS], b[COLS];
};

__device__ __forceinline__ void load_round(Round& x, const int* cur,
                                           const int* end, int lane,
                                           const int32_t* __restrict__ pos,
                                           const uint8_t* __restrict__ rgb) {
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
        const int i = cur[k] + lane;
        const bool in = i < end[k];
        x.p[k] = in ? pos[i] : NONE;
        x.r[k] = in ? rgb[3 * i] : 0;
        x.g[k] = in ? rgb[3 * i + 1] : 0;
        x.b[k] = in ? rgb[3 * i + 2] : 0;
    }
}

__global__ void __launch_bounds__(THREADS)
scatter_keys_kernel(int32_t* __restrict__ planes,
                    const int32_t* __restrict__ pos,
                    const uint8_t* __restrict__ rgb,
                    const int64_t* __restrict__ cum,
                    const int32_t* __restrict__ rank_lut, int n,
                    int n_rows, int t_pad, int rows_per_block,
                    bool vec_store) {
    __shared__ __align__(16) int32_t tile[TILE_R * TILE_C];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int col0 = (tid >> 5) * COLS;
    const int c0 = blockIdx.x * TILE_C;
    const int row_begin = blockIdx.y * rows_per_block;
    const int row_end = min(n_rows, row_begin + rows_per_block);

    // each column's segment (the plain version clamps columns past the
    // last to t_pad - 1, so that column runs to n) and its cursor at the
    // first element on or after row_begin, the searches side by side
    int cur[COLS], end[COLS], hi[COLS];
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
        const int t = c0 + col0 + k;
        cur[k] = end[k] = 0;
        if (t < t_pad) {
            cur[k] = t > 0 ? static_cast<int>(cum[t - 1]) : 0;
            end[k] = t == t_pad - 1 ? n : static_cast<int>(cum[t]);
        }
        hi[k] = end[k];
    }
    for (bool busy = true; busy;) {
        busy = false;
#pragma unroll
        for (int k = 0; k < COLS; ++k) {
            if (cur[k] < hi[k]) {
                const int mid = (cur[k] + hi[k]) >> 1;
                if (pos[mid] < row_begin) cur[k] = mid + 1; else hi[k] = mid;
                busy = true;
            }
        }
    }
    for (int k = tid; k < TILE_R * TILE_C / 4; k += THREADS)
        reinterpret_cast<int4*>(tile)[k] = make_int4(0, 0, 0, 0);
    Round x;
    load_round(x, cur, end, lane, pos, rgb);
    __syncthreads();

    for (int r0 = row_begin; r0 < row_end; r0 += TILE_R) {
        const int r1 = min(row_end, r0 + TILE_R);
        for (bool first = true;; first = false) {
            if (!first) load_round(x, cur, end, lane, pos, rgb);
            bool again = false;
#pragma unroll
            for (int k = 0; k < COLS; ++k) {
                const bool hit = x.p[k] < r1;
                if (hit && x.p[k] >= r0) {   // p < r0 only for unsorted input
                    int cls, s, pr;
                    cmst::classify(x.r[k], x.g[k], x.b[k], cls, s, pr);
                    tile[(x.p[k] - r0) * TILE_C + col0 + k] = cls > 0
                        ? ((cls << cmst::KEY_RANK_BITS)
                           | rank_lut[(s << 8) | pr])
                        : 0;
                }
                const int taken = __popc(__ballot_sync(FULL, hit));
                cur[k] += taken;
                again |= taken == 32;
            }
            if (!again) break;
        }
        // the next tile's first round, in flight during the stores
        load_round(x, cur, end, lane, pos, rgb);
        __syncthreads();
        // store the tile's rows, then zero what was stored for the next
        const int n_r = r1 - r0;
        int32_t* dst = planes + static_cast<int64_t>(r0) * t_pad + c0;
        if (vec_store) {
            for (int k = tid; k < n_r * (TILE_C / 4); k += THREADS) {
                const int r = k / (TILE_C / 4), q = k % (TILE_C / 4);
                int4* src = reinterpret_cast<int4*>(tile) + k;
                __stcs(reinterpret_cast<int4*>(
                           dst + static_cast<int64_t>(r) * t_pad) + q, *src);
                *src = make_int4(0, 0, 0, 0);
            }
        } else {
            for (int k = tid; k < n_r * TILE_C; k += THREADS) {
                const int r = k / TILE_C, c = k % TILE_C;
                if (c0 + c < t_pad)
                    dst[static_cast<int64_t>(r) * t_pad + c] = tile[k];
                tile[k] = 0;
            }
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" int cmst_scatter_keys(void* planes, const void* pos,
                                 const void* rgb, const void* cum,
                                 const void* rank_lut, int64_t n,
                                 int64_t n_rows, int64_t t_pad,
                                 void* stream) {
    if (n < 0 || n >= (int64_t{1} << 31) || n_rows < 1
        || n_rows >= (int64_t{1} << 31) || t_pad < 1
        || t_pad >= (int64_t{1} << 31))
        return cudaErrorInvalidValue;
    // the blocks the current card holds at once
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, scatter_keys_kernel, THREADS, 0);
    if (err != cudaSuccess) return err;
    const int resident = sms * (per_sm > 0 ? per_sm : 1);
    const int64_t col_tiles = (t_pad + TILE_C - 1) / TILE_C;
    // rows a block takes: whole tiles, about WAVES waves in all
    const int64_t row_blocks = (int64_t{WAVES} * resident + col_tiles - 1)
        / col_tiles;
    const int64_t tiles = (n_rows + TILE_R - 1) / TILE_R;
    const int rows_per_block =
        static_cast<int>((tiles + row_blocks - 1) / row_blocks) * TILE_R;
    const dim3 grid(static_cast<unsigned>(col_tiles),
                    static_cast<unsigned>((n_rows + rows_per_block - 1)
                                          / rows_per_block));
    // 16-byte stores need every row of the tile 16-byte aligned and whole
    const bool vec_store = t_pad % TILE_C == 0;
    scatter_keys_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<int32_t*>(planes), static_cast<const int32_t*>(pos),
        static_cast<const uint8_t*>(rgb), static_cast<const int64_t*>(cum),
        static_cast<const int32_t*>(rank_lut), static_cast<int>(n),
        static_cast<int>(n_rows), static_cast<int>(t_pad), rows_per_block,
        vec_store);
    return cudaGetLastError();
}
