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
// 2 x (Sg + W) x T x 4 bytes, ~420 MB at a production mask's support,
// against ~12 integer operations a word: HBM bandwidth bounds it
// (~0.125 ms at 3.35 TB/s), so the design is that of a streaming
// reduction.
//
// The first design reached 38% of HBM: each thread loaded one
// 4-byte word a row with one load in flight, in a loop with a
// data-dependent `continue`, and the gap and ring parts were two
// launches. This design is one launch over (column group, row chunk,
// part), the part being the gap rows or the ring words of one
// orientation; chunks are 256 rows, halved (to 32) while the grid has
// fewer than 512 blocks, so a narrow plane (a mesh shard of 512
// columns) still fills the card. Each thread takes 4 adjacent columns
// with one 16-byte load a row (a scalar loader with bounds checks when
// T % 4 != 0 or the plane is not 16-byte aligned), and issues the loads
// of UNROLL rows before any compare. The chunk's query words are staged
// in shared memory; a group of UNROLL rows whose query words are all
// zero (the pad rows, in whole runs at the end of each part) is skipped
// without loading its targets, the same choice for the whole block.
// The partial sums are added into the zeroed outputs with 32-bit
// atomics, one a column and output per block. Integer addition modulo
// 2^32 does not depend on order, so the result is exact and
// deterministic, and wraps exactly like JAX's int32 sums. Overflow
// bound: gap_lo <= 1,023 x Sg, below 2^31 up to 2.1M gap rows; the whole
// 566x1210 plane has 685k pixels.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int COLS = 4;                  // adjacent columns a thread
constexpr int MAX_CHUNK = 256;           // rows (or words) of a chunk
constexpr int MIN_CHUNK = 32;
constexpr int MIN_BLOCKS = 512;          // chunks shrink until the grid has
                                         // as many (a narrow mesh shard)
constexpr int UNROLL = 8;                // rows whose loads are in flight
constexpr int SL_SHIFT = 16;
constexpr int Q_SL_MASK = 0x1FF;
constexpr int Q_NZ_SHIFT = 9;
constexpr int Q_SIG_SHIFT = 10;
constexpr int COLOR_FLUX = 40;  // DEFAULT_COLOR_FLUX

// 4 adjacent words of one row, from column c on; past n_cols they read 0
template <bool VEC>
__device__ __forceinline__ uint4 load4(const uint32_t* __restrict__ row,
                                       int64_t c, int64_t n_cols) {
    if (VEC) return __ldg(reinterpret_cast<const uint4*>(row + c));
    uint4 v;
    v.x = c < n_cols ? __ldg(row + c) : 0u;
    v.y = c + 1 < n_cols ? __ldg(row + c + 1) : 0u;
    v.z = c + 2 < n_cols ? __ldg(row + c + 2) : 0u;
    v.w = c + 3 < n_cols ? __ldg(row + c + 3) : 0u;
    return v;
}

__device__ __forceinline__ void gap_term(int q, uint32_t word, uint32_t& lo,
                                         uint32_t& hi) {
    const int w = static_cast<int>(word);
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

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
split_kernel(const uint32_t* __restrict__ t_gap,
             const int32_t* __restrict__ q_gap,
             const uint32_t* __restrict__ t_he,
             const uint32_t* __restrict__ q_he, int n_or, int64_t n_rows,
             int64_t n_words, int64_t n_cols, int chunk,
             int64_t gap_chunks, int64_t he_chunks,
             uint32_t* __restrict__ out) {
    __shared__ uint32_t s_q[MAX_CHUNK];
    const int64_t c = (blockIdx.x * static_cast<int64_t>(THREADS)
                       + threadIdx.x) * COLS;
    // blockIdx.y: the gap chunks of each orientation, then the ring
    // chunks of each orientation
    int64_t y = blockIdx.y;
    const bool gap = y < n_or * gap_chunks;
    if (!gap) y -= n_or * gap_chunks;
    const int64_t chunks = gap ? gap_chunks : he_chunks;
    const int o = static_cast<int>(y / chunks);
    const int64_t r0 = (y - o * chunks) * chunk;
    const int64_t rows = gap ? n_rows : n_words;
    const int n = static_cast<int>(min(static_cast<int64_t>(chunk),
                                       rows - r0));
    const uint32_t* q = gap ? reinterpret_cast<const uint32_t*>(q_gap)
                            : q_he;
    for (int k = threadIdx.x; k < n; k += THREADS)
        s_q[k] = q[o * rows + r0 + k];
    __syncthreads();
    if (c >= n_cols) return;
    const uint32_t* base = (gap ? t_gap : t_he)
        + (o * rows + r0) * n_cols;
    uint32_t a0[COLS] = {0, 0, 0, 0}, a1[COLS] = {0, 0, 0, 0};
    int k = 0;
    for (; k + UNROLL <= n; k += UNROLL) {
        uint32_t any = 0;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) any |= s_q[k + u];
        if (!any) continue;  // pad rows or no query term: all vals 0
        uint4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
            v[u] = load4<VEC>(base + (k + u) * n_cols, c, n_cols);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const uint32_t qw = s_q[k + u];
            const uint32_t w[COLS] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
            for (int i = 0; i < COLS; ++i) {
                if (gap) gap_term(static_cast<int>(qw), w[i], a0[i], a1[i]);
                else a0[i] += __popc(w[i] & qw);
            }
        }
    }
    for (; k < n; ++k) {
        const uint32_t qw = s_q[k];
        if (!qw) continue;
        const uint4 v = load4<VEC>(base + k * n_cols, c, n_cols);
        const uint32_t w[COLS] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < COLS; ++i) {
            if (gap) gap_term(static_cast<int>(qw), w[i], a0[i], a1[i]);
            else a0[i] += __popc(w[i] & qw);
        }
    }
    // out: (gap_hi, gap_lo, high_expr) [3, n_or, n_cols]
    const int64_t plane = static_cast<int64_t>(n_or) * n_cols;
    uint32_t* dst = out + o * n_cols + c;
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
        if (c + i >= n_cols) break;
        if (gap) {
            if (a1[i]) atomicAdd(dst + i, a1[i]);
            if (a0[i]) atomicAdd(dst + plane + i, a0[i]);
        } else if (a0[i]) {
            atomicAdd(dst + 2 * plane + i, a0[i]);
        }
    }
}

}  // namespace

// out: int32 [3, n_or, n_cols] = (gap_hi, gap_lo, high_expr), zeroed here.
extern "C" int cmst_shape_split(const void* t_gap, const void* q_gap,
                                const void* t_he, const void* q_he,
                                int n_or, int64_t n_rows, int64_t n_words,
                                int64_t n_cols, void* out, void* stream) {
    if (n_or < 1 || n_or > 2) return cudaErrorInvalidValue;
    const int64_t col_blocks = cmst::blocks_for((n_cols + COLS - 1) / COLS,
                                                THREADS);
    int chunk = MAX_CHUNK;
    auto grid_y = [&](int c) {
        return n_or * ((n_rows + c - 1) / c + (n_words + c - 1) / c);
    };
    while (chunk > MIN_CHUNK && col_blocks * grid_y(chunk) < MIN_BLOCKS)
        chunk /= 2;
    const int64_t gap_chunks = (n_rows + chunk - 1) / chunk;
    const int64_t he_chunks = (n_words + chunk - 1) / chunk;
    const int64_t y = grid_y(chunk);
    if (y > 65535) return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int64_t plane = static_cast<int64_t>(n_or) * n_cols;
    cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(3 * plane) * sizeof(int32_t), st);
    if (err != cudaSuccess) return err;
    if (n_cols == 0 || y == 0) return cudaGetLastError();
    const bool vec = n_cols % COLS == 0
        && reinterpret_cast<uintptr_t>(t_gap) % 16 == 0
        && reinterpret_cast<uintptr_t>(t_he) % 16 == 0;
    const dim3 grid(static_cast<unsigned>(col_blocks),
                    static_cast<unsigned>(y));
    auto kernel = vec ? split_kernel<true> : split_kernel<false>;
    kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const uint32_t*>(t_gap),
        static_cast<const int32_t*>(q_gap),
        static_cast<const uint32_t*>(t_he),
        static_cast<const uint32_t*>(q_he), n_or, n_rows, n_words, n_cols,
        chunk, gap_chunks, he_chunks, static_cast<uint32_t*>(out));
    return cudaGetLastError();
}
