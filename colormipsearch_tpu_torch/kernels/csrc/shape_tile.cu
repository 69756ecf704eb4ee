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
// Bound on the H100: bytes. The kernel writes the planes (~420 MB for a
// production mask at T 2,048) and gathers the field rows they need (zsl
// and grad at every gap pixel, one tfg byte row per 8 ring pixels), ~0.23
// ms at 3.35 TB/s. One thread per target column t, so a warp's loads of
// one field row are 32 store rows of it (consecutive addresses when
// rows_sel ascends, as the engine sorts it; a permutation makes each
// warp load touch up to 32 sectors) and its stores 32 consecutive words.
//
// The first design took 5.6x its bound: each output word was one
// thread's 32 serial iterations, each loading keep and h_pos and
// gathering one tfg byte, although a word's ring positions come from
// np.flatnonzero and are mostly raster runs (ascending; descending in a
// row for the mirror), so 32 gathers re-read the same 4-5 bytes; the gap
// planes read zsl once per orientation; and both grids spent one grid
// row per output row, 8 short blocks of one row each.
//
// This design: one launch, whose blocks each take a range of gap rows
// (both orientations) or of ring words, for 256 columns.
//  * Gap rows: the block stages its rows' positions in shared memory;
//    each thread loads zsl once and grad once per orientation, four rows
//    at a time (12 loads in flight), and writes both orientations' words;
//    rows at or past sg are written as zeros without touching the fields.
//  * Ring words: the block first cuts each of its 32 words into
//    segments, one warp per word (h_pos and keep depend on j alone): a
//    segment is a run of live ring rows whose positions step by the
//    word's direction (+1 or -1, whichever more of its steps take), so a
//    raster run is one segment; any other position is a segment of one.
//    Warp 0 then lists the block's segments word after word (a word
//    with none gets one empty segment, so it is still stored). Each
//    thread walks that list four segments at a time: it loads the 1-5
//    tfg bytes that cover each segment's pixels (up to 20 loads in
//    flight; read-only path, so a byte that neighbouring segments or
//    words share comes from L1), takes the run's bits with one shift and
//    mask, reverses them for a descending run, and stores a word after
//    its last segment. Exact for any h_pos; only faster for runs.
// Field offsets are int64_t: n_px * R is 1.4e9 at R 2,048 and passes
// 2^31 at R 4,096 (the lesson of K1).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;       // one target column a thread
constexpr int WARPS = THREADS / 32;
constexpr int GAP_ROWS = 64;       // gap rows a block, both orientations
constexpr int GAP_UNROLL = 4;      // gap rows whose loads are in flight
constexpr int HE_WORDS = 32;       // ring words a block (one warp's lanes)
constexpr int HE_UNROLL = 4;       // segments whose loads are in flight
constexpr uint16_t LAST_OF_WORD = 0x8000;
constexpr int SL_SHIFT = 16;
constexpr int64_t MAX_GRID_Y = 65535;  // blocks beyond it: grid-stride

// one run of a ring word: pixels lo .. lo + n - 1 feed word bits
// b0 .. b0 + n - 1 (in descending order when rev)
struct Segment {
    int32_t lo;
    uint32_t meta;  // b0 | n << 5 | rev << 11
};

__device__ __forceinline__ uint32_t field16(const uint16_t* f, int64_t px,
                                            int64_t n_r, int64_t r) {
    return __ldg(f + px * n_r + r);
}

__device__ void gap_block(const uint16_t* __restrict__ zsl,
                          const uint16_t* __restrict__ grad, int64_t n_r,
                          int64_t r, bool col_ok, int64_t t, int64_t n_cols,
                          const int32_t* __restrict__ pos_gap,
                          const int32_t* __restrict__ g_pos, int n_or,
                          int n_gap_pad, int sg, int i0,
                          uint32_t* __restrict__ t_gap, int32_t* s_pz,
                          int32_t* s_g) {
    const int n = min(GAP_ROWS, n_gap_pad - i0);
    const int live = max(0, min(n, sg - i0));
    for (int k = threadIdx.x; k < live; k += THREADS) {
        s_pz[k] = pos_gap[i0 + k];
        for (int o = 0; o < n_or; ++o)
            s_g[o * GAP_ROWS + k] = g_pos[o * n_gap_pad + i0 + k];
    }
    __syncthreads();
    if (col_ok) {
        uint32_t* out0 = t_gap + static_cast<int64_t>(i0) * n_cols + t;
        uint32_t* out1 = out0 + static_cast<int64_t>(n_gap_pad) * n_cols;
        int k = 0;
        for (; k + GAP_UNROLL <= live; k += GAP_UNROLL) {
            uint32_t z[GAP_UNROLL], g0[GAP_UNROLL], g1[GAP_UNROLL];
#pragma unroll
            for (int u = 0; u < GAP_UNROLL; ++u) {
                z[u] = field16(zsl, s_pz[k + u], n_r, r);
                g0[u] = field16(grad, s_g[k + u], n_r, r);
                g1[u] = n_or == 2
                    ? field16(grad, s_g[GAP_ROWS + k + u], n_r, r) : 0u;
            }
#pragma unroll
            for (int u = 0; u < GAP_UNROLL; ++u) {
                const int64_t off = static_cast<int64_t>(k + u) * n_cols;
                out0[off] = (z[u] << SL_SHIFT) | g0[u];
                if (n_or == 2) out1[off] = (z[u] << SL_SHIFT) | g1[u];
            }
        }
        for (; k < live; ++k) {
            const uint32_t z = field16(zsl, s_pz[k], n_r, r) << SL_SHIFT;
            const int64_t off = static_cast<int64_t>(k) * n_cols;
            out0[off] = z | field16(grad, s_g[k], n_r, r);
            if (n_or == 2)
                out1[off] = z | field16(grad, s_g[GAP_ROWS + k], n_r, r);
        }
        for (; k < n; ++k) {  // pad rows
            const int64_t off = static_cast<int64_t>(k) * n_cols;
            out0[off] = 0u;
            if (n_or == 2) out1[off] = 0u;
        }
    }
}

// Cut word `row` (flat over n_or * n_words) into segments; one warp.
__device__ void cut_word(const int32_t* __restrict__ h_pos,
                         const uint8_t* __restrict__ keep, int n_words,
                         int sh, int64_t row, Segment* segs, int* n_seg) {
    const int b = threadIdx.x & 31;
    const int k = static_cast<int>(row % n_words);
    const int64_t j = row * 32 + b;
    const bool live = 32 * k + b < sh && keep[j] != 0;
    const int hp = live ? h_pos[j] : 0;
    const int prev_hp = __shfl_up_sync(0xffffffffu, hp, 1);
    const bool prev_live = __shfl_up_sync(0xffffffffu, live ? 1 : 0, 1)
        && b > 0;
    const int step = hp - prev_hp;
    const bool linked = live && prev_live;
    const uint32_t up = __ballot_sync(0xffffffffu, linked && step == 1);
    const uint32_t down = __ballot_sync(0xffffffffu, linked && step == -1);
    const int dir = __popc(down) > __popc(up) ? -1 : 1;
    const uint32_t cont = dir < 0 ? down : up;
    const bool start = live && !((cont >> b) & 1u);
    const uint32_t starts = __ballot_sync(0xffffffffu, start);
    if (start) {
        const uint32_t after = b == 31 ? 0u : ~cont & (~0u << (b + 1));
        const int n = (after ? __ffs(after) - 1 : 32) - b;
        const bool rev = dir < 0 && n > 1;
        Segment s;
        s.lo = rev ? hp - (n - 1) : hp;
        s.meta = static_cast<uint32_t>(b) | static_cast<uint32_t>(n) << 5
            | static_cast<uint32_t>(rev) << 11;
        segs[__popc(starts & ((1u << b) - 1u))] = s;
    }
    if (b == 0) *n_seg = __popc(starts);
}

// The tfg bytes that cover a segment's pixels (1-5 byte rows; none for
// the empty segment that stands for a word without any), as one integer.
__device__ __forceinline__ uint64_t segment_bytes(
        const uint8_t* __restrict__ tfg, int64_t n_r, int64_t r, Segment s) {
    const int n = (s.meta >> 5) & 63;
    const int n_bytes = n ? (((s.lo & 7) + n - 1) >> 3) + 1 : 0;
    const uint8_t* p = tfg + static_cast<int64_t>(s.lo >> 3) * n_r + r;
    uint64_t v = 0;
#pragma unroll
    for (int i = 0; i < 5; ++i)
        if (i < n_bytes)
            v |= static_cast<uint64_t>(__ldg(p + i * n_r)) << (8 * i);
    return v;
}

// The segment's bits at their place in the word.
__device__ __forceinline__ uint32_t segment_bits(Segment s, uint64_t v) {
    const int n = (s.meta >> 5) & 63;
    uint32_t bits = static_cast<uint32_t>(v >> (s.lo & 7))
        & (n == 32 ? 0xffffffffu : (1u << n) - 1u);
    if ((s.meta >> 11) & 1) bits = __brev(bits) >> (32 - n);
    return bits << (s.meta & 31);
}

__device__ void he_block(const uint8_t* __restrict__ tfg, int64_t n_r,
                         int64_t r, bool col_ok, int64_t n_cols,
                         const int32_t* __restrict__ h_pos,
                         const uint8_t* __restrict__ keep, int n_words,
                         int sh, int64_t w0, int64_t n_rows,
                         uint32_t* __restrict__ t_he,
                         Segment (*s_seg)[32], int* s_nseg,
                         uint16_t* s_order, int* s_total) {
    const int nw = static_cast<int>(min(static_cast<int64_t>(HE_WORDS),
                                        n_rows - w0));
    for (int wl = threadIdx.x >> 5; wl < nw; wl += WARPS)
        cut_word(h_pos, keep, n_words, sh, w0 + wl, s_seg[wl], s_nseg + wl);
    __syncthreads();
    if (threadIdx.x < 32) {
        // one list of the block's segments, word after word; a word
        // without any gets one empty segment, so every word is stored
        const int lane = threadIdx.x;
        int ns = 0;
        if (lane < nw) {
            ns = s_nseg[lane];
            if (ns == 0) {
                s_seg[lane][0] = Segment{0, 0u};
                ns = 1;
            }
        }
        int incl = ns;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int x = __shfl_up_sync(0xffffffffu, incl, d);
            if (lane >= d) incl += x;
        }
        for (int i = 0; i < ns; ++i)
            s_order[incl - ns + i] = static_cast<uint16_t>(
                lane << 5 | i | (i == ns - 1 ? LAST_OF_WORD : 0));
        if (lane == 31) *s_total = incl;
    }
    __syncthreads();
    if (!col_ok) return;
    // HE_UNROLL segments' loads in flight; a word is stored after its
    // last segment
    const int total = *s_total;
    uint32_t word = 0;
    for (int s0 = 0; s0 < total; s0 += HE_UNROLL) {
        Segment sg[HE_UNROLL];
        uint16_t ord[HE_UNROLL];
        uint64_t v[HE_UNROLL];
#pragma unroll
        for (int u = 0; u < HE_UNROLL; ++u) {
            ord[u] = s0 + u < total ? s_order[s0 + u] : 0;
            sg[u] = s_seg[(ord[u] >> 5) & 31][ord[u] & 31];
            if (s0 + u >= total) sg[u].meta = 0;
            v[u] = segment_bytes(tfg, n_r, r, sg[u]);
        }
#pragma unroll
        for (int u = 0; u < HE_UNROLL; ++u) {
            if (s0 + u >= total) break;
            word |= segment_bits(sg[u], v[u]);
            if (ord[u] & LAST_OF_WORD) {
                t_he[(w0 + ((ord[u] >> 5) & 31)) * n_cols] = word;
                word = 0;
            }
        }
    }
}

__global__ void __launch_bounds__(THREADS)
tile_kernel(const uint16_t* __restrict__ zsl,
            const uint16_t* __restrict__ grad,
            const uint8_t* __restrict__ tfg, int64_t n_r,
            const int32_t* __restrict__ rows_sel, int64_t n_cols,
            const int32_t* __restrict__ pos_gap,
            const int32_t* __restrict__ g_pos,
            const int32_t* __restrict__ h_pos,
            const uint8_t* __restrict__ keep, int n_or, int n_gap_pad,
            int n_words, int sg, int sh, int64_t gap_blocks,
            int64_t he_blocks, uint32_t* __restrict__ t_gap,
            uint32_t* __restrict__ t_he) {
    __shared__ int32_t s_pz[GAP_ROWS];
    __shared__ int32_t s_g[2 * GAP_ROWS];
    __shared__ Segment s_seg[HE_WORDS][32];
    __shared__ int s_nseg[HE_WORDS];
    __shared__ uint16_t s_order[HE_WORDS * 32];
    __shared__ int s_total;
    const int64_t t = blockIdx.x * static_cast<int64_t>(THREADS)
        + threadIdx.x;
    const bool col_ok = t < n_cols;
    const int64_t r = col_ok ? rows_sel[t] : 0;
    const int64_t he_rows = static_cast<int64_t>(n_or) * n_words;
    for (int64_t y = blockIdx.y; y < gap_blocks + he_blocks;
         y += gridDim.y) {
        if (y < gap_blocks)
            gap_block(zsl, grad, n_r, r, col_ok, t, n_cols, pos_gap, g_pos,
                      n_or, n_gap_pad, sg, static_cast<int>(y) * GAP_ROWS,
                      t_gap, s_pz, s_g);
        else
            he_block(tfg, n_r, r, col_ok, n_cols, h_pos, keep, n_words, sh,
                     (y - gap_blocks) * HE_WORDS, he_rows, t_he + t, s_seg,
                     s_nseg, s_order, &s_total);
        __syncthreads();  // the next block row reuses the shared arrays
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
    const int64_t gap_blocks = (n_gap_pad + GAP_ROWS - 1) / GAP_ROWS;
    const int64_t he_blocks = (static_cast<int64_t>(n_or) * n_words
                               + HE_WORDS - 1) / HE_WORDS;
    const int64_t y = gap_blocks + he_blocks;
    if (y == 0) return cudaGetLastError();
    const dim3 grid(cmst::blocks_for(n_cols, THREADS),
                    static_cast<unsigned>(y < MAX_GRID_Y ? y : MAX_GRID_Y));
    tile_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(zsl),
        static_cast<const uint16_t*>(grad),
        static_cast<const uint8_t*>(tfg), n_r,
        static_cast<const int32_t*>(rows_sel), n_cols,
        static_cast<const int32_t*>(pos_gap),
        static_cast<const int32_t*>(g_pos),
        static_cast<const int32_t*>(h_pos),
        static_cast<const uint8_t*>(keep), n_or, n_gap_pad, n_words, sg, sh,
        gap_blocks, he_blocks, static_cast<uint32_t*>(t_gap),
        static_cast<uint32_t*>(t_he));
    return cudaGetLastError();
}
