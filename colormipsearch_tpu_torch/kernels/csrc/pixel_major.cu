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
// slice. A transpose that moves one element a thread per access is
// bound by issued memory instructions instead (2-byte or 1-byte warp
// accesses of 64 or 32 bytes), so the design moves 16 bytes a thread
// per access on both sides:
//  * a tile is 256 bytes along each side (16 slots of 16 bytes): 128 x
//    128 int16 (32 KB) or 256 x 256 uint8 (64 KB) between two barriers,
//    256 threads (tiles with 128-byte sides, 8 KB and 16 KB, ran
//    slower on the H100: each DRAM burst of a side is one 128-byte line);
//  * load: a warp reads two src rows of 256 bytes, 16 bytes a thread,
//    and writes them to shared memory as 16-byte slots; the slot of
//    (row r, column slot s) sits at s ^ ((r / V) % 16), V = 16 /
//    sizeof(T), so a quarter-warp's 128 bytes fill all 32 banks;
//  * store: a thread gathers the V elements of one dst row (pixel c)
//    over V consecutive targets; with the swizzle they all lie in one
//    physical slot column, so a warp, which takes 8 slots of 4 dst
//    rows, reads 8 slots whose banks differ (no conflict) and writes 4 x
//    128 bytes of dst rows as 16-byte vectors (a warp pair: 256 bytes a
//    row);
//  * the grid is sized by occupancy and each block walks tiles, the
//    pixel tiles of one band of targets in turn; the next tile's loads
//    are issued before the current tile's stores.
// Every pitch is arbitrary (R is the count of store rows: a sorted 1,638
// of them gives a dst pitch of 3,276 bytes; n is ragged in the last
// chunk; p0 moves the dst base), so each launch picks its access widths
// from the pitches and pointers: the widest of 16, 8, 4, 2 (, 1) bytes
// that divides the src pitch and base for the loads, and 16-byte or
// element stores for the dst. All paths are exact. Offsets are 64-bit:
// n_px * R passes 2^31 at R 4,096.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SLOTS = 16;                  // 16-byte slots a tile side

template <int BYTES> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = uint32_t; };
template <> struct Word<2> { using type = uint16_t; };
template <> struct Word<1> { using type = uint8_t; };

// LW: bytes a load instruction moves; VSTORE: 16-byte dst stores.
template <typename T, int LW, bool VSTORE>
__global__ void __launch_bounds__(THREADS)
pixel_major_kernel(const T* __restrict__ src, int64_t n_r, int64_t n,
                   T* __restrict__ dst, int64_t p0, int64_t tiles_c,
                   int64_t n_tiles) {
    constexpr int V = 16 / sizeof(T);      // elements in a 16-byte slot
    constexpr int TILE = SLOTS * V;        // tile edge in elements
    constexpr int PER = TILE * SLOTS / THREADS;  // slots a thread a phase
    constexpr int WORDS = 16 / LW;         // load words in a slot
    constexpr int WE = LW / static_cast<int>(sizeof(T));  // elements a word
    constexpr int HALVES = SLOTS / 8;      // warps a dst row segment
    using W = typename Word<LW>::type;
    extern __shared__ uint4 tile[];        // [TILE rows r][SLOTS slots]

    uint4 regs[PER];
    auto load = [&](int64_t t) {
        const int64_t r0 = (t / tiles_c) * TILE;
        const int64_t c0 = (t % tiles_c) * TILE;
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const int j = threadIdx.x + k * THREADS;
            const int64_t r = r0 + j / SLOTS;
            const int64_t c = c0 + (j % SLOTS) * V;
            uint4 v = make_uint4(0, 0, 0, 0);
            W* w = reinterpret_cast<W*>(&v);
            const W* row = reinterpret_cast<const W*>(src + r * n + c);
#pragma unroll
            for (int q = 0; q < WORDS; ++q)
                if (r < n_r && c + q * WE < n) w[q] = row[q];
            regs[k] = v;
        }
    };

    int64_t t = blockIdx.x;
    if (t >= n_tiles) return;
    load(t);
    for (; t < n_tiles; t += gridDim.x) {
        __syncthreads();                  // the last tile's reads are done
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const int j = threadIdx.x + k * THREADS;
            const int r = j / SLOTS;
            tile[r * SLOTS + ((j % SLOTS) ^ ((r / V) % SLOTS))] = regs[k];
        }
        __syncthreads();
        const int64_t r0 = (t / tiles_c) * TILE;
        const int64_t c0 = (t % tiles_c) * TILE;
        if (t + gridDim.x < n_tiles) load(t + gridDim.x);  // in flight
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const int j = threadIdx.x + k * THREADS;
            const int lane = j % 32, warp = j / 32;
            const int c = (warp / HALVES) * 4 + lane / 8;  // dst row
            const int s = (warp % HALVES) * 8 + lane % 8;  // V targets
            if (c0 + c >= n) continue;
            const int64_t rb = r0 + s * V;
            if (rb >= n_r) continue;
            // (row s*V + i, slot c / V) sits at slot (c / V) ^ s
            const T* col = reinterpret_cast<const T*>(tile)
                + (s * V * SLOTS + ((c / V) ^ s)) * V + c % V;
            T* out = dst + (p0 + c0 + c) * n_r + rb;
            if (VSTORE) {
                uint4 v;
                T* e = reinterpret_cast<T*>(&v);
#pragma unroll
                for (int i = 0; i < V; ++i) e[i] = col[i * SLOTS * V];
                *reinterpret_cast<uint4*>(out) = v;
            } else {
#pragma unroll
                for (int i = 0; i < V; ++i)
                    if (rb + i < n_r) out[i] = col[i * SLOTS * V];
            }
        }
    }
}

template <typename T, int LW, bool VSTORE>
cudaError_t launch_as(const T* src, int64_t n_r, int64_t n, T* dst,
                      int64_t p0, cudaStream_t st) {
    constexpr int TILE = SLOTS * 16 / sizeof(T);
    constexpr size_t SMEM = static_cast<size_t>(TILE) * SLOTS * 16;
    const int64_t tiles_c = (n + TILE - 1) / TILE;
    const int64_t n_tiles = tiles_c * ((n_r + TILE - 1) / TILE);
    auto kernel = pixel_major_kernel<T, LW, VSTORE>;
    static int resident_on[cmst::MAX_DEVICES] = {};
    int resident = 0;
    cudaError_t err = cmst::resident_blocks(kernel, THREADS, SMEM,
                                            resident_on, resident);
    if (err != cudaSuccess) return err;
    const int64_t grid = std::min<int64_t>(n_tiles, resident);
    kernel<<<static_cast<unsigned>(grid), THREADS, SMEM, st>>>(
        src, n_r, n, dst, p0, tiles_c, n_tiles);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* src_v, int64_t n_r, int64_t n, void* dst_v,
                   int64_t p0, cudaStream_t st) {
    const T* src = static_cast<const T*>(src_v);
    T* dst = static_cast<T*>(dst_v);
    const int lw = std::max<int>(
        cmst::widest(n * sizeof(T), reinterpret_cast<uintptr_t>(src)),
        sizeof(T));
    const bool vstore = cmst::widest(
        n_r * sizeof(T), reinterpret_cast<uintptr_t>(dst + p0 * n_r)) == 16;
#define CMST_PM(LW)                                                        \
    return vstore ? launch_as<T, LW, true>(src, n_r, n, dst, p0, st)       \
                  : launch_as<T, LW, false>(src, n_r, n, dst, p0, st)
    switch (lw) {
        case 16: CMST_PM(16);
        case 8: CMST_PM(8);
        case 4: CMST_PM(4);
        case 2: CMST_PM(2);
        default:
            if constexpr (sizeof(T) == 1) { CMST_PM(1); }
            return cudaErrorInvalidValue;
    }
#undef CMST_PM
}

}  // namespace

// src [n_r, n] -> rows [p0, p0 + n) of dst [n_px, n_r]; elem_size 1 or 2.
extern "C" int cmst_pixel_major(const void* src, int64_t n_r, int64_t n,
                                void* dst, int64_t n_px, int64_t p0,
                                int elem_size, void* stream) {
    if (p0 < 0 || n < 0 || n_r < 0 || p0 + n > n_px)
        return cudaErrorInvalidValue;
    if (n == 0 || n_r == 0) return cudaGetLastError();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (elem_size == 2) return launch<uint16_t>(src, n_r, n, dst, p0, st);
    if (elem_size == 1) return launch<uint8_t>(src, n_r, n, dst, p0, st);
    return cudaErrorInvalidValue;
}
