// K8: dense target-plane pack, in three modes.
//
// Replaces colormipsearch_tpu/ops/common.py `pack_target_planes` (the
// summary mode, row 5 of the kernel table), `pack_target_planes_keys`
// (the key mode, row 7) and `pack_target_planes_split` (the split mode,
// row 6). All read a decoded uint8 [T, P, 3] target stack and write
// pixel-major planes [rows, T_pad], one element per (pixel, target):
//   summary: int32 (cls << 24) | (p << 16) | (s << 8) | maxch, or 0 when
//            the threshold is folded (thr >= 0) and maxch <= thr;
//            rows = P;
//   key:     int32 (cls << 15) | rank[(s << 8) | p] when maxch > thr and
//            cls > 0, else 0; rows = P + 1 (row P the zero sentinel);
//   split:   uint16 (p << 8) | s and uint8 cls when maxch > thr, else 0
//            in both (the threshold is always folded); rows = P.
// Columns t >= T (the target bucket's padding) are written as 0.
//
// Bound on the H100: memory traffic, 3*T*P bytes read and 4*rows*T_pad
// written (3*rows*T_pad in the split mode; 4.2 GB + 5.6 GB at 566x1210
// and 2,048 targets: >= 2.9 ms at 3.35 TB/s; 2.5 ms in the split mode).
//
// The summary and key modes: K7's first tiled transpose. A 32 x 8
// thread block loads a tile of 32 pixels x 32 targets along the stack's
// rows (a warp reads 96 contiguous bytes of one target), classifies each
// pixel into its word in shared memory, and writes the tile back along
// the planes' rows (a warp writes 128 contiguous bytes of one pixel
// row); the tile is padded by one word per row against bank conflicts.
// The 256 KB rank LUT does not fit in shared memory and is read through
// the read-only cache (__ldg).
//
// The split mode moves 16 bytes a thread on both sides, as K7 does now:
//  * a tile is 32 pixels x 128 targets: 12 KB of stack in, 12 KB of
//    planes out between two barriers;
//  * load: the tile's bytes are staged in shared memory by cp.async, the
//    aligned 16-byte chunks that hold each target's 96 bytes (7 of them:
//    a target's row is 3*P bytes, 2,054,580 at 566x1210, 4 mod 16, so
//    its base moves by 4 bytes mod 16 from one target to the next).
//    Consecutive threads copy consecutive chunks of one row, so a warp
//    reads a few contiguous spans; the next tile's copies are in flight
//    while this one is classified and stored (two stages). Only chunks
//    that hold a byte of the tile and of the target's own row are read,
//    so no copy leaves the stack's allocation; a ragged last tile leaves
//    stale bytes in pixels whose rows are never stored;
//  * a thread takes 16 pixels (48 bytes) of one target from its 4 chunks
//    (16-byte shared loads at an odd pitch of 7 chunks: 8 lanes meet no
//    bank twice), shifts them into place in registers when the row is
//    not 16-byte aligned (a word select and a funnel shift), classifies
//    them and writes their halves into two pixel-major planes, [32][128]
//    uint16 and uint8: a warp's 32 lanes fill 64 and 32 contiguous bytes;
//  * store: a thread moves 16 bytes of a plane's row, 8 uint16 or 16
//    uint8 targets, so a warp writes 512 contiguous bytes of shared
//    memory into two rows of the uint16 plane or four of the uint8 one,
//    16-byte vectors along the output rows (when t_pad is a multiple of
//    16; else one element a store);
//  * the grid is the blocks the card holds at once, each walking tiles
//    (the pixel tiles of one band of 128 targets in turn); targets >= T
//    are not read. All paths are exact.
// What holds it well under its bound on the H100 is the read side: the
// stack's reads alone (no stores) take nearly the whole kernel's time,
// and neither the tile's shape (16-128 targets, 96-768 bytes of a row),
// nor a third stage, a fourth block an SM, TMA bulk copies, nor walking
// every band of a group of pixel tiles made them faster; the
// classification and the stores hide beneath them.
// Offsets are 64-bit: T*P*3 and rows*T_pad pass 2^31 at production
// shapes.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;

enum Mode { SUMMARY = 0, KEYS = 1, SPLIT = 2 };

template <int MODE>
__global__ void pack_planes_kernel(const uint8_t* __restrict__ stack,
                                   int64_t n_t, int64_t n_px,
                                   int64_t n_rows, int64_t t_pad, int thr,
                                   const int32_t* __restrict__ rank_lut,
                                   int32_t* __restrict__ out) {
    __shared__ int32_t tile[TILE][TILE + 1];
    const int64_t p0 = static_cast<int64_t>(blockIdx.x) * TILE;  // pixel
    const int64_t t0 = static_cast<int64_t>(blockIdx.y) * TILE;  // target
    for (int j = threadIdx.y; j < TILE; j += ROWS) {
        const int64_t t = t0 + j;
        const int64_t p = p0 + threadIdx.x;
        int32_t word = 0;
        if (t < n_t && p < n_px) {
            const uint8_t* px = stack + (t * n_px + p) * 3;
            const int r = px[0], g = px[1], b = px[2];
            int cls, s, pr;
            cmst::classify(r, g, b, cls, s, pr);
            const int maxch = max(max(r, g), b);
            if (MODE == KEYS) {
                if (maxch > thr && cls > 0)
                    word = (cls << cmst::KEY_RANK_BITS)
                        | __ldg(rank_lut + ((s << 8) | pr));
            } else if (thr < 0 || maxch > thr) {
                word = (cls << 24) | (pr << 16) | (s << 8) | maxch;
            }
        }
        tile[j][threadIdx.x] = word;
    }
    __syncthreads();
    for (int j = threadIdx.y; j < TILE; j += ROWS) {
        const int64_t p = p0 + j;
        const int64_t t = t0 + threadIdx.x;
        if (p < n_rows && t < t_pad)
            out[p * t_pad + t] = tile[threadIdx.x][j];
    }
}

// ---- the split mode --------------------------------------------------

constexpr int SP_THREADS = 256;
constexpr int SP_PX = 32;                        // pixels a tile
constexpr int SP_T = 128;                        // targets a tile
constexpr int RUN = 16;                          // pixels a thread classifies
// the aligned 16-byte chunks that hold a tile's 3 * SP_PX bytes of one
// target (one more for an unaligned row); odd, so 8 lanes reading 16
// bytes each at this pitch meet no bank twice
constexpr int CHUNKS = (3 * SP_PX + 15) / 16 + 1;
static_assert(CHUNKS % 2 == 1, "the staging pitch must be odd");
static_assert(SP_T * SP_PX / RUN == SP_THREADS, "one run a thread");
constexpr int COPIES = (SP_T * CHUNKS + SP_THREADS - 1) / SP_THREADS;

// The split words of one pixel: (p << 8) | s and cls for a strictly
// dominant channel above the threshold, else 0 and 0. p is the maximum
// and s the median of the three channels (cmst::classify's s).
__device__ __forceinline__ void split_word(int r, int g, int b, int thr,
                                           uint16_t& ps, uint8_t& cls) {
    const int mx = max(max(r, g), b);
    const int md = r + g + b - mx - min(min(r, g), b);
    int c;
    if (b == mx) c = r > g ? 1 : 2;
    else if (g == mx) c = b > r ? 3 : 4;
    else c = g > b ? 5 : 6;
    const bool live = mx > md && mx > thr;
    ps = live ? static_cast<uint16_t>((mx << 8) | md) : 0;
    cls = live ? static_cast<uint8_t>(c) : 0;
}

// byte b of the little-endian words w
__device__ __forceinline__ int byte_at(const uint32_t* w, int b) {
    return static_cast<int>((w[b / 4] >> (8 * (b % 4))) & 0xFF);
}

__device__ __forceinline__ void copy_async16(void* smem, const void* gmem) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(gmem));
}

__device__ __forceinline__ void copy_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one group of this thread's copies is in flight
__device__ __forceinline__ void copy_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::);
}

template <bool ALIGNED, bool VSTORE>
__global__ void __launch_bounds__(SP_THREADS)
pack_split_kernel(const uint8_t* __restrict__ stack, int64_t n_t,
                  int64_t n_px, int64_t t_pad, int thr,
                  uint16_t* __restrict__ out16, uint8_t* __restrict__ out8,
                  int tiles_p, int n_tiles) {
    // two stages of raw bytes, [target][chunk], and the two planes
    __shared__ __align__(16) uint4 raw[2][SP_T][CHUNKS];
    __shared__ __align__(16) uint16_t s16[SP_PX][SP_T];
    __shared__ __align__(16) uint8_t s8[SP_PX][SP_T];
    const int64_t pitch = 3 * n_px;
    const int tt = threadIdx.x % SP_T;   // the thread's target in a tile
    const int run0 = threadIdx.x / SP_T * RUN;  // its run's first pixel

    // stage a tile's raw bytes: consecutive threads copy consecutive
    // chunks of one target's row, so a warp reads a few contiguous spans
    auto stage = [&](int tile, int buf) {
        const int band = tile / tiles_p;
        const int64_t p0 = static_cast<int64_t>(tile - band * tiles_p) * SP_PX;
#pragma unroll
        for (int k = 0; k < COPIES; ++k) {
            const int c = threadIdx.x + k * SP_THREADS;
            if (c >= SP_T * CHUNKS) break;
            const int j = c / CHUNKS, q = c - j * CHUNKS;
            const int64_t t = static_cast<int64_t>(band) * SP_T + j;
            if (t >= n_t) continue;
            const uint8_t* row = stack + t * pitch;
            const uintptr_t a = reinterpret_cast<uintptr_t>(row + 3 * p0);
            const uintptr_t chunk = (a & ~uintptr_t{15}) + 16 * q;
            // the chunks that hold a byte of the tile's pixels, and of
            // this target's row (so of the stack's allocation)
            if (chunk < a + 3 * SP_PX
                && chunk < reinterpret_cast<uintptr_t>(row + pitch))
                copy_async16(&raw[buf][j][q],
                             reinterpret_cast<const void*>(chunk));
        }
        copy_commit();
    };

    int tile = blockIdx.x;
    if (tile >= n_tiles) return;
    stage(tile, 0);
    for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
        const int next = tile + static_cast<int>(gridDim.x);
        if (next < n_tiles) stage(next, (it + 1) & 1);
        else copy_commit();  // an empty group keeps the count
        copy_wait_one();     // this tile's copies have landed
        __syncthreads();
        const int band = tile / tiles_p;
        const int64_t p0 = static_cast<int64_t>(tile - band * tiles_p) * SP_PX;
        const int64_t t0 = static_cast<int64_t>(band) * SP_T;
        const int64_t t = t0 + tt;
        uint16_t ps[RUN] = {};
        uint8_t cls[RUN] = {};
        if (t < n_t) {
            // the run's 48 bytes: 4 chunks from its own (the row's byte
            // offset is the same for every tile: 3 * p0 is a multiple of
            // 96), shifted into place
            const uint32_t off = ALIGNED ? 0 : static_cast<uint32_t>(
                reinterpret_cast<uintptr_t>(stack + t * pitch) & 15);
            const uint4* src = &raw[it & 1][tt][3 * run0 / 16];
            uint32_t rw[16];
#pragma unroll
            for (int q = 0; q < (ALIGNED ? 3 : 4); ++q) {
                const uint4 v = src[q];
                rw[4 * q] = v.x;
                rw[4 * q + 1] = v.y;
                rw[4 * q + 2] = v.z;
                rw[4 * q + 3] = v.w;
            }
            uint32_t w[12];
            if (ALIGNED) {
#pragma unroll
                for (int i = 0; i < 12; ++i) w[i] = rw[i];
            } else {
                const uint32_t ow = off >> 2, sh = 8 * (off & 3);
                uint32_t x[13];
#pragma unroll
                for (int i = 0; i < 13; ++i)
                    x[i] = ow & 2 ? (ow & 1 ? rw[i + 3] : rw[i + 2])
                                  : (ow & 1 ? rw[i + 1] : rw[i]);
#pragma unroll
                for (int i = 0; i < 12; ++i)
                    w[i] = __funnelshift_r(x[i], x[i + 1], sh);
            }
            // pixels past n_px hold other bytes; their rows are never
            // stored
#pragma unroll
            for (int i = 0; i < RUN; ++i)
                split_word(byte_at(w, 3 * i), byte_at(w, 3 * i + 1),
                           byte_at(w, 3 * i + 2), thr, ps[i], cls[i]);
        }
#pragma unroll
        for (int i = 0; i < RUN; ++i) {
            s16[run0 + i][tt] = ps[i];
            s8[run0 + i][tt] = cls[i];
        }
        __syncthreads();
        // 16 bytes a thread a step: 8 uint16 targets, then 16 uint8 ones
#pragma unroll
        for (int j = 0; j < SP_PX * SP_T * 2 / 16 / SP_THREADS; ++j) {
            const int v = threadIdx.x + j * SP_THREADS;
            const int row = v / (SP_T / 8), col = v % (SP_T / 8) * 8;
            const int64_t p = p0 + row, tc = t0 + col;
            if (p >= n_px || tc >= t_pad) continue;
            uint16_t* dst = out16 + p * t_pad + tc;
            if (VSTORE) {
                *reinterpret_cast<uint4*>(dst) =
                    *reinterpret_cast<const uint4*>(&s16[row][col]);
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    if (tc + e < t_pad) dst[e] = s16[row][col + e];
            }
        }
#pragma unroll
        for (int j = 0; j < SP_PX * SP_T / 16 / SP_THREADS; ++j) {
            const int v = threadIdx.x + j * SP_THREADS;
            const int row = v / (SP_T / 16), col = v % (SP_T / 16) * 16;
            const int64_t p = p0 + row, tc = t0 + col;
            if (p >= n_px || tc >= t_pad) continue;
            uint8_t* dst = out8 + p * t_pad + tc;
            if (VSTORE) {
                *reinterpret_cast<uint4*>(dst) =
                    *reinterpret_cast<const uint4*>(&s8[row][col]);
            } else {
#pragma unroll
                for (int e = 0; e < 16; ++e)
                    if (tc + e < t_pad) dst[e] = s8[row][col + e];
            }
        }
    }
}

template <bool ALIGNED, bool VSTORE>
cudaError_t launch_split(const uint8_t* stack, int64_t n_t, int64_t n_px,
                         int64_t t_pad, int thr, uint16_t* out16,
                         uint8_t* out8, cudaStream_t st) {
    auto kernel = pack_split_kernel<ALIGNED, VSTORE>;
    static int resident_on[cmst::MAX_DEVICES] = {};
    int resident = 0;
    cudaError_t err = cmst::resident_blocks(kernel, SP_THREADS, 0,
                                            resident_on, resident);
    if (err != cudaSuccess) return err;
    const int64_t tiles_p = (n_px + SP_PX - 1) / SP_PX;
    const int64_t n_tiles = tiles_p * ((t_pad + SP_T - 1) / SP_T);
    if (n_tiles > INT32_MAX) return cudaErrorInvalidValue;
    kernel<<<static_cast<unsigned>(std::min<int64_t>(n_tiles, resident)),
             SP_THREADS, 0, st>>>(stack, n_t, n_px, t_pad, thr, out16, out8,
                                  static_cast<int>(tiles_p),
                                  static_cast<int>(n_tiles));
    return cudaGetLastError();
}

cudaError_t pack_split(const uint8_t* stack, int64_t n_t, int64_t n_px,
                       int64_t t_pad, int thr, uint16_t* out16,
                       uint8_t* out8, cudaStream_t st) {
    const bool aligned = cmst::widest(
        3 * n_px, reinterpret_cast<uintptr_t>(stack)) == 16;
    const bool vstore = t_pad % 16 == 0
        && reinterpret_cast<uintptr_t>(out16) % 16 == 0
        && reinterpret_cast<uintptr_t>(out8) % 16 == 0;
    if (aligned)
        return vstore ? launch_split<true, true>(stack, n_t, n_px, t_pad,
                                                 thr, out16, out8, st)
                      : launch_split<true, false>(stack, n_t, n_px, t_pad,
                                                  thr, out16, out8, st);
    return vstore ? launch_split<false, true>(stack, n_t, n_px, t_pad, thr,
                                              out16, out8, st)
                  : launch_split<false, false>(stack, n_t, n_px, t_pad,
                                               thr, out16, out8, st);
}

}  // namespace

// stack uint8 [n_t, n_px, 3] -> planes [rows, t_pad] in the given mode
// (0 summary: int32 out0, thr < 0 keeps every pixel's word; 1 key: int32
// out0 with rows = n_px + 1, rank_lut int32 [65536]; 2 split: uint16
// out0 and uint8 out1).
extern "C" int cmst_pack_planes(const void* stack, int64_t n_t,
                                int64_t n_px, int64_t t_pad, int thr,
                                int mode, const void* rank_lut, void* out0,
                                void* out1, void* stream) {
    if (n_t > t_pad || n_t < 0 || n_px < 0 || mode < SUMMARY || mode > SPLIT
        || (mode != SPLIT && (t_pad + TILE - 1) / TILE > 65535)
        || (mode == KEYS && rank_lut == nullptr)
        || (mode == SPLIT && out1 == nullptr))
        return cudaErrorInvalidValue;
    const int64_t n_rows = mode == KEYS ? n_px + 1 : n_px;
    if (n_rows == 0 || t_pad == 0) return cudaGetLastError();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint8_t* src = static_cast<const uint8_t*>(stack);
    if (mode == SPLIT)
        return pack_split(src, n_t, n_px, t_pad, thr,
                          static_cast<uint16_t*>(out0),
                          static_cast<uint8_t*>(out1), st);
    const dim3 grid(cmst::blocks_for(n_rows, TILE),
                    cmst::blocks_for(t_pad, TILE));
    const dim3 block(TILE, ROWS);
    int32_t* out = static_cast<int32_t*>(out0);
    if (mode == KEYS)
        pack_planes_kernel<KEYS><<<grid, block, 0, st>>>(
            src, n_t, n_px, n_rows, t_pad, thr,
            static_cast<const int32_t*>(rank_lut), out);
    else
        pack_planes_kernel<SUMMARY><<<grid, block, 0, st>>>(
            src, n_t, n_px, n_rows, t_pad, thr, nullptr, out);
    return cudaGetLastError();
}
