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
// and 2,048 targets: >= 2.9 ms at 3.35 TB/s). The operation is a
// transpose with a per-pixel classification on the way, so the design
// is K7's tiled transpose: a 32 x 8 thread block loads a tile of 32
// pixels x 32 targets along the stack's rows (a warp reads 96 contiguous
// bytes of one target), classifies each pixel into its word in shared
// memory, and writes the tile back along the planes' rows (a warp writes
// 128 contiguous bytes of one pixel row; 64 + 32 in the split mode); the
// tile is padded by one word per row against bank conflicts. The 256 KB
// rank LUT does not fit in shared memory and is read through the
// read-only cache (__ldg). Offsets are 64-bit: T*P*3 and rows*T_pad pass
// 2^31 at production shapes.
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
                                   void* __restrict__ out0,
                                   uint8_t* __restrict__ out1) {
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
            } else if (MODE == SPLIT) {
                // both outputs of one element in one word: cls above the
                // 16 bits of (p << 8) | s
                if (maxch > thr) word = (cls << 16) | (pr << 8) | s;
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
        if (p < n_rows && t < t_pad) {
            const int32_t word = tile[threadIdx.x][j];
            if (MODE == SPLIT) {
                static_cast<uint16_t*>(out0)[p * t_pad + t] =
                    static_cast<uint16_t>(word & 0xFFFF);
                out1[p * t_pad + t] = static_cast<uint8_t>(word >> 16);
            } else {
                static_cast<int32_t*>(out0)[p * t_pad + t] = word;
            }
        }
    }
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
        || (t_pad + TILE - 1) / TILE > 65535
        || (mode == KEYS && rank_lut == nullptr)
        || (mode == SPLIT && out1 == nullptr))
        return cudaErrorInvalidValue;
    const int64_t n_rows = mode == KEYS ? n_px + 1 : n_px;
    if (n_rows == 0 || t_pad == 0) return cudaGetLastError();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(cmst::blocks_for(n_rows, TILE),
                    cmst::blocks_for(t_pad, TILE));
    const dim3 block(TILE, ROWS);
    const uint8_t* src = static_cast<const uint8_t*>(stack);
    const int32_t* lut = static_cast<const int32_t*>(rank_lut);
    uint8_t* cls = static_cast<uint8_t*>(out1);
    if (mode == KEYS)
        pack_planes_kernel<KEYS><<<grid, block, 0, st>>>(
            src, n_t, n_px, n_rows, t_pad, thr, lut, out0, nullptr);
    else if (mode == SPLIT)
        pack_planes_kernel<SPLIT><<<grid, block, 0, st>>>(
            src, n_t, n_px, n_rows, t_pad, thr, nullptr, out0, cls);
    else
        pack_planes_kernel<SUMMARY><<<grid, block, 0, st>>>(
            src, n_t, n_px, n_rows, t_pad, thr, nullptr, out0, nullptr);
    return cudaGetLastError();
}
