// K8: dense target-plane pack, in two modes.
//
// Replaces colormipsearch_tpu/ops/common.py `pack_target_planes` (the
// summary mode, row 5 of the kernel table) and `pack_target_planes_keys`
// (the key mode, row 7). Both read a decoded uint8 [T, P, 3] target
// stack and write pixel-major int32 planes [rows, T_pad], one word per
// (pixel, target):
//   summary: (cls << 24) | (p << 16) | (s << 8) | maxch, or 0 when the
//            threshold is folded (thr >= 0) and maxch <= thr; rows = P;
//   key:     (cls << 15) | rank[(s << 8) | p] when maxch > thr and
//            cls > 0, else 0; rows = P + 1 (row P the zero sentinel).
// Columns t >= T (the target bucket's padding) are written as 0.
//
// Bound on the H100: memory traffic, 3*T*P bytes read and 4*rows*T_pad
// written (4.2 GB + 5.6 GB at 566x1210 and 2,048 targets: >= 2.9 ms at
// 3.35 TB/s). The operation is a transpose with a per-pixel
// classification on the way, so the design is K7's tiled transpose: a
// 32 x 8 thread block loads a tile of 32 pixels x 32 targets along the
// stack's rows (a warp reads 96 contiguous bytes of one target),
// classifies each pixel into its word in shared memory, and writes the
// tile back along the planes' rows (a warp writes 128 contiguous bytes
// of one pixel row); the tile is padded by one word per row against
// bank conflicts. The 256 KB rank LUT does not fit in shared memory and
// is read through the read-only cache (__ldg). Offsets are 64-bit:
// T*P*3 and rows*T_pad pass 2^31 at production shapes.
#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;

template <bool KEYS>
__global__ void pack_planes_kernel(const uint8_t* __restrict__ stack,
                                   int64_t n_t, int64_t n_px,
                                   int64_t n_rows, int64_t t_pad, int thr,
                                   const int32_t* __restrict__ rank_lut,
                                   int32_t* __restrict__ planes) {
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
            if (KEYS) {
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
            planes[p * t_pad + t] = tile[threadIdx.x][j];
    }
}

}  // namespace

// stack uint8 [n_t, n_px, 3] -> planes int32 [n_px (+1 with keys), t_pad];
// keys != 0 selects the rank-key mode (rank_lut int32 [65536]); in the
// summary mode thr < 0 keeps every pixel's word.
extern "C" int cmst_pack_planes(const void* stack, int64_t n_t,
                                int64_t n_px, int64_t t_pad, int thr,
                                int keys, const void* rank_lut,
                                void* planes, void* stream) {
    if (n_t > t_pad || n_t < 0 || n_px < 0
        || (t_pad + TILE - 1) / TILE > 65535 || (keys && rank_lut == nullptr))
        return cudaErrorInvalidValue;
    const int64_t n_rows = keys ? n_px + 1 : n_px;
    if (n_rows == 0 || t_pad == 0) return cudaGetLastError();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(cmst::blocks_for(n_rows, TILE),
                    cmst::blocks_for(t_pad, TILE));
    const dim3 block(TILE, ROWS);
    if (keys) {
        pack_planes_kernel<true><<<grid, block, 0, st>>>(
            static_cast<const uint8_t*>(stack), n_t, n_px, n_rows, t_pad,
            thr, static_cast<const int32_t*>(rank_lut),
            static_cast<int32_t*>(planes));
    } else {
        pack_planes_kernel<false><<<grid, block, 0, st>>>(
            static_cast<const uint8_t*>(stack), n_t, n_px, n_rows, t_pad,
            thr, nullptr, static_cast<int32_t*>(planes));
    }
    return cudaGetLastError();
}
