// K12: bit re-encodings of a pixel-major [rows, T] plane set, in three
// modes.
//
// Replaces colormipsearch_tpu/ops/common.py `split_planes_from_packed`
// (the split mode), `key_planes_from_packed` (the key mode, row 8 of the
// kernel table) and ops/pixel_match.py `split_key_planes` (the split-key
// mode, row 12's re-encoding). Element by element:
//   split:     int32 summary word v -> uint16 (v >> 8) & 0xFFFF, i.e.
//              (p << 8) | s, and uint8 (v >> 24) & 0x7, the class;
//   key:       int32 summary word v (threshold folded) -> int32
//              (cls << 15) | rank[(s << 8) | p] when cls > 0, else 0;
//              the output has one row more than the input, the zero
//              sentinel row;
//   splitkeys: int32 key k -> uint16 k & 0x7FFF, the rank, and uint8
//              (uint32(k) >> 15) & 0xFF, the class.
//
// Bound on the H100: memory traffic. Each element is read once (4
// bytes) and written once (3 or 4 bytes) with a handful of integer
// operations between: 5.6 GB in and 4.2 GB out at 566x1210 and 2,048
// targets (>= 2.9 ms at 3.35 TB/s). Design: a flat grid-stride loop in
// which each thread takes 4 consecutive elements, so it reads one
// 16-byte word and writes 8 + 4 (or 16) bytes, every warp's accesses
// contiguous; the 256 KB rank LUT of the key mode is read through the
// read-only cache (__ldg). Sizes that are not a multiple of 4 (or
// unaligned pointers) take the same loop one element a thread. Offsets
// are 64-bit: rows*T passes 2^31 at production shapes.
#include "common.cuh"

namespace {

enum Mode { SPLIT = 0, KEYS = 1, SPLITKEYS = 2 };

// one element: the 16 + 8 bits of the split modes in one word (lo 16
// bits the uint16 output, bits 16..23 the uint8 one), or the key
template <int MODE>
__device__ __forceinline__ uint32_t recode(int32_t v,
                                           const int32_t* __restrict__ lut) {
    const uint32_t u = static_cast<uint32_t>(v);
    if (MODE == SPLIT)
        return ((u >> 8) & 0xFFFFu) | (((u >> 24) & 0x7u) << 16);
    if (MODE == SPLITKEYS)
        return (u & 0x7FFFu) | (((u >> 15) & 0xFFu) << 16);
    const int cls = (u >> 24) & 0x7;
    const int s = (u >> 8) & 0xFF;
    const int p = (u >> 16) & 0xFF;
    return cls > 0 ? static_cast<uint32_t>(
        (cls << cmst::KEY_RANK_BITS) | __ldg(lut + ((s << 8) | p))) : 0u;
}

template <int MODE, int VEC>
__global__ void repack_kernel(const int32_t* __restrict__ src, int64_t n,
                              int64_t n_out,
                              const int32_t* __restrict__ lut,
                              void* __restrict__ out0,
                              uint8_t* __restrict__ out1) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x)
             + threadIdx.x; q * VEC < n_out; q += stride) {
        const int64_t i = q * VEC;
        // past the input (i >= n): the key mode's sentinel row, zero; with
        // VEC 4, n % 4 == 0, so a quad lies wholly on one side
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (i < n) {
            if (VEC == 4) {
                const int4 v = reinterpret_cast<const int4*>(src)[q];
                w[0] = recode<MODE>(v.x, lut);
                w[1] = recode<MODE>(v.y, lut);
                w[2] = recode<MODE>(v.z, lut);
                w[3] = recode<MODE>(v.w, lut);
            } else {
                w[0] = recode<MODE>(src[i], lut);
            }
        }
        if (MODE == KEYS) {
            int32_t* dst = static_cast<int32_t*>(out0);
            if (VEC == 4)
                reinterpret_cast<int4*>(dst)[q] = make_int4(
                    static_cast<int>(w[0]), static_cast<int>(w[1]),
                    static_cast<int>(w[2]), static_cast<int>(w[3]));
            else
                dst[i] = static_cast<int32_t>(w[0]);
        } else if (VEC == 4) {
            // element i + k at the lower address: the lower bits
            reinterpret_cast<uint2*>(out0)[q] = make_uint2(
                (w[0] & 0xFFFFu) | (w[1] << 16),
                (w[2] & 0xFFFFu) | (w[3] << 16));
            reinterpret_cast<uint32_t*>(out1)[q] =
                ((w[0] >> 16) & 0xFFu) | (((w[1] >> 16) & 0xFFu) << 8)
                | (((w[2] >> 16) & 0xFFu) << 16) | ((w[3] >> 16) << 24);
        } else {
            static_cast<uint16_t*>(out0)[i] =
                static_cast<uint16_t>(w[0] & 0xFFFFu);
            out1[i] = static_cast<uint8_t>(w[0] >> 16);
        }
    }
}

template <int MODE>
void launch(bool vec, const int32_t* src, int64_t n, int64_t n_out,
            const int32_t* lut, void* out0, uint8_t* out1, cudaStream_t st) {
    constexpr int threads = 256;
    // enough blocks to fill every SM several times; the loop strides
    const int64_t per = vec ? 4 : 1;
    const int64_t want = (n_out + per * threads - 1) / (per * threads);
    const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
    if (vec)
        repack_kernel<MODE, 4><<<blocks, threads, 0, st>>>(
            src, n, n_out, lut, out0, out1);
    else
        repack_kernel<MODE, 1><<<blocks, threads, 0, st>>>(
            src, n, n_out, lut, out0, out1);
}

}  // namespace

// src int32 [rows, cols] -> mode 0 split: uint16 out0 + uint8 out1
// [rows, cols]; mode 1 key: int32 out0 [rows + 1, cols] (rank_lut int32
// [65536]); mode 2 splitkeys: uint16 out0 + uint8 out1 [rows, cols].
extern "C" int cmst_repack_planes(int mode, const void* src, int64_t rows,
                                  int64_t cols, const void* rank_lut,
                                  void* out0, void* out1, void* stream) {
    if (rows < 0 || cols < 0 || mode < SPLIT || mode > SPLITKEYS
        || (mode == KEYS && rank_lut == nullptr)
        || (mode != KEYS && out1 == nullptr))
        return cudaErrorInvalidValue;
    const int64_t n = rows * cols;
    const int64_t n_out = mode == KEYS ? n + cols : n;
    if (n_out == 0) return cudaGetLastError();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto aligned = [](const void* p, int64_t a) {
        return reinterpret_cast<uintptr_t>(p) % a == 0;
    };
    // 4 elements a thread: whole quads of both sizes, 16-byte input,
    // 16- or 8-byte and 4-byte outputs
    const bool vec = n % 4 == 0 && n_out % 4 == 0 && aligned(src, 16)
        && aligned(out0, mode == KEYS ? 16 : 8)
        && (mode == KEYS || aligned(out1, 4));
    const int32_t* s = static_cast<const int32_t*>(src);
    const int32_t* lut = static_cast<const int32_t*>(rank_lut);
    uint8_t* o1 = static_cast<uint8_t*>(out1);
    if (mode == SPLIT) launch<SPLIT>(vec, s, n, n_out, lut, out0, o1, st);
    else if (mode == KEYS) launch<KEYS>(vec, s, n, n_out, lut, out0, o1, st);
    else launch<SPLITKEYS>(vec, s, n, n_out, lut, out0, o1, st);
    return cudaGetLastError();
}
