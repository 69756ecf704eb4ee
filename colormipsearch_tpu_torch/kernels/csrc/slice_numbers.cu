// Row 15: z-slice numbers of RGB pixels by the exact integer LUT search.
//
// Replaces colormipsearch_tpu/ops/shape_score.py `slice_numbers_device`
// (:96). Per pixel (uint8 r, g, b): the >=-tie dominance class with R, G,
// B priority (class 1..6 of SLICE_LUT_RANGES), its primary p and secondary
// s channel, then the first minimum over the class's LUT row of
// |255*s - sec[i]*p| (int32: every in-range LUT entry's dominant channel
// is 255, so this equals the nearest-ratio scan); slice = start[cls] + i +
// 1, and 0 for black.
//
// Bound on the H100: a pixel reads 3 bytes and writes 4. A color depth
// MIP is ~95% black, so over a stack the bytes bound it (3.35 TB/s); a
// dense image is bound by the operations of the search. Design:
//  * a persistent grid (the blocks the card holds at once) walks the
//    pixels, so each block stages the six LUT rows in shared memory once;
//  * 16 pixels a thread: 48 bytes read with the widest loads the base
//    allows (16 bytes when it is 16-byte aligned; 48 is a multiple of
//    16, so every group shares the base's alignment) and 64 bytes written
//    as four 16-byte stores; the n % 16 pixels of the tail one a thread;
//  * black first, by the warp: a scan of the lanes' counts of non-black
//    pixels gives each lane its place in the warp's list of them. A warp
//    whose 512 pixels are all black writes its zeros and moves on. A
//    sparse warp (a CDM's edges) lists its non-black pixels in shared
//    memory and searches them 32 at a time, so no lane idles on a black
//    pixel beside one that is not (a ballot alone would leave the warp
//    running all 16 searches whenever any lane has a pixel at that
//    step); a nearly dense warp searches its lanes' own pixels;
//  * every class row is strictly monotone (ops/shape_score._lut_tables
//    asserts it), so h(i) = dir * (sec[i]*p - 255*s) rises strictly with
//    i for p >= 1 and |h| falls, then rises: a binary search of six
//    fixed steps over the row's true length finds the first i with h(i)
//    >= 0, and the lower of its two neighbours (ties to the lower index)
//    is the first minimum of the 56-step scan it replaces. The rows are
//    staged with dir folded in, at an odd stride, so the threads of a
//    warp that search different classes meet in different banks.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 16;     // pixels a thread
constexpr int MAX_ROW = 63;   // the six-step search reaches index 62
constexpr int STRIDE = 65;    // odd: row c starts in bank c
// a warp with more non-black pixels than this searches them in place
constexpr int DENSE = 32 * GROUP * 3 / 4;

template <int BYTES> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = uint32_t; };
template <> struct Word<2> { using type = uint16_t; };
template <> struct Word<1> { using type = uint8_t; };

struct Lut {
    int32_t rows[6 * STRIDE];  // dir * sec[i], i < len
    int32_t starts[6];
    int32_t lens[6];
    int32_t dirs[6];
};

__device__ __forceinline__ int32_t slice_of(int r, int g, int b,
                                            const Lut& lut) {
    if ((r | g | b) == 0) return 0;
    const int p = max(max(r, g), b);
    const int s = r + g + b - p - min(min(r, g), b);  // the median
    int cls;
    if (r >= g && r >= b) cls = g >= b ? 5 : 6;
    else if (g >= b) cls = r >= b ? 4 : 3;
    else cls = r >= g ? 1 : 2;
    const int32_t* row = lut.rows + (cls - 1) * STRIDE;
    const int len = lut.lens[cls - 1];
    const int target = lut.dirs[cls - 1] * 255 * s;
    // pos: the count of i < len with row[i] * p < target (a prefix)
    int pos = 0;
#pragma unroll
    for (int step = 32; step > 0; step >>= 1) {
        const int q = min(pos + step, len);
        if (row[q - 1] * p < target) pos = q;
    }
    int idx;
    if (pos == 0) idx = 0;
    else if (pos == len) idx = len - 1;
    else idx = target - row[pos - 1] * p <= row[pos] * p - target
        ? pos - 1 : pos;
    return lut.starts[cls - 1] + idx + 1;
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t* w, int k) {
    return (w[k >> 2] >> (8 * (k & 3))) & 0xFF;
}

template <int LW>
__global__ void __launch_bounds__(THREADS)
slice_numbers_kernel(const uint8_t* __restrict__ rgb, int64_t n,
                     const int32_t* __restrict__ rows,
                     const int32_t* __restrict__ starts,
                     const int32_t* __restrict__ lens, int row_len,
                     int32_t* __restrict__ out) {
    using W = typename Word<LW>::type;
    __shared__ Lut lut;
    // a warp's non-black pixels (r | g << 8 | b << 16), then their slices
    __shared__ uint32_t lists[THREADS / 32][33 * GROUP];
    if (threadIdx.x < 6) {
        const int c = threadIdx.x;
        const int32_t* src = rows + c * row_len;
        lut.starts[c] = starts[c];
        lut.lens[c] = lens[c];
        lut.dirs[c] = lens[c] > 1 && src[1] < src[0] ? -1 : 1;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 6 * MAX_ROW; i += blockDim.x) {
        const int c = i / MAX_ROW, k = i % MAX_ROW;
        if (k < lut.lens[c])
            lut.rows[c * STRIDE + k] = lut.dirs[c] * rows[c * row_len + k];
    }
    __syncthreads();

    const int64_t n_groups = n / GROUP;
    const int lane = threadIdx.x % 32;
    const int64_t warp = (blockIdx.x * static_cast<int64_t>(blockDim.x)
                          + threadIdx.x) / 32;
    const int64_t warps = gridDim.x * static_cast<int64_t>(blockDim.x) / 32;
    uint32_t* list = lists[threadIdx.x / 32];
    // warp-uniform trip count, so every lane reaches the shuffles
    for (int64_t g0 = warp * 32; g0 < n_groups; g0 += warps * 32) {
        const int64_t g = g0 + lane;
        const bool valid = g < n_groups;
        __align__(16) uint32_t w[12] = {};
        if (valid) {
            const W* src = reinterpret_cast<const W*>(rgb + g * 3 * GROUP);
            W* dst = reinterpret_cast<W*>(w);
#pragma unroll
            for (int q = 0; q < 48 / LW; ++q) dst[q] = src[q];
        }
        // the lane's non-black pixels, and their place in the warp's list
        uint32_t px[GROUP];
        uint32_t live = 0;
#pragma unroll
        for (int i = 0; i < GROUP; ++i) {
            px[i] = byte_of(w, 3 * i) | byte_of(w, 3 * i + 1) << 8
                | byte_of(w, 3 * i + 2) << 16;
            live |= static_cast<uint32_t>(px[i] != 0) << i;
        }
        const int count = __popc(live);
        int end = count;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(0xFFFFFFFFu, end, d);
            if (lane >= d) end += v;
        }
        const int total = __shfl_sync(0xFFFFFFFFu, end, 31);
        uint4* o = reinterpret_cast<uint4*>(out + g * GROUP);
        if (total == 0) {  // 512 black pixels: zeros, no search
            if (valid) {
#pragma unroll
                for (int q = 0; q < 4; ++q) o[q] = make_uint4(0, 0, 0, 0);
            }
            continue;
        }
        int32_t res[GROUP];
        if (total > DENSE) {
            // a nearly dense warp: each lane searches its own pixels
#pragma unroll
            for (int i = 0; i < GROUP; ++i)
                res[i] = slice_of(px[i] & 0xFF, px[i] >> 8 & 0xFF,
                                  px[i] >> 16, lut);
        } else {
            // the warp's non-black pixels, listed in order (entry j at
            // j + j / 32: lanes writing entries 16 apart meet no bank
            // twice), searched 32 at a time, then read back in order
            int at = end - count;
#pragma unroll
            for (int i = 0; i < GROUP; ++i)
                if (live >> i & 1) {
                    list[at + (at >> 5)] = px[i];
                    ++at;
                }
            __syncwarp();
            for (int j = lane; j < total; j += 32) {
                const uint32_t v = list[j + (j >> 5)];
                list[j + (j >> 5)] = slice_of(v & 0xFF, v >> 8 & 0xFF,
                                              v >> 16, lut);
            }
            __syncwarp();
            at = end - count;
#pragma unroll
            for (int i = 0; i < GROUP; ++i) {
                res[i] = 0;
                if (live >> i & 1) {
                    res[i] = static_cast<int32_t>(list[at + (at >> 5)]);
                    ++at;
                }
            }
            __syncwarp();  // read before the next group writes the list
        }
        if (valid) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
                o[q] = make_uint4(res[4 * q], res[4 * q + 1],
                                  res[4 * q + 2], res[4 * q + 3]);
        }
    }
    // the tail: n % 16 pixels, one a thread of the first block
    const int64_t i = n_groups * GROUP + threadIdx.x;
    if (blockIdx.x == 0 && i < n)
        out[i] = slice_of(rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2], lut);
}

template <int LW>
cudaError_t launch_as(const uint8_t* rgb, int64_t n, const int32_t* rows,
                      const int32_t* starts, const int32_t* lens,
                      int row_len, int32_t* out, cudaStream_t st) {
    auto kernel = slice_numbers_kernel<LW>;
    static int resident_on[cmst::MAX_DEVICES] = {};
    int resident = 0;
    cudaError_t err = cmst::resident_blocks(kernel, THREADS, 0, resident_on,
                                            resident);
    if (err != cudaSuccess) return err;
    const int64_t need = std::max<int64_t>(
        cmst::blocks_for((n / GROUP + 31) / 32 * 32, THREADS), 1);
    kernel<<<static_cast<unsigned>(std::min<int64_t>(need, resident)),
             THREADS, 0, st>>>(rgb, n, rows, starts, lens, row_len, out);
    return cudaGetLastError();
}

}  // namespace

// rgb uint8 [n, 3]; rows int32 [6, row_len] (secondaries, each strictly
// monotone over its first lens[c] entries, padded after them); starts
// int32 [6]; lens int32 [6] (1..row_len) -> out int32 [n], 16-byte
// aligned.
extern "C" int cmst_slice_numbers(const void* rgb, int64_t n,
                                  const void* rows, const void* starts,
                                  const void* lens, int row_len, void* out,
                                  void* stream) {
    if (row_len < 1 || row_len > MAX_ROW || n < 0)
        return cudaErrorInvalidValue;
    if (n == 0) return cudaGetLastError();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint8_t* src = static_cast<const uint8_t*>(rgb);
    const int32_t* r = static_cast<const int32_t*>(rows);
    const int32_t* s = static_cast<const int32_t*>(starts);
    const int32_t* l = static_cast<const int32_t*>(lens);
    int32_t* o = static_cast<int32_t*>(out);
    if (reinterpret_cast<uintptr_t>(o) % 16) return cudaErrorInvalidValue;
    switch (cmst::widest(reinterpret_cast<uintptr_t>(src), 48)) {
        case 16: return launch_as<16>(src, n, r, s, l, row_len, o, st);
        case 8: return launch_as<8>(src, n, r, s, l, row_len, o, st);
        case 4: return launch_as<4>(src, n, r, s, l, row_len, o, st);
        case 2: return launch_as<2>(src, n, r, s, l, row_len, o, st);
        default: return launch_as<1>(src, n, r, s, l, row_len, o, st);
    }
}
