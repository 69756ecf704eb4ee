// K1: sparse rank-key plane pack.
//
// Replaces colormipsearch_tpu/ops/common.py `_scatter_key_chunk`
// (driven by `pack_target_planes_keys_sparse`): every foreground pixel
// of a target shard arrives as a COO element (pixel position, RGB),
// target-major; the kernel classifies it, looks its hue ratio up in the
// rank LUT, recovers its target column by binary search over the
// cumulative per-target counts, and stores the key into the zeroed
// int32 [P+1, T_pad] planes (row P stays the all-zero sentinel).
//
// Bound on the H100: the scattered 4-byte stores. Consecutive elements
// belong to the same target (one column) at increasing pixel rows, so
// neighbouring threads store to addresses T_pad*4 bytes apart — one
// 32-byte sector per store, ~N*32 bytes of write traffic for N elements
// (about 2.7 GB for a 2,048-target shard at 6% foreground) plus the
// 4*(P+1)*T_pad-byte memset. The design keeps everything else off the
// memory path: the 256 KB rank LUT and the T_pad-entry `cum` array are
// read through L2, and one thread owns one element, so there is no
// atomic and no second pass. Offsets are 64-bit: (P+1)*T_pad exceeds
// 2^31 at production shapes.
#include "common.cuh"

namespace {

__global__ void scatter_keys_kernel(int32_t* __restrict__ planes,
                                    const int32_t* __restrict__ pos,
                                    const uint8_t* __restrict__ rgb,
                                    const int64_t* __restrict__ cum,
                                    const int32_t* __restrict__ rank_lut,
                                    int64_t n, int64_t t_pad) {
    const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x)
        + threadIdx.x;
    if (i >= n) return;
    int cls, s, p;
    cmst::classify(rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2], cls, s, p);
    const int32_t key = cls > 0
        ? ((cls << cmst::KEY_RANK_BITS) | rank_lut[(s << 8) | p]) : 0;
    // searchsorted(cum, i, side="right"): the first column whose
    // cumulative count exceeds the element's global index
    int64_t lo = 0, hi = t_pad;
    while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (cum[mid] <= i) lo = mid + 1; else hi = mid;
    }
    const int64_t t = lo < t_pad - 1 ? lo : t_pad - 1;
    planes[static_cast<int64_t>(pos[i]) * t_pad + t] = key;
}

}  // namespace

extern "C" int cmst_scatter_keys(void* planes, const void* pos,
                                 const void* rgb, const void* cum,
                                 const void* rank_lut, int64_t n,
                                 int64_t n_rows, int64_t t_pad,
                                 void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(
        planes, 0, static_cast<size_t>(n_rows) * t_pad * sizeof(int32_t),
        st);
    if (err != cudaSuccess) return err;
    if (n > 0) {
        constexpr int threads = 256;
        scatter_keys_kernel<<<cmst::blocks_for(n, threads), threads, 0,
                              st>>>(
            static_cast<int32_t*>(planes),
            static_cast<const int32_t*>(pos),
            static_cast<const uint8_t*>(rgb),
            static_cast<const int64_t*>(cum),
            static_cast<const int32_t*>(rank_lut), n, t_pad);
    }
    return cudaGetLastError();
}
