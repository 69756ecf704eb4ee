// Shared helpers of the pixel-match kernels.
//
// Every C entry point launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch (too many threads, too much shared memory).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cmst {

// Rank-key layout of ops/common.py: key = (cls << KEY_RANK_BITS) | rank.
constexpr int KEY_RANK_BITS = 15;

// Strict-dominance classification of one RGB pixel (the oracle's
// classify_rgb): class id 1..6 with secondary s and primary p channel,
// or class 0 with s = p = 0 when no channel strictly dominates.
__device__ __forceinline__ void classify(int r, int g, int b, int& cls,
                                         int& s, int& p) {
    cls = 0;
    s = 0;
    p = 0;
    if (b > r && b > g) {
        p = b;
        if (r > g) { cls = 1; s = r; } else { cls = 2; s = g; }
    } else if (g > b && g > r) {
        p = g;
        if (b > r) { cls = 3; s = b; } else { cls = 4; s = r; }
    } else if (r > b && r > g) {
        p = r;
        if (g > b) { cls = 5; s = g; } else { cls = 6; s = b; }
    }
}

// A kernel's launch set-up (a raised shared-memory limit, its resident
// blocks) holds for one device: caches of it are kept per device, and
// past MAX_DEVICES it is redone on every launch.
constexpr int MAX_DEVICES = 64;

inline int current_device() {
    int dev = 0;
    cudaGetDevice(&dev);
    return dev;
}

inline int blocks_for(int64_t n, int threads) {
    return static_cast<int>((n + threads - 1) / threads);
}

// The widest of 16, 8, 4, 2, 1 bytes that divides both values (a pitch
// and a base address): the access width a launch can take.
inline int widest(int64_t a, int64_t b) {
    for (int w = 16; w > 1; w >>= 1)
        if (a % w == 0 && b % w == 0) return w;
    return 1;
}

// The blocks of `kernel` (at `threads` a block and `smem` bytes of
// dynamic shared memory, the kernel's limit raised to it) that the
// current device holds at once, the grid of a persistent kernel; cached
// per device in `cache`, one static array for each kernel instance.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem,
                            int (&cache)[MAX_DEVICES], int& resident) {
    const int dev = current_device();
    if (dev < MAX_DEVICES && cache[dev] > 0) {
        resident = cache[dev];
        return cudaSuccess;
    }
    cudaError_t err = smem == 0 ? cudaSuccess : cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, threads, smem);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return err;
    resident = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
    if (dev < MAX_DEVICES) cache[dev] = resident;
    return cudaSuccess;
}

namespace {

// The variant reduction of reduce_variants_device (the JAX package's
// ops/pixel_match.py:576) over per-variant counts int32 [B, V, T]:
// best = max(straight max, mirror max), mirrored = mirror max >
// straight max (strictly), pair_flags = the flag counts summed over all
// V variants (FLAGS only). One thread per (mask, column).
template <bool FLAGS>
__global__ void reduce_variants_kernel(const int32_t* __restrict__ match,
                                       const int32_t* __restrict__ flag,
                                       int batch, int n_var, int n_straight,
                                       int64_t n_cols,
                                       int32_t* __restrict__ best,
                                       uint8_t* __restrict__ mirrored,
                                       int32_t* __restrict__ pair_flags) {
    const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x)
        + threadIdx.x;
    if (i >= batch * n_cols) return;
    const int64_t b = i / n_cols;
    const int64_t t = i - b * n_cols;
    const int64_t base = b * n_var * n_cols + t;
    int straight = match[base];
    int mirror = 0;
    int flags = FLAGS ? flag[base] : 0;
    for (int v = 1; v < n_var; ++v) {
        const int c = match[base + v * n_cols];
        if (v < n_straight) straight = max(straight, c);
        else mirror = v == n_straight ? c : max(mirror, c);
        if (FLAGS) flags += flag[base + v * n_cols];
    }
    const bool has_mirror = n_var > n_straight;
    best[i] = has_mirror ? max(straight, mirror) : straight;
    mirrored[i] = has_mirror && mirror > straight;
    if (FLAGS) pair_flags[i] = flags;
}

}  // namespace

}  // namespace cmst
