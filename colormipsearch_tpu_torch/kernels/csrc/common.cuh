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

inline int blocks_for(int64_t n, int threads) {
    return static_cast<int>((n + threads - 1) / threads);
}

}  // namespace cmst
