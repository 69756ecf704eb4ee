// K2: positional wire form -> per-lane interval tables; and its qkey
// mode (row 13 of the kernel table): the factored wire form -> the same
// tables.
//
// K2 replaces colormipsearch_tpu/ops/pixel_match.py
// `expand_union_tables_from_pos` (+ its `_map_vmap_chunks` batching); the
// qkey mode replaces `expand_union_tables` (:1633), which is K2 without
// the positional derivation: qk = key_list[b, qidx[b, l, u]], then one
// row of (tab_lo[0], tab_lo[1], tab_span[0], tab_span[1])[qk]. The qkey
// mode is one launch on K2's grid (a thread owns one element of one mask
// and loops over the lanes): it reads 4 bytes of qidx and writes 16
// bytes of tables per (lane, element), coalesced along u, and its
// gathers hit L2 (the key lists and the 1.8 MB tables), so it is bound
// by bytes like K2.
//
// K2, per mask b: every (lane (dx, dy), union element u) reads query pixel
// src = u - dx - dy*w, finds its row in the mask's query-pixel list
// q_pos (the inactive key slot KL-1 where src is no query pixel or the
// shift leaves the image), takes its key from key_list, and gathers
// that key's two (lo, span) interval windows from the shared
// per-tolerance tables into lane_lo / lane_span [B, L, 2, U].
//
// Bound on the H100: writing the tables, 16*B*L*U bytes, coalesced
// along u, plus reading u_pos, q_pos and the key lists once. The design
// is one launch and no scratch: a block of EXPAND_THREADS threads owns
// EXPAND_THREADS union elements of one mask and LANES_PER_BLOCK lanes,
// so u, ux and uy are loaded and derived once for those lanes. q_pos
// rises (np.flatnonzero's order, pads = P last), so the row of src is
// found by search, not through a [P+1] map: the block stages every 32nd
// entry of q_pos in shared memory (at most 2,048 entries, 8 KB), narrows
// src there to one 32-entry (128-byte) segment, and finishes with a
// search in that segment, which L2 holds. The launcher sorts the lanes by
// (dy, dx), so a thread's next lane reads a pixel a few columns on: it
// follows the last lane's bound a few steps instead of searching again.
// The lane offsets come by value in the launch's parameters (no copy to
// the card per call), and every index is 32-bit (the launcher refuses
// outputs of 2^31 elements). u_pos needs no order.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int EXPAND_THREADS = 256;
constexpr int SAMPLE_STEP = 32;       // q_pos entries per staged sample
constexpr int MAX_SAMPLES = 2048;     // n_q < 65,535 = 2,048 * 32
constexpr int MAX_LANES = 256;
constexpr int LANES_PER_BLOCK = 3;    // lanes a thread computes

// The lanes in the order a thread visits them, sorted by (dy, dx) so
// that neighbouring lanes read neighbouring query pixels, and the lane
// slot j of the output each one fills.
struct LaneOffsets {
    int32_t dx[MAX_LANES];
    int32_t dy[MAX_LANES];
    int32_t slot[MAX_LANES];
};

// Steps that a lower bound in q_pos moves, at most, to follow a src that
// moved this far: q_pos holds distinct pixels.
constexpr int NEAR = 8;

__global__ void __launch_bounds__(EXPAND_THREADS)
expand_kernel(const int32_t* __restrict__ u_pos, int u_stride_b,
              const int32_t* __restrict__ q_pos, int n_q,
              const int32_t* __restrict__ key_list, int n_kl,
              const uint32_t* __restrict__ tab_lo,
              const uint32_t* __restrict__ tab_span, int n_keys,
              const LaneOffsets offs, int n_lanes, int lanes_per_block,
              int n_u, int w, int h, uint32_t* __restrict__ lane_lo,
              uint32_t* __restrict__ lane_span) {
    __shared__ int32_t sample[MAX_SAMPLES];
    const int b = static_cast<int>(blockIdx.z);
    const int32_t* qp = q_pos + b * n_q;
    const int n_s = (n_q + SAMPLE_STEP - 1) / SAMPLE_STEP;
    for (int k = threadIdx.x; k < n_s; k += EXPAND_THREADS)
        sample[k] = qp[k * SAMPLE_STEP];
    __syncthreads();
    const int u_idx = blockIdx.x * EXPAND_THREADS + threadIdx.x;
    if (u_idx >= n_u) return;
    const int n_px = w * h;
    const int u = u_pos[b * u_stride_b + u_idx];   // sentinel = n_px
    const int ux = u % w;
    const int uy = u / w;
    const int32_t* kl = key_list + b * n_kl;
    uint32_t* lo_out = lane_lo + b * n_lanes * 2 * n_u + u_idx;
    uint32_t* span_out = lane_span + b * n_lanes * 2 * n_u + u_idx;
    const int j0 = static_cast<int>(blockIdx.y) * lanes_per_block;
    const int j_end = min(n_lanes, j0 + lanes_per_block);
    // a = the lower bound of prev in q_pos (valid once prev >= 0)
    int a = 0, prev = -1;
    for (int jj = j0; jj < j_end; ++jj) {
        const int dx = offs.dx[jj], dy = offs.dy[jj];
        const int qx = ux - dx;
        const int qy = uy - dy;
        int row = n_kl - 1;
        if (u < n_px && qx >= 0 && qx < w && qy >= 0 && qy < h) {
            const int src = u - dx - dy * w;
            if (prev >= 0 && src - prev <= NEAR && prev - src <= NEAR) {
                // follow src from the last lane's bound
                while (a < n_q && qp[a] < src) ++a;
                while (a > 0 && qp[a - 1] >= src) --a;
            } else {
                // the last sample <= src, then its segment
                int lo = 0, hi = n_s;
                while (lo < hi) {
                    const int mid = (lo + hi) >> 1;
                    if (sample[mid] <= src) lo = mid + 1; else hi = mid;
                }
                a = 0;
                if (lo > 0) {
                    a = (lo - 1) * SAMPLE_STEP;
                    int e = min(n_q, a + SAMPLE_STEP);
                    while (a < e) {
                        const int mid = (a + e) >> 1;
                        if (qp[mid] < src) a = mid + 1; else e = mid;
                    }
                }
            }
            prev = src;
            if (a < n_q && qp[a] == src) row = a;
        }
        int key = kl[row];
        key = key < 0 ? 0 : (key >= n_keys ? n_keys - 1 : key);
        const int o = offs.slot[jj] * 2 * n_u;
        lo_out[o] = tab_lo[key];
        lo_out[o + n_u] = tab_lo[n_keys + key];
        span_out[o] = tab_span[key];
        span_out[o + n_u] = tab_span[n_keys + key];
    }
}

// qkey mode: qidx int32 [batch, n_lanes, n_u] (the uint16 indices,
// widened), key_list int32 [batch, n_kl]; out-of-range indices and keys
// are clamped, as the gathers of the JAX function clamp them. One
// thread per (mask, lane, element), 32-bit indices.
__global__ void __launch_bounds__(EXPAND_THREADS)
expand_qkeys_kernel(const int32_t* __restrict__ qidx,
                    const int32_t* __restrict__ key_list, int n_kl,
                    const uint32_t* __restrict__ tab_lo,
                    const uint32_t* __restrict__ tab_span, int n_keys,
                    int n_lanes, int n_u, uint32_t* __restrict__ lane_lo,
                    uint32_t* __restrict__ lane_span) {
    const int b = static_cast<int>(blockIdx.z);
    const int j = static_cast<int>(blockIdx.y);
    const int u_idx = blockIdx.x * EXPAND_THREADS + threadIdx.x;
    if (u_idx >= n_u) return;
    int row = qidx[(b * n_lanes + j) * n_u + u_idx];
    row = row < 0 ? 0 : (row >= n_kl ? n_kl - 1 : row);
    int key = key_list[b * n_kl + row];
    key = key < 0 ? 0 : (key >= n_keys ? n_keys - 1 : key);
    const int o = (b * n_lanes + j) * 2 * n_u + u_idx;
    lane_lo[o] = tab_lo[key];
    lane_lo[o + n_u] = tab_lo[n_keys + key];
    lane_span[o] = tab_span[key];
    lane_span[o + n_u] = tab_span[n_keys + key];
}

// The outputs' element count, and every index the kernels form, fit in
// an int.
bool fits_int(int64_t batch, int64_t n_lanes, int64_t n_u, int64_t other) {
    const int64_t lim = int64_t{1} << 31;
    return batch >= 0 && n_lanes >= 0 && n_u >= 0
        && batch * n_lanes * 2 * n_u < lim && other < lim;
}

}  // namespace

// Row 13: (qidx, key_list) -> lane_lo / lane_span uint32 [batch, n_lanes,
// 2, n_u].
extern "C" int cmst_expand_qkeys(const void* qidx, const void* key_list,
                                 int64_t n_kl, const void* tab_lo,
                                 const void* tab_span, int64_t n_keys,
                                 int64_t batch, int64_t n_lanes, int64_t n_u,
                                 void* lane_lo, void* lane_span,
                                 void* stream) {
    if (n_kl < 1 || n_keys < 1 || batch > 65535 || n_lanes > 65535
        || !fits_int(batch, n_lanes, n_u,
                     std::max(batch * n_kl, 2 * n_keys)))
        return cudaErrorInvalidValue;
    if (batch * n_lanes * n_u > 0) {
        const dim3 grid((n_u + EXPAND_THREADS - 1) / EXPAND_THREADS, n_lanes,
                        batch);
        expand_qkeys_kernel<<<grid, EXPAND_THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int32_t*>(qidx),
            static_cast<const int32_t*>(key_list), n_kl,
            static_cast<const uint32_t*>(tab_lo),
            static_cast<const uint32_t*>(tab_span), n_keys, n_lanes, n_u,
            static_cast<uint32_t*>(lane_lo),
            static_cast<uint32_t*>(lane_span));
    }
    return cudaGetLastError();
}

// K2: offsets is a HOST array of n_lanes (dx, dy) pairs; it travels in
// the launch's parameters. q_pos [batch, n_q] must rise within each mask
// (pads = w*h last).
extern "C" int cmst_expand_tables(const void* u_pos, int64_t u_stride_b,
                                  const void* q_pos, int64_t n_q,
                                  const void* key_list, int64_t n_kl,
                                  const void* tab_lo, const void* tab_span,
                                  int64_t n_keys, const void* offsets,
                                  int64_t batch, int64_t n_lanes,
                                  int64_t n_u, int32_t w, int32_t h,
                                  void* lane_lo, void* lane_span,
                                  void* stream) {
    if (n_kl != n_q + 1 || n_q > MAX_SAMPLES * SAMPLE_STEP || n_keys < 1
        || n_lanes > MAX_LANES || batch > 65535 || w < 1 || h < 1
        || !fits_int(batch, n_lanes, n_u,
                     std::max({batch * u_stride_b, batch * n_kl,
                               2 * n_keys,
                               static_cast<int64_t>(w) * h + 1})))
        return cudaErrorInvalidValue;
    LaneOffsets offs;
    const int32_t* host = static_cast<const int32_t*>(offsets);
    int order[MAX_LANES];
    for (int j = 0; j < n_lanes; ++j) order[j] = j;
    std::sort(order, order + n_lanes, [host](int x, int y) {
        return host[2 * x + 1] != host[2 * y + 1]
            ? host[2 * x + 1] < host[2 * y + 1] : host[2 * x] < host[2 * y];
    });
    for (int jj = 0; jj < n_lanes; ++jj) {
        offs.dx[jj] = host[2 * order[jj]];
        offs.dy[jj] = host[2 * order[jj] + 1];
        offs.slot[jj] = order[jj];
    }
    const int lpb = LANES_PER_BLOCK;
    if (batch * n_lanes * n_u > 0) {
        const dim3 grid((n_u + EXPAND_THREADS - 1) / EXPAND_THREADS,
                        (n_lanes + lpb - 1) / lpb, batch);
        expand_kernel<<<grid, EXPAND_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int32_t*>(u_pos), u_stride_b,
            static_cast<const int32_t*>(q_pos), n_q,
            static_cast<const int32_t*>(key_list), n_kl,
            static_cast<const uint32_t*>(tab_lo),
            static_cast<const uint32_t*>(tab_span), n_keys, offs, n_lanes,
            lpb, n_u, w, h, static_cast<uint32_t*>(lane_lo),
            static_cast<uint32_t*>(lane_span));
    }
    return cudaGetLastError();
}
