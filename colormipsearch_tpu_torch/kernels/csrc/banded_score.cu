// K9 and K11: the banded f32 pixel-match predicate on packed summary
// planes (K9) or on split planes (K11).
//
// K9 replaces colormipsearch_tpu/ops/pixel_match.py
// `score_query_against_planes_raw` + `score_query_batch` +
// `reduce_variants_device` (with `predicate_from_rules`); K11 replaces
// `score_query_against_split_planes_raw` + `score_query_batch_split`
// (row 10 of the kernel table), the same predicate on the split pair
// uint16 (p << 8) | s and uint8 cls (threshold always folded: no maxch
// test). The two differ only in the plane loader, a template argument;
// everything after the load is one code. For mask b,
// variant v and target column t it counts the query pixels q whose
// target pixel planes[pos[b, v, q], t] matches (the match count) and
// those whose verdict lies in the ambiguity band (the flag count, the
// pairs the float64 oracle rescores); pos < 0 skips the element. The
// per-query-pixel rules (query_side_rules) are computed by the caller
// with torch and arrive as arrays; the kernel evaluates the
// [elements]-shaped half of the predicate in the JAX package's f32
// operation order.
//
// Exactness: every f32 operation of the predicate is written with an
// explicitly rounded intrinsic (__fmul_rn, __fsub_rn, __fdiv_rn,
// __fmaf_rn), so nvcc contracts nothing on its own. The rounding follows
// what XLA compiles the JAX function to: the adjacent-class test's
// g = ts - bound * tp decides the match by its sign with the product
// rounded on its own (`ts <= bound * tp`), and the flag by |g| taken
// from one fused multiply-add; an FMA in one place more or less moves
// verdicts and flags at the band's edge. So the counts equal the plain
// version's (and the JAX function's) bit for bit. Never build with
// -use_fast_math.
//
// Bound on the H100: one 4-byte gather (K11: a 2-byte and a 1-byte
// gather) and ~25 integer and f32 operations per (mask, variant, query
// pixel, column) element, 6e9 elements for 8 masks x 18 variants x 20,480
// padded query pixels x 2,048 columns; most of the operations are integer
// compares and selects, which issue at a quarter of the f32 FMA rate.
//
// The first design (one column a thread, one block per (column block,
// query chunk, mask x variant), ~92k blocks) filled the card but paid per
// element ~10 shared-memory loads for the query pixel's rules against one
// global gather, and 47M int32 atomics (~80 per output word). Three
// changes were measured on the H100, alone and together (PERF.md): C
// columns a thread, every variant of a query chunk in one block, and
// several query chunks a block. Only the first paid: looping the variants
// in a block costs registers and so occupancy, and more than one chunk a
// block serialises its staging. So a thread now takes COLS = 4 adjacent
// columns, read with one vector load (int4; K11 a uint2 + uint32) when the
// column count and the planes' alignment allow it and one by one
// otherwise, and every rule read from shared memory serves 4 elements. The
// grid is (column block, query chunk, mask x variant); each thread keeps
// 2 x COLS counts in registers and adds them into the zeroed [2, B, V, T]
// scratch with int32 atomics at the end. Integer addition is order-free,
// so the result is exact and deterministic. A second small pass reduces
// over the variants.
#include "common.cuh"

namespace {

constexpr int QC = 256;       // query pixels staged per chunk
constexpr int THREADS = 128;  // threads per block (COLS columns each)
constexpr int COLS = 4;       // adjacent target columns a thread

// Loaders read the planes through the read-only cache (__ldg): load
// gathers COLS consecutive columns (a vector load when `vec`, else one by
// one, columns past the edge 0) into packed words, decode unpacks one.

// K9's loader: one int32 summary word (cls << 24) | (p << 16) | (s << 8)
// | maxch; valid unless the threshold is tested here (not FOLDED)
struct SummaryPlanes {
    const int32_t* planes;
    int thr;
    __device__ __forceinline__ void load(int64_t i, bool vec, int64_t left,
                                         uint32_t (&w)[COLS]) const {
        if (vec) {
            const int4 x = __ldg(reinterpret_cast<const int4*>(planes + i));
            w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
            return;
        }
#pragma unroll
        for (int c = 0; c < COLS; ++c)
            w[c] = c < left ? __ldg(planes + i + c) : 0;
    }
    template <bool FOLDED>
    __device__ __forceinline__ bool decode(uint32_t v, int& t_cls, int& t_s,
                                           int& t_p) const {
        t_cls = (v >> 24) & 0x7;
        t_s = (v >> 8) & 0xFF;
        t_p = (v >> 16) & 0xFF;
        return FOLDED || static_cast<int>(v & 0xFF) > thr;
    }
};

// K11's loader: the split pair, the threshold folded into it; the class
// byte is taken as it is, as the JAX function takes it. Packed word:
// (cls << 16) | (p << 8) | s.
struct SplitPlanes {
    const uint16_t* sp;
    const uint8_t* c8;
    __device__ __forceinline__ void load(int64_t i, bool vec, int64_t left,
                                         uint32_t (&w)[COLS]) const {
        if (vec) {
            const uint2 x = __ldg(reinterpret_cast<const uint2*>(sp + i));
            const uint32_t c = __ldg(reinterpret_cast<const uint32_t*>(
                c8 + i));
            w[0] = (x.x & 0xFFFF) | ((c & 0xFF) << 16);
            w[1] = (x.x >> 16) | (((c >> 8) & 0xFF) << 16);
            w[2] = (x.y & 0xFFFF) | (((c >> 16) & 0xFF) << 16);
            w[3] = (x.y >> 16) | ((c >> 24) << 16);
            return;
        }
#pragma unroll
        for (int c = 0; c < COLS; ++c)
            w[c] = c < left ? (__ldg(sp + i + c)
                               | (static_cast<uint32_t>(__ldg(c8 + i + c))
                                  << 16))
                            : 0;
    }
    template <bool FOLDED>
    __device__ __forceinline__ bool decode(uint32_t v, int& t_cls, int& t_s,
                                           int& t_p) const {
        t_cls = v >> 16;
        t_s = v & 0xFF;
        t_p = (v >> 8) & 0xFF;
        return true;
    }
};

// one element's verdicts: the query pixel's rules against a target pixel
template <bool EXACT_SAME>
__device__ __forceinline__ void predicate(
        int t_cls, int t_s, int t_p, int q_same, float a, float bq,
        float aq, int4 tcb, int up, float ztol, float band, bool& match,
        bool& flag) {
    const float ts_f = static_cast<float>(t_s);
    const float tp_f = static_cast<float>(t_p);
    const bool same = q_same == t_cls && t_s >= 1;
    bool m_same, f_same;
    if (EXACT_SAME) {
        // every product < 2^24: exact in f32, as in the JAX package
        const float lhs = fabsf(__fsub_rn(__fmul_rn(a, tp_f),
                                          __fmul_rn(ts_f, bq)));
        const float rhs = __fmul_rn(aq, tp_f);
        m_same = same && lhs <= rhs;
        f_same = same && lhs == rhs;
    } else {
        const float t_r32 = __fdiv_rn(ts_f, fmaxf(tp_f, 1.0f));
        const float gap = fabsf(__fsub_rn(t_r32, a));
        m_same = same && gap <= ztol;
        f_same = same && fabsf(__fsub_rn(gap, ztol)) < band;
    }
    // the two rule slots target distinct classes: at most one fires
    const bool sel0 = t_cls == tcb.x;
    const bool sel1 = t_cls == tcb.y;
    const bool sel = (sel0 || sel1) && t_cls > 0;
    const float bound_sel = __int_as_float(sel0 ? tcb.z : tcb.w);
    const bool upper_sel = sel0 ? (up & 1) : (up >> 1);
    // g = ts - bound * tp: its sign with the product rounded on its own,
    // its magnitude as one fused multiply-add (see above)
    const bool m_adj = sel
        && ((ts_f <= __fmul_rn(bound_sel, tp_f)) == upper_sel);
    const float g = __fmaf_rn(-bound_sel, tp_f, ts_f);
    const bool f_adj = sel && fabsf(g) < __fmul_rn(band, tp_f);
    match = m_same || m_adj;
    flag = f_same || f_adj;
}

struct Rules {
    const int32_t* same_cls;
    const float* bq_s;
    const float* bq_p;
    const float* a_qp;
    const float* q_r;
    const int32_t* tc;
    const float* bound;
    const uint8_t* upper;
    int64_t stride;  // between the two rule slots: batch * n_q
};

template <bool EXACT_SAME, bool FOLDED, class Planes>
__global__ void __launch_bounds__(THREADS) banded_score_kernel(
        const Planes planes, int64_t n_cols, bool vec,
        const int32_t* __restrict__ pos, int n_var, int n_q, const Rules r,
        float ztol, float band, int32_t* __restrict__ match_out,
        int32_t* __restrict__ flag_out) {
    __shared__ int32_t s_pos[QC];
    __shared__ float4 s_q[QC];   // (bq_s or q_r, bq_p, a_qp, same_cls)
    __shared__ int4 s_tcb[QC];   // (tc0, tc1, bound0, bound1 bits)
    __shared__ int s_up[QC];     // upper0 | upper1 << 1

    const int bv = blockIdx.z;   // mask x variant
    const int b = bv / n_var;
    const int q0 = blockIdx.y * QC;
    const int n = min(QC, n_q - q0);
    const int64_t qb = static_cast<int64_t>(b) * n_q + q0;
    for (int k = threadIdx.x; k < n; k += THREADS) {
        s_q[k] = make_float4(EXACT_SAME ? r.bq_s[qb + k] : r.q_r[qb + k],
                             EXACT_SAME ? r.bq_p[qb + k] : 0.0f,
                             EXACT_SAME ? r.a_qp[qb + k] : 0.0f,
                             __int_as_float(r.same_cls[qb + k]));
        s_tcb[k] = make_int4(r.tc[qb + k], r.tc[r.stride + qb + k],
                             __float_as_int(r.bound[qb + k]),
                             __float_as_int(r.bound[r.stride + qb + k]));
        s_up[k] = (r.upper[qb + k] != 0)
            | ((r.upper[r.stride + qb + k] != 0) << 1);
        s_pos[k] = pos[static_cast<int64_t>(bv) * n_q + q0 + k];
    }
    __syncthreads();
    const int64_t t0 = (blockIdx.x * static_cast<int64_t>(THREADS)
                        + threadIdx.x) * COLS;
    if (t0 >= n_cols) return;
    const int64_t left = n_cols - t0;

    int n_match[COLS] = {}, n_flag[COLS] = {};
    for (int k = 0; k < n; ++k) {
        const int p = s_pos[k];
        if (p < 0) continue;
        const float4 q = s_q[k];
        const int4 tcb = s_tcb[k];
        const int up = s_up[k];
        const int q_same = __float_as_int(q.w);
        uint32_t w[COLS];
        planes.load(static_cast<int64_t>(p) * n_cols + t0, vec, left, w);
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
            int t_cls, t_s, t_p;
            const bool valid = planes.template decode<FOLDED>(w[c], t_cls,
                                                              t_s, t_p);
            bool m, f;
            predicate<EXACT_SAME>(t_cls, t_s, t_p, q_same, q.x, q.y, q.z,
                                  tcb, up, ztol, band, m, f);
            n_match[c] += valid && m;
            n_flag[c] += valid && f;
        }
    }
    const int64_t out = static_cast<int64_t>(bv) * n_cols + t0;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
        if (c >= left) continue;
        if (n_match[c]) atomicAdd(match_out + out + c, n_match[c]);
        if (n_flag[c]) atomicAdd(flag_out + out + c, n_flag[c]);
    }
}

// the counts into the zeroed scratch, then the variant reduction
template <bool FOLDED, class Planes>
int run(const Planes& planes, int64_t n_cols, bool aligned, const void* pos,
        int batch, int n_var, int n_q, int n_straight, const void* same_cls,
        const void* bq_s, const void* bq_p, const void* a_qp,
        const void* q_r, const void* tc, const void* bound,
        const void* upper, int exact_same, float ztol, float band,
        void* scratch, void* best, void* mirrored, void* pair_flags,
        void* stream) {
    if (n_straight < 1 || n_straight > n_var) return cudaErrorInvalidValue;
    if (batch == 0 || n_cols == 0) return cudaGetLastError();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int32_t* match = static_cast<int32_t*>(scratch);
    int32_t* flag = match + static_cast<int64_t>(batch) * n_var * n_cols;
    if (n_q > 0) {
        const Rules r{static_cast<const int32_t*>(same_cls),
                      static_cast<const float*>(bq_s),
                      static_cast<const float*>(bq_p),
                      static_cast<const float*>(a_qp),
                      static_cast<const float*>(q_r),
                      static_cast<const int32_t*>(tc),
                      static_cast<const float*>(bound),
                      static_cast<const uint8_t*>(upper),
                      static_cast<int64_t>(batch) * n_q};
        const int n_chunks = (n_q + QC - 1) / QC;
        if (static_cast<int64_t>(batch) * n_var > 65535 || n_chunks > 65535)
            return cudaErrorInvalidValue;
        // vector loads need whole groups of COLS columns on 16-byte-aligned
        // planes
        const bool vec = aligned && n_cols % COLS == 0;
        const dim3 grid(static_cast<unsigned>(
                            (n_cols + THREADS * COLS - 1) / (THREADS * COLS)),
                        n_chunks, batch * n_var);
        const int32_t* p = static_cast<const int32_t*>(pos);
        if (exact_same)
            banded_score_kernel<true, FOLDED, Planes><<<grid, THREADS, 0, st>>>(
                planes, n_cols, vec, p, n_var, n_q, r, ztol, band, match,
                flag);
        else
            banded_score_kernel<false, FOLDED, Planes>
                <<<grid, THREADS, 0, st>>>(planes, n_cols, vec, p, n_var, n_q,
                                           r, ztol, band, match, flag);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    constexpr int threads = 256;
    cmst::reduce_variants_kernel<true>
        <<<cmst::blocks_for(static_cast<int64_t>(batch) * n_cols, threads),
           threads, 0, st>>>(match, flag, batch, n_var, n_straight, n_cols,
                             static_cast<int32_t*>(best),
                             static_cast<uint8_t*>(mirrored),
                             static_cast<int32_t*>(pair_flags));
    return cudaGetLastError();
}

}  // namespace

// K9: planes int32 [P, n_cols] (summary words); pos int32 [batch, n_var,
// n_q]; same_cls int32, bq_s / bq_p / a_qp / q_r f32 [batch, n_q]; tc
// int32, bound f32, upper uint8 [2, batch, n_q]; scratch int32 [2, batch,
// n_var, n_cols], zeroed by the caller -> best int32, mirrored uint8,
// pair_flags int32 [batch, n_cols]. thr < 0: threshold folded.
extern "C" int cmst_banded_score(
        const void* planes, int64_t n_cols, const void* pos, int batch,
        int n_var, int n_q, int n_straight, const void* same_cls,
        const void* bq_s, const void* bq_p, const void* a_qp,
        const void* q_r, const void* tc, const void* bound,
        const void* upper, int exact_same, float ztol, float band, int thr,
        void* scratch, void* best, void* mirrored, void* pair_flags,
        void* stream) {
    const SummaryPlanes p{static_cast<const int32_t*>(planes), thr};
    const bool aligned = reinterpret_cast<uintptr_t>(planes) % 16 == 0;
    auto go = [&](auto run_) {
        return run_(p, n_cols, aligned, pos, batch, n_var, n_q, n_straight,
                    same_cls, bq_s, bq_p, a_qp, q_r, tc, bound, upper,
                    exact_same, ztol, band, scratch, best, mirrored,
                    pair_flags, stream);
    };
    return thr < 0 ? go(run<true, SummaryPlanes>)
                   : go(run<false, SummaryPlanes>);
}

// K11: the split pair sp uint16 and c8 uint8 [P, n_cols] (threshold
// folded); every other argument as cmst_banded_score's.
extern "C" int cmst_banded_score_split(
        const void* sp, const void* c8, int64_t n_cols, const void* pos,
        int batch, int n_var, int n_q, int n_straight, const void* same_cls,
        const void* bq_s, const void* bq_p, const void* a_qp,
        const void* q_r, const void* tc, const void* bound,
        const void* upper, int exact_same, float ztol, float band,
        void* scratch, void* best, void* mirrored, void* pair_flags,
        void* stream) {
    const SplitPlanes p{static_cast<const uint16_t*>(sp),
                        static_cast<const uint8_t*>(c8)};
    const bool aligned = reinterpret_cast<uintptr_t>(sp) % 16 == 0
        && reinterpret_cast<uintptr_t>(c8) % 16 == 0;
    return run<true>(p, n_cols, aligned, pos, batch, n_var, n_q, n_straight,
                     same_cls, bq_s, bq_p, a_qp, q_r, tc, bound, upper,
                     exact_same, ztol, band, scratch, best, mirrored,
                     pair_flags, stream);
}
