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
// gather) and ~25 integer and f32
// operations per (mask, variant, query pixel, column) element, 6e9
// elements for 8 masks x 18 variants x 20,480 padded query pixels x
// 2,048 columns. K3's lesson (one thread walking a whole query serially
// is latency-bound) shapes the grid: blocks split over (column block,
// query chunk, mask x variant), so ~10^5 blocks keep every SM busy; a
// chunk's positions and rules are staged in shared memory (every thread
// reads the same entry: a broadcast), each thread owns one column and
// keeps its two counts in registers, and adds them with int32 atomics
// into a zeroed [B, V, T] scratch. Integer addition is order-free, so
// the result is exact and deterministic. A second small pass reduces
// over the variants.
#include "common.cuh"

namespace {

constexpr int QC = 256;       // query pixels staged per block
constexpr int THREADS = 256;  // columns per block

// Loaders read the planes through the read-only cache (__ldg).

// K9's loader: one int32 summary word (cls << 24) | (p << 16) | (s << 8)
// | maxch; valid unless the threshold is tested here (not FOLDED)
struct SummaryPlanes {
    const int32_t* planes;
    int thr;
    template <bool FOLDED>
    __device__ __forceinline__ bool load(int64_t i, int& t_cls, int& t_s,
                                         int& t_p) const {
        const int v = __ldg(planes + i);
        t_cls = (v >> 24) & 0x7;
        t_s = (v >> 8) & 0xFF;
        t_p = (v >> 16) & 0xFF;
        return FOLDED || (v & 0xFF) > thr;
    }
};

// K11's loader: the split pair, the threshold folded into it; the class
// byte is taken as it is, as the JAX function takes it
struct SplitPlanes {
    const uint16_t* sp;
    const uint8_t* c8;
    template <bool FOLDED>
    __device__ __forceinline__ bool load(int64_t i, int& t_cls, int& t_s,
                                         int& t_p) const {
        const int w = __ldg(sp + i);
        t_cls = __ldg(c8 + i);
        t_s = w & 0xFF;
        t_p = w >> 8;
        return true;
    }
};

template <bool EXACT_SAME, bool FOLDED, class Planes>
__global__ void banded_score_kernel(
        const Planes planes, int64_t n_cols,
        const int32_t* __restrict__ pos, int n_var, int n_q,
        const int32_t* __restrict__ same_cls,
        const float* __restrict__ bq_s, const float* __restrict__ bq_p,
        const float* __restrict__ a_qp, const float* __restrict__ q_r,
        const int32_t* __restrict__ tc, const float* __restrict__ bound,
        const uint8_t* __restrict__ upper, int64_t rule_stride,
        float ztol, float band,
        int32_t* __restrict__ match_out, int32_t* __restrict__ flag_out) {
    __shared__ int32_t s_pos[QC];
    __shared__ int32_t s_same[QC];
    __shared__ float s_a[QC];   // bq_s (exact branch) or q_r (banded)
    __shared__ float s_b[QC];   // bq_p (exact branch)
    __shared__ float s_c[QC];   // a_qp (exact branch)
    __shared__ int32_t s_tc[2][QC];
    __shared__ float s_bound[2][QC];
    __shared__ uint8_t s_up[2][QC];

    const int bv = blockIdx.z;          // b * n_var + v
    const int b = bv / n_var;
    const int q0 = blockIdx.y * QC;
    const int n = min(QC, n_q - q0);
    const int64_t t = blockIdx.x * static_cast<int64_t>(THREADS)
        + threadIdx.x;

    const int64_t qb = static_cast<int64_t>(b) * n_q + q0;
    const int32_t* pos_c = pos + static_cast<int64_t>(bv) * n_q + q0;
    for (int k = threadIdx.x; k < n; k += THREADS) {
        s_pos[k] = pos_c[k];
        s_same[k] = same_cls[qb + k];
        if (EXACT_SAME) {
            s_a[k] = bq_s[qb + k];
            s_b[k] = bq_p[qb + k];
            s_c[k] = a_qp[qb + k];
        } else {
            s_a[k] = q_r[qb + k];
        }
        for (int r = 0; r < 2; ++r) {
            s_tc[r][k] = tc[r * rule_stride + qb + k];
            s_bound[r][k] = bound[r * rule_stride + qb + k];
            s_up[r][k] = upper[r * rule_stride + qb + k];
        }
    }
    __syncthreads();
    if (t >= n_cols) return;

    int n_match = 0;
    int n_flag = 0;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
        const int p = s_pos[k];
        if (p < 0) continue;
        int t_cls, t_s, t_p;
        const bool valid = planes.template load<FOLDED>(
            static_cast<int64_t>(p) * n_cols + t, t_cls, t_s, t_p);
        const float ts_f = static_cast<float>(t_s);
        const float tp_f = static_cast<float>(t_p);

        const bool same = s_same[k] == t_cls && t_s >= 1;
        bool m_same, f_same;
        if (EXACT_SAME) {
            // every product < 2^24: exact in f32, as in the JAX package
            const float lhs = fabsf(__fsub_rn(__fmul_rn(s_a[k], tp_f),
                                              __fmul_rn(ts_f, s_b[k])));
            const float rhs = __fmul_rn(s_c[k], tp_f);
            m_same = same && lhs <= rhs;
            f_same = same && lhs == rhs;
        } else {
            const float t_r32 = __fdiv_rn(ts_f, fmaxf(tp_f, 1.0f));
            const float gap = fabsf(__fsub_rn(t_r32, s_a[k]));
            m_same = same && gap <= ztol;
            f_same = same && fabsf(__fsub_rn(gap, ztol)) < band;
        }
        // the two rule slots target distinct classes: at most one fires
        const bool sel0 = t_cls == s_tc[0][k];
        const bool sel1 = t_cls == s_tc[1][k];
        const bool sel = (sel0 || sel1) && t_cls > 0;
        const float bound_sel = sel0 ? s_bound[0][k] : s_bound[1][k];
        const bool upper_sel = sel0 ? s_up[0][k] : s_up[1][k];
        // g = ts - bound * tp: its sign with the product rounded on its
        // own, its magnitude as one fused multiply-add (see above)
        const bool m_adj = sel
            && ((ts_f <= __fmul_rn(bound_sel, tp_f)) == upper_sel);
        const float g = __fmaf_rn(-bound_sel, tp_f, ts_f);
        const bool f_adj = sel && fabsf(g) < __fmul_rn(band, tp_f);

        n_match += valid && (m_same || m_adj);
        n_flag += valid && (f_same || f_adj);
    }
    const int64_t out = static_cast<int64_t>(bv) * n_cols + t;
    if (n_match) atomicAdd(match_out + out, n_match);
    if (n_flag) atomicAdd(flag_out + out, n_flag);
}

template <bool EXACT_SAME, bool FOLDED, class Planes>
void launch(const dim3& grid, cudaStream_t st, const Planes& planes,
            int64_t n_cols, const int32_t* pos, int n_var, int n_q,
            const int32_t* same_cls, const float* bq_s, const float* bq_p,
            const float* a_qp, const float* q_r, const int32_t* tc,
            const float* bound, const uint8_t* upper, int64_t rule_stride,
            float ztol, float band, int32_t* match, int32_t* flag) {
    banded_score_kernel<EXACT_SAME, FOLDED, Planes>
        <<<grid, THREADS, 0, st>>>(
        planes, n_cols, pos, n_var, n_q, same_cls, bq_s, bq_p, a_qp, q_r,
        tc, bound, upper, rule_stride, ztol, band, match, flag);
}

// the counts into the zeroed scratch, then the variant reduction
template <bool FOLDED, class Planes>
int run(const Planes& planes, int64_t n_cols, const void* pos, int batch,
        int n_var, int n_q, int n_straight, const void* same_cls,
        const void* bq_s, const void* bq_p, const void* a_qp,
        const void* q_r, const void* tc, const void* bound,
        const void* upper, int exact_same, float ztol, float band,
        void* scratch, void* best, void* mirrored, void* pair_flags,
        void* stream) {
    if (n_straight < 1 || n_straight > n_var
        || static_cast<int64_t>(batch) * n_var > 65535
        || (n_q + QC - 1) / QC > 65535)
        return cudaErrorInvalidValue;
    if (batch == 0 || n_cols == 0) return cudaGetLastError();
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int32_t* match = static_cast<int32_t*>(scratch);
    int32_t* flag = match + static_cast<int64_t>(batch) * n_var * n_cols;
    if (n_q > 0) {
        const dim3 grid(cmst::blocks_for(n_cols, THREADS),
                        (n_q + QC - 1) / QC, batch * n_var);
        const int64_t rule_stride = static_cast<int64_t>(batch) * n_q;
        auto args = [&](auto launcher) {
            launcher(grid, st, planes, n_cols,
                     static_cast<const int32_t*>(pos), n_var, n_q,
                     static_cast<const int32_t*>(same_cls),
                     static_cast<const float*>(bq_s),
                     static_cast<const float*>(bq_p),
                     static_cast<const float*>(a_qp),
                     static_cast<const float*>(q_r),
                     static_cast<const int32_t*>(tc),
                     static_cast<const float*>(bound),
                     static_cast<const uint8_t*>(upper), rule_stride, ztol,
                     band, match, flag);
        };
        if (exact_same) args(launch<true, FOLDED, Planes>);
        else args(launch<false, FOLDED, Planes>);
        cudaError_t err = cudaGetLastError();
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
// int32, bound f32, upper uint8 [2, batch, n_q]; scratch int32
// [2, batch, n_var, n_cols], zeroed by the caller -> best int32, mirrored
// uint8, pair_flags int32 [batch, n_cols]. thr < 0: threshold folded.
extern "C" int cmst_banded_score(
        const void* planes, int64_t n_cols, const void* pos, int batch,
        int n_var, int n_q, int n_straight, const void* same_cls,
        const void* bq_s, const void* bq_p, const void* a_qp,
        const void* q_r, const void* tc, const void* bound,
        const void* upper, int exact_same, float ztol, float band, int thr,
        void* scratch, void* best, void* mirrored, void* pair_flags,
        void* stream) {
    const SummaryPlanes p{static_cast<const int32_t*>(planes), thr};
    auto go = [&](auto run_) {
        return run_(p, n_cols, pos, batch, n_var, n_q, n_straight, same_cls,
                    bq_s, bq_p, a_qp, q_r, tc, bound, upper, exact_same,
                    ztol, band, scratch, best, mirrored, pair_flags, stream);
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
    return run<true>(p, n_cols, pos, batch, n_var, n_q, n_straight,
                     same_cls, bq_s, bq_p, a_qp, q_r, tc, bound, upper,
                     exact_same, ztol, band, scratch, best, mirrored,
                     pair_flags, stream);
}
