"""Pixel-match scoring: host plan construction and the device kernels
K2-K4, K9-K11 and K13.

The host side (classic query plans, interval tables bisected against the
float64 oracle, union plans, the batch stackers) is carried over from
the JAX package's ops/pixel_match.py unchanged, so both packages build
identical plans. The device side replaces the package's jitted
functions with hand-written CUDA kernels (kernels/csrc), each beside its
plain PyTorch version:

  * K2 ``expand_union_tables_from_pos``: positional wire form -> per-lane
    interval tables (expand_tables.cu),
  * K3 ``score_query_batch_union_keys``: union key gathers, per-lane
    interval counts and the straight/mirror reduction (union_score.cu);
    it scores the full-union and the x-union plans,
  * K4 ``union_keys_topk``: per-mask top-k emit selection (topk.cu),
  * K9 ``score_query_batch``: the banded f32 predicate on summary planes
    with per-pair ambiguity flags (banded_score.cu),
  * K10 ``score_query_batch_keys``: the classic rank-key kernel, three
    interval windows per query pixel (key_score.cu),
  * K11 ``score_query_batch_split``: K9's predicate on the split planes
    (banded_score.cu, its split loader),
  * K13 ``score_query_batch_union_keys_splitk``: K3 on the split key
    planes (union_score.cu, its split-key loader), which K12's
    ``split_key_planes`` (ops/common.py, repack_planes.cu) makes.

Tables that hold uint32 bits (interval lo/span, summary words) travel as
int32 tensors with the same bits, because torch's uint32 lacks most
operations; uint16 planes travel as int16 with the same bits.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from colormipsearch_tpu_torch.constants import (
    BG_GB,
    BR_BG,
    CLASS_BG,
    CLASS_BR,
    CLASS_GB,
    CLASS_GR,
    CLASS_RB,
    CLASS_RG,
    GB_GR,
    GR_RG,
    RG_RB,
)
from colormipsearch_tpu_torch.kernels import build as kbuild
from colormipsearch_tpu_torch.ops import common
from colormipsearch_tpu_torch.oracle import pixel as oracle_pixel

# Adjacent-class compatibility table.  Each row:
#   (query class, target class,
#    (qs_mul, qp_mul, q_is_less), (ts_mul, tp_mul, t_is_less),
#    gap_is_sum_minus_2c, boundary constant)
# The ratio preconditions (e.g. r < 0.44) are exact as integer
# cross-multiplications: 25*s < 11*p  <=>  s/p < 0.44 in float64 (ties at
# equality agree because fl(s/p) == fl(0.44) is not < fl(0.44)).
_ADJ_TABLE = (
    (CLASS_BR, CLASS_BG, (25, 11, True), (50, 27, True), True, BR_BG),
    (CLASS_BG, CLASS_BR, (50, 27, True), (25, 11, True), True, BR_BG),
    (CLASS_BG, CLASS_GB, (5, 4, False), (5, 4, False), False, BG_GB),
    (CLASS_GB, CLASS_BG, (5, 4, False), (5, 4, False), False, BG_GB),
    (CLASS_GB, CLASS_GR, (10, 7, True), (10, 7, True), True, GB_GR),
    (CLASS_GR, CLASS_GB, (10, 7, True), (10, 7, True), True, GB_GR),
    (CLASS_GR, CLASS_RG, (5, 4, False), (5, 4, False), False, GR_RG),
    (CLASS_RG, CLASS_GR, (5, 4, False), (5, 4, False), False, GR_RG),
    (CLASS_RG, CLASS_RB, (10, 7, True), (10, 7, True), True, RG_RB),
    (CLASS_RB, CLASS_RG, (10, 7, True), (10, 7, True), True, RG_RB),
)


def _bucket(q: int, minimum: int = 512) -> int:
    """Pad query sizes to the {1, 1.25, 1.5, 1.75} x 2^k bucket ladder
    (512, 640, 768, 896, 1024, 1280, ...): average padding waste ~11%
    and worst case 25%, vs up to 2x for plain powers of two, while the
    number of distinct kernel shapes (whose XLA compilations the
    persistent cache amortizes) stays small."""
    if q <= minimum:
        return minimum
    base = minimum
    while base * 2 < q:
        base *= 2
    for m in (4, 5, 6, 7, 8):
        n = base * m // 4
        if n >= q:
            return n
    return base * 2


# --- classic query plans and the banded f32 predicate -----------------------
#
# The packed path scores summary planes (ops/common.pack_target_planes)
# with a predicate that is exact integer arithmetic for same-class pixels
# and float32 with a guard band for the adjacent-class branches; pixels
# whose verdict falls inside the band are counted separately (the pair's
# flags), and the engine rescores flagged pairs with the float64 oracle.

# float32 guard band around the z-tolerance for the adjacent-class gap;
# float32 evaluation error is bounded by ~5e-7, float64-vs-exact by ~3e-16.
ADJ_BAND = 1e-4

# Largest z-tolerance denominator for the exact same-class test: the
# f32-evaluated integer products must stay < 2^24 (b * 255 * 255), so
# fractions up to 1/258 of a percent stay exact; coarser denominators
# fall back to the banded-f32 ratio-gap branch.
_MAX_INT_DENOM = 258


@dataclasses.dataclass
class QueryPlan:
    """Host-side precomputation for one query (mask) image: the
    reference's shifted/mirrored position arrays
    (PixelMatchColorDepthSearchAlgorithm ctor) in padded dense form."""
    positions: np.ndarray      # int32 [V, Q] target-lookup positions, -1 pad
    q_cls: np.ndarray          # int32 [Q]
    q_s: np.ndarray            # int32 [Q]
    q_p: np.ndarray            # int32 [Q]
    query_size: int            # true (unpadded) number of query positions
    n_straight: int            # variants [0:n_straight] are unmirrored
    mirror: bool
    ztol_num: int
    ztol_den: int

    @property
    def n_variants(self) -> int:
        return self.positions.shape[0]


def build_query_plan(query_rgb: np.ndarray, query_threshold: int, *,
                     mirror: bool, xy_shift: int,
                     pix_color_fluctuation,
                     excluded_region: np.ndarray | None = None,
                     pad_to: int | None = None) -> QueryPlan:
    """Build the padded position/attribute arrays for one query image."""
    h, w = query_rgb.shape[:2]
    fg = (query_rgb > query_threshold).any(axis=-1)
    if excluded_region is not None:
        fg &= ~excluded_region
    positions = np.flatnonzero(fg.reshape(-1)).astype(np.int64)
    q = positions.size

    # classify only the foreground (~0.1-1% of the plane)
    cls, s, p = oracle_pixel.classify_rgb(
        query_rgb.reshape(-1, 3)[positions])
    q_cls = cls.astype(np.int32)
    q_s = s.astype(np.int32)
    q_p = p.astype(np.int32)

    x = positions % w
    y = positions // w
    variants = []
    for dx, dy in oracle_pixel.shift_offsets(xy_shift):
        nx, ny = x + dx, y + dy
        ok = (nx >= 0) & (nx < w) & (ny >= 0) & (ny < h)
        variants.append(np.where(ok, ny * w + nx, -1))
    n_straight = len(variants)
    if mirror:
        for v in list(variants):
            vx = v % w
            variants.append(np.where(v < 0, -1, v + (w - 1) - 2 * vx))
    pos = np.stack(variants).astype(np.int32) if q else \
        np.full((n_straight * (2 if mirror else 1), 0), -1, np.int32)

    q_pad = pad_to if pad_to is not None else _bucket(q)
    if q_pad < q:
        raise ValueError(f"pad_to {q_pad} < query size {q}")
    if q_pad > q:
        pos = np.pad(pos, ((0, 0), (0, q_pad - q)), constant_values=-1)
        q_cls = np.pad(q_cls, (0, q_pad - q))
        q_s = np.pad(q_s, (0, q_pad - q))
        q_p = np.pad(q_p, (0, q_pad - q))

    a, b = common.ztol_fraction(pix_color_fluctuation)
    return QueryPlan(pos, q_cls, q_s, q_p, q, n_straight, mirror, a, b)


def build_neg_query_plan(query_rgb: np.ndarray, query_threshold: int,
                         neg_query_rgb: np.ndarray, neg_query_threshold: int,
                         *, mirror_neg_query: bool, xy_shift: int,
                         pix_color_fluctuation,
                         excluded_region: np.ndarray | None = None,
                         pad_to: int | None = None) -> QueryPlan | None:
    """Build the negative-query plan for device scoring.

    Reference semantics (PixelMatchColorDepthSearchAlgorithm:36-57,195-217):
    the negative pass reads SOURCE pixels from the negative image at the
    POSITIVE query's positions, zipped with the shifted NEGATIVE query
    position arrays as target lookups, truncated to the shorter length.
    The returned plan's ``query_size`` is the TRUE negative-query
    foreground size (the divisor of the score subtraction), which may
    exceed the padded zip length.  Returns None when either side is empty.
    """
    h, w = query_rgb.shape[:2]
    fg = (query_rgb > query_threshold).any(axis=-1)
    neg_fg = (neg_query_rgb > neg_query_threshold).any(axis=-1)
    if excluded_region is not None:
        fg &= ~excluded_region
        neg_fg &= ~excluded_region
    positions = np.flatnonzero(fg.reshape(-1)).astype(np.int64)
    neg_positions = np.flatnonzero(neg_fg.reshape(-1)).astype(np.int64)
    neg_query_size = int(neg_positions.size)
    size = min(positions.size, neg_query_size)
    if size == 0:
        return None

    src = positions[:size]
    ncls, ns, np_ = oracle_pixel.classify_rgb(
        neg_query_rgb.reshape(-1, 3)[src])
    q_cls = ncls.astype(np.int32)
    q_s = ns.astype(np.int32)
    q_p = np_.astype(np.int32)

    x = neg_positions % w
    y = neg_positions // w
    variants = []
    for dx, dy in oracle_pixel.shift_offsets(xy_shift):
        nx, ny = x + dx, y + dy
        ok = (nx >= 0) & (nx < w) & (ny >= 0) & (ny < h)
        variants.append(np.where(ok, ny * w + nx, -1)[:size])
    n_straight = len(variants)
    if mirror_neg_query:
        for v in list(variants):
            vx = v % w
            variants.append(np.where(v < 0, -1, v + (w - 1) - 2 * vx))
    pos = np.stack(variants).astype(np.int32)

    q_pad = pad_to if pad_to is not None else _bucket(size)
    if q_pad > size:
        pos = np.pad(pos, ((0, 0), (0, q_pad - size)), constant_values=-1)
        q_cls = np.pad(q_cls, (0, q_pad - size))
        q_s = np.pad(q_s, (0, q_pad - size))
        q_p = np.pad(q_p, (0, q_pad - size))

    a, b = common.ztol_fraction(pix_color_fluctuation)
    return QueryPlan(pos, q_cls, q_s, q_p, neg_query_size, n_straight,
                     mirror_neg_query, a, b)


@functools.lru_cache(maxsize=1)
def _adj_rule_tables():
    """Per-query-class adjacency rule tables.

    Every dominance class has at most TWO adjacent classes it can match
    (e.g. BG pairs with BR and GB), so instead of sweeping all 10 rows of
    _ADJ_TABLE per pair, each query pixel carries its <= 2 candidate
    rules; the kernel evaluates exactly those.  Arrays are indexed
    [class 0..6, rule slot 0..1]:
      tc       target class (0 = slot disabled)
      qms, qmp, qless   query-side ratio precondition (exact ints)
      tms, tmp, tless   target-side ratio precondition
      sign, offs        gap = sign * (q_r + t_r) + offs   (offs = -/+ 2c)
    """
    shape = (7, 2)
    tc = np.zeros(shape, np.int32)
    qms = np.zeros(shape, np.int32)
    qmp = np.zeros(shape, np.int32)
    qless = np.zeros(shape, bool)
    tms = np.zeros(shape, np.int32)
    tmp_ = np.zeros(shape, np.int32)
    tless = np.zeros(shape, bool)
    sign = np.zeros(shape, np.float32)
    offs = np.zeros(shape, np.float32)
    slot = [0] * 7
    for qc, t, (a, b, ql), (c_, d, tl), plus, const in _ADJ_TABLE:
        k = slot[qc]
        slot[qc] += 1
        tc[qc, k] = t
        qms[qc, k], qmp[qc, k], qless[qc, k] = a, b, ql
        tms[qc, k], tmp_[qc, k], tless[qc, k] = c_, d, tl
        sign[qc, k] = 1.0 if plus else -1.0
        offs[qc, k] = np.float32(-2.0 * const) if plus \
            else np.float32(2.0 * const)
    return tc, qms, qmp, qless, tms, tmp_, tless, sign, offs


def _f32(x: float, device) -> torch.Tensor:
    """A float32 scalar tensor (x rounded to nearest, as jnp.float32)."""
    return torch.tensor(float(np.float32(x)), dtype=torch.float32,
                        device=device)


def query_side_rules(q_cls, q_s, q_p, *, ztol_num: int, ztol_den: int):
    """Per-query-pixel precomputation for the elementwise predicate, in
    the JAX package's f32 operation order (torch, on the tensors' device).

    Folds the adjacent-class machinery of calculatePixelGap (:260-388)
    into at most two one-sided bound tests per query pixel: every
    adjacent-class branch is "target class == tc AND a one-sided ratio
    condition", because the target-side precondition and the gap
    threshold bound t_r from the SAME side —

        plus rules  (gap = (q_r - c) + (t_r - c) <= ztol):
            t_r <  pre_hi   and  t_r <= ztol + 2c - q_r
        minus rules (gap = (c - q_r) + (c - t_r) <= ztol):
            t_r >  pre_lo   and  t_r >= 2c - ztol - q_r

    so the per-element test is one bound test on g = t_s - B*t_p
    (direction chosen by `upper`), with B precomputed here per (query
    pixel, rule slot). Boundary points (the strict-vs-non-strict
    distinction and all f32 rounding) fall inside the ambiguity band and
    are flagged for the float64 oracle.

    Returns (same_cls, bq_s, bq_p, a_qp, tc, bound, upper):
      same_cls: int32 — q_cls where the same-class branch can fire
                (ratio > 0 per :262), else -1
      bq_s, bq_p, a_qp: f32 — ztol_den * q_s, ztol_den * q_p and
                ztol_num * q_p (the same-class test
                |q_s*t_p - t_s*q_p| * b <= a * q_p * t_p, exact in f32
                while every product is < 2^24)
      tc:       int32 [2, ...] — adjacency rule target class (0 = off)
      bound:    f32  [2, ...] — ratio bound B
      upper:    bool [2, ...] — True for upper (t_r <= B), else lower
    """
    a, b = ztol_num, ztol_den
    dev = q_cls.device
    ztol_f32 = _f32(a / b, dev)
    f32 = torch.float32

    q_r = q_s.to(f32) / q_p.clamp(min=1).to(f32)
    tc_t, qms_t, qmp_t, qless_t, tms_t, tmp_t, _tless, sign_t, offs_t = \
        (torch.from_numpy(t).to(dev) for t in _adj_rule_tables())
    cls = q_cls.long()

    same_cls = torch.where(q_s >= 1, q_cls, -1).to(torch.int32)
    bq_s = (b * q_s).to(f32)
    bq_p = (b * q_p).to(f32)
    a_qp = (a * q_p).to(f32)

    tc, bound, upper = [], [], []
    for k in (0, 1):
        # query-side precondition (exact ints), folded into the rule's
        # target class (0 = rule disabled for this query pixel)
        q_lhs = qms_t[cls, k] * q_s - qmp_t[cls, k] * q_p
        pre_q = torch.where(qless_t[cls, k], q_lhs < 0, q_lhs > 0)
        tc.append(torch.where(pre_q, tc_t[cls, k], 0).to(torch.int32))
        # plus rules (sign +1, offs = -2c): upper bound
        #   min(pre_hi, ztol + 2c - q_r)   with pre_hi = tmp/tms
        # minus rules (sign -1, offs = +2c): lower bound
        #   max(pre_lo, 2c - ztol - q_r)
        pre_ratio = tmp_t[cls, k].to(f32) / tms_t[cls, k].clamp(min=1) \
            .to(f32)
        plus = sign_t[cls, k] > 0
        offs = offs_t[cls, k]
        gap_bound = torch.where(plus, (ztol_f32 - offs) - q_r,
                                (-ztol_f32 + offs) - q_r)
        bound.append(torch.where(plus, torch.minimum(pre_ratio, gap_bound),
                                 torch.maximum(pre_ratio, gap_bound)))
        upper.append(plus)
    return (same_cls, bq_s, bq_p, a_qp, torch.stack(tc), torch.stack(bound),
            torch.stack(upper))


def element_predicate(q_cls, q_s, q_p, t_cls, t_s, t_p, t_max, *,
                      target_threshold: int, ztol_num: int, ztol_den: int):
    """Elementwise match predicate on pixel summaries (broadcastable):
    (match, flag) bool tensors, `flag` marking the ambiguity-band
    pixels whose verdict the float64 oracle re-checks."""
    rules = query_side_rules(q_cls, q_s, q_p, ztol_num=ztol_num,
                             ztol_den=ztol_den)
    return predicate_from_rules(
        rules, q_s, q_p, t_cls, t_s, t_p, t_max,
        target_threshold=target_threshold, ztol_num=ztol_num,
        ztol_den=ztol_den)


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """a * b + c for float32 tensors, rounded once (a fused multiply-add,
    as CUDA's __fmaf_rn). The product of two floats is exact in float64;
    the sum's rounding error comes from TwoSum, and a sum that is not
    exact is rounded to odd (the neighbour with an odd last bit), which
    then rounds to float32 as the exact value would (53 >= 24 + 2
    bits)."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    bits = s.view(torch.int64)
    inexact_even = (err != 0) & ((bits & 1) == 0)
    # the neighbour in err's direction: one more unit of magnitude when
    # err has the sign of s, one less otherwise
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where(inexact_even, bits + step, bits)
    return bits.view(torch.float64).to(torch.float32)


def predicate_from_rules(rules, q_s, q_p, t_cls, t_s, t_p, t_max, *,
                         target_threshold: int, ztol_num: int,
                         ztol_den: int):
    """The [elements]-shaped half of the predicate (see query_side_rules),
    in the f32 operation order the JAX function compiles to (see the
    adjacent-class bound test below)."""
    a, b = ztol_num, ztol_den
    dev = t_s.device
    f32 = torch.float32
    band = _f32(ADJ_BAND, dev)
    same_cls, bq_s, bq_p, a_qp, tc, bound, upper = rules

    ts_f = t_s.to(f32)
    tp_f = t_p.to(f32)
    same = (same_cls == t_cls) & (t_s >= 1)
    if b <= _MAX_INT_DENOM:
        # exact-in-f32 integer arithmetic: every product < 2^24
        lhs = torch.abs(bq_s * tp_f - ts_f * bq_p)
        rhs = a_qp * tp_f
        m_same = same & (lhs <= rhs)
        f_same = same & (lhs == rhs)
    else:
        q_r = q_s.to(f32) / q_p.clamp(min=1).to(f32)
        t_r32 = ts_f / tp_f.clamp(min=1)
        ztol_f32 = _f32(a / b, dev)
        gap = torch.abs(t_r32 - q_r)
        m_same = same & (gap <= ztol_f32)
        f_same = same & (torch.abs(gap - ztol_f32) < band)

    # the two rule slots target DISTINCT classes, so at most one rule can
    # fire per element: select its bound/direction by class equality
    sel0 = t_cls == tc[0]
    sel1 = t_cls == tc[1]
    sel = (sel0 | sel1) & (t_cls > 0)
    bound_sel = torch.where(sel0, bound[0], bound[1])
    upper_sel = torch.where(sel0, upper[0], upper[1])
    # g = ts_f - bound_sel * tp_f. XLA (its CPU backend) compiles the
    # sign test `g <= 0` as `ts_f <= bound_sel * tp_f`, the product
    # rounded on its own, and the band test's g as one fused multiply-add
    # (rounded once); the JAX function's verdicts follow both, and so do
    # these. (Both roundings err by ~1e-7, far inside the 1e-4 band.)
    m_adj = sel & ((ts_f <= bound_sel * tp_f) == upper_sel)
    g = fma_f32(-bound_sel, tp_f, ts_f)
    f_adj = sel & (torch.abs(g) < band * tp_f)

    match = m_same | m_adj
    flag = f_same | f_adj
    if target_threshold >= 0:
        # a negative threshold means it was folded into the pack
        valid = t_max > target_threshold
        match = match & valid
        flag = flag & valid
    return match, flag


def reduce_variant_scores(scores: np.ndarray, plan: QueryPlan):
    """[V, T] per-variant scores -> (best [T], mirrored [T]) per reference
    max semantics (mirror wins only when strictly greater)."""
    straight = scores[:plan.n_straight].max(axis=0)
    if plan.mirror:
        mirrored = scores[plan.n_straight:].max(axis=0)
        best = np.maximum(straight, mirrored)
        return best, mirrored > straight
    return straight, np.zeros(scores.shape[1], dtype=bool)


# --- rank-key interval predicate ------------------------------------------
#
# Targets pack to key = (cls << 15) | rank-of-ratio
# (ops/common.pack_target_planes_keys) and each query pixel carries up to
# three precomputed key intervals (same class + <= 2 adjacent classes).
# The per-element test is a few unsigned range checks on the gathered
# key and, because the interval endpoints are found by bisecting the
# float64 oracle itself (oracle/pixel.pixel_gap), the device verdict is
# bit-identical to the reference with no ambiguity band and no oracle
# fallback.
#
# Faithfulness rests on the match set being an interval of the ratio
# order for every (query pixel, target class): same-class matches form
# the window |r2 - r1| <= z (r2 > 0); each adjacent-class rule bounds r2
# from one side only (its precondition and its gap bound point the same
# way), and IEEE-754 rounding preserves weak monotonicity, so bisection
# probes of the oracle land exactly on the f64 verdict boundary.  The
# JAX package's `-m slow` suite proves membership equality for every
# achievable ratio pair of every class pair.

# encodes an empty interval: (key - EMPTY_LO) mod 2^32 > any span for
# every achievable key (< 2^18)
_EMPTY_LO = np.uint32(1 << 31)


@functools.lru_cache(maxsize=1)
def _adj_direction_tables():
    """Per-query-class adjacency slots for the interval build.

    Returns (tc, prefix): int32/bool [2, 7] arrays — slot k's target
    class (0 = none) and whether its match set is a PREFIX of the ratio
    order ("plus" rules: gap grows with t_r) or a suffix ("minus").
    """
    tc = np.zeros((2, 7), np.int32)
    prefix = np.zeros((2, 7), bool)
    slot = [0] * 7
    for qc, t, _q, _t, plus, _c in _ADJ_TABLE:
        k = slot[qc]
        slot[qc] += 1
        tc[k, qc] = t
        prefix[k, qc] = plus
    return tc, prefix


def _bisect_key_intervals(q_cls: np.ndarray, q_rank: np.ndarray,
                          z_tol: float):
    """Key intervals by f64-oracle bisection for (class, ratio-rank)
    query summaries (the core of build_key_intervals; see there).

    The oracle predicate depends on the query pixel only through
    (class, float64 ratio), and equal rationals give identical float64
    quotients, so (cls, rank) fully determines the intervals.
    """
    from colormipsearch_tpu_torch.ops.common import (
        KEY_RANK_BITS,
        ratio_rank_table,
    )

    vals, _ = ratio_rank_table()
    n_ratios = vals.size
    q_cls = np.asarray(q_cls, np.int64)
    q_rank = np.asarray(q_rank, np.int64)
    q_r = vals[q_rank]
    n_q = q_cls.shape[0]

    lo = np.full((3, n_q), _EMPTY_LO, np.uint32)
    span = np.zeros((3, n_q), np.uint32)

    def probe(tc, j):
        return oracle_pixel.pixel_gap(q_cls, q_r, tc, vals[j]) <= z_tol

    def fill(slot, act, tc, lo_rank, hi_rank):
        key_lo = (tc.astype(np.int64) << KEY_RANK_BITS) + lo_rank
        key_hi = (tc.astype(np.int64) << KEY_RANK_BITS) + hi_rank
        lo[slot] = np.where(act, key_lo, int(_EMPTY_LO)).astype(np.uint32)
        span[slot] = np.where(act, key_hi - key_lo, 0).astype(np.uint32)

    # slot 0: same class.  Non-empty iff the ratio is positive (r2 > 0
    # is also required, hence ranks start at 1); the window contains
    # q's own rank (gap 0), so bisect each edge from there.
    act = (q_cls > 0) & (q_rank >= 1)
    anchor = np.maximum(q_rank, 1)
    # the bisection assumes the anchor matches (gap 0 <= z); with a
    # negative or NaN tolerance nothing matches and the degenerate
    # edges would otherwise underflow span to "match everything"
    act &= probe(q_cls, anchor)
    lo_i, hi_i = np.ones(n_q, np.int64), anchor.astype(np.int64)
    for _ in range(16):  # first j in [1, q_rank] with match (monotone)
        mid = (lo_i + hi_i) // 2
        m = probe(q_cls, mid)
        hi_i = np.where(m, mid, hi_i)
        lo_i = np.where(m, lo_i, mid + 1)
    left = lo_i
    lo_i, hi_i = anchor.astype(np.int64), np.full(n_q, n_ratios - 1)
    for _ in range(16):  # last j in [q_rank, R-1] with match
        mid = (lo_i + hi_i + 1) // 2
        m = probe(q_cls, mid)
        lo_i = np.where(m, mid, lo_i)
        hi_i = np.where(m, hi_i, mid - 1)
    fill(0, act, q_cls, left, lo_i)

    # slots 1..2: adjacent classes.  "plus" rules match a prefix of the
    # ratio order (both the precondition and the gap bound cap r2 from
    # above), "minus" rules a suffix; the closed end decides emptiness.
    tc_tab, prefix_tab = _adj_direction_tables()
    for k in (0, 1):
        tc = tc_tab[k][q_cls]
        pref = prefix_tab[k][q_cls]
        end = np.where(pref, 0, n_ratios - 1)
        act = (tc > 0) & probe(tc, end)
        lo_i = np.zeros(n_q, np.int64)
        hi_i = np.full(n_q, n_ratios - 1, np.int64)
        for _ in range(16):
            mid = np.where(pref, (lo_i + hi_i + 1) // 2,
                           (lo_i + hi_i) // 2)
            m = probe(tc, mid)
            lo_i = np.where(pref,
                            np.where(m, mid, lo_i),
                            np.where(m, lo_i, mid + 1))
            hi_i = np.where(pref,
                            np.where(m, hi_i, mid - 1),
                            np.where(m, mid, hi_i))
        fill(k + 1, act, tc,
             np.where(pref, 0, lo_i), np.where(pref, lo_i, n_ratios - 1))
    return lo, span


@functools.lru_cache(maxsize=4)
def _key_interval_table(z_tol: float):
    """(lo, span) uint32 [3, 7 << KEY_RANK_BITS] interval tables for one
    z-tolerance, indexed by the query pixel's OWN key
    (cls << KEY_RANK_BITS) | rank.  Built once by bisecting every
    achievable (class, rank) pair (~119k) and cached per tolerance —
    plan builds then cost a table gather instead of re-running the
    bisections per pixel per lane (the full-union build probes each
    query pixel up to 18x otherwise)."""
    from colormipsearch_tpu_torch.ops.common import (
        KEY_RANK_BITS,
        ratio_rank_table,
    )

    vals, _ = ratio_rank_table()
    n_ratios = vals.size
    cls = np.repeat(np.arange(1, 7, dtype=np.int64), n_ratios)
    rank = np.tile(np.arange(n_ratios, dtype=np.int64), 6)
    lo, span = _bisect_key_intervals(cls, rank, z_tol)
    n = 7 << KEY_RANK_BITS
    tab_lo = np.full((3, n), _EMPTY_LO, np.uint32)
    tab_span = np.zeros((3, n), np.uint32)
    idx = (cls << KEY_RANK_BITS) | rank
    tab_lo[:, idx] = lo
    tab_span[:, idx] = span
    return tab_lo, tab_span


@functools.lru_cache(maxsize=4)
def _key_interval_table2(z_tol: float):
    """Slot-compacted twin of _key_interval_table: (lo, span) uint32
    [2, 7 << KEY_RANK_BITS] plus per-key metadata for the segmented
    kernel: ``any2`` bool [n_keys] (second window live) and
    ``disjoint_ok`` (True iff for EVERY key the live windows sit in
    distinct class segments — the proof that the segmented kernel's
    window-indicator sums need no OR).

    Compacting once at table build removes the per-plan
    compact_interval_slots pass (the heaviest part of the ~39 ms
    full-union plan build) and shrinks the per-lane gathers by 1/3.
    """
    from colormipsearch_tpu_torch.ops.common import KEY_RANK_BITS

    tab_lo3, tab_span3 = _key_interval_table(z_tol)
    ne = ~((tab_lo3 == _EMPTY_LO) & (tab_span3 == 0))  # [3, n]
    order = np.argsort(~ne, axis=0, kind="stable")
    lo = np.take_along_axis(tab_lo3, order, axis=0)
    span = np.take_along_axis(tab_span3, order, axis=0)
    ne = np.take_along_axis(ne, order, axis=0)
    if ne[2].any():
        # 3 live windows at this tolerance: callers fall back to the
        # uncompacted 3-slot path (never observed at production
        # tolerances; proven per tolerance here, not assumed)
        return None
    seg_lo = lo >> KEY_RANK_BITS
    seg_hi = (lo + span) >> KEY_RANK_BITS
    both = ne[0] & ne[1]
    disjoint_ok = bool((~both | ((seg_lo[0] != seg_lo[1])
                                 & (seg_lo[0] == seg_hi[0])
                                 & (seg_lo[1] == seg_hi[1]))).all())
    return (np.ascontiguousarray(lo[:2]),
            np.ascontiguousarray(span[:2]),
            np.ascontiguousarray(ne[1]), disjoint_ok)


def build_key_intervals(q_cls: np.ndarray, q_s: np.ndarray,
                        q_p: np.ndarray, z_tol: float):
    """Per-query-pixel key intervals (lo uint32 [3, Q], span uint32 [3, Q]).

    A target key k matches query pixel i iff
    (k - lo[slot, i]) mod 2^32 <= span[slot, i] for some slot.  Endpoints
    are found by vectorized bisection of the float64 oracle predicate
    (pixel_gap(q, t) <= z_tol), so membership equals the reference's f64
    verdict exactly — including the query-side rule preconditions, which
    the oracle evaluates internally (a failed precondition makes every
    probe miss and the interval comes out empty).  The bisections run
    once per (class, rank, tolerance) via a cached table
    (_key_interval_table); this is a gather.
    """
    from colormipsearch_tpu_torch.ops.common import (
        KEY_RANK_BITS,
        ratio_rank_table,
    )

    _, rank_tab = ratio_rank_table()
    q_cls = np.asarray(q_cls, np.int64)
    q_s = np.asarray(q_s, np.int64)
    q_p = np.asarray(q_p, np.int64)
    rank = rank_tab[np.minimum(q_s, 255), np.minimum(q_p, 255)]
    # class 0 (padded / inactive) maps to key 0, whose table entries are
    # the initialization value: the empty interval
    key = np.where(q_cls > 0, (q_cls << KEY_RANK_BITS) | rank, 0)
    tab_lo, tab_span = _key_interval_table(float(z_tol))
    return tab_lo[:, key], tab_span[:, key]


@dataclasses.dataclass
class KeyQueryPlan:
    """Rank-key form of QueryPlan: positions are sentinel-encoded
    (padded / out-of-bounds lanes point at the planes' all-zero row P)
    and per-pixel predicates are three key intervals."""
    positions: np.ndarray      # int32 [V, Q], sentinel = n_pixels
    lo: np.ndarray             # uint32 [3, Q]
    span: np.ndarray           # uint32 [3, Q]
    query_size: int
    n_straight: int
    mirror: bool

    @property
    def n_variants(self) -> int:
        return self.positions.shape[0]


def key_plan_from_query_plan(plan: QueryPlan, n_pixels: int,
                             pix_color_fluctuation) -> KeyQueryPlan:
    """Convert a built QueryPlan for the classic key kernel (K10).

    `n_pixels` is H*W of the image the positions index (the sentinel
    row); the z-tolerance re-derives from the fluctuation value the
    same way the reference does (double division by 100).
    """
    pos = np.where(plan.positions < 0, n_pixels,
                   plan.positions).astype(np.int32)
    lo, span = build_key_intervals(
        plan.q_cls, plan.q_s, plan.q_p,
        float(pix_color_fluctuation) / 100.0)
    return KeyQueryPlan(pos, lo, span, plan.query_size,
                        plan.n_straight, plan.mirror)


# --- full-union lane form of the rank-key kernel ----------------------------
#
# The xy-shift variants of a query gather heavily overlapping row sets,
# so the plan gathers ONE fully dilated union of every shifted query
# position per orientation and evaluates each shift offset as a predicate
# LANE with its own interval constants. A union element u serves lane
# (dx, dy) iff q = u - dx - dy*w is a query position with the shift
# in-bounds — exactly the per-variant membership rule; inactive (element,
# lane) pairs carry empty intervals (lo = _EMPTY_LO, span = 0) that no
# key satisfies, and padded elements gather the all-zero sentinel row.


@dataclasses.dataclass
class UnionKeyPlan:
    """Host-side precomputation for the x-union lane key kernel."""
    u_pos: np.ndarray      # int32 [S, U] straight dy-set positions,
    #                        sentinel-encoded (= n_pixels)
    mu_pos: np.ndarray     # int32 [S or 0, U] mirrored dy-set positions
    lane_lo: np.ndarray    # uint32 [L, 3, U] per-lane key intervals
    lane_span: np.ndarray  # uint32 [L, 3, U]
    query_size: int        # true (unpadded) number of query positions
    mirror: bool
    # slot-2 segmentation (full-union plans): elements are PERMUTED so
    # the ones with a live second interval window in ANY lane form the
    # prefix [0, u2); the kernel then runs slot-2 tests only there
    # (~21% of elements at production tolerances — docs/DESIGN.md §6).
    # -1 = unsegmented (x-union plans, or a single-slot table).
    u2: int = -1
    # per-(lane, element) QUERY KEYS int32 [L, U] (0 = inactive) — the
    # compressed wire form of the lane tables: the device gathers
    # lo/span from the shared per-tolerance interval table instead of
    # receiving the ~740 KB/mask expanded tables (~3.5x less plan-arg
    # upload; decisive when thousands of masks stream over a slow
    # host->device link).  None on the 3-slot fallback path.
    qkeys: np.ndarray | None = None
    z_tol: float | None = None
    # factored qkey wire form (2x smaller again): qidx uint16 [L, U]
    # indexes key_list int32 [Q_pad + 1] (last entry = 0, the inactive
    # slot); qkeys[j, u] == key_list[qidx[j, u]].  Present iff qkeys is.
    qidx: np.ndarray | None = None
    key_list: np.ndarray | None = None
    # positional wire form (the smallest): the flat query positions
    # themselves — the device derives qidx from (u_pos, q_pos,
    # offsets) via a pos_index scatter + gathers
    # (expand_union_tables_from_pos), so the per-(lane, element) index
    # matrix never crosses the wire at all (~14 KB vs 92 KB per mask).
    q_pos: np.ndarray | None = None

    @property
    def n_sets(self) -> int:
        return self.u_pos.shape[0]

    @property
    def n_lanes(self) -> int:
        if self.lane_lo is not None:
            return self.lane_lo.shape[0]
        return (self.qkeys if self.qkeys is not None
                else self.qidx).shape[0]

    @property
    def n_straight(self) -> int:
        return self.n_sets * self.n_lanes


def compact_interval_slots(lane_lo: np.ndarray, lane_span: np.ndarray):
    """Drop always-empty interval slots from [..., 3, U] lane tables.

    A key's windows live in distinct class segments (same-class plus up
    to two adjacent-class rules), but at production tolerances at most
    TWO are ever non-empty for any (class, rank) — verified here per
    plan, not assumed — so the third per-element range test in
    score_query_union_keys_raw is dead weight.  Slots are compacted
    per (lane, row) (which slot holds a window is irrelevant: the
    kernel ORs them) and trailing all-empty slots are sliced off."""
    ne = ~((lane_lo == _EMPTY_LO) & (lane_span == 0))
    order = np.argsort(~ne, axis=-2, kind="stable")
    lo = np.take_along_axis(lane_lo, order, axis=-2)
    sp = np.take_along_axis(lane_span, order, axis=-2)
    ne = np.take_along_axis(ne, order, axis=-2)
    used = ne.any(axis=tuple(i for i in range(ne.ndim) if i != ne.ndim - 2))
    # the per-row front-packing makes `used` a prefix (slot s used only
    # if every earlier slot is), so its sum is the slot count
    n_slots = max(int(used.sum()), 1)
    return (np.ascontiguousarray(lo[..., :n_slots, :]),
            np.ascontiguousarray(sp[..., :n_slots, :]))


def _select_query_foreground(query_rgb: np.ndarray,
                             query_threshold: int,
                             excluded_region: np.ndarray | None):
    """(flat positions int64 [Q], rgb uint8 [Q, 3]) of the query
    foreground.  Uses the native threaded COO pass when available (the
    full-plane numpy any-reduce was the plan build's largest single
    cost at production mask counts); numpy otherwise — identical
    output either way."""
    sel = None
    try:
        from colormipsearch_tpu_torch.io import native_decoder
        if (query_rgb.flags.c_contiguous
                and query_rgb.dtype == np.uint8
                and query_rgb.ndim == 3 and query_rgb.shape[-1] == 3):
            sel = native_decoder.coo_select(
                query_rgb[None], query_threshold)
    except ImportError:
        pass
    if sel is not None:
        pos0, _t, vals = sel
        if excluded_region is not None:
            keep = ~excluded_region.reshape(-1)[pos0]
            pos0 = pos0[keep]
            vals = vals[keep]
        return pos0.astype(np.int64), vals
    fg = (query_rgb > query_threshold).any(axis=-1)
    if excluded_region is not None:
        fg &= ~excluded_region
    positions = np.flatnonzero(fg.reshape(-1)).astype(np.int64)
    return positions, query_rgb.reshape(-1, 3)[positions]


def offsets_form_grid(xy_shift: int) -> bool:
    """True when shift_offsets(xy_shift) is a full {dx} x {dy} grid —
    the precondition of the x-union lane factorization (holds for the
    production xy_shift in {0, 2}; not for > 2)."""
    offsets = oracle_pixel.shift_offsets(xy_shift)
    dxs = sorted({dx for dx, _ in offsets})
    dys = sorted({dy for _, dy in offsets})
    return {(dx, dy) for dx in dxs for dy in dys} == set(offsets)


def build_union_key_plan(query_rgb: np.ndarray, query_threshold: int, *,
                         mirror: bool, xy_shift: int,
                         pix_color_fluctuation,
                         excluded_region: np.ndarray | None = None,
                         pad_to: int | None = None
                         ) -> UnionKeyPlan | None:
    """Build the x-union lane plan: the x-dilated union of the query
    support gathered once per dy-set (S = 3 sets at xyShift 2), each dx
    shift an interval lane. Scored by K3 with S > 1 and no slot-2
    prefix.

    Returns None when the shift offsets do not form a {dy} x {dx} grid
    (they do for the production xy_shift in {0, 2}); callers fall back
    to the classic key plan.
    """
    if not offsets_form_grid(xy_shift):
        return None
    offsets = oracle_pixel.shift_offsets(xy_shift)
    dxs = sorted({dx for dx, _ in offsets})
    dys = sorted({dy for _, dy in offsets})

    h, w = query_rgb.shape[:2]
    n_pixels = h * w
    positions, vals = _select_query_foreground(
        query_rgb, query_threshold, excluded_region)

    # classify only the foreground; pos_index maps a flat pixel back to
    # its row in the classified arrays (-1 = not a query position)
    cls, s, p = oracle_pixel.classify_rgb(vals)
    pos_index = np.full(n_pixels, -1, np.int64)
    pos_index[positions] = np.arange(positions.size)

    # x-dilated union of the query support (flat positions; dx shifts
    # that leave the row are skipped, like the reference's -1 sentinel)
    x = positions % w
    union = np.unique(np.concatenate(
        [(positions + dx)[(x + dx >= 0) & (x + dx < w)] for dx in dxs])) \
        if positions.size else np.empty(0, np.int64)
    u_count = union.size
    ux = union % w
    uy = union // w

    # per-lane interval constants: lane dx at union row u reads query
    # pixel q = u - dx (same image row, must be a query position);
    # inactive elements get class 0, which build_key_intervals maps to
    # the empty interval
    ztol = float(pix_color_fluctuation) / 100.0
    lane_lo = np.empty((len(dxs), 3, u_count), np.uint32)
    lane_span = np.empty_like(lane_lo)
    for j, dx in enumerate(dxs):
        qx = ux - dx
        src = union - dx
        # qx in [0, w) keeps src on the same row and inside the image
        jj = pos_index[np.clip(src, 0, n_pixels - 1)]
        active = (qx >= 0) & (qx < w) & (jj >= 0)
        idx = np.where(active, jj, 0)
        lane_lo[j], lane_span[j] = build_key_intervals(
            np.where(active, cls[idx], 0), np.where(active, s[idx], 0),
            np.where(active, p[idx], 0), ztol)

    # dy row sets (straight + mirrored); y overflow -> sentinel row
    u_pos = np.full((len(dys), u_count), n_pixels, np.int32)
    mu_pos = np.full((len(dys) if mirror else 0, u_count), n_pixels,
                     np.int32)
    mirror_u = union + (w - 1) - 2 * ux
    for i, dy in enumerate(dys):
        ok = (uy + dy >= 0) & (uy + dy < h)
        u_pos[i] = np.where(ok, union + dy * w, n_pixels)
        if mirror:
            mu_pos[i] = np.where(ok, mirror_u + dy * w, n_pixels)

    lane_lo, lane_span = compact_interval_slots(lane_lo, lane_span)
    plan = UnionKeyPlan(u_pos, mu_pos, lane_lo, lane_span,
                        int(positions.size), mirror)
    return pad_union_key_plan(
        plan, pad_to if pad_to is not None else _bucket(u_count), n_pixels)


def build_full_union_key_plan(query_rgb: np.ndarray, query_threshold: int,
                              *, mirror: bool, xy_shift: int,
                              pix_color_fluctuation,
                              excluded_region: np.ndarray | None = None,
                              pad_to: int | None = None,
                              light: bool = False) -> UnionKeyPlan:
    """Full (x+y) union form: ONE gathered row set per orientation, every
    shift offset an interval lane (S=1, L=n_offsets in UnionKeyPlan
    terms).  ~0.5x the gathered rows of the x-union form for ~1.5x the
    range tests; unlike the x-union it needs no {dx} x {dy} grid, so it
    covers any xyShift.  Same kernel (score_query_*_union_keys)."""
    offsets = oracle_pixel.shift_offsets(xy_shift)

    h, w = query_rgb.shape[:2]
    n_pixels = h * w
    positions, vals = _select_query_foreground(
        query_rgb, query_threshold, excluded_region)

    # classify only the foreground; pos_index maps a flat pixel back to
    # its row in the classified arrays (-1 = not a query position)
    cls, s, p = oracle_pixel.classify_rgb(vals)
    pos_index = np.full(n_pixels, -1, np.int64)
    pos_index[positions] = np.arange(positions.size)

    # union of every valid shifted position (shifts that leave the image
    # are skipped per offset, like the reference's -1 sentinel)
    x = positions % w
    y = positions // w
    parts = [(positions + dx + dy * w)
             [(x + dx >= 0) & (x + dx < w) & (y + dy >= 0) & (y + dy < h)]
             for dx, dy in offsets]
    union = np.unique(np.concatenate(parts)) if positions.size \
        else np.empty(0, np.int64)
    u_count = union.size
    ux = union % w
    uy = union // w

    # lane (dx, dy) at union element u reads query pixel q = u - dx -
    # dy*w (same-row x and in-image y required); inactive elements get
    # class 0 -> the empty interval
    from colormipsearch_tpu_torch.ops.common import (
        KEY_RANK_BITS,
        ratio_rank_table,
    )

    ztol = float(pix_color_fluctuation) / 100.0
    tab2 = _key_interval_table2(ztol)
    if tab2 is not None:
        # fast path: slot-compacted per-key table — one key lookup per
        # query pixel, then per-lane table gathers (no per-plan
        # compaction pass)
        tab_lo, tab_span, tab_any2, disjoint_ok = tab2
        _, rank_tab = ratio_rank_table()
        key_q = np.where(
            cls > 0,
            (cls.astype(np.int64) << KEY_RANK_BITS)
            | rank_tab[np.minimum(s, 255), np.minimum(p, 255)],
            0)
        n_slots0 = 2
    else:
        disjoint_ok = False
        n_slots0 = 3
    n_q = positions.size
    factored = tab2 is not None and n_q < 65535
    qkeys = qidx = key_list = q_pos = None
    if tab2 is not None:
        # all lanes at once: [L, U] geometry, one pos_index gather, one
        # key gather (the per-lane python loop was the plan build's
        # second-largest cost)
        offs = np.asarray(offsets, np.int64)
        dxs = offs[:, 0][:, None]
        dys = offs[:, 1][:, None]
        qx = ux[None, :] - dxs
        qy = uy[None, :] - dys
        src = union[None, :] - dxs - dys * w
        jj = pos_index[np.clip(src, 0, n_pixels - 1)]
        active = ((qx >= 0) & (qx < w) & (qy >= 0) & (qy < h)
                  & (jj >= 0))
        k_lane = np.where(active, key_q[np.where(active, jj, 0)], 0)
        lane_any2 = tab_any2[k_lane]
        if factored:
            qidx = np.where(active, jj, n_q).astype(np.uint16)
            q_pos = positions.astype(np.int32)
            # key_list[q] = the query pixel's key; the trailing slot is
            # the inactive 0-key every out-of-lane element points at
            key_list = np.zeros(n_q + 1, np.int32)
            key_list[:n_q] = key_q.astype(np.int32)
        if light and factored and disjoint_ok:
            # the engine's wire form never touches the expanded tables
            # or the full qkeys matrix: skip materializing them (the
            # dominant remaining plan-build cost at production counts)
            lane_lo = lane_span = None
        else:
            qkeys = k_lane.astype(np.int32)
            lane_lo = np.ascontiguousarray(
                np.swapaxes(tab_lo[:, k_lane], 0, 1))
            lane_span = np.ascontiguousarray(
                np.swapaxes(tab_span[:, k_lane], 0, 1))
    else:
        lane_lo = np.empty((len(offsets), n_slots0, u_count), np.uint32)
        lane_span = np.empty_like(lane_lo)
        lane_any2 = np.zeros((len(offsets), u_count), bool)
        for j, (dx, dy) in enumerate(offsets):
            qx = ux - dx
            qy = uy - dy
            src = union - dx - dy * w
            jj = pos_index[np.clip(src, 0, n_pixels - 1)]
            active = ((qx >= 0) & (qx < w) & (qy >= 0) & (qy < h)
                      & (jj >= 0))
            idx = np.where(active, jj, 0)
            lane_lo[j], lane_span[j] = build_key_intervals(
                np.where(active, cls[idx], 0),
                np.where(active, s[idx], 0),
                np.where(active, p[idx], 0), ztol)

    # one straight row set; the mirrored set reuses the lane table —
    # mirror(q + dx + dy*w) = mirror_x(q) - dx + dy*w, so it covers the
    # (-dx, dy) shifts of the mirrored query, a complete set because
    # {dx} is symmetric
    u_pos = union.astype(np.int32).reshape(1, u_count)
    mu_pos = (union + (w - 1) - 2 * ux).astype(np.int32) \
        .reshape(1, u_count) if mirror else np.zeros((0, u_count),
                                                     np.int32)
    if tab2 is None:
        lane_lo, lane_span = compact_interval_slots(lane_lo, lane_span)
    if not disjoint_ok:
        # the qkey kernel ADDS the two slots' indicator sums, valid
        # only under the per-table disjointness proof
        qkeys = None
        qidx = key_list = q_pos = None
    u2 = -1
    two_slots = (tab2 is not None if lane_lo is None
                 else lane_lo.shape[1] == 2)
    if two_slots and u_count and disjoint_ok:
        # slot-2 segmentation: permute elements so those with a live
        # second window (in any lane) form the prefix — the kernel then
        # confines slot-2 range tests to [0, u2).  The mirror position
        # set shares the element order, so one permutation serves both.
        # The segmented kernel ADDS the two slots' indicator sums
        # (no OR), which is exact because _key_interval_table2 proved
        # every key's live windows sit in distinct class segments
        # (disjoint_ok) — no key can match both.
        any2 = lane_any2.any(axis=0)
        perm = np.concatenate([np.flatnonzero(any2),
                               np.flatnonzero(~any2)])
        u_pos = u_pos[:, perm]
        mu_pos = mu_pos[:, perm]
        if lane_lo is not None:
            lane_lo = np.ascontiguousarray(lane_lo[:, :, perm])
            lane_span = np.ascontiguousarray(lane_span[:, :, perm])
        if qkeys is not None:
            qkeys = np.ascontiguousarray(qkeys[:, perm])
        if qidx is not None:
            qidx = np.ascontiguousarray(qidx[:, perm])
        u2 = int(any2.sum())
    plan = UnionKeyPlan(u_pos, mu_pos, lane_lo, lane_span,
                        int(positions.size), mirror, u2=u2,
                        qkeys=qkeys, z_tol=ztol, qidx=qidx,
                        key_list=key_list, q_pos=q_pos)
    return pad_union_key_plan(
        plan, pad_to if pad_to is not None else _bucket(u_count), n_pixels)


def pad_union_key_plan(plan: UnionKeyPlan, u_pad: int,
                       n_pixels: int,
                       n_slots: int | None = None) -> UnionKeyPlan:
    """Re-pad a union plan to a wider bucket (sentinel positions, empty
    intervals) — lets a batch of plans with different natural buckets
    stack into one dispatch without rebuilding the bisections.
    ``n_slots`` additionally pads the (compacted) interval-slot axis so
    plans with different slot counts stack too."""
    u = plan.u_pos.shape[1]
    light = plan.lane_lo is None
    s = 2 if light else plan.lane_lo.shape[1]
    s_pad = s if n_slots is None else n_slots
    if u_pad == u and s_pad == s:
        return plan
    if u_pad < u:
        raise ValueError(f"pad_to {u_pad} < union size {u}")
    if s_pad < s:
        raise ValueError(f"n_slots {s_pad} < slot count {s}")
    padw = ((0, 0), (0, u_pad - u))
    lane_pad = ((0, 0), (0, s_pad - s), (0, u_pad - u))
    # padding appends sentinel elements with empty slot-2 windows, so
    # the segmentation prefix [0, u2) is unchanged (qkey 0 = inactive)
    return UnionKeyPlan(
        np.pad(plan.u_pos, padw, constant_values=n_pixels),
        np.pad(plan.mu_pos, padw, constant_values=n_pixels),
        None if light else np.pad(plan.lane_lo, lane_pad,
                                  constant_values=int(_EMPTY_LO)),
        None if light else np.pad(plan.lane_span, lane_pad),
        plan.query_size, plan.mirror, u2=plan.u2,
        qkeys=(None if plan.qkeys is None
               else np.pad(plan.qkeys, padw)),
        z_tol=plan.z_tol,
        # pad elements point at the plan's own inactive 0-key slot
        qidx=(None if plan.qidx is None
              else np.pad(plan.qidx, padw,
                          constant_values=plan.query_size)),
        key_list=plan.key_list, q_pos=plan.q_pos)


def stack_union_plan_args(plans: list, n_pixels: int):
    """Host [B, ...] stacks of (u_pos, mu_pos, lane_lo, lane_span) for
    a batch of union plans, padded to the batch's common union bucket
    and interval-slot count (slot counts vary per mask after
    compact_interval_slots).

    Also returns the batch's slot-2 prefix width ``u2_pad`` (static
    kernel parameter): the max of the members' segmentation prefixes,
    bucketed so dispatch shapes are reused; ``u_pad`` for any
    unsegmented member (the kernel then tests slot 2 full-width, which
    is always correct).  LIGHT plans (tables dropped for the
    compressed wire forms) get their tables re-expanded on host here,
    so this stacker works for any plan."""

    def host_expand(p):
        if p.lane_lo is not None:
            return p
        tabs = interval_table_arrays(p.z_tol)
        assert tabs is not None and p.qidx is not None
        qk = p.key_list[p.qidx.astype(np.int64)]
        return dataclasses.replace(
            p,
            lane_lo=np.ascontiguousarray(
                np.swapaxes(tabs[0][:, qk], 0, 1)),
            lane_span=np.ascontiguousarray(
                np.swapaxes(tabs[1][:, qk], 0, 1)))

    plans = [host_expand(p) for p in plans]
    n_slots = max(p.lane_lo.shape[1] for p in plans)
    # single-slot tables carry no live slot-2 windows: clamp their u2
    # so the common bucketing (one source of truth) sees 0
    plans = [dataclasses.replace(p, u2=0) if p.lane_lo.shape[1] < 2
             and p.u2 < 0 else p for p in plans]
    plans, u_pad, u2_pad, _kl = _stack_union_common(
        plans, n_pixels, with_key_list=False)
    plans = [pad_union_key_plan(p, u_pad, n_pixels, n_slots)
             for p in plans]
    return (np.stack([p.u_pos for p in plans]),
            np.stack([p.mu_pos for p in plans]),
            np.stack([p.lane_lo for p in plans]),
            np.stack([p.lane_span for p in plans]),
            u2_pad)


def stack_union_pos_args(plans: list, n_pixels: int):
    """[B, ...] stacks of (u_pos, mu_pos, q_pos, key_list) + static u2
    for the POSITIONAL wire form, or None when any plan lacks it.  The
    per-(lane, element) index matrix never crosses the wire: the device
    re-derives it from the query positions
    (expand_union_tables_from_pos), cutting plan args to ~65 KB/mask."""
    if any(p.q_pos is None or p.key_list is None for p in plans):
        return None
    plans, _u_pad, u2_pad, kl = _stack_union_common(
        plans, n_pixels, with_key_list=True)
    qp = np.full((len(plans), kl.shape[1] - 1), n_pixels, np.int32)
    for i, p in enumerate(plans):
        qp[i, :p.q_pos.size] = p.q_pos
    return (np.stack([p.u_pos for p in plans]),
            np.stack([p.mu_pos for p in plans]),
            qp, kl, u2_pad)


def stack_union_qkey_args(plans: list, n_pixels: int):
    """[B, ...] stacks of (u_pos, mu_pos, qidx, key_list) + static u2 for
    the factored qkey wire form, or None when any plan lacks it (3-slot
    tolerance, disjointness unproven, or a >= 65,535-pixel query). qidx
    stays uint16 [B, L, U] here (convert.as_tensor widens it to int32);
    index query_size of a mask points at its trailing 0 key."""
    if any(p.qidx is None or p.key_list is None for p in plans):
        return None
    plans, _u_pad, u2_pad, kl = _stack_union_common(
        plans, n_pixels, with_key_list=True)
    return (np.stack([p.u_pos for p in plans]),
            np.stack([p.mu_pos for p in plans]),
            np.stack([p.qidx for p in plans]),
            kl,
            u2_pad)


def interval_table_arrays(z_tol: float):
    """The shared (lo, span) uint32 [2, 7 << KEY_RANK_BITS] per-key
    interval tables the qkey kernel gathers from, or None when the
    tolerance needs 3 slots (callers use the expanded lane tables)."""
    tab2 = _key_interval_table2(float(z_tol))
    if tab2 is None:
        return None
    tab_lo, tab_span, _any2, ok = tab2
    return (tab_lo, tab_span) if ok else None


def _stack_union_common(plans: list, n_pixels: int,
                        with_key_list: bool):
    """Shared stacking core of the three union wire forms: the common
    union bucket, the batch's bucketed slot-2 prefix, padded plans, and
    (optionally) the padded key-list matrix — ONE source of truth for
    the dispatch-shape rules."""
    u_pad = max(p.u_pos.shape[1] for p in plans)
    u2_pad = max(p.u2 if p.u2 >= 0 else u_pad for p in plans)
    if 0 < u2_pad < u_pad:
        u2_pad = min(u_pad, _bucket(u2_pad, minimum=128))
    plans = [pad_union_key_plan(p, u_pad, n_pixels) for p in plans]
    kl = None
    if with_key_list:
        kl_pad = _bucket(max(p.key_list.size for p in plans),
                         minimum=512)
        kl = np.zeros((len(plans), kl_pad), np.int32)
        for i, p in enumerate(plans):
            # trailing zeros keep every inactive index (q >= query
            # size) pointing at a 0 key
            kl[i, :p.key_list.size] = p.key_list
    return plans, u_pad, u2_pad, kl


# --- device kernels ------------------------------------------------------

_U32 = 0xFFFFFFFF


def expand_union_tables_from_pos_plain(u_pos, q_pos, key_list, tab_lo,
                                       tab_span, *, offsets, w: int,
                                       h: int):
    """Plain PyTorch version of K2 (see expand_union_tables_from_pos)."""
    n_px = w * h
    batch, n_u = u_pos.shape[0], u_pos.shape[2]
    n_kl = key_list.shape[1]
    dev = u_pos.device
    pos_index = torch.full((batch, n_px + 1), n_kl - 1, dtype=torch.int32,
                           device=dev)
    qi = torch.arange(q_pos.shape[1], dtype=torch.int32, device=dev)
    rows = torch.arange(batch, device=dev)[:, None].expand_as(q_pos)
    pos_index[rows, q_pos.long()] = qi.expand_as(q_pos)
    u = u_pos[:, 0].long()                                  # [B, U]
    ux, uy = u % w, u // w
    js = []
    for dx, dy in offsets:
        qx, qy = ux - dx, uy - dy
        src = (u - dx - dy * w).clamp(0, n_px - 1)
        ok = (u < n_px) & (qx >= 0) & (qx < w) & (qy >= 0) & (qy < h)
        js.append(torch.where(ok, torch.gather(pos_index, 1, src),
                              torch.full_like(src, n_kl - 1,
                                              dtype=torch.int32)))
    jj = torch.stack(js, 1).long()                          # [B, L, U]
    qk = torch.gather(key_list.long(), 1,
                      jj.reshape(batch, -1)).reshape(jj.shape)
    lane_lo = torch.stack([tab_lo[0][qk], tab_lo[1][qk]], 2)
    lane_span = torch.stack([tab_span[0][qk], tab_span[1][qk]], 2)
    return lane_lo.contiguous(), lane_span.contiguous()


def expand_union_tables_from_pos(u_pos, q_pos, key_list, tab_lo, tab_span,
                                 *, offsets, w: int, h: int):
    """K2: positional wire form -> expanded device lane tables.

    u_pos int32 [B, S, U] (set 0 is read; sentinel = w*h), q_pos int32
    [B, KL-1] (pad = w*h), key_list int32 [B, KL], tab_lo/tab_span int32
    [2, n_keys] (uint32 bits) -> (lane_lo, lane_span) int32 [B, L, 2, U]
    with L = len(offsets). The same derivation as the host plan build:
    out-of-image shifts, non-query pixels and sentinel pads are inactive
    (key 0 -> the empty interval). CPU tensors run the plain version;
    CUDA tensors launch kernels/csrc/expand_tables.cu or raise.

    Precondition of the kernel (not of the plain version): each mask's
    q_pos rises strictly, its pads (= w*h) last, as
    stack_union_pos_args builds it from np.flatnonzero; the kernel finds
    a pixel's row by searching q_pos. u_pos needs no order.
    """
    batch, n_sets, n_u = u_pos.shape
    n_kl = key_list.shape[1]
    kbuild.check_tensor(u_pos, "u_pos", torch.int32)
    kbuild.check_tensor(q_pos, "q_pos", torch.int32, (batch, n_kl - 1))
    kbuild.check_tensor(key_list, "key_list", torch.int32, (batch, n_kl))
    kbuild.check_tensor(tab_lo, "tab_lo", torch.int32)
    kbuild.check_tensor(tab_span, "tab_span", torch.int32, tuple(tab_lo.shape))
    kbuild.same_device(u_pos, q_pos, key_list, tab_lo, tab_span)
    if tab_lo.dim() != 2 or tab_lo.shape[0] != 2 or n_sets < 1:
        raise ValueError("expected tab_lo [2, n_keys] and u_pos [B, S>=1, U]")
    if u_pos.device.type == "cpu":
        return expand_union_tables_from_pos_plain(
            u_pos, q_pos, key_list, tab_lo, tab_span, offsets=offsets,
            w=w, h=h)
    kbuild.require_cuda(u_pos)
    offs = _host_offsets(tuple(tuple(o) for o in offsets))
    lane_lo = torch.empty((batch, len(offsets), 2, n_u), dtype=torch.int32,
                          device=u_pos.device)
    lane_span = torch.empty_like(lane_lo)
    lib = kbuild.load_library()
    kbuild.check(lib.cmst_expand_tables(
        u_pos.data_ptr(), n_sets * n_u, q_pos.data_ptr(), n_kl - 1,
        key_list.data_ptr(), n_kl, tab_lo.data_ptr(), tab_span.data_ptr(),
        tab_lo.shape[1], offs, batch, len(offsets), n_u, w, h,
        lane_lo.data_ptr(), lane_span.data_ptr(),
        kbuild.stream_of(u_pos)), "expand_union_tables_from_pos")
    kbuild.count_launch("expand_union_tables_from_pos")
    return lane_lo, lane_span


@functools.lru_cache(maxsize=64)
def _host_offsets(offsets: tuple):
    """K2's lane offsets as a host int32 array of (dx, dy) pairs, built
    once per offset set: the launcher copies them into the kernel's
    parameters, so no call copies to the card."""
    flat = [c for o in offsets for c in o]
    return (ctypes.c_int32 * max(len(flat), 1))(*flat)


def _is_segmented(u2, n_slots: int, n_u: int) -> bool:
    # segmented (slot-2 hits ADDED on the prefix u < u2) only for
    # two-slot tables with an in-range prefix; otherwise slots are ORed
    return u2 is not None and n_slots == 2 and 0 <= u2 < n_u


def _lane_counts_plain(key, lo, sp, c0: int, u2, seg: bool):
    """int64 [L, T] lane counts of the union slice that starts at element
    c0 and whose gathered keys are key int64 [n, T]; lo, sp int64 [L,
    n_slots, U] are one mask's lane windows (sp as uint32 values)."""
    n = key.shape[0]
    n2 = min(max((u2 or 0) - c0, 0), n)
    counts = []
    for j in range(lo.shape[0]):
        l, s = lo[j, :, c0:c0 + n], sp[j, :, c0:c0 + n]
        hit = ((key - l[0, :, None]) & _U32) <= s[0, :, None]
        if seg:
            c = hit.sum(0)
            if n2 > 0:
                c = c + (((key[:n2] - l[1, :n2, None]) & _U32)
                         <= s[1, :n2, None]).sum(0)
        else:
            for sl in range(1, lo.shape[1]):
                hit |= ((key - l[sl, :, None]) & _U32) <= s[sl, :, None]
            c = hit.sum(0)
        counts.append(c)
    return torch.stack(counts)


def _union_finish_plain(counts, n_msets: int):
    """counts [B, 2, S, L, T] summed over the whole union -> (best int32
    [B, T], mirrored bool [B, T]): the max over sets and lanes of each
    orientation, the mirror winning only when strictly greater."""
    straight = counts[:, 0].amax(dim=(1, 2))
    if n_msets == 0:
        return straight.to(torch.int32), torch.zeros_like(straight,
                                                          dtype=torch.bool)
    mirror = counts[:, 1, :n_msets].amax(dim=(1, 2))
    return torch.maximum(straight, mirror).to(torch.int32), mirror > straight


def _union_walk_plain(gather, n_cols: int, dev, u_pos, mu_pos, lane_lo,
                      lane_span, u2, chunk: int, seg: bool | None = None):
    """K3's, K13's and the qkey kernel's plain walk: gather(rows) -> int64
    [len(rows), T] keys. The kernels' decomposition: the lane counts of
    every `chunk`-element slice of the union, summed into [B, 2, S, L, T]
    as the kernels' atomics sum them (which also keeps the int64 [chunk,
    T] intermediates bounded at production shapes), then one max over
    sets and lanes of each orientation (_union_finish_plain). `seg`
    forces the segmented form with prefix u2 (the qkey kernel, where u2
    may equal U); None derives it as K3 does."""
    batch, n_sets, n_u = u_pos.shape
    n_lanes, n_slots = lane_lo.shape[1], lane_lo.shape[2]
    if seg is None:
        seg = _is_segmented(u2, n_slots, n_u)
    counts = torch.zeros((batch, 2, n_sets, n_lanes, n_cols),
                         dtype=torch.int64, device=dev)
    for b in range(batch):
        lo_b = lane_lo[b].long()
        sp_b = lane_span[b].long() & _U32
        for o, pos_sets in enumerate((u_pos[b], mu_pos[b])):
            for si, pos in enumerate(pos_sets):
                for c0 in range(0, n_u, chunk):
                    counts[b, o, si] += _lane_counts_plain(
                        gather(pos[c0:c0 + chunk].long()), lo_b, sp_b, c0,
                        u2, seg)
    return _union_finish_plain(counts, mu_pos.shape[1])


def score_query_batch_union_keys_plain(planes, u_pos, mu_pos, lane_lo,
                                       lane_span, u2=None, *,
                                       chunk: int = 4096):
    """Plain PyTorch version of K3 (see score_query_batch_union_keys)."""
    return _union_walk_plain(
        lambda rows: planes.index_select(0, rows).long(), planes.shape[1],
        planes.device, u_pos, mu_pos, lane_lo, lane_span, u2, chunk)


def _check_union(planes: dict, u_pos, mu_pos, lane_lo, lane_span) -> None:
    """Validation shared by the K3 and K13 wrappers; `planes` maps each
    plane tensor's name to (tensor, dtype)."""
    _check_planes(planes)
    batch, n_sets, n_u = u_pos.shape
    kbuild.check_tensor(u_pos, "u_pos", torch.int32)
    kbuild.check_tensor(mu_pos, "mu_pos", torch.int32)
    kbuild.check_tensor(lane_lo, "lane_lo", torch.int32)
    kbuild.check_tensor(lane_span, "lane_span", torch.int32,
                        tuple(lane_lo.shape))
    kbuild.same_device(*(x for x, _ in planes.values()), u_pos, mu_pos,
                       lane_lo, lane_span)
    n_msets = mu_pos.shape[1]
    if mu_pos.shape[0] != batch or mu_pos.shape[2] != n_u \
            or n_msets not in (0, n_sets):
        raise ValueError(f"mu_pos {tuple(mu_pos.shape)} does not fit "
                         f"u_pos {tuple(u_pos.shape)}")
    if lane_lo.dim() != 4 or lane_lo.shape[0] != batch \
            or lane_lo.shape[3] != n_u or not 1 <= lane_lo.shape[2] <= 3:
        raise ValueError(f"lane tables {tuple(lane_lo.shape)} do not fit "
                         f"u_pos {tuple(u_pos.shape)}")
    if batch > 65535:
        raise ValueError(f"{batch} masks in one launch (at most 65,535)")


# bytes of the union kernels' lane-count scratch a launch may take
UNION_SCRATCH_CAP = 1 << 30


def _union_scratch(batch: int, n_sets: int, n_lanes: int, n_cols: int,
                   dev) -> torch.Tensor:
    """The zeroed int32 [B, 2, S, L, T] lane counts the union kernels
    (K3, K13, row 14) sum their chunks into; raises past
    UNION_SCRATCH_CAP."""
    n_bytes = batch * 2 * n_sets * n_lanes * n_cols * 4
    if n_bytes > UNION_SCRATCH_CAP:
        raise ValueError(
            f"the union kernels' lane counts [{batch}, 2, {n_sets}, "
            f"{n_lanes}, {n_cols}] take {n_bytes} bytes, past the "
            f"{UNION_SCRATCH_CAP}-byte cap: split the batch")
    return torch.zeros((batch, 2, n_sets, n_lanes, n_cols),
                       dtype=torch.int32, device=dev)


def _check_chunk(chunk: int) -> None:
    if chunk < 0:
        raise ValueError(f"chunk {chunk} < 0 (0: the kernel chooses)")


def _launch_union(entry: str, name: str, plane_ptrs, n_cols: int, dev,
                  u_pos, mu_pos, lane_lo, lane_span, u2, chunk: int):
    """Launch K3 (entry cmst_union_score) or K13 (cmst_union_score_splitk)
    on CUDA tensors; returns (best, mirrored)."""
    batch, n_sets, n_u = u_pos.shape
    n_lanes, n_slots = lane_lo.shape[1], lane_lo.shape[2]
    scratch = _union_scratch(batch, n_sets, n_lanes, n_cols, dev)
    best = torch.empty((batch, n_cols), dtype=torch.int32, device=dev)
    mirrored = torch.empty((batch, n_cols), dtype=torch.bool, device=dev)
    seg = _is_segmented(u2, n_slots, n_u)
    lib = kbuild.load_library()
    kbuild.check(getattr(lib, entry)(
        *plane_ptrs, n_cols, u_pos.data_ptr(), mu_pos.data_ptr(), n_sets,
        mu_pos.shape[1], lane_lo.data_ptr(), lane_span.data_ptr(), batch,
        n_lanes, n_slots, n_u, u2 if seg else -1, int(seg), chunk,
        scratch.data_ptr(), best.data_ptr(), mirrored.data_ptr(),
        kbuild.stream_of(u_pos)), name)
    kbuild.count_launch(name)
    return best, mirrored


def score_query_batch_union_keys(planes, u_pos, mu_pos, lane_lo, lane_span,
                                 u2: int | None = None, *, chunk: int = 0):
    """K3: batched union-lane key scoring with the variant reduction.

    planes int32 [P+1, T]; u_pos int32 [B, S, U]; mu_pos int32 [B, S or
    0, U] (mirror sets, empty without mirror); lane_lo/lane_span int32
    [B, L, n_slots <= 3, U] (uint32 bits); u2 the batch's slot-2
    segmentation prefix (stack_union_plan_args) or None. Returns
    (best int32 [B, T], mirrored bool [B, T]). CPU tensors run the plain
    version; CUDA tensors launch kernels/csrc/union_score.cu or raise.
    `chunk` sets the union elements a block counts (0: the kernel
    chooses; any other value is for testing the decomposition); the
    result does not depend on it.
    """
    _check_union({"planes": (planes, torch.int32)}, u_pos, mu_pos, lane_lo,
                 lane_span)
    _check_chunk(chunk)
    if planes.device.type == "cpu":
        return score_query_batch_union_keys_plain(
            planes, u_pos, mu_pos, lane_lo, lane_span, u2)
    kbuild.require_cuda(planes)
    return _launch_union("cmst_union_score", "score_query_batch_union_keys",
                         (planes.data_ptr(),), planes.shape[1],
                         planes.device, u_pos, mu_pos, lane_lo, lane_span,
                         u2, chunk)


def split_key_planes(keys: torch.Tensor):
    """K12, split-key mode: int32 [P+1, T] key planes -> (int16 [P+1, T]
    with the bits of the uint16 rank, uint8 [P+1, T] cls), as the JAX
    package's split_key_planes. CPU tensors run the plain version; CUDA
    tensors launch kernels/csrc/repack_planes.cu or raise."""
    return common.repack_planes(keys, "split_key_planes")


def score_query_batch_union_keys_splitk_plain(rank, cls, u_pos, mu_pos,
                                              lane_lo, lane_span, u2=None,
                                              *, chunk: int = 4096):
    """Plain PyTorch version of K13 (see
    score_query_batch_union_keys_splitk): the key of each gathered element
    is (cls << 15) | rank."""
    def gather(rows):
        return (cls.index_select(0, rows).long() << common.KEY_RANK_BITS) \
            | (rank.index_select(0, rows).long() & 0xFFFF)

    return _union_walk_plain(gather, rank.shape[1], rank.device, u_pos,
                             mu_pos, lane_lo, lane_span, u2, chunk)


def score_query_batch_union_keys_splitk(rank, cls, u_pos, mu_pos, lane_lo,
                                        lane_span, u2: int | None = None, *,
                                        chunk: int = 0):
    """K13: K3 over the split key planes of split_key_planes (rank int16
    with the uint16 bits, cls uint8, both [P+1, T]); every other argument
    and the result as score_query_batch_union_keys'. CPU tensors run the
    plain version; CUDA tensors launch kernels/csrc/union_score.cu or
    raise."""
    _check_union({"rank": (rank, torch.int16), "cls": (cls, torch.uint8)},
                 u_pos, mu_pos, lane_lo, lane_span)
    _check_chunk(chunk)
    if rank.device.type == "cpu":
        return score_query_batch_union_keys_splitk_plain(
            rank, cls, u_pos, mu_pos, lane_lo, lane_span, u2)
    kbuild.require_cuda(rank)
    return _launch_union("cmst_union_score_splitk",
                         "score_query_batch_union_keys_splitk",
                         (rank.data_ptr(), cls.data_ptr()), rank.shape[1],
                         rank.device, u_pos, mu_pos, lane_lo, lane_span, u2,
                         chunk)


def union_keys_topk_plain(best, mirrored, k: int, pair_flags=None):
    """Plain PyTorch version of K4: a stable descending sort gives
    jax.lax.top_k's order (score descending, lower column first)."""
    scores, idx = torch.sort(best, dim=1, descending=True, stable=True)
    idx = idx[:, :k]
    out = (scores[:, :k].contiguous(), idx.to(torch.int32),
           torch.gather(mirrored, 1, idx))
    if pair_flags is None:
        return out
    return out + (torch.gather(pair_flags, 1, idx),)


@functools.lru_cache(maxsize=None)
def _topk_max_cols(lib) -> int:
    """K4's column cap (topk.cu MAX_COLS), asked of each library once."""
    return int(lib.cmst_topk_max_cols())


def union_keys_topk(best, mirrored, k: int, pair_flags=None):
    """K4: per-mask top-k of best int32 [B, T] -> (scores_k int32 [B, k],
    idx_k int32 [B, k], mirr_k bool [B, k]) in jax.lax.top_k's order, and
    with pair_flags int32 [B, T] also flags_k int32 [B, k] gathered at the
    same columns (the per-shard tail of the mesh steps). CPU tensors run
    the plain version; CUDA tensors launch kernels/csrc/topk.cu
    (T <= 16,384) or raise."""
    batch, n_cols = best.shape
    kbuild.check_tensor(best, "best", torch.int32)
    kbuild.check_tensor(mirrored, "mirrored", torch.bool, (batch, n_cols))
    extra = ()
    if pair_flags is not None:
        kbuild.check_tensor(pair_flags, "pair_flags", torch.int32,
                            (batch, n_cols))
        extra = (pair_flags,)
    kbuild.same_device(best, mirrored, *extra)
    if not 1 <= k <= n_cols:
        raise ValueError(f"k={k} outside [1, {n_cols}]")
    if best.device.type == "cpu":
        return union_keys_topk_plain(best, mirrored, k, pair_flags)
    kbuild.require_cuda(best)
    lib = kbuild.load_library()
    max_cols = _topk_max_cols(lib)
    if n_cols > max_cols:
        raise ValueError(f"union_keys_topk: {n_cols} columns exceed the "
                         f"kernel's {max_cols}")
    # the int32 outputs (scores, columns[, flags]) as views of one
    # allocation (carving the bool output from it too costs more host time
    # in dtype views than its own allocation)
    scores_k, idx_k, *flags = torch.empty(
        (3 if extra else 2, batch, k), dtype=torch.int32,
        device=best.device).unbind(0)
    flags_k = flags[0] if extra else None
    mirr_k = torch.empty((batch, k), dtype=torch.bool, device=best.device)
    kbuild.check(lib.cmst_topk(
        best.data_ptr(), mirrored.data_ptr(),
        pair_flags.data_ptr() if extra else None, batch, n_cols, k,
        scores_k.data_ptr(), idx_k.data_ptr(), mirr_k.data_ptr(),
        flags_k.data_ptr() if extra else None, kbuild.stream_of(best)),
        "union_keys_topk")
    kbuild.count_launch("union_keys_topk")
    out = (scores_k, idx_k, mirr_k)
    return out + (flags_k,) if extra else out


def score_query_batch_union_keys_topk(planes, u_pos, mu_pos, lane_lo,
                                      lane_span, u2: int | None = None, *,
                                      k: int):
    """K3 + K4: batched union scoring and the per-mask top-k emit
    selection. Returns (scores_k, idx_k, mirr_k, best, mirrored); the
    dense [B, T] arrays stay on the device as the lossless fallback when
    a mask's k-th selected score could still emit (engine/cds.py)."""
    best, mirrored = score_query_batch_union_keys(
        planes, u_pos, mu_pos, lane_lo, lane_span, u2)
    scores_k, idx_k, mirr_k = union_keys_topk(best, mirrored, k)
    return scores_k, idx_k, mirr_k, best, mirrored


# --- the qkey wire form: row 13 (table expansion) and row 14 (scoring) ---


def _check_qkeys(qidx, key_list, tab_lo, tab_span) -> None:
    """Validation shared by the row 13 and row 14 wrappers."""
    kbuild.check_tensor(qidx, "qidx", torch.int32)
    if qidx.dim() != 3:
        raise ValueError(f"expected qidx [B, L, U], got {tuple(qidx.shape)}")
    kbuild.check_tensor(key_list, "key_list", torch.int32)
    if key_list.dim() != 2 or key_list.shape[0] != qidx.shape[0] \
            or key_list.shape[1] < 1:
        raise ValueError(f"key_list {tuple(key_list.shape)} does not fit "
                         f"qidx {tuple(qidx.shape)}")
    kbuild.check_tensor(tab_lo, "tab_lo", torch.int32)
    kbuild.check_tensor(tab_span, "tab_span", torch.int32,
                        tuple(tab_lo.shape))
    if tab_lo.dim() != 2 or tab_lo.shape[0] != 2 or tab_lo.shape[1] < 1:
        raise ValueError(f"expected tab_lo [2, n_keys], got "
                         f"{tuple(tab_lo.shape)}")
    kbuild.same_device(qidx, key_list, tab_lo, tab_span)


def expand_union_tables_plain(qidx, key_list, tab_lo, tab_span):
    """Plain PyTorch version of row 13 (see expand_union_tables)."""
    batch, n_lanes, n_u = qidx.shape
    rows = qidx.long().clamp(0, key_list.shape[1] - 1)
    qk = torch.gather(key_list.long(), 1, rows.reshape(batch, -1)) \
        .reshape(rows.shape).clamp(0, tab_lo.shape[1] - 1)
    lane_lo = torch.stack([tab_lo[0][qk], tab_lo[1][qk]], 2)
    lane_span = torch.stack([tab_span[0][qk], tab_span[1][qk]], 2)
    return lane_lo.contiguous(), lane_span.contiguous()


def expand_union_tables(qidx, key_list, tab_lo, tab_span):
    """Row 13: the factored qkey wire form -> expanded lane tables.

    qidx int32 [B, L, U] (the uint16 indices widened; index query_size
    points at the mask's trailing 0 key), key_list int32 [B, KL],
    tab_lo/tab_span int32 [2, n_keys] (uint32 bits of the shared
    per-tolerance tables, interval_table_arrays) -> (lane_lo, lane_span)
    int32 [B, L, 2, U] with qk = key_list[b, qidx[b, l, u]] and slot s of
    each table at qk. Equal to K2's expansion of the same batch's
    positional form. CPU tensors run the plain version; CUDA tensors
    launch kernels/csrc/expand_tables.cu (its qkey mode) or raise."""
    _check_qkeys(qidx, key_list, tab_lo, tab_span)
    if qidx.device.type == "cpu":
        return expand_union_tables_plain(qidx, key_list, tab_lo, tab_span)
    kbuild.require_cuda(qidx)
    batch, n_lanes, n_u = qidx.shape
    lane_lo = torch.empty((batch, n_lanes, 2, n_u), dtype=torch.int32,
                          device=qidx.device)
    lane_span = torch.empty_like(lane_lo)
    lib = kbuild.load_library()
    kbuild.check(lib.cmst_expand_qkeys(
        qidx.data_ptr(), key_list.data_ptr(), key_list.shape[1],
        tab_lo.data_ptr(), tab_span.data_ptr(), tab_lo.shape[1], batch,
        n_lanes, n_u, lane_lo.data_ptr(), lane_span.data_ptr(),
        kbuild.stream_of(qidx)), "expand_union_tables")
    kbuild.count_launch("expand_union_tables")
    return lane_lo, lane_span


def _qkey_prefix(u2, n_u: int) -> int:
    """The slot-2 prefix of the qkey form: u2 when 0 <= u2 <= U, else the
    whole union (JAX score_query_union_qkeys_raw's u2e)."""
    return u2 if u2 is not None and 0 <= u2 <= n_u else n_u


def score_query_batch_union_qkeys_plain(planes, u_pos, mu_pos, qidx,
                                        key_list, tab_lo, tab_span,
                                        u2=None, *, chunk: int = 4096):
    """Plain PyTorch version of row 14: the plain row 13 expansion, then
    K3's plain walk in its segmented form."""
    lane_lo, lane_span = expand_union_tables_plain(qidx, key_list, tab_lo,
                                                   tab_span)
    return _union_walk_plain(
        lambda rows: planes.index_select(0, rows).long(), planes.shape[1],
        planes.device, u_pos, mu_pos, lane_lo, lane_span,
        _qkey_prefix(u2, u_pos.shape[2]), chunk, seg=True)


def score_query_batch_union_qkeys(planes, u_pos, mu_pos, qidx, key_list,
                                  tab_lo, tab_span, u2: int | None = None, *,
                                  chunk: int = 0):
    """Row 14: K3 on the factored qkey wire form.

    planes int32 [P+1, T]; u_pos int32 [B, S, U], mu_pos int32 [B, S or
    0, U]; qidx, key_list, tab_lo, tab_span as expand_union_tables';
    u2 the batch's slot-2 prefix (stack_union_qkey_args; None or out of
    [0, U] = the whole union). The two windows of a key are disjoint
    (the wire form exists only under that proof), so slot 2's hits are
    always ADDED, never ORed. Returns (best int32 [B, T], mirrored bool
    [B, T]), equal to K3's on the same batch's expanded tables. CPU
    tensors run the plain version; CUDA tensors launch
    kernels/csrc/union_score.cu (its qkey table source) or raise
    (`chunk` as score_query_batch_union_keys')."""
    _check_planes({"planes": (planes, torch.int32)})
    _check_chunk(chunk)
    _check_qkeys(qidx, key_list, tab_lo, tab_span)
    kbuild.check_tensor(u_pos, "u_pos", torch.int32)
    kbuild.check_tensor(mu_pos, "mu_pos", torch.int32)
    kbuild.same_device(planes, u_pos, mu_pos, qidx)
    batch, n_sets, n_u = u_pos.shape
    n_msets = mu_pos.shape[1]
    if mu_pos.shape[0] != batch or mu_pos.shape[2] != n_u \
            or n_msets not in (0, n_sets):
        raise ValueError(f"mu_pos {tuple(mu_pos.shape)} does not fit "
                         f"u_pos {tuple(u_pos.shape)}")
    if qidx.shape[0] != batch or qidx.shape[2] != n_u:
        raise ValueError(f"qidx {tuple(qidx.shape)} does not fit u_pos "
                         f"{tuple(u_pos.shape)}")
    if batch > 65535:
        raise ValueError(f"{batch} masks in one launch (at most 65,535)")
    if planes.device.type == "cpu":
        return score_query_batch_union_qkeys_plain(
            planes, u_pos, mu_pos, qidx, key_list, tab_lo, tab_span, u2)
    kbuild.require_cuda(planes)
    dev = planes.device
    n_cols = planes.shape[1]
    scratch = _union_scratch(batch, n_sets, qidx.shape[1], n_cols, dev)
    best = torch.empty((batch, n_cols), dtype=torch.int32, device=dev)
    mirrored = torch.empty((batch, n_cols), dtype=torch.bool, device=dev)
    lib = kbuild.load_library()
    kbuild.check(lib.cmst_union_score_qkeys(
        planes.data_ptr(), n_cols, u_pos.data_ptr(), mu_pos.data_ptr(),
        n_sets, n_msets, qidx.data_ptr(), key_list.data_ptr(),
        key_list.shape[1], tab_lo.data_ptr(), tab_span.data_ptr(),
        tab_lo.shape[1], batch, qidx.shape[1], n_u, _qkey_prefix(u2, n_u),
        chunk, scratch.data_ptr(), best.data_ptr(), mirrored.data_ptr(),
        kbuild.stream_of(planes)), "score_query_batch_union_qkeys")
    kbuild.count_launch("score_query_batch_union_qkeys")
    return best, mirrored


# --- the classic kernels: K9 (banded, packed planes) and K10 (keys) -------


def _reduce_variants(scores: torch.Tensor, n_straight: int):
    """[V, T] counts -> (best int32 [T], mirrored bool [T]) with the
    semantics of reduce_variants_device (mirror wins only when strictly
    greater than the best straight variant)."""
    straight = scores[:n_straight].max(0).values
    if scores.shape[0] > n_straight:
        mirror = scores[n_straight:].max(0).values
        return (torch.maximum(straight, mirror).to(torch.int32),
                mirror > straight)
    return straight.to(torch.int32), torch.zeros_like(straight,
                                                      dtype=torch.bool)


def _check_planes(planes: dict) -> None:
    """{name: (tensor, dtype)}: each plane tensor 2-D, contiguous and of
    its dtype, all of one shape."""
    shape = None
    for name, (x, dtype) in planes.items():
        kbuild.check_tensor(x, name, dtype, shape)
        if x.dim() != 2:
            raise ValueError(f"{name}: expected [rows, T], got "
                             f"{tuple(x.shape)}")
        shape = tuple(x.shape)


def _check_classic(planes: dict, pos, n_straight: int, per_q: dict) -> None:
    """Validation shared by the K9, K10 and K11 wrappers; `planes` maps
    each plane tensor's name to (tensor, dtype)."""
    _check_planes(planes)
    kbuild.check_tensor(pos, "pos", torch.int32)
    if pos.dim() != 3:
        raise ValueError(f"expected pos [B, V, Q], got {tuple(pos.shape)}")
    batch, n_var, n_q = pos.shape
    for name, (x, shape) in per_q.items():
        kbuild.check_tensor(x, name, torch.int32, shape)
    kbuild.same_device(*(x for x, _ in planes.values()), pos,
                       *(x for x, _ in per_q.values()))
    if not 1 <= n_straight <= n_var:
        raise ValueError(f"n_straight {n_straight} outside [1, {n_var}]")
    if batch * n_var > 65535:
        raise ValueError(f"{batch} masks x {n_var} variants in one launch "
                         "(at most 65,535)")


def _banded_walk_plain(gather, n_cols: int, dev, pos, q_cls, q_s, q_p, *,
                       target_threshold: int, ztol_num: int, ztol_den: int,
                       n_straight: int, rows: int):
    """K9's and K11's plain walk: gather(plane rows) -> (t_cls, t_s, t_p,
    t_max) int32 [len(rows), T]. Each mask's query is taken in chunks of
    about `rows` / V pixels, so the [V, chunk, T] intermediates stay
    bounded at production shapes."""
    rules = query_side_rules(q_cls, q_s, q_p, ztol_num=ztol_num,
                             ztol_den=ztol_den)
    same_cls, bq_s, bq_p, a_qp, tc, bound, upper = rules
    batch, n_var, n_q = pos.shape
    chunk = max(1, rows // n_var)
    best = torch.empty((batch, n_cols), dtype=torch.int32, device=dev)
    mirrored = torch.empty((batch, n_cols), dtype=torch.bool, device=dev)
    pair_flags = torch.empty((batch, n_cols), dtype=torch.int32,
                             device=dev)
    for b in range(batch):
        match = torch.zeros((n_var, n_cols), dtype=torch.int64, device=dev)
        flag = torch.zeros_like(match)
        for c0 in range(0, n_q, chunk):
            c1 = min(n_q, c0 + chunk)
            pos_c = pos[b, :, c0:c1]                              # [V, c]
            fields = [x.reshape(n_var, c1 - c0, n_cols) for x in gather(
                pos_c.clamp(min=0).reshape(-1).long())]

            def col(x):
                return x[b, c0:c1][None, :, None]                 # [1, c, 1]

            def pair(x):
                return x[:, b, c0:c1][:, None, :, None]       # [2, 1, c, 1]

            m, f = predicate_from_rules(
                (col(same_cls), col(bq_s), col(bq_p), col(a_qp), pair(tc),
                 pair(bound), pair(upper)),
                col(q_s), col(q_p), *fields,
                target_threshold=target_threshold, ztol_num=ztol_num,
                ztol_den=ztol_den)
            ok = (pos_c >= 0)[:, :, None]
            match += (m & ok).sum(1)
            flag += (f & ok).sum(1)
        best[b], mirrored[b] = _reduce_variants(match, n_straight)
        pair_flags[b] = flag.sum(0).to(torch.int32)
    return best, mirrored, pair_flags


def score_query_batch_plain(planes, pos, q_cls, q_s, q_p, *,
                            target_threshold: int, ztol_num: int,
                            ztol_den: int, n_straight: int,
                            rows: int = 8192):
    """Plain PyTorch version of K9 (see score_query_batch)."""
    return _banded_walk_plain(
        lambda r: common.unpack_summary(planes.index_select(0, r)),
        planes.shape[1], planes.device, pos, q_cls, q_s, q_p,
        target_threshold=target_threshold, ztol_num=ztol_num,
        ztol_den=ztol_den, n_straight=n_straight, rows=rows)


def _launch_banded(entry: str, name: str, plane_ptrs, thr_arg: tuple,
                   n_cols: int, dev, pos, q_cls, q_s, q_p, *, ztol_num: int,
                   ztol_den: int, n_straight: int):
    """Launch K9 (entry cmst_banded_score, thr_arg (threshold,)) or K11
    (cmst_banded_score_split, thr_arg ()) on CUDA tensors: the
    query-side rules computed here with torch, on the tensors' device;
    returns (best, mirrored, pair_flags)."""
    batch, n_var, n_q = pos.shape
    same_cls, bq_s, bq_p, a_qp, tc, bound, upper = (
        x.contiguous() for x in query_side_rules(
            q_cls, q_s, q_p, ztol_num=ztol_num, ztol_den=ztol_den))
    q_r = (q_s.to(torch.float32)
           / q_p.clamp(min=1).to(torch.float32)).contiguous()
    scratch = torch.zeros((2, batch, n_var, n_cols), dtype=torch.int32,
                          device=dev)
    best = torch.empty((batch, n_cols), dtype=torch.int32, device=dev)
    mirrored = torch.empty((batch, n_cols), dtype=torch.bool, device=dev)
    pair_flags = torch.empty((batch, n_cols), dtype=torch.int32,
                             device=dev)
    lib = kbuild.load_library()
    kbuild.check(getattr(lib, entry)(
        *plane_ptrs, n_cols, pos.data_ptr(), batch, n_var, n_q, n_straight,
        same_cls.data_ptr(), bq_s.data_ptr(), bq_p.data_ptr(),
        a_qp.data_ptr(), q_r.data_ptr(), tc.data_ptr(), bound.data_ptr(),
        upper.data_ptr(), int(ztol_den <= _MAX_INT_DENOM),
        float(np.float32(ztol_num / ztol_den)), float(np.float32(ADJ_BAND)),
        *thr_arg, scratch.data_ptr(), best.data_ptr(), mirrored.data_ptr(),
        pair_flags.data_ptr(), kbuild.stream_of(pos)), name)
    kbuild.count_launch(name)
    return best, mirrored, pair_flags


def score_query_batch(planes, pos, q_cls, q_s, q_p, *,
                      target_threshold: int, ztol_num: int, ztol_den: int,
                      n_straight: int):
    """K9: a batch of classic query plans against summary planes.

    planes int32 [P, T] (summary words, ops/common.pack_target_planes);
    pos int32 [B, V, Q] (-1 = skip); q_cls, q_s, q_p int32 [B, Q];
    target_threshold < 0 when the data threshold is folded into the
    planes; the z-tolerance is the exact fraction ztol_num / ztol_den.
    Returns (best int32 [B, T], mirrored bool [B, T], pair_flags int32
    [B, T]): the best variant's match count, whether a mirrored variant
    won strictly, and the number of ambiguity-band elements summed over
    all variants (pairs with flags > 0 are rescored by the float64
    oracle). The query-side rules are computed here with torch, on the
    tensors' device. CPU tensors run the plain version; CUDA tensors
    launch kernels/csrc/banded_score.cu or raise.
    """
    batch, n_var, n_q = pos.shape if pos.dim() == 3 else (0, 0, 0)
    _check_classic({"planes": (planes, torch.int32)}, pos, n_straight,
                   {"q_cls": (q_cls, (batch, n_q)),
                    "q_s": (q_s, (batch, n_q)), "q_p": (q_p, (batch, n_q))})
    kw = dict(ztol_num=ztol_num, ztol_den=ztol_den, n_straight=n_straight)
    if planes.device.type == "cpu":
        return score_query_batch_plain(planes, pos, q_cls, q_s, q_p,
                                       target_threshold=target_threshold,
                                       **kw)
    kbuild.require_cuda(planes)
    return _launch_banded("cmst_banded_score", "score_query_batch",
                          (planes.data_ptr(),),
                          (max(int(target_threshold), -1),), planes.shape[1],
                          planes.device, pos, q_cls, q_s, q_p, **kw)


def score_query_batch_split_plain(sp, c8, pos, q_cls, q_s, q_p, *,
                                  ztol_num: int, ztol_den: int,
                                  n_straight: int, rows: int = 8192):
    """Plain PyTorch version of K11 (see score_query_batch_split): K9's
    walk on the split pair, t_p = sp >> 8 and t_s = sp & 0xFF of the
    uint16 bits, the class byte as it is, the threshold folded."""
    def gather(r):
        w = sp.index_select(0, r).to(torch.int32) & 0xFFFF
        t_cls = c8.index_select(0, r).to(torch.int32)
        return t_cls, w & 0xFF, w >> 8, torch.zeros_like(w)

    return _banded_walk_plain(
        gather, sp.shape[1], sp.device, pos, q_cls, q_s, q_p,
        target_threshold=-1, ztol_num=ztol_num, ztol_den=ztol_den,
        n_straight=n_straight, rows=rows)


def score_query_batch_split(sp, c8, pos, q_cls, q_s, q_p, *,
                            ztol_num: int, ztol_den: int, n_straight: int):
    """K11: a batch of classic query plans against the split planes.

    sp int16 [P, T] (the bits of the uint16 (p << 8) | s) and c8 uint8
    [P, T] (the class), the pair of ops/common.pack_target_planes_split
    or split_planes_from_packed, the data threshold folded into them;
    every other argument and the result as score_query_batch's (there is
    no target_threshold). The counts and flags equal K9's on the summary
    planes the pair was split from. CPU tensors run the plain version;
    CUDA tensors launch kernels/csrc/banded_score.cu or raise.
    """
    batch, n_var, n_q = pos.shape if pos.dim() == 3 else (0, 0, 0)
    _check_classic({"sp": (sp, torch.int16), "c8": (c8, torch.uint8)}, pos,
                   n_straight,
                   {"q_cls": (q_cls, (batch, n_q)),
                    "q_s": (q_s, (batch, n_q)), "q_p": (q_p, (batch, n_q))})
    kw = dict(ztol_num=ztol_num, ztol_den=ztol_den, n_straight=n_straight)
    if sp.device.type == "cpu":
        return score_query_batch_split_plain(sp, c8, pos, q_cls, q_s, q_p,
                                             **kw)
    kbuild.require_cuda(sp)
    return _launch_banded("cmst_banded_score_split", "score_query_batch_split",
                          (sp.data_ptr(), c8.data_ptr()), (), sp.shape[1],
                          sp.device, pos, q_cls, q_s, q_p, **kw)


def score_query_batch_keys_plain(planes, pos, lo, span, *, n_straight: int,
                                 rows: int = 8192):
    """Plain PyTorch version of K10 (see score_query_batch_keys), chunked
    over the query like score_query_batch_plain."""
    batch, n_var, n_q = pos.shape
    n_cols = planes.shape[1]
    dev = planes.device
    chunk = max(1, rows // n_var)
    best = torch.empty((batch, n_cols), dtype=torch.int32, device=dev)
    mirrored = torch.empty((batch, n_cols), dtype=torch.bool, device=dev)
    for b in range(batch):
        lo_b = lo[b].long()
        sp_b = span[b].long() & _U32
        match = torch.zeros((n_var, n_cols), dtype=torch.int64, device=dev)
        for c0 in range(0, n_q, chunk):
            c1 = min(n_q, c0 + chunk)
            key = planes.index_select(
                0, pos[b, :, c0:c1].reshape(-1).long()).reshape(
                    n_var, c1 - c0, n_cols).long()
            hit = None
            for r in range(3):
                m = ((key - lo_b[r, c0:c1, None]) & _U32) \
                    <= sp_b[r, c0:c1, None]
                hit = m if hit is None else hit | m
            match += hit.sum(1)
        best[b], mirrored[b] = _reduce_variants(match, n_straight)
    return best, mirrored


def score_query_batch_keys(planes, pos, lo, span, *, n_straight: int):
    """K10: a batch of classic key plans against rank-key planes.

    planes int32 [P+1, T]; pos int32 [B, V, Q] (sentinel-encoded, every
    entry a plane row); lo/span int32 [B, 3, Q] (uint32 bits of the
    interval windows, key_plan_from_query_plan). Returns (best int32
    [B, T], mirrored bool [B, T]); the predicate has no ambiguity band,
    so there are no flags. CPU tensors run the plain version; CUDA
    tensors launch kernels/csrc/key_score.cu or raise.
    """
    batch, n_var, n_q = pos.shape if pos.dim() == 3 else (0, 0, 0)
    _check_classic({"planes": (planes, torch.int32)}, pos, n_straight,
                   {"lo": (lo, (batch, 3, n_q)),
                    "span": (span, (batch, 3, n_q))})
    if planes.device.type == "cpu":
        return score_query_batch_keys_plain(planes, pos, lo, span,
                                            n_straight=n_straight)
    kbuild.require_cuda(planes)
    dev = planes.device
    n_cols = planes.shape[1]
    scratch = torch.zeros((batch, n_var, n_cols), dtype=torch.int32,
                          device=dev)
    best = torch.empty((batch, n_cols), dtype=torch.int32, device=dev)
    mirrored = torch.empty((batch, n_cols), dtype=torch.bool, device=dev)
    lib = kbuild.load_library()
    kbuild.check(lib.cmst_key_score(
        planes.data_ptr(), n_cols, pos.data_ptr(), batch, n_var, n_q,
        n_straight, lo.data_ptr(), span.data_ptr(), scratch.data_ptr(),
        best.data_ptr(), mirrored.data_ptr(), kbuild.stream_of(planes)),
        "score_query_batch_keys")
    kbuild.count_launch("score_query_batch_keys")
    return best, mirrored
