"""K8, K9 and K10 of the PyTorch port (their plain versions) and the
classic query plans, against the JAX package.

On the CPU every wrapper runs its plain PyTorch version; the same
inputs, made with numpy from a seed, go through the JAX function (on
JAX's CPU backend) and the port. Every output compared here is an
integer, a bool or a float32 computed in the same operation order, so
the tolerance is 0: exact equality, the ambiguity flags included. The
CUDA kernels themselves are compared with their plain versions in
tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from colormipsearch_tpu.ops import common as jcommon
from colormipsearch_tpu.ops import pixel_match as jpm
from colormipsearch_tpu.ops.common import ztol_fraction
from colormipsearch_tpu_torch import convert, testing
from colormipsearch_tpu_torch.kernels import build as kbuild
from colormipsearch_tpu_torch.ops import common as tcommon
from colormipsearch_tpu_torch.ops import pixel_match as tpm

torch.set_num_threads(2)
CPU = torch.device("cpu")
H, W = 30, 40


def _stack(rng, t, n=250):
    stack = np.stack([testing.scattered_pixels(rng, H, W, n)
                      for _ in range(t)])
    # threshold-edge and tie pixels: maxch == 20 (dead), 21 (live), and
    # a live-but-tied pixel (class 0)
    stack[0, 0, 0] = (20, 20, 20)
    stack[0, 0, 1] = (21, 0, 0)
    stack[0, 0, 2] = (200, 200, 200)
    return stack


def _t(a):
    return convert.as_tensor(a, CPU)


# --- K8 ----------------------------------------------------------------


@pytest.mark.parametrize("thr", [None, 0, 20])
@pytest.mark.parametrize("t, t_pad", [(6, 6), (5, 32)])
def test_k8_summary_planes_equal_jax(thr, t, t_pad):
    """Summary mode: the JAX words bit for bit, padding columns zero."""
    rng = np.random.default_rng(t + (thr or 0))
    stack = _stack(rng, t)
    want = np.asarray(jcommon.pack_target_planes(jnp.asarray(stack),
                                                 data_threshold=thr))
    got = tcommon.pack_target_planes(torch.from_numpy(stack), thr,
                                     t_pad=t_pad).numpy()
    assert got.shape == (H * W, t_pad) and got.dtype == np.int32
    np.testing.assert_array_equal(got[:, :t].view(np.uint32), want)
    assert not got[:, t:].any()


@pytest.mark.parametrize("t, t_pad", [(6, 6), (5, 32)])
def test_k8_key_planes_equal_jax(t, t_pad):
    """Key mode: the JAX dense key pack (and so the sparse K1 pack), the
    sentinel row and padding columns zero."""
    rng = np.random.default_rng(40 + t)
    stack = _stack(rng, t)
    lut = tcommon.rank_lut_tensor(CPU)
    want = np.asarray(jcommon.pack_target_planes_keys(
        jnp.asarray(stack), 20, jcommon.rank_lut_device()))
    got = tcommon.pack_target_planes_keys(torch.from_numpy(stack), 20, lut,
                                          t_pad=t_pad).numpy()
    np.testing.assert_array_equal(got[:, :t], want)
    assert not got[:, t:].any() and not got[-1].any()
    sparse = tcommon.pack_target_planes_keys_sparse(stack, 20, lut, t_pad,
                                                    CPU).numpy()
    np.testing.assert_array_equal(got, sparse)


def test_k8_wrapper_validates_inputs():
    lut = tcommon.rank_lut_tensor(CPU)
    stack = torch.zeros((2, 4, 5, 3), dtype=torch.uint8)
    with pytest.raises(TypeError):
        tcommon.pack_target_planes(stack.int(), 20)
    with pytest.raises(ValueError):
        tcommon.pack_target_planes(stack, 20, t_pad=1)
    with pytest.raises(ValueError):
        tcommon.pack_target_planes_keys(stack[0], 20, lut)
    with pytest.raises(ValueError):
        tcommon.pack_target_planes_keys(stack, 20, lut[:100])


# --- plans ---------------------------------------------------------------


def _assert_same_fields(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def _mask_and_neg(rng, n=220):
    mask = testing.scattered_pixels(rng, H, W, n)
    neg = testing.scattered_pixels(rng, H, W, n // 2)
    region = np.zeros((H, W), bool)
    region[:3, :5] = True
    return mask, neg, region


@pytest.mark.parametrize("flu, xy, mirror", [
    (1.0, 0, False), (2.0, 2, True), (0.37, 4, True), (1.23, 2, False)])
def test_plans_equal_jax_field_for_field(flu, xy, mirror):
    """build_query_plan, build_neg_query_plan, key_plan_from_query_plan
    and build_union_key_plan give the JAX package's plans, every field."""
    rng = np.random.default_rng(int(flu * 100) + xy)
    mask, neg, region = _mask_and_neg(rng)
    kw = dict(mirror=mirror, xy_shift=xy, pix_color_fluctuation=flu,
              excluded_region=region)
    plan = tpm.build_query_plan(mask, 20, **kw)
    _assert_same_fields(plan, jpm.build_query_plan(mask, 20, **kw))
    nkw = dict(mirror_neg_query=mirror, xy_shift=xy,
               pix_color_fluctuation=flu, excluded_region=region)
    _assert_same_fields(tpm.build_neg_query_plan(mask, 20, neg, 30, **nkw),
                        jpm.build_neg_query_plan(mask, 20, neg, 30, **nkw))
    assert tpm.build_neg_query_plan(mask, 20, neg * 0, 30, **nkw) is None
    _assert_same_fields(
        tpm.key_plan_from_query_plan(plan, H * W, flu),
        jpm.key_plan_from_query_plan(
            jpm.build_query_plan(mask, 20, **kw), H * W, flu))
    union = tpm.build_union_key_plan(mask, 20, **kw)
    want = jpm.build_union_key_plan(mask, 20, **kw)
    assert (union is None) == (want is None) == (xy > 2)
    if union is not None:
        assert union.n_sets == (3 if xy else 1)
        _assert_same_fields(union, want)
    assert tpm.offsets_form_grid(xy) == jpm.offsets_form_grid(xy)


@pytest.mark.parametrize("flu", [1.0, 2.0, 0.37, 1.23])
def test_query_side_rules_equal_jax(flu):
    """Every query class and ratio, bit for bit (float32 bounds too)."""
    a, b = ztol_fraction(flu)
    sv, pv = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    ok = (pv >= 1) & (sv < pv)
    q_s = np.tile(sv[ok], 7).astype(np.int32)
    q_p = np.tile(pv[ok], 7).astype(np.int32)
    q_cls = np.repeat(np.arange(7), ok.sum()).astype(np.int32)
    want = jpm.query_side_rules(*(jnp.asarray(x) for x in (q_cls, q_s, q_p)),
                                ztol_num=a, ztol_den=b)
    got = tpm.query_side_rules(*(torch.from_numpy(x)
                                 for x in (q_cls, q_s, q_p)),
                               ztol_num=a, ztol_den=b)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


# --- K9 ----------------------------------------------------------------


def _batch_args(plans):
    return [np.stack([getattr(p, f) for p in plans])
            for f in ("positions", "q_cls", "q_s", "q_p")]


def _k9_both(planes, plans, thr=-1):
    kw = dict(target_threshold=thr, ztol_num=plans[0].ztol_num,
              ztol_den=plans[0].ztol_den, n_straight=plans[0].n_straight)
    args = _batch_args(plans)
    want = jpm.score_query_batch(jnp.asarray(planes),
                                 *(jnp.asarray(a) for a in args), **kw)
    got = tpm.score_query_batch(_t(planes), *(_t(a) for a in args), **kw)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("mirror", [True, False])
@pytest.mark.parametrize("xy", [0, 2, 4])
@pytest.mark.parametrize("flu", [1.0, 2.0, 0.37])
def test_k9_banded_scoring_equals_jax(flu, xy, mirror):
    """best, mirrored and pair_flags equal the JAX function exactly, on
    folded planes and with the per-element threshold test."""
    rng = np.random.default_rng(int(flu * 100) + 10 * xy + mirror)
    stack = _stack(rng, 9)
    queries = [testing.scattered_pixels(rng, H, W, n) for n in (220, 90)]
    queries.append(stack[3].copy())  # a strong match
    for thr in (-1, 20):
        planes = np.asarray(jcommon.pack_target_planes(
            jnp.asarray(stack), data_threshold=None if thr >= 0 else 20))
        plans = [jpm.build_query_plan(q, 20, mirror=mirror, xy_shift=xy,
                                      pix_color_fluctuation=flu, pad_to=640)
                 for q in queries]
        got, want = _k9_both(planes, plans, thr)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[0].max() > 0


def test_k9_flags_the_exact_boundary_pair():
    """Ratios 1/4 and 6/25 are 0.01 apart exactly: the pair is flagged
    (tests/test_ops_pixel_match.py:75-92), as in the JAX function."""
    mask = np.zeros((8, 8, 3), np.uint8)
    target = np.zeros((8, 8, 3), np.uint8)
    mask[0, 0] = (1, 0, 4)
    target[0, 0] = (6, 0, 25)
    planes = np.asarray(jcommon.pack_target_planes(
        jnp.asarray(target[None]), data_threshold=0))
    plan = jpm.build_query_plan(mask, 0, mirror=False, xy_shift=0,
                                pix_color_fluctuation=1.0)
    got, want = _k9_both(planes, [plan])
    assert got[2][0, 0] > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mirror_neg", [True, False])
def test_k9_negative_plan_equals_jax(mirror_neg):
    rng = np.random.default_rng(77 + mirror_neg)
    stack = _stack(rng, 7)
    planes = np.asarray(jcommon.pack_target_planes(jnp.asarray(stack),
                                                   data_threshold=20))
    mask, neg, region = _mask_and_neg(rng)
    plans = [jpm.build_neg_query_plan(
        mask, 20, neg, 20, mirror_neg_query=mirror_neg, xy_shift=2,
        pix_color_fluctuation=1.0, excluded_region=region, pad_to=512)]
    got, want = _k9_both(planes, plans)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("flu", [1.0, 0.37])
def test_k9_band_edges_equal_jax(flu):
    """Each mask repeats one query pixel over every achievable target
    ratio of every class, so the counts cover the band's edges; the JAX
    function's f32 rounding (its fused `t_s - B * t_p`) is followed
    exactly, flags included."""
    rng = np.random.default_rng(5)
    sv, pv = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    ok = (pv >= 1) & (sv < pv)
    t_s, t_p = sv[ok].astype(np.int64), pv[ok].astype(np.int64)
    cls = np.arange(1, 7)
    planes = ((cls[None] << 24) | (t_p[:, None] << 16) | (t_s[:, None] << 8)
              | t_p[:, None]).astype(np.uint32)
    batch, n_q = 24, t_s.size
    a, b = ztol_fraction(flu)
    q_p = rng.integers(1, 256, batch)
    per_q = [np.repeat(x[:, None], n_q, 1).astype(np.int32) for x in (
        rng.integers(1, 7, batch), np.minimum(rng.integers(0, 255, batch),
                                              q_p - 1), q_p)]
    pos = np.tile(np.arange(n_q, dtype=np.int32), (batch, 1, 1))
    kw = dict(target_threshold=-1, ztol_num=a, ztol_den=b, n_straight=1)
    want = jpm.score_query_batch(jnp.asarray(planes), jnp.asarray(pos),
                                 *(jnp.asarray(x) for x in per_q), **kw)
    got = tpm.score_query_batch(_t(planes), _t(pos),
                                *(_t(x) for x in per_q), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2].sum()) > 0


@pytest.mark.parametrize("flu", [1.0, 0.37])
def test_element_predicate_equals_jax(flu):
    """match and flag of every (query pixel, target ratio) pair for 40
    query pixels of each class against every achievable target ratio of
    each class, folded threshold: the JAX verdicts exactly."""
    rng = np.random.default_rng(int(flu * 100))
    a, b = ztol_fraction(flu)
    sv, pv = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    ok = (pv >= 1) & (sv < pv)
    k = 40
    q_p = rng.integers(1, 256, 6 * k)
    # the first query pixel, (BR, 2/11), meets (BG, 109/205) with |g|
    # inside the 0.37% band only when g is rounded once
    q = [np.r_[1, np.repeat(np.arange(1, 7), k)],
         np.r_[2, np.minimum(rng.integers(0, 255, 6 * k), q_p - 1)],
         np.r_[11, q_p]]
    t = [np.repeat(np.arange(1, 7), ok.sum()), np.tile(sv[ok], 6),
         np.tile(pv[ok], 6)]
    args = [x.astype(np.int32)[:, None] for x in q] \
        + [x.astype(np.int32)[None] for x in t] \
        + [np.zeros((1, 1), np.int32)]
    kw = dict(target_threshold=-1, ztol_num=a, ztol_den=b)
    want = jax.jit(lambda *x: jpm.element_predicate(*x, **kw))(*args)
    got = tpm.element_predicate(*(torch.from_numpy(x) for x in args), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].any()


@pytest.mark.parametrize("mirror", [True, False])
def test_reduce_variant_scores_equals_jax(mirror):
    rng = np.random.default_rng(4)
    scores = rng.integers(0, 6, (18 if mirror else 9, 50))
    plan = tpm.build_query_plan(np.zeros((4, 4, 3), np.uint8), 20,
                                mirror=mirror, xy_shift=2,
                                pix_color_fluctuation=1.0)
    for g, w in zip(tpm.reduce_variant_scores(scores, plan),
                    jpm.reduce_variant_scores(scores, plan)):
        np.testing.assert_array_equal(g, w)


def test_fma_f32_rounds_once():
    """fma_f32 equals XLA's fused `c - a * b` on random float32s (where
    rounding the product first differs in many of them)."""
    rng = np.random.default_rng(8)
    n = 200_000
    a = rng.uniform(-2, 2, n).astype(np.float32)
    b = rng.uniform(-300, 300, n).astype(np.float32)
    c = (a.astype(np.float64) * b + rng.normal(0, 1e-5, n)) \
        .astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b, c: c - a * b)(a, b, c))
    got = tpm.fma_f32(*(torch.from_numpy(x) for x in (-a, b, c))).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (want != (c - a * b).astype(np.float32)).any()


# --- K10 ---------------------------------------------------------------


@pytest.mark.parametrize("flu, xy, mirror", [
    (1.0, 0, False), (1.0, 2, True), (2.0, 4, True), (0.37, 2, False)])
def test_k10_key_scoring_equals_jax(flu, xy, mirror):
    rng = np.random.default_rng(90 + xy)
    stack = _stack(rng, 10)
    planes = np.asarray(jcommon.pack_target_planes_keys(
        jnp.asarray(stack), 20, jcommon.rank_lut_device()))
    queries = [testing.scattered_pixels(rng, H, W, 200), stack[4].copy()]
    kplans = [jpm.key_plan_from_query_plan(jpm.build_query_plan(
        q, 20, mirror=mirror, xy_shift=xy, pix_color_fluctuation=flu,
        pad_to=768), H * W, flu) for q in queries]
    args = [np.stack([getattr(p, f) for p in kplans])
            for f in ("positions", "lo", "span")]
    n_straight = kplans[0].n_straight
    jb, jm, jf = jpm.score_query_batch_keys(
        jnp.asarray(planes), *(jnp.asarray(a) for a in args),
        n_straight=n_straight)
    tb, tm = tpm.score_query_batch_keys(_t(planes), *(_t(a) for a in args),
                                        n_straight=n_straight)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert not np.asarray(jf).any() and tb.max() > 0


def test_k9_k10_wrappers_validate_and_never_launch_on_cpu():
    kbuild.reset_launches()
    planes = torch.zeros((12, 4), dtype=torch.int32)
    pos = torch.zeros((2, 3, 5), dtype=torch.int32)
    q = torch.zeros((2, 5), dtype=torch.int32)
    kw = dict(target_threshold=-1, ztol_num=1, ztol_den=100)
    best, mirrored, flags = tpm.score_query_batch(planes, pos, q, q, q,
                                                  n_straight=3, **kw)
    assert tuple(best.shape) == (2, 4) and not flags.any()
    with pytest.raises(ValueError):  # no straight variant
        tpm.score_query_batch(planes, pos, q, q, q, n_straight=0, **kw)
    with pytest.raises(ValueError):  # q_s of another query width
        tpm.score_query_batch(planes, pos, q, q[:, :4].contiguous(), q,
                              n_straight=1, **kw)
    with pytest.raises(TypeError):
        tpm.score_query_batch(planes.float(), pos, q, q, q, n_straight=1,
                              **kw)
    lo = torch.zeros((2, 3, 5), dtype=torch.int32)
    tpm.score_query_batch_keys(planes, pos, lo, lo, n_straight=2)
    with pytest.raises(ValueError):
        tpm.score_query_batch_keys(planes, pos, lo[:, :2].contiguous(),
                                   lo, n_straight=2)
    assert all(n == 0 for n in kbuild.launches.values())
