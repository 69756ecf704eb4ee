"""The split-plane encodings of the PyTorch port (their plain versions)
against the JAX package: K8's split mode (row 6), K12's three
re-encodings (split_planes_from_packed, key_planes_from_packed: row 8;
split_key_planes: row 12), K11 (the split-plane predicate, row 10) and
K13 (the split-key union kernel, row 12).

On the CPU every wrapper runs its plain PyTorch version; the same
inputs, made with numpy from a seed, go through the JAX function (on
JAX's CPU backend) and the port. Every output is an integer, a bool or a
float32 computed in the same operation order, so the tolerance is 0:
exact equality, the ambiguity flags included. The port holds uint16
planes as int16 with the same bits, so they are compared as uint16
views. The CUDA kernels are compared with their plain versions in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

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


def _u16(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint16)


def _random_words(rng, rows=70, cols=24):
    """int32 planes over the whole 32-bit range (sign bit included)."""
    return rng.integers(0, 1 << 32, (rows, cols), dtype=np.uint64) \
        .astype(np.uint32).view(np.int32)


# --- K8, split mode (row 6) ---------------------------------------------


@pytest.mark.parametrize("thr", [0, 20])
@pytest.mark.parametrize("t, t_pad", [(6, 6), (5, 32)])
def test_k8_split_planes_equal_jax(thr, t, t_pad):
    """The uint16 (p << 8) | s and uint8 cls planes bit for bit, the
    threshold folded, padding columns zero."""
    rng = np.random.default_rng(3 * t + thr)
    stack = _stack(rng, t)
    want_sp, want_c8 = (np.asarray(a) for a in
                        jcommon.pack_target_planes_split(
                            jnp.asarray(stack), data_threshold=thr))
    sp, c8 = tcommon.pack_target_planes_split(torch.from_numpy(stack), thr,
                                              t_pad=t_pad)
    assert sp.dtype == torch.int16 and c8.dtype == torch.uint8
    assert tuple(sp.shape) == tuple(c8.shape) == (H * W, t_pad)
    np.testing.assert_array_equal(_u16(sp)[:, :t], want_sp)
    np.testing.assert_array_equal(c8.numpy()[:, :t], want_c8)
    assert not sp[:, t:].any() and not c8[:, t:].any()
    # p >= 128 sets the int16 sign bit: the bits survive
    assert (_u16(sp) >= 1 << 15).any()


# --- K12 (split_planes_from_packed, row 8, split_key_planes) -----------


@pytest.mark.parametrize("source", ["folded", "unfolded", "random"])
def test_k12_split_planes_from_packed_equals_jax(source):
    """The split pair of summary planes (any bits), and of folded planes
    the pair K8's split mode packs directly."""
    rng = np.random.default_rng(11)
    stack = _stack(rng, 7)
    if source == "random":
        planes = _random_words(rng)
    else:
        planes = np.asarray(jcommon.pack_target_planes(
            jnp.asarray(stack),
            data_threshold=20 if source == "folded" else None)).view(np.int32)
    want = [np.asarray(a) for a in jcommon.split_planes_from_packed(
        jnp.asarray(planes.view(np.uint32)))]
    sp, c8 = tcommon.split_planes_from_packed(_t(planes))
    np.testing.assert_array_equal(_u16(sp), want[0])
    np.testing.assert_array_equal(c8.numpy(), want[1])
    if source == "folded":
        direct = tcommon.pack_target_planes_split(torch.from_numpy(stack), 20)
        assert torch.equal(sp, direct[0]) and torch.equal(c8, direct[1])


@pytest.mark.parametrize("source", ["folded", "random"])
def test_k12_key_planes_from_packed_equals_jax(source):
    """Row 8: the rank-key planes (sentinel row included) of summary
    planes; of folded planes, K8's key mode (the dense key pack)."""
    rng = np.random.default_rng(12)
    stack = _stack(rng, 6)
    lut = tcommon.rank_lut_tensor(CPU)
    if source == "random":
        planes = _random_words(rng)
    else:
        planes = np.asarray(jcommon.pack_target_planes(
            jnp.asarray(stack), data_threshold=20)).view(np.int32)
    want = np.asarray(jcommon.key_planes_from_packed(
        jnp.asarray(planes.view(np.uint32)), jcommon.rank_lut_device()))
    got = tcommon.key_planes_from_packed(_t(planes), lut).numpy()
    assert got.dtype == np.int32 and got.shape == (planes.shape[0] + 1,
                                                   planes.shape[1])
    np.testing.assert_array_equal(got, want)
    assert not got[-1].any()
    if source == "folded":
        np.testing.assert_array_equal(got, tcommon.pack_target_planes_keys(
            torch.from_numpy(stack), 20, lut).numpy())


@pytest.mark.parametrize("source", ["keys", "random"])
def test_k12_split_key_planes_equals_jax(source):
    rng = np.random.default_rng(13)
    if source == "random":
        keys = _random_words(rng)
    else:
        keys = np.asarray(jcommon.pack_target_planes_keys(
            jnp.asarray(_stack(rng, 6)), 20, jcommon.rank_lut_device()))
    want = [np.asarray(a) for a in jpm.split_key_planes(jnp.asarray(keys))]
    rank, cls = tpm.split_key_planes(_t(keys))
    assert rank.dtype == torch.int16 and cls.dtype == torch.uint8
    np.testing.assert_array_equal(_u16(rank), want[0])
    np.testing.assert_array_equal(cls.numpy(), want[1])


# --- K11 (row 10) -------------------------------------------------------


def _batch_args(plans):
    return [np.stack([getattr(p, f) for p in plans])
            for f in ("positions", "q_cls", "q_s", "q_p")]


def _k11_both(sp, c8, args, a, b, n_straight):
    kw = dict(ztol_num=a, ztol_den=b, n_straight=n_straight)
    want = jpm.score_query_batch_split(
        jnp.asarray(sp), jnp.asarray(c8), *(jnp.asarray(x) for x in args),
        **kw)
    t_sp, t_c8 = convert.split_planes(sp, c8, CPU)
    got = tpm.score_query_batch_split(t_sp, t_c8, *(_t(x) for x in args),
                                      **kw)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("flu", [1.0, 0.37])
def test_k11_band_edges_equal_jax(flu):
    """Each mask repeats one query pixel over every achievable target
    ratio of every class, so the counts cover the band's edges: the JAX
    function's verdicts and flags exactly, and K9's on the summary
    planes the pair re-encodes."""
    rng = np.random.default_rng(5)
    sv, pv = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    ok = (pv >= 1) & (sv < pv)
    t_s, t_p = sv[ok].astype(np.int64), pv[ok].astype(np.int64)
    cls = np.arange(1, 7)
    planes = ((cls[None] << 24) | (t_p[:, None] << 16) | (t_s[:, None] << 8)
              | t_p[:, None]).astype(np.uint32)
    sp, c8 = (np.asarray(x) for x in jcommon.split_planes_from_packed(
        jnp.asarray(planes)))
    batch, n_q = 24, t_s.size
    a, b = ztol_fraction(flu)
    q_p = np.r_[11, rng.integers(1, 256, batch - 1)]
    per_q = [np.repeat(x[:, None], n_q, 1).astype(np.int32) for x in (
        np.r_[1, rng.integers(1, 7, batch - 1)],
        np.r_[2, np.minimum(rng.integers(0, 255, batch - 1), q_p[1:] - 1)],
        q_p)]
    args = [np.tile(np.arange(n_q, dtype=np.int32), (batch, 1, 1)), *per_q]
    got, want = _k11_both(sp, c8, args, a, b, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert int(got[2].sum()) > 0
    k9 = tpm.score_query_batch(_t(planes), *(_t(x) for x in args),
                               target_threshold=-1, ztol_num=a, ztol_den=b,
                               n_straight=1)
    for g, w in zip(got, k9):
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("mirror", [True, False])
@pytest.mark.parametrize("xy", [0, 2, 4])
def test_k11_split_scoring_equals_jax(xy, mirror):
    """best, mirrored and pair_flags on the split pair of folded planes
    equal the JAX function's, and K9's on the summary planes."""
    rng = np.random.default_rng(20 + 10 * xy + mirror)
    stack = _stack(rng, 9)
    queries = [testing.scattered_pixels(rng, H, W, n) for n in (220, 90)]
    queries.append(stack[3].copy())  # a strong match
    sp, c8 = (np.asarray(x) for x in jcommon.pack_target_planes_split(
        jnp.asarray(stack), data_threshold=20))
    for flu in (1.0, 0.37):
        plans = [jpm.build_query_plan(q, 20, mirror=mirror, xy_shift=xy,
                                      pix_color_fluctuation=flu, pad_to=640)
                 for q in queries]
        args = _batch_args(plans)
        got, want = _k11_both(sp, c8, args, plans[0].ztol_num,
                              plans[0].ztol_den, plans[0].n_straight)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[0].max() > 0
        planes = np.asarray(jcommon.pack_target_planes(
            jnp.asarray(stack), data_threshold=20))
        k9 = tpm.score_query_batch(
            _t(planes), *(_t(x) for x in args), target_threshold=-1,
            ztol_num=plans[0].ztol_num, ztol_den=plans[0].ztol_den,
            n_straight=plans[0].n_straight)
        for g, w in zip(got, k9):
            np.testing.assert_array_equal(g, w.numpy())


# --- K13 (row 12) -------------------------------------------------------


def _k13_inputs(seed, mirror=True, with_empty=False):
    rng = np.random.default_rng(seed)
    h, w = 60, 80
    queries = [testing.scattered_pixels(rng, h, w, 250) for _ in range(3)]
    if with_empty:
        # an empty query leaves the batch unsegmented (no slot-2 prefix)
        queries.append(np.zeros((h, w, 3), np.uint8))
    targets = [testing.scattered_pixels(rng, h, w, 200)
               for _ in range(9)] + [queries[0]]
    keys = np.asarray(jcommon.pack_target_planes_keys(
        jnp.asarray(np.stack(targets)), 20, jcommon.rank_lut_device()))
    plans = [jpm.build_full_union_key_plan(
        q, 20, mirror=mirror, xy_shift=2, pix_color_fluctuation=1.0)
        for q in queries]
    *arrs, u2 = jpm.stack_union_plan_args(plans, h * w)
    return keys, arrs, u2


@pytest.mark.parametrize("form", ["segmented", "or_two_slots", "one_slot",
                                  "unsegmented_batch", "no_mirror"])
def test_k13_splitk_union_scoring_equals_jax(form):
    """The split-key union kernel in its segmented form (slot-2 hits
    added on the prefix u < u2) and its OR forms: the JAX function's
    best and mirrored, and K3's on the unsplit key planes."""
    keys, arrs, u2 = _k13_inputs(
        61, mirror=form != "no_mirror",
        with_empty=form == "unsegmented_batch")
    u_pos, mu_pos, lo, sp = arrs
    if form in ("segmented", "no_mirror"):
        assert lo.shape[2] == 2 and 0 <= u2 < lo.shape[3]
    elif form == "or_two_slots":
        u2 = None
    elif form == "one_slot":
        lo, sp = lo[:, :, :1].copy(), sp[:, :, :1].copy()
    arrs = [u_pos, mu_pos, lo, sp]
    j_rank, j_cls = jpm.split_key_planes(jnp.asarray(keys))
    jb, jm, jf = jpm.score_query_batch_union_keys_splitk(
        j_rank, j_cls, *(jnp.asarray(a) for a in arrs), u2=u2)
    rank, cls = convert.split_key_planes(j_rank, j_cls, CPU)
    targs = convert.stacked_args(arrs, CPU)
    tb, tm = tpm.score_query_batch_union_keys_splitk(rank, cls, *targs, u2)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert not np.asarray(jf).any() and tb.max() > 0
    kb, km = tpm.score_query_batch_union_keys(convert.key_planes(keys, CPU),
                                              *targs, u2)
    assert torch.equal(tb, kb) and torch.equal(tm, km)


# --- state carried across, and the wrappers' checks ---------------------


def test_convert_split_pairs_round_trip_the_bits():
    rng = np.random.default_rng(14)
    hi = rng.integers(0, 1 << 16, (9, 13)).astype(np.uint16)
    lo = rng.integers(0, 256, (9, 13)).astype(np.uint8)
    for fn in (convert.split_planes, convert.split_key_planes):
        a, b = fn(hi, lo, CPU)
        assert a.dtype == torch.int16 and b.dtype == torch.uint8
        np.testing.assert_array_equal(_u16(a), hi)
        np.testing.assert_array_equal(b.numpy(), lo)
        with pytest.raises(ValueError):  # widened, as as_tensor would
            fn(hi.astype(np.int32), lo, CPU)
        with pytest.raises(ValueError):
            fn(hi, lo[:, :-1], CPU)


def test_split_wrappers_validate_and_never_launch_on_cpu():
    kbuild.reset_launches()
    planes = torch.zeros((12, 4), dtype=torch.int32)
    sp, c8 = tcommon.split_planes_from_packed(planes)
    pos = torch.zeros((2, 3, 5), dtype=torch.int32)
    q = torch.zeros((2, 5), dtype=torch.int32)
    kw = dict(ztol_num=1, ztol_den=100, n_straight=3)
    best, _, flags = tpm.score_query_batch_split(sp, c8, pos, q, q, q, **kw)
    assert tuple(best.shape) == (2, 4) and not flags.any()
    with pytest.raises(TypeError):  # int32 planes where int16 are due
        tpm.score_query_batch_split(planes, c8, pos, q, q, q, **kw)
    with pytest.raises(ValueError):  # the pair of two shapes
        tpm.score_query_batch_split(sp, c8[:6].contiguous(), pos, q, q, q,
                                    **kw)
    with pytest.raises(TypeError):
        tcommon.split_planes_from_packed(planes.to(torch.int16))
    with pytest.raises(TypeError):
        tpm.split_key_planes(planes.long())
    with pytest.raises(ValueError):
        tcommon.key_planes_from_packed(planes,
                                       tcommon.rank_lut_tensor(CPU)[:9])
    with pytest.raises(ValueError):
        tcommon.pack_target_planes_split(
            torch.zeros((2, 4, 5, 3), dtype=torch.uint8), 20, t_pad=1)
    lane = torch.zeros((1, 9, 2, 5), dtype=torch.int32)
    u_pos = torch.zeros((1, 1, 5), dtype=torch.int32)
    rank, cls = tpm.split_key_planes(planes)
    tpm.score_query_batch_union_keys_splitk(rank, cls, u_pos, u_pos, lane,
                                            lane)
    with pytest.raises(TypeError):
        tpm.score_query_batch_union_keys_splitk(planes, cls, u_pos, u_pos,
                                                lane, lane)
    assert all(n == 0 for n in kbuild.launches.values())
