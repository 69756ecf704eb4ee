"""Rows 13 and 14 of the PyTorch port (the qkey wire form: the lane-table
expansion and the union scoring on it) against the JAX package.

On the CPU every wrapper runs its plain PyTorch version; the same
inputs, made with numpy from a seed, go through the JAX function (on
JAX's CPU backend) and the port. All outputs are integers or bools, so
the tolerance is 0: exact equality. The CUDA kernels are compared with
their plain versions in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from colormipsearch_tpu.ops import common as jcommon
from colormipsearch_tpu.ops import pixel_match as jpm
from colormipsearch_tpu.oracle.pixel import shift_offsets
from colormipsearch_tpu_torch import convert, testing
from colormipsearch_tpu_torch.kernels import build as kbuild
from colormipsearch_tpu_torch.ops import pixel_match as tpm

torch.set_num_threads(2)
CPU = torch.device("cpu")
H, W = 30, 40


def _batch(rng, xy_shift, sizes=(250, 90, 170), mirror=True):
    """A batch of full-union plans (the JAX package's, which the port's
    builder equals) with excluded pixels and different query sizes."""
    region = np.zeros((H, W), bool)
    region[:4, :6] = True
    queries = [testing.scattered_pixels(rng, H, W, n) for n in sizes]
    plans = [jpm.build_full_union_key_plan(
        q, 20, mirror=mirror, xy_shift=xy_shift, pix_color_fluctuation=1.0,
        excluded_region=region) for q in queries]
    return queries, plans


def _qkey_args(plans):
    u_pos, mu_pos, qidx, key_list, u2 = jpm.stack_union_qkey_args(plans,
                                                                  H * W)
    tabs = jpm.interval_table_arrays(0.01)
    return (u_pos, mu_pos, qidx, key_list, u2), tabs


@pytest.mark.parametrize("xy_shift", [2, 4])
def test_row13_expand_union_tables_equals_jax(xy_shift):
    """Row 13 equals the JAX expansion, and K2's expansion of the same
    batch's positional form."""
    rng = np.random.default_rng(205 + xy_shift)
    _q, plans = _batch(rng, xy_shift)
    (_u, _m, qidx, key_list, _u2), tabs = _qkey_args(plans)
    assert qidx.dtype == np.uint16
    want = jpm.expand_union_tables(jnp.asarray(qidx), jnp.asarray(key_list),
                                   jnp.asarray(tabs[0]), jnp.asarray(tabs[1]))
    t_tabs = convert.interval_tables(tabs, CPU)
    got = tpm.expand_union_tables(convert.qidx(qidx, CPU),
                                  convert.as_tensor(key_list, CPU), *t_tabs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w))
    u_pos, _mu, q_pos, kl, _ = jpm.stack_union_pos_args(plans, H * W)
    offs = tuple((int(dx), int(dy)) for dx, dy in shift_offsets(xy_shift))
    pos_form = tpm.expand_union_tables_from_pos(
        *[convert.as_tensor(a, CPU) for a in (u_pos, q_pos, kl)], *t_tabs,
        offsets=offs, w=W, h=H)
    for g, p in zip(got, pos_form):
        assert torch.equal(g, p)


def test_row13_stacker_equals_jax():
    """The port's stack_union_qkey_args on the port's own plans equals the
    JAX stacker on the JAX plans, and both refuse a batch without the
    factored form."""
    rng = np.random.default_rng(7)
    queries, jplans = _batch(rng, 2)
    tplans = [tpm.build_full_union_key_plan(
        q, 20, mirror=True, xy_shift=2, pix_color_fluctuation=1.0,
        excluded_region=p_region) for q, p_region in
        zip(queries, [np.pad(np.ones((4, 6), bool),
                             ((0, H - 4), (0, W - 6)))] * 3)]
    want = jpm.stack_union_qkey_args(jplans, H * W)
    got = tpm.stack_union_qkey_args(tplans, H * W)
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4]
    light = tpm.build_union_key_plan(
        queries[0], 20, mirror=True, xy_shift=2, pix_color_fluctuation=1.0)
    assert tpm.stack_union_qkey_args([tplans[0], light], H * W) is None


@pytest.mark.parametrize("xy_shift", [2, 4])
def test_row14_union_qkeys_equals_jax(xy_shift):
    """Row 14 equals score_query_batch_union_qkeys and the classic key
    kernel (as tests/test_ops_pixel_keys.py holds the JAX one), and K3 on
    the same batch's expanded tables."""
    rng = np.random.default_rng(918 + xy_shift)
    queries, plans = _batch(rng, xy_shift)
    targets = [testing.scattered_pixels(rng, H, W, 200)
               for _ in range(7)] + [queries[0]]
    stack = np.stack(targets)
    t_keys = np.asarray(jcommon.pack_target_planes_keys(
        jnp.asarray(stack), 20, jcommon.rank_lut_device()))
    (u_pos, mu_pos, qidx, key_list, u2), tabs = _qkey_args(plans)
    want = jpm.score_query_batch_union_qkeys(
        jnp.asarray(t_keys), jnp.asarray(u_pos), jnp.asarray(mu_pos),
        jnp.asarray(qidx), jnp.asarray(key_list), jnp.asarray(tabs[0]),
        jnp.asarray(tabs[1]), u2=u2)
    planes = convert.key_planes(t_keys, CPU)
    args = (planes, convert.as_tensor(u_pos, CPU),
            convert.as_tensor(mu_pos, CPU), convert.qidx(qidx, CPU),
            convert.as_tensor(key_list, CPU),
            *convert.interval_tables(tabs, CPU))
    best, mirrored = tpm.score_query_batch_union_qkeys(*args, u2)
    np.testing.assert_array_equal(best.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(mirrored.numpy(), np.asarray(want[1]))
    assert best.max() > 0 and mirrored.any()
    # the classic key kernel on the same masks (the JAX test's reference)
    kplans = [jpm.key_plan_from_query_plan(jpm.build_query_plan(
        q, 20, mirror=True, xy_shift=xy_shift, pix_color_fluctuation=1.0,
        excluded_region=np.pad(np.ones((4, 6), bool),
                               ((0, H - 4), (0, W - 6)))), H * W, 1.0)
        for q in queries]
    q_pad = max(kp.positions.shape[1] for kp in kplans)
    kb, _km = tpm.score_query_batch_keys(
        planes, *(convert.as_tensor(np.stack([np.pad(
            getattr(kp, f), ((0, 0), (0, q_pad - kp.positions.shape[1])),
            constant_values=H * W if f == "positions" else 0)
            for kp in kplans]), CPU) for f in ("positions", "lo", "span")),
        n_straight=kplans[0].n_straight)
    assert torch.equal(best, kb)
    lo, sp = tpm.expand_union_tables(*args[3:])
    k3 = tpm.score_query_batch_union_keys(planes, args[1], args[2], lo, sp,
                                          u2)
    assert torch.equal(best, k3[0]) and torch.equal(mirrored, k3[1])


@pytest.mark.parametrize("u2", [None, 0, "full", "over"])
def test_row14_prefix_forms_equal_jax(u2):
    """The slot-2 prefix: None and values outside [0, U] test slot 2 over
    the whole union, 0 never, U everywhere; all equal the JAX function."""
    rng = np.random.default_rng(31)
    _q, plans = _batch(rng, 2, sizes=(150, 60), mirror=False)
    stack = np.stack([testing.scattered_pixels(rng, H, W, 220)
                      for _ in range(5)])
    t_keys = np.asarray(jcommon.pack_target_planes_keys(
        jnp.asarray(stack), 20, jcommon.rank_lut_device()))
    (u_pos, mu_pos, qidx, key_list, _u2), tabs = _qkey_args(plans)
    n_u = u_pos.shape[2]
    u2 = {"full": n_u, "over": n_u + 5}.get(u2, u2)
    want = jpm.score_query_batch_union_qkeys(
        *[jnp.asarray(a) for a in (t_keys, u_pos, mu_pos, qidx, key_list,
                                   *tabs)], u2=u2)
    best, mirrored = tpm.score_query_batch_union_qkeys(
        convert.key_planes(t_keys, CPU), convert.as_tensor(u_pos, CPU),
        convert.as_tensor(mu_pos, CPU), convert.qidx(qidx, CPU),
        convert.as_tensor(key_list, CPU),
        *convert.interval_tables(tabs, CPU), u2)
    np.testing.assert_array_equal(best.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(mirrored.numpy(), np.asarray(want[1]))
    assert not mirrored.any()


def test_rows13_14_validate_and_never_count_on_the_cpu():
    rng = np.random.default_rng(3)
    _q, plans = _batch(rng, 2, sizes=(80,))
    (u_pos, mu_pos, qidx, key_list, u2), tabs = _qkey_args(plans)
    q = convert.qidx(qidx, CPU)
    kl = convert.as_tensor(key_list, CPU)
    t_tabs = convert.interval_tables(tabs, CPU)
    kbuild.reset_launches()
    tpm.expand_union_tables(q, kl, *t_tabs)
    assert kbuild.launches["expand_union_tables"] == 0
    with pytest.raises(TypeError):
        tpm.expand_union_tables(q.long(), kl, *t_tabs)
    with pytest.raises(ValueError):
        tpm.expand_union_tables(q, kl[:, :0], *t_tabs)
    with pytest.raises(ValueError):
        convert.qidx(qidx.astype(np.int32), CPU)
    planes = torch.zeros((H * W + 1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        tpm.score_query_batch_union_qkeys(
            planes, convert.as_tensor(u_pos, CPU),
            convert.as_tensor(mu_pos[:, :, :5], CPU), q, kl, *t_tabs, u2)
