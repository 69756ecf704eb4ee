"""K1-K4 of the PyTorch port against the JAX package's jitted functions.

On the CPU every wrapper runs its plain PyTorch version; the same
inputs, made with numpy from a seed, go through the JAX function (on
JAX's CPU backend) and the port. All outputs are integers or bools, so
the tolerance is 0: exact equality. The CUDA kernels themselves are
compared with their plain versions in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from colormipsearch_tpu.ops import common as jcommon
from colormipsearch_tpu.ops import pixel_match as jpm
from colormipsearch_tpu.oracle.pixel import PixelMatchOracle, shift_offsets
from colormipsearch_tpu_torch import convert, testing
from colormipsearch_tpu_torch.kernels import build as kbuild
from colormipsearch_tpu_torch.ops import common as tcommon
from colormipsearch_tpu_torch.ops import pixel_match as tpm

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _stack(rng, t, h, w, n=200):
    stack = np.stack([testing.scattered_pixels(rng, h, w, n)
                      for _ in range(t)])
    # threshold-edge and tie pixels: maxch == 20 (dead), 21 (live), and
    # a live-but-tied pixel (class 0 -> key 0)
    stack[0, 0, 0] = (20, 20, 20)
    stack[0, 0, 1] = (21, 0, 0)
    stack[0, 0, 2] = (200, 200, 200)
    return stack


def _jax_planes(stack, thr=20):
    return np.asarray(jcommon.pack_target_planes_keys(
        jnp.asarray(stack), thr, jcommon.rank_lut_device()))


# --- K1 ----------------------------------------------------------------


@pytest.mark.parametrize("t, t_pad", [(5, 8), (8, 8), (3, 32)])
def test_k1_sparse_pack_equals_jax(t, t_pad):
    """The port's sparse pack (host COO select + K1's plain version)
    equals the JAX sparse pack and the JAX dense pack, padding columns
    and the zero sentinel row included."""
    rng = np.random.default_rng(9 + t)
    stack = _stack(rng, t, 24, 37)
    lut = tcommon.rank_lut_tensor(CPU)
    got = tcommon.pack_target_planes_keys_sparse(stack, 20, lut, t_pad,
                                                 CPU).numpy()
    sparse = np.asarray(jcommon.pack_target_planes_keys_sparse(
        stack, 20, jcommon.rank_lut_device(), t_pad))
    dense = np.pad(_jax_planes(stack), ((0, 0), (0, t_pad - t)))
    np.testing.assert_array_equal(got, sparse)
    np.testing.assert_array_equal(got, dense)
    assert got.shape == (24 * 37 + 1, t_pad) and (got[-1] == 0).all()


def test_k1_dense_plain_and_empty_stack():
    rng = np.random.default_rng(4)
    stack = _stack(rng, 4, 20, 30)
    lut = tcommon.rank_lut_tensor(CPU)
    dense = tcommon.pack_target_planes_keys(torch.from_numpy(stack), 20,
                                            lut)
    np.testing.assert_array_equal(dense.numpy(), _jax_planes(stack))
    black = np.zeros((3, 20, 30, 3), np.uint8)
    planes = tcommon.pack_target_planes_keys_sparse(black, 20, lut, 4, CPU)
    assert tuple(planes.shape) == (601, 4) and not planes.any()


def test_k1_wrapper_validates_inputs():
    lut = tcommon.rank_lut_tensor(CPU)
    pos = torch.zeros(3, dtype=torch.int64)  # wrong dtype
    rgb = torch.zeros((3, 3), dtype=torch.uint8)
    cum = torch.tensor([3, 3], dtype=torch.int64)
    with pytest.raises(TypeError):
        tcommon.scatter_key_planes(pos, rgb, cum, lut, n_px=10, t_pad=2)
    with pytest.raises(ValueError):
        tcommon.scatter_key_planes(pos.int(), rgb, cum[:1], lut, n_px=10,
                                   t_pad=2)


# --- K2 ----------------------------------------------------------------


@pytest.mark.parametrize("xy_shift", [2, 4])
def test_k2_expand_from_pos_equals_jax(xy_shift):
    """Device lane-table expansion equals the JAX expansion and the host
    plan's own tables (sentinel pads, out-of-image shifts, excluded
    regions, different query sizes in one batch)."""
    rng = np.random.default_rng(51 + xy_shift)
    h, w = 30, 40
    region = np.zeros((h, w), bool)
    region[:4, :6] = True
    queries = [testing.scattered_pixels(rng, h, w, n)
               for n in (250, 90, 170)]
    plans = [jpm.build_full_union_key_plan(
        q, 20, mirror=True, xy_shift=xy_shift, pix_color_fluctuation=1.0,
        excluded_region=region) for q in queries]
    u_pos, _mu, q_pos, key_list, _u2 = jpm.stack_union_pos_args(plans,
                                                                 h * w)
    tabs = jpm.interval_table_arrays(0.01)
    offs = tuple((int(dx), int(dy)) for dx, dy in shift_offsets(xy_shift))
    want_lo, want_sp = jpm.expand_union_tables_from_pos(
        jnp.asarray(u_pos), jnp.asarray(q_pos), jnp.asarray(key_list),
        jnp.asarray(tabs[0]), jnp.asarray(tabs[1]), offsets=offs, w=w, h=h)
    got_lo, got_sp = tpm.expand_union_tables_from_pos(
        *[convert.as_tensor(a, CPU) for a in (u_pos, q_pos, key_list)],
        *convert.interval_tables(tabs, CPU), offsets=offs, w=w, h=h)
    np.testing.assert_array_equal(got_lo.numpy().view(np.uint32),
                                  np.asarray(want_lo))
    np.testing.assert_array_equal(got_sp.numpy().view(np.uint32),
                                  np.asarray(want_sp))
    u_pad = max(p.u_pos.shape[1] for p in plans)
    padded = [jpm.pad_union_key_plan(p, u_pad, h * w) for p in plans]
    host_lo, host_sp = tpm.stack_union_plan_args(
        [tpm.pad_union_key_plan(p, u_pad, h * w) for p in plans],
        h * w)[2:4]
    np.testing.assert_array_equal(
        got_lo.numpy().view(np.uint32), np.stack([p.lane_lo for p in padded]))
    np.testing.assert_array_equal(got_lo.numpy().view(np.uint32), host_lo)
    np.testing.assert_array_equal(got_sp.numpy().view(np.uint32), host_sp)


# --- K3 ----------------------------------------------------------------


def _k3_inputs(seed, xy_shift=2, mirror=True, with_empty=True):
    rng = np.random.default_rng(seed)
    h, w = 60, 80
    queries = [testing.scattered_pixels(rng, h, w, 250) for _ in range(3)]
    if with_empty:
        # an empty query pads to the batch shape and leaves the batch
        # unsegmented (its plan has no slot-2 prefix)
        queries.append(np.zeros((h, w, 3), np.uint8))
    targets = [testing.scattered_pixels(rng, h, w, 200)
               for _ in range(9)] + [queries[0]]
    planes = _jax_planes(np.stack(targets))
    plans = [jpm.build_full_union_key_plan(
        q, 20, mirror=mirror, xy_shift=xy_shift, pix_color_fluctuation=1.0)
        for q in queries]
    *arrs, u2 = jpm.stack_union_plan_args(plans, h * w)
    return planes, arrs, u2, queries, targets


def _k3_both(planes, arrs, u2):
    jb, jm, _ = jpm.score_query_batch_union_keys(
        jnp.asarray(planes), *[jnp.asarray(a) for a in arrs], u2=u2)
    tb, tm = tpm.score_query_batch_union_keys(
        convert.key_planes(planes, CPU),
        *convert.stacked_args(arrs, CPU), u2)
    return (np.asarray(jb), np.asarray(jm)), (tb.numpy(), tm.numpy())


@pytest.mark.parametrize("form", ["segmented", "unsegmented", "one_slot",
                                  "three_slots", "no_mirror", "xy_shift_4"])
def test_k3_union_scoring_equals_jax(form):
    planes, arrs, u2, _, _ = _k3_inputs(
        61, xy_shift=4 if form == "xy_shift_4" else 2,
        mirror=form != "no_mirror", with_empty=form != "segmented")
    u_pos, mu_pos, lo, sp = arrs
    if form == "segmented":
        assert lo.shape[2] == 2 and 0 <= u2 < lo.shape[3]
    elif form == "unsegmented":
        u2 = None
    elif form == "one_slot":
        lo, sp = lo[:, :, :1].copy(), sp[:, :, :1].copy()
    elif form == "three_slots":
        lo = np.concatenate([lo, np.full_like(lo[:, :, :1], 1 << 31)], 2)
        sp = np.concatenate([sp, np.zeros_like(sp[:, :, :1])], 2)
    elif form == "no_mirror":
        assert mu_pos.shape[1] == 0
    (jb, jm), (tb, tm) = _k3_both(planes, [u_pos, mu_pos, lo, sp], u2)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tm, jm)
    assert tb.max() > 0


def test_k3_per_variant_counts_equal_oracle():
    """One lane and one orientation at a time, the plain K3 yields each
    shift/mirror variant's count: it equals the float64 oracle's."""
    flu, thr = 1.23, 20
    rng = np.random.default_rng(23)
    h, w = 40, 60
    query = testing.scattered_pixels(rng, h, w, 400)
    query[0, 0] = (50, 0, 53)
    targets = [testing.scattered_pixels(rng, h, w, 300)
               for _ in range(4)] + [query]
    planes = convert.key_planes(_jax_planes(np.stack(targets), thr), CPU)
    plan = tpm.build_full_union_key_plan(
        query, thr, mirror=True, xy_shift=2, pix_color_fluctuation=flu)
    fields = convert.union_plan(plan, CPU)
    u_pos, mu_pos, lo, sp = (fields[f][None] for f in (
        "u_pos", "mu_pos", "lane_lo", "lane_span"))
    no_mirror = u_pos[:, :0]
    oracle = PixelMatchOracle(query, thr, mirror=True, target_threshold=thr,
                              z_tolerance=flu / 100, xy_shift=2)
    results = [oracle.score(t) for t in targets]
    for j in range(lo.shape[1]):
        lane = (lo[:, j:j + 1].contiguous(), sp[:, j:j + 1].contiguous())
        straight, _ = tpm.score_query_batch_union_keys(
            planes, u_pos, no_mirror, *lane, plan.u2)
        mirror, _ = tpm.score_query_batch_union_keys(
            planes, mu_pos, no_mirror, *lane, plan.u2)
        assert [r.per_variant[j] for r in results] == \
            straight[0].tolist(), j
        assert [r.per_variant_mirror[j] for r in results] == \
            mirror[0].tolist(), j


# --- K4 ----------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 7, 40])
def test_k4_topk_equals_jax_index_for_index(k):
    """Scores with many ties (a narrow score range over many columns):
    the plain K4 order equals jax.lax.top_k's, column for column."""
    rng = np.random.default_rng(k)
    best = rng.integers(-2, 4, (3, 40)).astype(np.int32)
    mirrored = rng.random((3, 40)) < 0.5
    js, ji = jax.lax.top_k(jnp.asarray(best), k)
    jm = np.take_along_axis(mirrored, np.asarray(ji), axis=1)
    ts, ti, tm = tpm.union_keys_topk(torch.from_numpy(best),
                                     torch.from_numpy(mirrored), k)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm.numpy(), jm)


def test_k3_k4_topk_equals_jax():
    """score_query_batch_union_keys_topk end to end on real plans (mostly
    zero scores: ties everywhere) against the JAX function."""
    planes, arrs, u2, _, _ = _k3_inputs(71)
    k = 6
    want = jpm.score_query_batch_union_keys_topk(
        jnp.asarray(planes), *[jnp.asarray(a) for a in arrs], u2=u2, k=k)
    got = tpm.score_query_batch_union_keys_topk(
        convert.key_planes(planes, CPU), *convert.stacked_args(arrs, CPU),
        u2=u2, k=k)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


# --- policy ------------------------------------------------------------


def test_cpu_tensors_never_launch_a_kernel():
    """The plain path is taken only because the tensors lie on the CPU,
    and it never counts as a kernel launch."""
    kbuild.reset_launches()
    planes, arrs, u2, _, _ = _k3_inputs(5)
    best, mirrored = tpm.score_query_batch_union_keys(
        convert.key_planes(planes, CPU), *convert.stacked_args(arrs, CPU),
        u2)
    tpm.union_keys_topk(best, mirrored, 3)
    assert all(n == 0 for n in kbuild.launches.values())
    with pytest.raises(ValueError):
        tpm.union_keys_topk(best, mirrored, best.shape[1] + 1)
