"""The port's mesh steps (colormipsearch_tpu_torch.parallel.mesh) at D = 8
CPU shards against the JAX package's steps on the tests' 8 virtual CPU
devices, and against the port's single-device functions.

Every input is made with numpy from a seed and handed to both packages.
All outputs are integers or bools, so equality is exact: the dense steps
equal the single-device kernels, the top-k steps a per-shard top-k of
the single-device scores (jax.lax.top_k's order, indices offset by the
shard's first column, shards concatenated in order), and every output
the JAX step's, the flagged-pair counts included. Each test checks that
the step it names really ran (parallel.mesh.step_calls).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from colormipsearch_tpu.ops import common as jcommon
from colormipsearch_tpu.ops import pixel_match as jpm
from colormipsearch_tpu.ops import shape_score as jss
from colormipsearch_tpu.parallel import mesh as jmesh
from colormipsearch_tpu_torch import convert, testing
from colormipsearch_tpu_torch.ops import pixel_match as tpm
from colormipsearch_tpu_torch.ops import shape_score as tss
from colormipsearch_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)
CPU = torch.device("cpu")
H, W = 24, 32
D = 8
T = 4 * D  # 4 columns a shard
BATCH = 2
FLU = 1.23  # the banded f32 branch: flags occur


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) == D
    return jmesh.create_mesh(D), tmesh.create_mesh(["cpu"] * D)


@pytest.fixture(scope="module")
def data():
    """Targets, two masks and the band-edge pair that flags: mask pixel
    (50, 0, 53) against target pixel (151, 0, 158) at 1.23%
    (tests/test_engine_mesh.py)."""
    rng = np.random.default_rng(21)
    targets = np.stack([testing.scattered_pixels(rng, H, W, 150)
                        for _ in range(T)])
    masks = [testing.scattered_pixels(rng, H, W, 90) for _ in range(BATCH)]
    masks[0][:T // 8] = targets[:T // 8, 0]  # a few exact matches
    for m in masks:
        m[H - 1, 5] = (50, 0, 53)
    targets[1::3, H - 1, 5] = (151, 0, 158)
    return targets, masks


def _np(x):
    return np.asarray(x)


def _t(a):
    return convert.as_tensor(a, CPU)


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy()
        w = _np(w)
        if w.dtype == np.uint32:
            g = g.view(np.uint32)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_array_equal(g, w)


def _per_shard_topk(best, mirrored, flags, k):
    """The expected top-k layout from single-device [B, T] results."""
    w = best.shape[1] // D
    parts = []
    for s in range(D):
        cols = slice(s * w, (s + 1) * w)
        sk, ik, mk, fk = tpm.union_keys_topk_plain(
            best[:, cols].contiguous(), mirrored[:, cols].contiguous(),
            min(k, w), flags[:, cols].contiguous())
        parts.append((sk, ik + s * w, mk, fk))
    return tuple(torch.cat([p[i] for p in parts], 1) for i in range(4))


def _calls(name):
    return tmesh.step_calls[name]


# --- the mesh itself ----------------------------------------------------


def test_create_mesh_and_shards():
    mesh = tmesh.create_mesh(["cpu"] * 3)
    assert mesh.size == 3 and tmesh.TARGET_AXIS == "targets"
    assert mesh.devices == (torch.device("cpu"),) * 3
    planes = torch.arange(2 * 5 * 6, dtype=torch.int32).reshape(2, 5, 6)
    shards = tmesh.shard_target_planes(mesh, planes)
    assert [tuple(s.shape) for s in shards] == [(2, 5, 2)] * 3
    assert all(s.is_contiguous() for s in shards)
    assert torch.equal(torch.cat(shards, -1), planes)
    host = tmesh.shard_target_planes(mesh, planes.numpy().astype(np.uint32))
    assert all(torch.equal(a, b) for a, b in zip(host, shards))
    with pytest.raises(ValueError, match="divide"):
        tmesh.shard_target_planes(tmesh.create_mesh(["cpu"] * 4), planes)
    np.testing.assert_array_equal(tmesh.local_target_mask(shards, 6),
                                  np.ones(6, bool))
    np.testing.assert_array_equal(tmesh.pull_target_cols(planes),
                                  planes.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.create_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.create_mesh(["cuda:0"])
    with pytest.raises(ValueError):
        tmesh.create_mesh([])


def test_resolve_mesh_rule():
    mesh = tmesh.create_mesh(["cpu"] * 2)
    assert tmesh.resolve_mesh(None, CPU) is None
    assert tmesh.resolve_mesh(False, CPU) is None
    assert tmesh.resolve_mesh(mesh, CPU) is mesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.resolve_mesh(True, CPU)
    with pytest.raises(ValueError, match="mesh"):
        tmesh.resolve_mesh(mesh, torch.device("meta"))


def test_sharded_jax_array_converts(meshes):
    jm, tm = meshes
    planes = np.arange(5 * T, dtype=np.uint32).reshape(5, T) * 2654435761
    sharded = jmesh.shard_target_planes(jm, jnp.asarray(planes))
    whole = convert.as_tensor(sharded, CPU)  # the global layout
    _assert_equal([whole], [planes])
    shards = tmesh.shard_target_planes(tm, np.asarray(sharded))
    _assert_equal([torch.cat(shards, 1)], [planes])


# --- the pixel-match steps ----------------------------------------------


def _packed(data):
    targets, masks = data
    planes = _np(jcommon.pack_target_planes(jnp.asarray(targets)))
    plans = [jpm.build_query_plan(m, 20, mirror=True, xy_shift=2,
                                  pix_color_fluctuation=FLU) for m in masks]
    q_pad = max(p.positions.shape[1] for p in plans)
    plans = [jpm.build_query_plan(m, 20, mirror=True, xy_shift=2,
                                  pix_color_fluctuation=FLU, pad_to=q_pad)
             for m in masks]
    args = [np.stack([getattr(p, f) for p in plans])
            for f in ("positions", "q_cls", "q_s", "q_p")]
    kw = dict(ztol_num=plans[0].ztol_num, ztol_den=plans[0].ztol_den,
              n_straight=plans[0].n_straight)
    return planes, plans, args, kw


@pytest.mark.parametrize("top_k", [0, 2])
def test_search_step_equals_jax(meshes, data, top_k):
    jm, tm = meshes
    planes, plans, args, kw = _packed(data)
    jargs = [jnp.asarray(a[0]) for a in args]
    want = jmesh.make_sharded_search_step(
        jm, target_threshold=20, top_k=top_k, **kw)(
            jmesh.shard_target_planes(jm, jnp.asarray(planes)), *jargs)
    before = _calls("search")
    got = tmesh.make_sharded_search_step(
        tm, target_threshold=20, top_k=top_k, **kw)(
            tmesh.shard_target_planes(tm, planes), *[_t(a[0]) for a in args])
    assert _calls("search") == before + 1
    _assert_equal(got, want)
    single = tpm.score_query_batch(_t(planes), *[_t(a[:1]) for a in args],
                                   target_threshold=20, **kw)
    _assert_equal(got[:3], [x[0].numpy() for x in single])
    assert int(got[3]) == int(single[0].max())


@pytest.mark.parametrize("top_k", [0, 3])
def test_batch_step_equals_jax(meshes, data, top_k):
    """The packed (K9) step, flags and the flagged-pair count included."""
    jm, tm = meshes
    planes, _plans, args, kw = _packed(data)
    want = jmesh.make_sharded_batch_step(
        jm, target_threshold=20, top_k=top_k, **kw)(
            jmesh.shard_target_planes(jm, jnp.asarray(planes)),
            *[jnp.asarray(a) for a in args])
    before = _calls("batch")
    got = tmesh.make_sharded_batch_step(
        tm, target_threshold=20, top_k=top_k, **kw)(
            tmesh.shard_target_planes(tm, planes), *[_t(a) for a in args])
    assert _calls("batch") == before + 1
    _assert_equal(got, want)
    best, mirrored, flags = tpm.score_query_batch(
        _t(planes), *[_t(a) for a in args], target_threshold=20, **kw)
    assert (flags > 0).any(), "the band-edge pixels must flag"
    if top_k == 0:
        _assert_equal(got[:3], [best, mirrored, flags])
    else:
        _assert_equal(got[:4], _per_shard_topk(best, mirrored, flags, top_k))
        # every flagged pair is counted, selected or not
        _assert_equal([got[5]], [(flags > 0).sum(1, dtype=torch.int32)])
        selected = (got[3] > 0).sum(1)
        assert (got[5] > selected).any(), "some flags must leak"
    _assert_equal([got[3 if top_k == 0 else 4]],
                  [best.max(1).values])


def test_split_step_equals_jax(meshes, data):
    jm, tm = meshes
    targets, _masks = data
    _planes, _plans, args, kw = _packed(data)
    sp, c8 = (_np(x) for x in jcommon.pack_target_planes_split(
        jnp.asarray(targets), 20))
    want = jmesh.make_sharded_batch_step_split(jm, **kw)(
        jmesh.shard_target_planes(jm, jnp.asarray(sp)),
        jmesh.shard_target_planes(jm, jnp.asarray(c8)),
        *[jnp.asarray(a) for a in args])
    t_sp, t_c8 = convert.split_planes(sp, c8, CPU)
    before = _calls("batch_split")
    got = tmesh.make_sharded_batch_step_split(tm, **kw)(
        tmesh.shard_target_planes(tm, t_sp),
        tmesh.shard_target_planes(tm, t_c8), *[_t(a) for a in args])
    assert _calls("batch_split") == before + 1
    _assert_equal(got, want)
    single = tpm.score_query_batch_split(t_sp, t_c8, *[_t(a) for a in args],
                                         **kw)
    _assert_equal(got[:3], single)


def _key_planes(data):
    targets, _ = data
    return _np(jcommon.pack_target_planes_keys(
        jnp.asarray(targets), 20, jcommon.rank_lut_device()))


@pytest.mark.parametrize("top_k", [0, 2])
def test_keys_step_equals_jax(meshes, data, top_k):
    jm, tm = meshes
    _targets, masks = data
    t_keys = _key_planes(data)
    plans = [jpm.build_query_plan(m, 20, mirror=True, xy_shift=2,
                                  pix_color_fluctuation=1.0) for m in masks]
    q_pad = max(p.positions.shape[1] for p in plans)
    plans = [jpm.build_query_plan(m, 20, mirror=True, xy_shift=2,
                                  pix_color_fluctuation=1.0, pad_to=q_pad)
             for m in masks]
    kplans = [jpm.key_plan_from_query_plan(p, H * W, 1.0) for p in plans]
    args = [np.stack([getattr(kp, f) for kp in kplans])
            for f in ("positions", "lo", "span")]
    n_straight = kplans[0].n_straight
    want = jmesh.make_sharded_batch_step_keys(
        jm, n_straight=n_straight, top_k=top_k)(
            jmesh.shard_target_planes(jm, jnp.asarray(t_keys)),
            *[jnp.asarray(a) for a in args])
    before = _calls("batch_keys")
    got = tmesh.make_sharded_batch_step_keys(
        tm, n_straight=n_straight, top_k=top_k)(
            tmesh.shard_target_planes(tm, t_keys), *[_t(a) for a in args])
    assert _calls("batch_keys") == before + 1
    _assert_equal(got, want)
    best, mirrored = tpm.score_query_batch_keys(
        _t(t_keys), *[_t(a) for a in args], n_straight=n_straight)
    zeros = torch.zeros_like(best)
    want_single = ([best, mirrored, zeros] if top_k == 0
                   else _per_shard_topk(best, mirrored, zeros, top_k))
    _assert_equal(got[:len(want_single)], want_single)
    assert best.max() > 0


def _union_args(data, form):
    _targets, masks = data
    build = (jpm.build_full_union_key_plan if form == "full"
             else jpm.build_union_key_plan)
    plans = [build(m, 20, mirror=True, xy_shift=2,
                   pix_color_fluctuation=1.0) for m in masks]
    return plans, jpm.stack_union_plan_args(plans, H * W)


@pytest.mark.parametrize("form", ["x", "full"])
@pytest.mark.parametrize("top_k", [0, 3])
def test_union_keys_step_equals_jax(meshes, data, form, top_k):
    jm, tm = meshes
    t_keys = _key_planes(data)
    _plans, (*arrs, u2) = _union_args(data, form)
    u2 = u2 if form == "full" else None
    want = jmesh.make_sharded_batch_step_union_keys(jm, top_k=top_k, u2=u2)(
        jmesh.shard_target_planes(jm, jnp.asarray(t_keys)),
        *[jnp.asarray(a) for a in arrs])
    before = _calls("batch_union_keys")
    got = tmesh.make_sharded_batch_step_union_keys(tm, top_k=top_k, u2=u2)(
        tmesh.shard_target_planes(tm, t_keys), *[_t(a) for a in arrs])
    assert _calls("batch_union_keys") == before + 1
    _assert_equal(got, want)
    best, mirrored = tpm.score_query_batch_union_keys(
        _t(t_keys), *[_t(a) for a in arrs], u2)
    zeros = torch.zeros_like(best)
    want_single = ([best, mirrored, zeros] if top_k == 0
                   else _per_shard_topk(best, mirrored, zeros, top_k))
    _assert_equal(got[:len(want_single)], want_single)


@pytest.mark.parametrize("top_k", [0, 3])
def test_union_qkeys_step_equals_jax_and_the_tables_step(meshes, data,
                                                          top_k):
    """Row 14 over the mesh equals the JAX qkey step, and the union-keys
    step fed with row 13's expansion of the same batch."""
    jm, tm = meshes
    t_keys = _key_planes(data)
    plans, _ = _union_args(data, "full")
    u_pos, mu_pos, qidx, key_list, u2 = jpm.stack_union_qkey_args(plans,
                                                                  H * W)
    tabs = jpm.interval_table_arrays(0.01)
    want = jmesh.make_sharded_batch_step_union_qkeys(jm, top_k=top_k,
                                                     u2=u2)(
        jmesh.shard_target_planes(jm, jnp.asarray(t_keys)),
        *[jnp.asarray(a) for a in (u_pos, mu_pos, qidx, key_list, *tabs)])
    shards = tmesh.shard_target_planes(tm, t_keys)
    qargs = (_t(u_pos), _t(mu_pos), convert.qidx(qidx, CPU), _t(key_list),
             *convert.interval_tables(tabs, CPU))
    before = _calls("batch_union_qkeys")
    got = tmesh.make_sharded_batch_step_union_qkeys(tm, top_k=top_k, u2=u2)(
        shards, *qargs)
    assert _calls("batch_union_qkeys") == before + 1
    _assert_equal(got, want)
    lo, sp = tpm.expand_union_tables(*qargs[2:])
    tables = tmesh.make_sharded_batch_step_union_keys(tm, top_k=top_k,
                                                      u2=u2)(
        shards, qargs[0], qargs[1], lo, sp)
    _assert_equal(got, [x.numpy() for x in tables])


# --- the shape steps ------------------------------------------------------


def _shape_data():
    rng = np.random.default_rng(0)
    p_rows = H * W
    t_pack = rng.integers(0, 1 << 27, (p_rows, T)).astype(np.uint32)
    q_pack = rng.integers(0, 1 << 12, p_rows).astype(np.int32)
    q_pack[::3] = 0
    return t_pack, q_pack


@pytest.mark.parametrize("both", [False, True])
def test_shape_step_equals_jax(meshes, both):
    jm, tm = meshes
    t_pack, q_pack = _shape_data()
    if both:
        t_pack = np.stack([t_pack, t_pack[::-1].copy()])
        q_pack = np.stack([q_pack, q_pack[::-1].copy()])
    want = jmesh.make_sharded_shape_step(jm, both=both)(
        jmesh.shard_target_planes(jm, jnp.asarray(t_pack)),
        jnp.asarray(q_pack))
    name = "shape_both" if both else "shape"
    before = _calls(name)
    got = tmesh.make_sharded_shape_step(tm, both=both)(
        tmesh.shard_target_planes(tm, t_pack), _t(q_pack))
    assert _calls(name) == before + 1
    _assert_equal(got, want)
    pairs = tss.shape_score_pairs_both if both else tss.shape_score_pairs
    _assert_equal(got, pairs(_t(t_pack), _t(q_pack)))


def test_shape_split_step_equals_jax(meshes):
    jm, tm = meshes
    rng = np.random.default_rng(2)
    t_pack, q_pack = _shape_data()
    t_gap = np.stack([t_pack, t_pack]) & np.uint32((0x1FF << 16) | 0xFFFF)
    q_gap = np.stack([q_pack, q_pack]) & np.int32(0x7FF)
    t_he = rng.integers(0, 1 << 32, (2, 9, T), dtype=np.uint64) \
        .astype(np.uint32)
    q_he = rng.integers(0, 1 << 32, (2, 9), dtype=np.uint64).astype(np.uint32)
    want = jmesh.make_sharded_shape_split_step(jm)(
        jmesh.shard_target_planes(jm, jnp.asarray(t_gap)),
        jnp.asarray(q_gap),
        jmesh.shard_target_planes(jm, jnp.asarray(t_he)), jnp.asarray(q_he))
    before = _calls("shape_split")
    got = tmesh.make_sharded_shape_split_step(tm)(
        tmesh.shard_target_planes(tm, t_gap), _t(q_gap),
        tmesh.shard_target_planes(tm, t_he), _t(q_he))
    assert _calls("shape_split") == before + 1
    _assert_equal(got, want)
    _assert_equal(got, tss.shape_score_pairs_split(
        _t(t_gap), _t(q_gap), _t(t_he), _t(q_he)))


def test_steps_check_their_shards(meshes, data):
    _jm, tm = meshes
    t_keys = _key_planes(data)
    _plans, (*arrs, u2) = _union_args(data, "full")
    step = tmesh.make_sharded_batch_step_union_keys(tm, u2=u2)
    shards = tmesh.shard_target_planes(tm, t_keys)
    with pytest.raises(ValueError, match="shards"):
        step(shards[:4], *[_t(a) for a in arrs])
    tmesh.reset_step_calls()
    assert set(tmesh.step_calls.values()) == {0}


def test_k4_flag_gather_equals_lax_top_k():
    """K4's flag gather (the per-shard tail of the mesh steps) picks the
    flags at jax.lax.top_k's columns, ties included."""
    rng = np.random.default_rng(8)
    best = rng.integers(0, 4, (3, 50)).astype(np.int32)
    mirrored = rng.integers(0, 2, (3, 50)).astype(bool)
    flags = rng.integers(0, 9, (3, 50)).astype(np.int32)
    sk, ik = jax.lax.top_k(jnp.asarray(best), 7)
    got = tpm.union_keys_topk(_t(best), _t(mirrored), 7, _t(flags))
    _assert_equal(got, [sk, ik, np.take_along_axis(mirrored, _np(ik), 1),
                        np.take_along_axis(flags, _np(ik), 1)])
    assert len(tpm.union_keys_topk(_t(best), _t(mirrored), 7)) == 3
    with pytest.raises(ValueError):
        tpm.union_keys_topk(_t(best), _t(mirrored), 7, _t(flags[:, :9]))


def test_shape_steps_plug_into_the_batch_scorers(meshes):
    """make_sharded_shape_step, cut over the mesh, as the pairs_fn of
    score_shape_batch and the pairs_both_fn of score_shape_batch_stacked
    (as the JAX package plugs its steps in): the single-device scores."""
    _jm, tm = meshes
    t_pack, q_pack = _shape_data()
    t_m = t_pack[::-1].copy()
    one = tmesh.make_sharded_shape_step(tm)
    both = tmesh.make_sharded_shape_step(tm, both=True)
    before = (_calls("shape"), _calls("shape_both"))
    got = tss.score_shape_batch(
        t_pack, t_m, q_pack, mirror=True, device=CPU,
        pairs_fn=lambda t, q: one(tmesh.shard_target_planes(tm, t), q))
    want = tss.score_shape_batch(t_pack, t_m, q_pack, mirror=True,
                                 device=CPU)
    rows = np.stack([t_pack, t_m])
    got2 = tss.score_shape_batch_stacked(
        rows, q_pack, mirror=True, device=CPU,
        pairs_both_fn=lambda t, q: both(tmesh.shard_target_planes(tm, t), q))
    assert (_calls("shape"), _calls("shape_both")) == (before[0] + 2,
                                                       before[1] + 1)
    for g, g2, w in zip(got, got2, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g2, w)
    assert want[2].any() and not want[2].all()
