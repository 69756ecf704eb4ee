"""The mesh finish (ops/mesh_finish.py, kernels/csrc/mesh_finish.cu) and
the sharded steps built on it.

On the CPU: mesh_finish_plain against jax.lax.top_k with the mirrored and
flag gathers at the chosen columns, the port's _finish_batched_step
against the JAX package's (colormipsearch_tpu/parallel/mesh.py:230-257,
run through shard_map on the tests' 8 virtual CPU devices, D = 8), and
the batched steps that use it (packed K9 with flags, keys and union keys
without) and the one-mask search step against the JAX steps, at k = 1,
3, w and past w, B = 1 and 2, all-equal scores (tie order). Every input
is made with numpy from a seed; every output is an integer or a bool,
so equality is exact.

The two tests marked `cuda` skip here: the kernel against its plain
version at testing.MESH_FINISH_EDGE_CASES, and every step on a mesh of
CUDA shards under torch.cuda.set_sync_debug_mode("error") (no step may
wait on the host) against the same step on a CPU mesh. JAX is imported
inside fixtures, so they also run on a GPU host, which has none:

    python -m pytest tests/test_torch_mesh_finish.py -m cuda -q --noconftest
"""

import numpy as np
import pytest
import torch

from colormipsearch_tpu_torch import convert, testing
from colormipsearch_tpu_torch.ops import common as tcommon
from colormipsearch_tpu_torch.ops import mesh_finish as mf
from colormipsearch_tpu_torch.ops import pixel_match as tpm
from colormipsearch_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)
CPU = torch.device("cpu")
H, W = 24, 32
D = 8
WIDTH = 4          # columns a shard
T = D * WIDTH
FLU = 1.23         # the banded f32 branch: flags occur


@pytest.fixture(scope="module")
def jx():
    """The JAX side: (jax, jnp, the JAX package's mesh module, its mesh
    over the 8 virtual CPU devices)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from colormipsearch_tpu.parallel import mesh as jmesh

    assert len(jax.devices()) == D
    return jax, jnp, jmesh, jmesh.create_mesh(D)


@pytest.fixture(scope="module")
def tm():
    return tmesh.create_mesh(["cpu"] * D)


def _t(a):
    return convert.as_tensor(np.asarray(a), CPU)


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        if w.dtype == np.uint32:
            g = g.view(np.uint32)
        assert g.shape == w.shape, (g.shape, w.shape)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def _scores(rng, kind: str, shape) -> np.ndarray:
    if kind == "narrow":      # many ties, as real match counts
        return rng.integers(0, 6, shape).astype(np.int32)
    if kind == "equal":       # every score of a row the same
        return np.repeat(rng.integers(-3, 9, (shape[0], 1)), shape[1],
                         axis=1).astype(np.int32)
    out = rng.integers(-(1 << 31), 1 << 31, shape, dtype=np.int64)
    pick = rng.random(shape) < 0.5
    out[pick] = rng.choice(np.array([-(1 << 31), (1 << 31) - 1, -1, 0, 1]),
                           int(pick.sum()))
    return out.astype(np.int32)


# --- the finish alone ---------------------------------------------------


@pytest.mark.parametrize("case", testing.MESH_FINISH_EDGE_CASES,
                         ids=[c[0] for c in testing.MESH_FINISH_EDGE_CASES])
def test_mesh_finish_plain_equals_lax_top_k(jx, case):
    """mesh_finish_plain at every edge case: jax.lax.top_k's scores and
    columns (offset), the mirrored bits and flags at those columns (zeros
    without flags), the row max and the flagged count; the wrapper on
    CPU tensors, writing into a column slice of wider outputs, gives the
    same and leaves the rest alone."""
    jax, jnp, _jmesh, _jm = jx
    rng = np.random.default_rng(sum(map(ord, case[0])))
    best, mirrored, flags, k = testing.topk_edge_inputs(rng, case, CPU)
    batch, width = best.shape
    offset = 3 * width
    got = mf.mesh_finish_plain(best, mirrored, k, flags, offset)
    b_np, m_np = best.numpy(), mirrored.numpy()
    f_np = (np.zeros_like(b_np) if flags is None else flags.numpy())
    sk, ik = jax.lax.top_k(jnp.asarray(b_np), k)
    ik = np.asarray(ik)
    row_max = (b_np.max(1) if width and batch
               else np.zeros(batch, np.int32))
    _assert_equal(got, [np.asarray(sk), (ik + offset).astype(np.int32),
                        np.take_along_axis(m_np, ik, 1),
                        np.take_along_axis(f_np, ik, 1),
                        row_max.astype(np.int32),
                        (f_np > 0).sum(1).astype(np.int32)])
    wide = torch.full((3, batch, 2 * k + 1), -7, dtype=torch.int32)
    wide_m = torch.zeros((batch, 2 * k + 1), dtype=torch.bool)
    tail = torch.full((2, batch), -7, dtype=torch.int32)
    out = (wide[0, :, k:2 * k], wide[1, :, k:2 * k], wide_m[:, k:2 * k],
           wide[2, :, k:2 * k], tail[0], tail[1])
    assert mf.mesh_finish(best, mirrored, k, flags, offset, out=out) is out
    _assert_equal(out, got)
    assert (wide[..., :k] == -7).all() and (wide[..., 2 * k:] == -7).all()
    assert not wide_m[:, :k].any() and not wide_m[:, 2 * k:].any()
    _assert_equal(mf.mesh_finish(best, mirrored, k, flags, offset), got)


def test_mesh_finish_checks_its_arguments():
    best = torch.zeros((2, 5), dtype=torch.int32)
    mirrored = torch.zeros((2, 5), dtype=torch.bool)
    with pytest.raises(ValueError, match="k=6"):
        mf.mesh_finish(best, mirrored, 6)
    with pytest.raises(TypeError):
        mf.mesh_finish(best.long(), mirrored, 2)
    wide = torch.zeros((2, 9), dtype=torch.int32)
    ok = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="row stride"):
        mf.mesh_finish(best, mirrored, 2,
                       out=(wide[:, :2], ok, None, None, None, None))
    with pytest.raises(ValueError, match="scores and idx"):
        mf.mesh_finish(best, mirrored, 2,
                       out=(None, ok, None, None, None, None))
    with pytest.raises(ValueError):
        mf.mesh_reduce(torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("with_flags", [True, False])
@pytest.mark.parametrize("n_shards", [1, 8])
def test_mesh_reduce_plain(n_shards, with_flags):
    rng = np.random.default_rng(n_shards)
    slot_max = rng.integers(-(1 << 31), 1 << 31, (n_shards, 5),
                            dtype=np.int64).astype(np.int32)
    slot_flagged = rng.integers(0, 100, (n_shards, 5)).astype(np.int32)
    got = mf.mesh_reduce(_t(slot_max),
                         _t(slot_flagged) if with_flags else None)
    np.testing.assert_array_equal(got[0].numpy(), slot_max.max(0))
    if with_flags:
        np.testing.assert_array_equal(got[1].numpy(), slot_flagged.sum(0))
    else:
        assert got[1] is None


def _jax_finish(jx, best, mirrored, flags, top_k):
    """The JAX package's _finish_batched_step over its 8-device mesh."""
    jax, jnp, jmesh, jm = jx
    spec = jmesh.P(None, jmesh.TARGET_AXIS)
    fn = jmesh.shard_map(
        lambda b, m, f: jmesh._finish_batched_step(b, m, f, top_k),
        mesh=jm, in_specs=(spec,) * 3,
        out_specs=jmesh._batched_out_specs(top_k), check_rep=False)
    return jax.jit(fn)(*(jmesh.shard_target_planes(jm, jnp.asarray(x))
                         for x in (best, mirrored, flags)))


@pytest.mark.parametrize("kind", ["narrow", "equal", "extremes"])
@pytest.mark.parametrize("with_flags", [True, False])
@pytest.mark.parametrize("batch,top_k", [(1, 1), (1, 3), (2, 1), (2, 3),
                                         (2, WIDTH), (1, 50), (2, 0)])
def test_finish_batched_step_equals_jax(jx, tm, batch, top_k, kind,
                                        with_flags):
    """The port's _finish_batched_step (one mesh_finish a shard, one
    mesh_reduce) against the JAX one at D = 8: k = 1, 3, w and past w
    (clipped to w), B = 1 and 2, ties, flags or none (the JAX step then
    gets zeros, as the key steps hand it)."""
    rng = np.random.default_rng(batch * 100 + top_k)
    best = _scores(rng, kind, (batch, T))
    mirrored = rng.random((batch, T)) < 0.5
    flags = (rng.integers(0, 3, (batch, T)) * (rng.random((batch, T)) < 0.3)
             ).astype(np.int32) if with_flags else np.zeros((batch, T),
                                                            np.int32)
    want = _jax_finish(jx, best, mirrored, flags, top_k)
    per = [(_t(best[:, s * WIDTH:(s + 1) * WIDTH]),
            _t(mirrored[:, s * WIDTH:(s + 1) * WIDTH]),
            _t(flags[:, s * WIDTH:(s + 1) * WIDTH]) if with_flags else None)
           for s in range(D)]
    got = tmesh._finish_batched_step(tm, per, top_k)
    _assert_equal(got, want)


def test_runs_and_shard_slices():
    """The shards a step's outputs take from other devices than the
    first: runs of consecutive shards, each one compact block."""
    cpu, meta = torch.device("cpu"), torch.device("meta")
    mesh = tmesh.Mesh((cpu, meta, meta, cpu, meta))
    assert tmesh._runs(mesh) == [[meta, 1, 2], [meta, 4, 1]]
    out = tmesh._ShardSlices(mesh, tmesh._runs(mesh), (3,), 2, (), torch.int32)
    assert tuple(out.full.shape) == (3, 10) and out.full.device == cpu
    assert [tuple(b.shape) for b, _, _ in out.blocks] == [(3, 4), (3, 2)]
    assert out.slice(0).device == cpu and out.slice(2).device == meta
    out.slice(3).fill_(5)
    assert (out.full[:, 6:8] == 5).all()
    assert tmesh._runs(tmesh.create_mesh(["cpu"] * 4)) == []
    assert tmesh._side_pool(tmesh.create_mesh(["cpu"] * 4)) is None


# --- the steps over the mesh ----------------------------------------------


def _library(n_masks: int):
    rng = np.random.default_rng(31)
    targets = np.stack([testing.scattered_pixels(rng, H, W, 150)
                        for _ in range(T)])
    masks = [testing.scattered_pixels(rng, H, W, 90) for _ in range(n_masks)]
    masks[0][:T // 8] = targets[:T // 8, 0]  # a few exact matches
    for m in masks:
        m[H - 1, 5] = (50, 0, 53)            # the band-edge pair that flags
    targets[1::3, H - 1, 5] = (151, 0, 158)
    return targets, masks


def _classic_args(masks, flu: float):
    plans = [tpm.build_query_plan(m, 20, mirror=True, xy_shift=2,
                                  pix_color_fluctuation=flu) for m in masks]
    q_pad = max(p.positions.shape[1] for p in plans)
    plans = [tpm.build_query_plan(m, 20, mirror=True, xy_shift=2,
                                  pix_color_fluctuation=flu, pad_to=q_pad)
             for m in masks]
    return plans, [np.stack([getattr(p, f) for p in plans])
                   for f in ("positions", "q_cls", "q_s", "q_p")]


TOP_KS = [1, 3, WIDTH, 9]


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("top_k", TOP_KS)
def test_batch_step_topk_equals_jax(jx, tm, batch, top_k):
    """The packed (K9) step with its flags through the finish."""
    _jax, jnp, jmesh, jm = jx
    targets, masks = _library(batch)
    planes = tcommon.pack_target_planes(torch.from_numpy(targets))
    plans, args = _classic_args(masks, FLU)
    kw = dict(ztol_num=plans[0].ztol_num, ztol_den=plans[0].ztol_den,
              n_straight=plans[0].n_straight)
    want = jmesh.make_sharded_batch_step(
        jm, target_threshold=20, top_k=top_k, **kw)(
            jmesh.shard_target_planes(jm, jnp.asarray(
                planes.numpy().view(np.uint32))),
            *[jnp.asarray(a) for a in args])
    got = tmesh.make_sharded_batch_step(
        tm, target_threshold=20, top_k=top_k, **kw)(
            tmesh.shard_target_planes(tm, planes), *[_t(a) for a in args])
    _assert_equal(got, want)
    assert int(got[5].sum()) > 0, "the band-edge pixels must flag"


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("top_k", TOP_KS)
def test_keys_step_topk_equals_jax(jx, tm, batch, top_k):
    """The classic key (K10) step: no flags, written as zeros."""
    _jax, jnp, jmesh, jm = jx
    targets, masks = _library(batch)
    keys = tcommon.pack_target_planes_keys(
        torch.from_numpy(targets), 20, tcommon.rank_lut_tensor(CPU))
    plans, _ = _classic_args(masks, 1.0)
    kplans = [tpm.key_plan_from_query_plan(p, H * W, 1.0) for p in plans]
    args = [np.stack([getattr(kp, f) for kp in kplans])
            for f in ("positions", "lo", "span")]
    n_straight = kplans[0].n_straight
    want = jmesh.make_sharded_batch_step_keys(
        jm, n_straight=n_straight, top_k=top_k)(
            jmesh.shard_target_planes(jm, jnp.asarray(keys.numpy())),
            *[jnp.asarray(a) for a in args])
    got = tmesh.make_sharded_batch_step_keys(
        tm, n_straight=n_straight, top_k=top_k)(
            tmesh.shard_target_planes(tm, keys), *[_t(a) for a in args])
    _assert_equal(got, want)
    assert not got[3].any() and not got[5].any()


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("top_k", [0, *TOP_KS])
def test_union_keys_step_topk_equals_jax(jx, tm, batch, top_k):
    """The full-union (K3) step, the default path's, dense and top-k."""
    _jax, jnp, jmesh, jm = jx
    targets, masks = _library(batch)
    keys = tcommon.pack_target_planes_keys(
        torch.from_numpy(targets), 20, tcommon.rank_lut_tensor(CPU))
    plans = [tpm.build_full_union_key_plan(m, 20, mirror=True, xy_shift=2,
                                           pix_color_fluctuation=1.0)
             for m in masks]
    *arrs, u2 = tpm.stack_union_plan_args(plans, H * W)
    want = jmesh.make_sharded_batch_step_union_keys(jm, top_k=top_k, u2=u2)(
        jmesh.shard_target_planes(jm, jnp.asarray(keys.numpy())),
        *[jnp.asarray(a) for a in arrs])
    got = tmesh.make_sharded_batch_step_union_keys(tm, top_k=top_k, u2=u2)(
        tmesh.shard_target_planes(tm, keys), *[_t(a) for a in arrs])
    _assert_equal(got, want)


@pytest.mark.parametrize("top_k", TOP_KS)
def test_search_step_topk_equals_jax(jx, tm, top_k):
    """The one-mask search step: K9 into the slices of its [T] outputs,
    the finish at B = 1."""
    _jax, jnp, jmesh, jm = jx
    targets, masks = _library(1)
    planes = tcommon.pack_target_planes(torch.from_numpy(targets))
    plans, args = _classic_args(masks, FLU)
    kw = dict(ztol_num=plans[0].ztol_num, ztol_den=plans[0].ztol_den,
              n_straight=plans[0].n_straight)
    want = jmesh.make_sharded_search_step(
        jm, target_threshold=20, top_k=top_k, **kw)(
            jmesh.shard_target_planes(jm, jnp.asarray(
                planes.numpy().view(np.uint32))),
            *[jnp.asarray(a[0]) for a in args])
    got = tmesh.make_sharded_search_step(
        tm, target_threshold=20, top_k=top_k, **kw)(
            tmesh.shard_target_planes(tm, planes), *[_t(a[0]) for a in args])
    _assert_equal(got, want)
    assert got[3].shape == ()


# --- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the mesh finish kernel has no CPU "
                    "mode (its plain version is tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", testing.MESH_FINISH_EDGE_CASES,
                         ids=[c[0] for c in testing.MESH_FINISH_EDGE_CASES])
def test_mesh_finish_kernel_equals_plain(cuda_device, case):
    testing.check_mesh_finish_edge(case, cuda_device)
    torch.cuda.synchronize()


def _all_steps(mesh, device):
    """Every sharded step on `mesh` with inputs on `device` (built on the
    CPU with the plain versions): {name: thunk}."""
    targets, masks = _library(2)
    rgb = torch.from_numpy(targets)
    planes = tcommon.pack_target_planes(rgb, 20)
    keys = tcommon.pack_target_planes_keys(rgb, 20,
                                           tcommon.rank_lut_tensor(CPU))
    sp, c8 = tcommon.split_planes_from_packed(planes)
    plans, args = _classic_args(masks, FLU)
    kw = dict(ztol_num=plans[0].ztol_num, ztol_den=plans[0].ztol_den,
              n_straight=plans[0].n_straight)
    kplans = [tpm.key_plan_from_query_plan(p, H * W, 1.0) for p in plans]
    kargs = [np.stack([getattr(kp, f) for kp in kplans])
             for f in ("positions", "lo", "span")]
    fplans = [tpm.build_full_union_key_plan(m, 20, mirror=True, xy_shift=2,
                                            pix_color_fluctuation=1.0)
              for m in masks]
    *uargs, u2 = tpm.stack_union_plan_args(fplans, H * W)
    u_pos, mu_pos, qidx, key_list, u2q = tpm.stack_union_qkey_args(fplans,
                                                                   H * W)
    tabs = tpm.interval_table_arrays(0.01)
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 1 << 27, (2, 40, T)).astype(np.uint32)
    q2 = rng.integers(0, 1 << 12, (2, 40)).astype(np.int32)
    t_he = rng.integers(0, 1 << 32, (2, 9, T), dtype=np.uint64) \
        .astype(np.uint32)
    q_he = rng.integers(0, 1 << 32, (2, 9), dtype=np.uint64).astype(np.uint32)

    def on(x):
        return (convert.as_tensor(x, device) if isinstance(x, np.ndarray)
                else x.to(device))

    def cut(x):
        return tmesh.shard_target_planes(mesh, x.to(device) if isinstance(
            x, torch.Tensor) else x)

    p_sh, k_sh, sp_sh, c8_sh = (cut(x) for x in (planes, keys, sp, c8))
    rows_sh, gap_sh, he_sh = (cut(x) for x in (
        rows, rows & np.uint32((0x1FF << 16) | 0xFFFF), t_he))
    a, ka, ua = ([on(x) for x in xs] for xs in (args, kargs, uargs))
    qa = [on(u_pos), on(mu_pos), convert.qidx(qidx, device), on(key_list),
          *convert.interval_tables(tabs, device)]
    q2_t, gapq, qhe = on(q2), on(q2 & np.int32(0x7FF)), on(q_he)
    steps = {}
    for top_k in (0, 3):
        steps[f"search_{top_k}"] = (tmesh.make_sharded_search_step(
            mesh, target_threshold=-1, top_k=top_k, **kw),
            (p_sh, *(x[0] for x in a)))
        steps[f"batch_{top_k}"] = (tmesh.make_sharded_batch_step(
            mesh, target_threshold=-1, top_k=top_k, **kw), (p_sh, *a))
        steps[f"keys_{top_k}"] = (tmesh.make_sharded_batch_step_keys(
            mesh, n_straight=kplans[0].n_straight, top_k=top_k), (k_sh, *ka))
        steps[f"union_{top_k}"] = (tmesh.make_sharded_batch_step_union_keys(
            mesh, top_k=top_k, u2=u2), (k_sh, *ua))
        steps[f"qkeys_{top_k}"] = (tmesh.make_sharded_batch_step_union_qkeys(
            mesh, top_k=top_k, u2=u2q), (k_sh, *qa))
    steps["split"] = (tmesh.make_sharded_batch_step_split(mesh, **kw),
                      (sp_sh, c8_sh, *a))
    steps["shape"] = (tmesh.make_sharded_shape_step(mesh),
                      ([x[0].contiguous() for x in rows_sh], q2_t[0]))
    steps["shape_both"] = (tmesh.make_sharded_shape_step(mesh, both=True),
                           (rows_sh, q2_t))
    steps["shape_split"] = (tmesh.make_sharded_shape_split_step(mesh),
                            (gap_sh, gapq, he_sh, qhe))
    return steps


@pytest.mark.cuda
def test_mesh_steps_make_no_host_sync(cuda_device):
    """Every step on 4 shards of one card (and, with several cards, on
    shards that alternate between two and on one shard a card) runs
    under
    torch.cuda.set_sync_debug_mode("error"), which raises on any call
    that waits on the host, and returns what the step returns on a CPU
    mesh."""
    n_cards = torch.cuda.device_count()
    layouts = [["cuda:0"] * 4]
    if n_cards > 1:
        # shards alternating over two cards; then one a card from the
        # second (the first device is not the current one)
        layouts += [["cuda:0", "cuda:1"] * 2,
                    [f"cuda:{i % n_cards}" for i in range(1, 5)]]
    want = {name: step(*args) for name, (step, args) in _all_steps(
        tmesh.create_mesh(["cpu"] * 4), CPU).items()}
    for layout in layouts:
        steps = _all_steps(tmesh.create_mesh(layout), cuda_device)
        torch.cuda.synchronize()
        got = {}
        for name, (step, args) in steps.items():
            torch.cuda.set_sync_debug_mode("error")
            try:
                got[name] = step(*args)
                got[name] = step(*args)   # the second call, streams made
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        for name, out in got.items():
            _assert_equal(out, [x.numpy() for x in want[name]])


@pytest.mark.cuda
def test_engines_over_every_card_equal_one_card(cuda_device, tmp_path,
                                                monkeypatch):
    """The default mesh of a host with several cards (use_mesh None:
    every card): colorDepthSearch in its configurations finds what one
    card finds, through the mesh steps (the shards' top-k blocks of the
    other cards copied to the first, a side stream a shard on each
    card)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards: the default mesh spans "
                    "every card")
    from colormipsearch_tpu_torch.engine import cds as tcds

    rng = np.random.default_rng(35)
    lib = testing.synthetic_library(rng, 40, 6, 64, 96, target_fg=0.08,
                                    mask_fg=0.03)
    masks = testing.write_neuron_images(tmp_path / "m", lib.masks, "m",
                                        threads=2)
    targets = testing.write_neuron_images(tmp_path / "t", lib.targets, "t",
                                          threads=2)
    params = dict(mask_threshold=20, data_threshold=20,
                  pix_color_fluctuation=1.0, xy_shift=2, mirror_mask=True)
    cases = (({}, {}, "batch_union_keys"),
             ({}, dict(pct_positive_pixels=1.0), "batch_union_keys"),
             (dict(use_key_planes=True), {}, "batch_keys"),
             (dict(use_key_planes=False), {}, "batch"),
             (dict(use_key_planes=False), {}, "batch_split"))
    for kw, extra, step in cases:
        if step == "batch_split":
            monkeypatch.setenv("CDS_SPLIT_PLANES", "1")
        p = tcds.CDSParams(**params, **extra)

        def run(use_mesh):
            engine = tcds.CDSearchEngine(p, device="cuda", use_mesh=use_mesh,
                                         decode_concurrency=2, **kw)
            return engine, sorted(
                (m.mask_image.mip_id, m.matched_image.mip_id,
                 m.matching_pixels, m.mirrored, m.matching_pixels_ratio)
                for m in engine.find_all_matches(masks, targets))

        _, want = run(False)
        tmesh.reset_step_calls()
        engine, got = run(None)
        assert engine._mesh is not None
        assert engine._mesh.size == torch.cuda.device_count()
        assert tmesh.step_calls[step] > 0, (step, tmesh.step_calls)
        assert got == want and len(got) >= 3, step
