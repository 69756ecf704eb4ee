"""The port's engines on a CPU mesh (8 shards on the CPU, where every
wrapper runs its plain PyTorch version) against the JAX engines, which
run their 8-device mesh in the tests, and against the port's
single-device engine: identical match tuples (matchingPixelsRatio to the
last bit) and identical shape scores. The cases mirror
tests/test_engine_mesh.py: single-device equality, the top-k cap,
streaming, split planes and the flagged zero-score pair, plus the
classic paths, the negative query and gradScores. Every case checks that
the mesh's steps ran (parallel.mesh.step_calls), or, for a mesh the
padded width does not divide, that they did not.

The library plants pixel pairs whose ratios are exactly the z-tolerance
apart (tests/test_torch_engine_classic.py): the packed kernel flags
them, so its float64 rescore runs on the mesh too.
"""

import numpy as np
import pytest
import torch

import jax

from colormipsearch_tpu.engine import cds as jcds
from colormipsearch_tpu.engine import gradscore as jgs
from colormipsearch_tpu.model import CDMatch as JCDMatch
from colormipsearch_tpu.model import neuron_from_json as jax_neuron
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.engine import cds as tcds
from colormipsearch_tpu_torch.engine import gradscore as tgs
from colormipsearch_tpu_torch.model import CDMatch
from colormipsearch_tpu_torch.parallel import mesh as tmesh
from colormipsearch_tpu_torch.utils.metrics import GLOBAL as TMETRICS

torch.set_num_threads(2)
H, W = 64, 96
PARAMS = dict(mask_threshold=20, data_threshold=20, pix_color_fluctuation=1.0,
              xy_shift=2, mirror_mask=True)
BOUNDARY = [(9, 60), (40, 12), (55, 80)]  # (y, x) of the planted pairs
MESH = tmesh.create_mesh(["cpu"] * 8)


def _tuples(matches):
    return sorted((m.mask_image.mip_id, m.matched_image.mip_id,
                   m.matching_pixels, m.mirrored, m.matching_pixels_ratio)
                  for m in matches)


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """6 masks (half cut from targets) x 40 targets: T_pad 64, 8 columns
    a shard."""
    tmp = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(35)
    lib = testing.synthetic_library(rng, 40, 6, H, W, target_fg=0.08,
                                    mask_fg=0.03)
    for img in lib.masks:
        for y, x in BOUNDARY:
            img[y, x] = (25, 0, 100)      # class BR, ratio 0.25
    for img in lib.targets[::3]:
        for y, x in BOUNDARY:
            img[y, x] = (24, 0, 100)      # class BR, ratio 0.24
    masks = testing.write_neuron_images(tmp / "m", lib.masks, "m",
                                        threads=2)
    targets = testing.write_neuron_images(tmp / "t", lib.targets, "t",
                                          threads=2)
    return lib, masks, targets


def _split_on(monkeypatch):
    monkeypatch.setenv("CDS_SPLIT_PLANES", "1")
    monkeypatch.setattr(jcds, "_USE_SPLIT", True)


CASES = {
    # name: (port and JAX engine kwargs, find_all_matches kwargs, params,
    #        the mesh step that must run)
    "default": ({}, {}, {}, "batch_union_keys"),
    "default_pct_1_emit_topk": ({}, {}, dict(pct_positive_pixels=1.0),
                                "batch_union_keys"),
    "default_max_matches_3": ({}, dict(max_matches_per_mask=3), {},
                              "batch_union_keys"),
    "x_union": (dict(use_union_keys="x"), {}, {}, "batch_union_keys"),
    "key_planes": (dict(use_key_planes=True), {}, {}, "batch_keys"),
    "key_planes_max_matches_2": (dict(use_key_planes=True),
                                 dict(max_matches_per_mask=2), {},
                                 "batch_keys"),
    "packed": (dict(use_key_planes=False), {}, {}, "batch"),
    "packed_max_matches_2": (dict(use_key_planes=False),
                             dict(max_matches_per_mask=2), {}, "batch"),
    "packed_split": (dict(use_key_planes=False), {}, {}, "batch_split"),
    "several_shards": ({}, {}, {}, "batch_union_keys"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_engine_equals_jax_and_single_device(library, case,
                                                  monkeypatch):
    _lib, masks, targets = library
    kw, find_kw, extra, step = CASES[case]
    if case == "packed_split":
        _split_on(monkeypatch)
    if case == "default_pct_1_emit_topk":
        # per-shard emit selection: 4 of the 8 columns a shard
        monkeypatch.setenv("CDS_EMIT_TOPK", "4")
    if case == "several_shards":
        monkeypatch.setenv("CDS_TARGET_TILE", "16")
    p = dict(PARAMS, **extra)
    jax_engine = jcds.CDSearchEngine(jcds.CDSParams(**p),
                                     decode_concurrency=2, **kw)
    assert jax_engine._mesh is not None
    want = _tuples(jax_engine.find_all_matches(
        [jax_neuron(m.to_json()) for m in masks],
        [jax_neuron(t.to_json()) for t in targets], **find_kw))
    single = tcds.CDSearchEngine(tcds.CDSParams(**p), device="cpu",
                                 use_mesh=False, decode_concurrency=2, **kw)
    assert single._mesh is None
    want_single = _tuples(single.find_all_matches(masks, targets, **find_kw))
    tmesh.reset_step_calls()
    TMETRICS.reset()
    port = tcds.CDSearchEngine(tcds.CDSParams(**p), device="cpu",
                               use_mesh=MESH, decode_concurrency=2, **kw)
    got = _tuples(port.find_all_matches(masks, targets, **find_kw))
    assert tmesh.step_calls[step] > 0, tmesh.step_calls
    assert got == want_single
    assert got == want
    assert len(got) >= 3, "the masks cut from targets must match"
    if case.startswith("packed"):
        assert TMETRICS.get("cds.rescore.count") > 0
    if case == "default_pct_1_emit_topk":
        assert TMETRICS.get("cds.emitSelect.count") > 0
    if "max_matches" in case:
        n = find_kw["max_matches_per_mask"]
        per_mask = {}
        for m in got:
            per_mask[m[0]] = per_mask.get(m[0], 0) + 1
        assert max(per_mask.values()) <= n


def test_streaming_iter_equals_batch_on_the_mesh(library, monkeypatch):
    """find_all_matches_iter chunks over several target tiles concatenate
    to the full match set; each tile's planes are cut over the mesh."""
    _lib, masks, targets = library
    monkeypatch.setenv("CDS_TARGET_TILE", "16")
    engine = tcds.CDSearchEngine(tcds.CDSParams(**PARAMS), device="cpu",
                                 use_mesh=MESH, decode_concurrency=2)
    tmesh.reset_step_calls()
    streamed = []
    chunks = 0
    for chunk in engine.find_all_matches_iter(masks, targets):
        streamed.extend(chunk)
        chunks += 1
    assert chunks >= 3
    calls = tmesh.step_calls["batch_union_keys"]
    assert calls >= 3
    full = engine.find_all_matches(masks, targets)
    assert _tuples(streamed) == _tuples(full) and full


def test_mesh_that_does_not_divide_runs_single_device(library):
    """T_pad 64 does not divide over 3 shards: every batch runs on the
    engine's device alone, with the same matches."""
    _lib, masks, targets = library
    tmesh.reset_step_calls()
    engine = tcds.CDSearchEngine(
        tcds.CDSParams(**PARAMS), device="cpu",
        use_mesh=tmesh.create_mesh(["cpu"] * 3), decode_concurrency=2)
    got = _tuples(engine.find_all_matches(masks[:2], targets))
    assert set(tmesh.step_calls.values()) == {0}
    single = tcds.CDSearchEngine(tcds.CDSParams(**PARAMS), device="cpu",
                                 decode_concurrency=2)
    assert got == _tuples(single.find_all_matches(masks[:2], targets))


@pytest.mark.parametrize("engine_kind", ["default", "packed", "packed_split"])
def test_negative_query_on_the_mesh(library, engine_kind, monkeypatch):
    """The negative pass scores the column shards (the split path keeps
    the summary planes for it), as the JAX mesh engine does."""
    lib, masks, targets = library
    kw = dict(neg_query_rgb=lib.masks[1], neg_query_threshold=20,
              mirror_neg_query=True)
    if engine_kind.startswith("packed"):
        kw["use_key_planes"] = False
    if engine_kind == "packed_split":
        _split_on(monkeypatch)
    jax_engine = jcds.CDSearchEngine(jcds.CDSParams(**PARAMS),
                                     decode_concurrency=2, **kw)
    want = _tuples(jax_engine.find_all_matches(
        [jax_neuron(m.to_json()) for m in masks],
        [jax_neuron(t.to_json()) for t in targets]))
    tmesh.reset_step_calls()
    port = tcds.CDSearchEngine(tcds.CDSParams(**PARAMS), device="cpu",
                               use_mesh=MESH, decode_concurrency=2, **kw)
    got = _tuples(port.find_all_matches(masks, targets))
    assert got == want and got
    neg_step = {"default": "batch_keys", "packed": "batch",
                "packed_split": "batch_split"}[engine_kind]
    assert tmesh.step_calls[neg_step] > 0, tmesh.step_calls


def _pixel(tmp_path, name, rgb):
    from colormipsearch_tpu_torch.model import ComputeFileType, Neuron

    img = np.zeros((8, 8, 3), np.uint8)
    img[0, 0] = rgb
    path = tmp_path / f"{name}.png"
    testing.write_png(path, img)
    n = Neuron(mip_id=name)
    n.set_compute_file(ComputeFileType.InputColorDepthImage, str(path))
    return n


def test_flagged_zero_score_pair_reaches_oracle(tmp_path):
    """rgb(50,0,53) vs rgb(151,0,158) at pixColorFluctuation 1.23: fast
    score 0, flagged, float64 score 1 (tests/test_engine_mesh.py). On the
    mesh's packed top-k step the flagged pair of target t0 falls outside
    its shard's top-1 (t1 scores 1 exactly), so the batch goes back to a
    dense pull; the mesh and single-device engines take different paths
    to the same matches, the JAX mesh engine's."""
    mask = _pixel(tmp_path, "m", (50, 0, 53))
    tgts = [_pixel(tmp_path, "t0", (151, 0, 158)),
            _pixel(tmp_path, "t1", (50, 0, 53))]
    params = dict(mask_threshold=0, data_threshold=0,
                  pix_color_fluctuation=1.23, xy_shift=0, mirror_mask=False)
    find = dict(max_matches_per_mask=1)
    results = {}
    for name, mesh in (("mesh", MESH), ("single", False)):
        TMETRICS.reset()
        tmesh.reset_step_calls()
        engine = tcds.CDSearchEngine(tcds.CDSParams(**params), device="cpu",
                                     use_mesh=mesh, use_key_planes=False)
        results[name] = _tuples(engine.find_all_matches([mask], tgts, **find))
        results[name + "_all"] = _tuples(engine.find_all_matches([mask],
                                                                 tgts))
        if name == "mesh":
            assert TMETRICS.get("cds.topkFlagDense.count") > 0
            assert tmesh.step_calls["batch"] >= 2
        assert TMETRICS.get("cds.rescore.count") > 0
    jax_engine = jcds.CDSearchEngine(jcds.CDSParams(**params),
                                     use_key_planes=False)
    jmask = jax_neuron(mask.to_json())
    jtgts = [jax_neuron(t.to_json()) for t in tgts]
    assert results["mesh"] == results["single"] == _tuples(
        jax_engine.find_all_matches([jmask], jtgts, **find))
    assert results["mesh_all"] == results["single_all"] == _tuples(
        jax_engine.find_all_matches([jmask], jtgts))
    assert [m[1:3] for m in results["mesh_all"]] == [("t0", 1), ("t1", 1)]


# --- gradScores ------------------------------------------------------------


@pytest.fixture(scope="module")
def shape_library(tmp_path_factory):
    """3 masks x 9 targets with gradient and z-gap variants, as PNGs."""
    tmp = tmp_path_factory.mktemp("mesh_shape")
    rng = np.random.default_rng(19)
    h, w = 48, 72
    lib = testing.synthetic_library(rng, 9, 3, h, w, target_fg=0.08,
                                    mask_fg=0.03)
    grads = [testing.synthetic_gradient(rng, t) for t in lib.targets]
    zgaps = [testing.synthetic_zgap(t, radius=4) for t in lib.targets]
    targets = testing.write_neuron_images(tmp / "t", lib.targets, "t",
                                          gradients=grads, zgaps=zgaps,
                                          threads=2)
    masks = testing.write_neuron_images(tmp / "m", lib.masks, "m",
                                        threads=2)
    return tmp, masks, targets


def _matches(masks, targets, cls=CDMatch, conv=lambda n: n):
    return [cls(mask_image=conv(m), matched_image=conv(t),
                matching_pixels=10 + (7 * i + 3 * j) % 13,
                matching_pixels_ratio=0.1)
            for i, m in enumerate(masks) for j, t in enumerate(targets)]


def _scores(matches):
    return sorted((m.mask_image.mip_id, m.matched_image.mip_id,
                   m.gradient_area_gap, m.high_expression_area,
                   m.normalized_score) for m in matches)


@pytest.mark.parametrize("mode", ["default", "device_store"])
def test_gradscore_mesh_equals_jax_and_single_device(shape_library,
                                                     tmp_path, monkeypatch,
                                                     mode):
    """The shape pass over the mesh (K5 a column shard, T padded to the
    mesh size) equals the JAX engine on its 8-device mesh and the port's
    single-device engine; with the device store its planes are built on
    the device and cut over the mesh."""
    tmp, masks, targets = shape_library
    params = dict(mask_threshold=20, data_threshold=20, mirror_mask=True,
                  negative_radius=4)
    store_kw = {}
    if mode == "device_store":
        store_kw = dict(pack_store=str(tmp_path / "store"))
        monkeypatch.setenv("CDS_SHAPE_STORE_DEVICE", "1")
    assert len(jax.devices()) == 8
    ref = jgs.GradScoreEngine(jcds.CDSParams(**params), decode_workers=2,
                              **store_kw)
    assert ref._mesh is not None
    want = ref.score_matches(_matches(masks, targets, JCDMatch,
                                      lambda n: jax_neuron(n.to_json())))
    results = {}
    for name, mesh in (("single", False), ("mesh", MESH)):
        for _ in range(2 if store_kw else 1):  # build, then read the store
            tmesh.reset_step_calls()
            engine = tgs.GradScoreEngine(tcds.CDSParams(**params),
                                         device="cpu", use_mesh=mesh,
                                         decode_workers=2, **store_kw)
            results[name] = _scores(engine.score_matches(
                _matches(masks, targets)))
        calls = tmesh.step_calls["shape_split"]
        assert (calls > 0) == (name == "mesh"), calls
    assert results["mesh"] == results["single"] == _scores(want)
    assert any(s[3] > 0 for s in results["mesh"])
