"""The port's CDSearchEngine on its classic and x-union paths (on the CPU:
the kernels' plain versions) against the JAX package's single-device
engine: identical match tuples, matchingPixelsRatio to the last bit.

Every mask and some targets carry planted pixel pairs whose ratios are
exactly the z-tolerance apart (1/4 and 6/25 at 1%, as in
tests/test_ops_pixel_match.py:75-92): the banded kernel counts them as
matches and flags them, and the float64 oracle, which the engine then
consults, rejects them. So the packed path's rescore runs and changes
scores. Other targets carry pairs inside the band of the 0.37%
tolerance. The JAX engine reads CDS_KEY_PLANES, CDS_UNION_KEYS and
CDS_SPLIT_PLANES when it is imported; it is given the same choice as
keyword arguments, or its module flag is patched for the test, here.
"""

import numpy as np
import pytest
import torch

import colormipsearch_tpu as jax_lib
import colormipsearch_tpu_torch as torch_lib
from colormipsearch_tpu.engine import cds as jcds
from colormipsearch_tpu.model import neuron_from_json as jax_neuron
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.engine import cds as tcds
from colormipsearch_tpu_torch.ops import pixel_match as tpm
from colormipsearch_tpu_torch.oracle.pixel import PixelMatchOracle
from colormipsearch_tpu_torch.utils.metrics import GLOBAL as TMETRICS

torch.set_num_threads(2)
H, W = 64, 96
PARAMS = dict(mask_threshold=20, data_threshold=20, pix_color_fluctuation=1.0,
              xy_shift=2, mirror_mask=True)
BOUNDARY = [(9, 60), (40, 12), (55, 80)]  # (y, x) of the planted pairs


def _tuples(matches):
    return sorted((m.mask_image.mip_id, m.matched_image.mip_id,
                   m.matching_pixels, m.mirrored, m.matching_pixels_ratio)
                  for m in matches)


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("classic")
    rng = np.random.default_rng(33)
    lib = testing.synthetic_library(rng, 40, 6, H, W, target_fg=0.08,
                                    mask_fg=0.03)
    for img in lib.masks:
        for y, x in BOUNDARY:
            img[y, x] = (25, 0, 100)      # class BR, ratio 0.25
    for img in lib.targets[::3]:
        for y, x in BOUNDARY:
            img[y, x] = (24, 0, 100)      # class BR, ratio 0.24
    for img in lib.targets[1::3]:
        for y, x in BOUNDARY:
            # ratio 52/205: 0.003658 from 0.25, within the f32 band of
            # the 0.37% tolerance (banded same-class branch)
            img[y, x] = (52, 0, 205)
    masks = testing.write_neuron_images(tmp / "m", lib.masks, "m",
                                        threads=2)
    targets = testing.write_neuron_images(tmp / "t", lib.targets, "t",
                                          threads=2)
    return lib, masks, targets


def _both(library, port_kw, jax_kw, *, pct=0.0, params=None, **find_kw):
    _lib, masks, targets = library
    p = dict(PARAMS, pct_positive_pixels=pct, **(params or {}))
    port = tcds.CDSearchEngine(tcds.CDSParams(**p), device="cpu",
                               decode_concurrency=2, **port_kw)
    jax_engine = jcds.CDSearchEngine(jcds.CDSParams(**p), use_mesh=False,
                                     decode_concurrency=2, **jax_kw)
    got = _tuples(port.find_all_matches(masks, targets, **find_kw))
    want = _tuples(jax_engine.find_all_matches(
        [jax_neuron(m.to_json()) for m in masks],
        [jax_neuron(t.to_json()) for t in targets], **find_kw))
    return got, want, port


PACKED = dict(use_key_planes=False)


def _split_on(monkeypatch) -> dict:
    """CDS_SPLIT_PLANES=1 for both engines (the JAX engine's flag is read
    at its import, so it is patched); returns how often each scored a
    batch on split planes, {"port": n, "jax": n}."""
    monkeypatch.setenv("CDS_SPLIT_PLANES", "1")
    monkeypatch.setattr(jcds, "_USE_SPLIT", True)
    calls = {"port": 0, "jax": 0}
    # the port's split-plane kernel, and the JAX engine's split-pair
    # accessor, which its single-device and mesh paths both call per
    # batch
    for key, owner, attr in (
            ("port", tpm, "score_query_batch_split"),
            ("jax", jcds.CDSearchEngine, "_split_planes")):
        def counted(*a, _fn=getattr(owner, attr), _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(owner, attr, counted)
    return calls


@pytest.mark.parametrize("case", [
    "packed", "packed_max_matches_2", "packed_pct_1", "packed_037",
    "packed_several_shards", "key_planes", "x_union", "x_union_xy4",
    "env_union_0", "env_key_planes", "dense_upload", "split_default_path",
    "packed_split", "packed_split_037", "packed_split_several_shards",
])
def test_engine_paths_equal_jax(library, case, monkeypatch):
    port_kw, jax_kw, kw = {}, {}, {}
    split_calls = None
    if case.startswith("packed"):
        port_kw = jax_kw = PACKED
    if case.startswith("packed_split"):
        split_calls = _split_on(monkeypatch)
    if case == "packed_max_matches_2":
        kw = dict(max_matches_per_mask=2)
    elif case == "packed_pct_1":
        kw = dict(pct=1.0)
    elif case in ("packed_037", "packed_split_037"):
        kw = dict(params=dict(pix_color_fluctuation=0.37))
    elif case in ("packed_several_shards", "packed_split_several_shards"):
        monkeypatch.setenv("CDS_TARGET_TILE", "16")
    elif case == "key_planes":
        port_kw = jax_kw = dict(use_key_planes=True)
    elif case.startswith("x_union"):
        port_kw = jax_kw = dict(use_union_keys="x")
        if case == "x_union_xy4":
            kw = dict(params=dict(xy_shift=4))
    elif case == "env_union_0":
        monkeypatch.setenv("CDS_UNION_KEYS", "0")
        jax_kw = dict(use_union_keys=False)
    elif case == "env_key_planes":
        monkeypatch.setenv("CDS_UNION_KEYS", "0")
        monkeypatch.setenv("CDS_KEY_PLANES", "1")
        jax_kw = dict(use_key_planes=True)
    elif case == "dense_upload":
        monkeypatch.setenv("CDS_DENSE_UPLOAD", "1")
    elif case == "split_default_path":
        # the JAX engine uses the split planes only on the packed path
        monkeypatch.setenv("CDS_SPLIT_PLANES", "1")
    TMETRICS.reset()
    got, want, port = _both(library, port_kw, jax_kw, **kw)
    assert got == want
    assert len(got) >= 6, "the masks cut from targets must match"
    # CDS_UNION_KEYS=0 alone selects the packed kernel too
    packed = case.startswith("packed") or case == "env_union_0"
    assert port.use_key_planes != packed
    # the planted boundary pairs are flagged, and rescored, on the
    # packed path only
    assert (TMETRICS.get("cds.rescore.count") > 0) == packed
    if case == "x_union":
        assert port.use_union_keys == "x"
    if case in ("x_union_xy4", "env_key_planes", "key_planes"):
        assert port.use_union_keys is False
    if split_calls is not None:
        # both engines scored every batch on the split planes
        assert split_calls["port"] == split_calls["jax"] > 0
    if case == "packed_max_matches_2":
        per_mask = {}
        for m in got:
            per_mask[m[0]] = per_mask.get(m[0], 0) + 1
        assert max(per_mask.values()) <= 2


def _oracle_tuples(library, neg, mirror_neg, mask_ids):
    lib, masks, targets = library
    out = []
    for mi in mask_ids:
        o = PixelMatchOracle(lib.masks[mi], 20, mirror=True,
                             target_threshold=20, z_tolerance=0.01,
                             xy_shift=2, neg_query_rgb=neg,
                             neg_query_threshold=20,
                             mirror_neg_query=mirror_neg)
        for ti, t in enumerate(lib.targets):
            r = o.score(t)
            if r.matching_pixels > 0 and r.matching_pixels_ratio > 0:
                out.append((masks[mi].mip_id, targets[ti].mip_id,
                            r.matching_pixels, r.mirrored,
                            r.matching_pixels_ratio))
    return sorted(out)


@pytest.mark.parametrize("engine, mirror_neg", [
    ("default", True), ("default", False), ("packed", True),
    ("packed_split", True)])
def test_negative_query_equals_jax_and_oracle(library, engine, mirror_neg,
                                              monkeypatch):
    """The negative query on the full-union engine (its pass on K10), on
    the packed engine (its pass on K9, flags rescored) and on the packed
    engine with CDS_SPLIT_PLANES=1 (positive pass K11, negative pass K9):
    the JAX engine's matches, and the float64 oracle's for two masks."""
    lib, masks, _ = library
    neg = lib.masks[1]
    kw = dict(neg_query_rgb=neg, neg_query_threshold=20,
              mirror_neg_query=mirror_neg)
    split_calls = None
    if engine.startswith("packed"):
        kw.update(PACKED)
    if engine == "packed_split":
        split_calls = _split_on(monkeypatch)
    got, want, _ = _both(library, kw, kw)
    assert got == want and got
    if split_calls is not None:
        assert split_calls["port"] == split_calls["jax"] > 0
    two = {masks[0].mip_id, masks[2].mip_id}
    assert [g for g in got if g[0] in two] == \
        _oracle_tuples(library, neg, mirror_neg, [0, 2])


def test_library_color_depth_search_equals_jax(tmp_path):
    """color_depth_search over image directories with device="cpu", with
    and without a negative query image file, as the JAX package's."""
    rng = np.random.default_rng(12)
    lib = testing.synthetic_library(rng, 12, 3, 40, 56, target_fg=0.08,
                                    mask_fg=0.03)
    for name, imgs in (("masks", lib.masks), ("targets", lib.targets)):
        (tmp_path / name).mkdir()
        for i, img in enumerate(imgs):
            testing.write_png(tmp_path / name / f"{name[0]}{i:03d}.png", img)
    testing.write_png(tmp_path / "neg.png", lib.masks[1])
    params = dict(mask_threshold=20, data_threshold=20,
                  pix_color_fluctuation=1.0, xy_shift=2, mirror_mask=True)
    for neg in (None, tmp_path / "neg.png"):
        got = torch_lib.color_depth_search(
            [tmp_path / "masks"], [tmp_path / "targets"],
            torch_lib.CDSParams(**params), neg_query=neg, device="cpu")
        want = jax_lib.color_depth_search(
            [tmp_path / "masks"], [tmp_path / "targets"],
            jax_lib.CDSParams(**params), neg_query=neg)
        assert _tuples(got) == _tuples(want) and got
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_lib.color_depth_search([], [], device="cuda")
