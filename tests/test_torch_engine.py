"""The port's CDSearchEngine (on the CPU: the kernels' plain versions)
against the JAX package's single-device engine: identical match tuples,
matchingPixelsRatio to the last bit.

Images are small (CDSParams excludes no label region by default); the
inputs are made with numpy from a seed and written as PNGs with the
port's writer.
"""

import numpy as np
import pytest
import torch

from colormipsearch_tpu.engine import cds as jcds
from colormipsearch_tpu.model import neuron_from_json as jax_neuron
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.engine import cds as tcds
from colormipsearch_tpu_torch.utils.metrics import GLOBAL as TMETRICS

torch.set_num_threads(2)


def _neurons(tmp_path, imgs, prefix):
    return testing.write_neuron_images(tmp_path / prefix, imgs, prefix,
                                       threads=2)


def _tuples(matches):
    return sorted((m.mask_image.mip_id, m.matched_image.mip_id,
                   m.matching_pixels, m.mirrored, m.matching_pixels_ratio)
                  for m in matches)


def _both(masks, targets, pct, **kw):
    """(port tuples, JAX tuples); the JAX engine reads the same neurons
    through the JAX package's model."""
    params = dict(mask_threshold=20, data_threshold=20,
                  pix_color_fluctuation=1.0, xy_shift=2, mirror_mask=True,
                  pct_positive_pixels=pct)
    port = tcds.CDSearchEngine(tcds.CDSParams(**params), device="cpu",
                               decode_concurrency=2)
    jax_engine = jcds.CDSearchEngine(jcds.CDSParams(**params),
                                     use_mesh=False, decode_concurrency=2)
    got = _tuples(port.find_all_matches(masks, targets, **kw))
    want = _tuples(jax_engine.find_all_matches(
        [jax_neuron(m.to_json()) for m in masks],
        [jax_neuron(t.to_json()) for t in targets], **kw))
    return got, want


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lib")
    rng = np.random.default_rng(31)
    lib = testing.synthetic_library(rng, 40, 6, 64, 96, target_fg=0.08,
                                    mask_fg=0.03)
    return (_neurons(tmp, lib.masks, "m"), _neurons(tmp, lib.targets, "t"))


@pytest.mark.parametrize("case", [
    "topk_emit",        # pct 1.0: K4 selection, no fallback
    "dense",            # pct 0: dense rows
    "topk_fallback",    # the k-th selected score could emit: dense pull
    "max_matches_2",    # --max-matches-per-mask 2
    "several_shards",   # CDS_TARGET_TILE 16: three target shards
])
def test_engine_matches_equal_jax(library, case, monkeypatch):
    masks, targets = library
    pct, kw = 1.0, {}
    # T_pad is 64 here; a top-k narrower than that takes the K4 path
    monkeypatch.setenv("CDS_EMIT_TOPK", "8")
    if case == "dense":
        pct = 0.0
    elif case == "topk_fallback":
        pct = 0.01
        monkeypatch.setenv("CDS_EMIT_TOPK", "2")
    elif case == "max_matches_2":
        pct, kw = 0.0, dict(max_matches_per_mask=2)
    elif case == "several_shards":
        monkeypatch.setenv("CDS_TARGET_TILE", "16")
    TMETRICS.reset()
    got, want = _both(masks, targets, pct, **kw)
    assert got == want
    assert got, "the synthetic masks cut from targets must match"
    if case == "topk_emit":
        assert TMETRICS.get("cds.emitSelect.count") > 0
        assert TMETRICS.get("cds.emitSelectFallback.count") == 0
    if case == "topk_fallback":
        assert TMETRICS.get("cds.emitSelectFallback.count") > 0
    if case == "max_matches_2":
        per_mask = {}
        for m in got:
            per_mask[m[0]] = per_mask.get(m[0], 0) + 1
        assert max(per_mask.values()) <= 2


def test_engine_large_query_takes_host_tables(tmp_path, monkeypatch):
    """A mask with >= 65,535 query pixels has no positional wire form:
    its batch stacks the host-built lane tables instead of running K2."""
    monkeypatch.setenv("CDS_EMIT_TOPK", "8")
    rng = np.random.default_rng(5)
    h, w = 260, 260
    big = rng.integers(21, 256, (h, w, 3)).astype(np.uint8)
    small = testing.scattered_pixels(rng, h, w, 2000)
    targets = [testing.scattered_pixels(rng, h, w, 3000) for _ in range(6)]
    targets += [big.copy(), small.copy()]
    masks = _neurons(tmp_path, [big, small], "m")
    tgts = _neurons(tmp_path, targets, "t")
    from colormipsearch_tpu_torch.ops import pixel_match as tpm

    plan = tpm.build_full_union_key_plan(
        big, 20, mirror=True, xy_shift=2, pix_color_fluctuation=1.0,
        light=True)
    assert plan.query_size >= 65535 and plan.q_pos is None
    got, want = _both(masks, tgts, 0.0)
    assert got == want
    assert ("m-00000", "t-00006") in {(g[0], g[1]) for g in got}


def test_engine_no_usable_masks(tmp_path):
    """Masks whose query is empty score nothing and emit nothing."""
    masks = _neurons(tmp_path, [np.zeros((20, 30, 3), np.uint8)], "m")
    targets = _neurons(tmp_path, [np.full((20, 30, 3), 200, np.uint8)],
                       "t")
    got, want = _both(masks, targets, 0.0)
    assert got == want == []
