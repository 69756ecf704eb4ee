"""Every seed gets the same work: exact counts, and only the planted
matches pass the emit line, with room to spare."""

import numpy as np
import pytest
import torch

from cdsbench import check, data as D, reference as R
from cdsbench.tests.tiny_cell import SEEDS, tiny_cell

# the largest chance score a mask reads against a column it was not cut
# from, as a share of its query, over the 12 seeds (0.383% when written)
CHANCE_MARGIN_PCT = 0.8


@pytest.fixture(scope="module")
def cells():
    _cell, config, traffic, _bench = tiny_cell()
    return config, traffic, [D.make_cell_data(s, config, traffic)
                             for s in SEEDS]


def test_counts_equal_for_every_seed(cells):
    config, traffic, datas = cells
    p = config["params"]
    h, w = config["image"]["height"], config["image"]["width"]
    excluded = D.label_regions(h, w, p["withNameLabelRegion"],
                               p["withColorScaleRegion"])
    lo, hi = config["mask_union_range"]
    for d in datas:
        assert d.columns == D.shard_columns(config)
        assert len(d.masks) == traffic["masks_per_call"]
        for base in d.bases:
            fg = (base > p["dataThreshold"]).any(axis=-1)
            assert fg.sum() == config["target_foreground_pixels"]
            assert (base[~fg] == 0).all()
        for mask, planted in zip(d.masks, d.planted):
            q = (mask > p["maskThreshold"]).any(axis=-1)
            assert q.sum() == config["mask_query_pixels"]
            assert not (q & excluded).any()
            assert len(set(planted.tolist())) == config["planted_per_shard"]
            flat = np.flatnonzero(q)
            assert lo <= D.shifted_union(flat, h, w) <= hi


def test_placements_keep_counts_and_stay_apart(cells):
    config, _traffic, datas = cells
    thr = config["params"]["dataThreshold"]
    d = datas[0]
    h = d.height
    for c in range(4):
        col = D.place(d.bases[d.col_base[c]], d.col_flip[c], d.col_roll[c])
        assert (col > thr).any(axis=-1).sum() == \
            config["target_foreground_pixels"]
    for b in range(len(d.bases)):
        ry = np.sort(d.col_roll[d.col_base == b, 0] % h)
        gaps = np.diff(np.concatenate([ry, ry[:1] + h]))
        assert gaps.min() >= D._ROLL_GAP


def test_only_planted_matches_pass_the_emit_line(cells):
    config, _traffic, datas = cells
    p = config["params"]
    worst = 0.0
    for d in datas:
        ref = R.Reference(d, p, torch.device("cpu"))
        for m, mask in enumerate(d.masks):
            q = ref.query(mask)
            best, mirrored = (x.numpy() for x in ref.score(q))
            got = check.emitted(best, mirrored, q.size,
                                p["pctPositivePixels"])
            assert sorted(got) == sorted(d.planted[m].tolist())
            # mirrored masks are found by a mirror variant
            assert all(mi == bool(m % 2) for _px, mi in got.values())
            chance = np.delete(best, d.planted[m]).max() / q.size * 100
            worst = max(worst, chance)
    # fewer than 256 columns pass, so no seed can need the dense fallback
    assert worst < CHANCE_MARGIN_PCT
