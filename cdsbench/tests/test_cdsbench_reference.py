"""The frozen reference against the port's float64 oracle and against
the port's CPU path driven as the benchmark drives it."""

import numpy as np
import torch

from cdsbench import data as D, reference as R
from cdsbench.tests.tiny_cell import SEEDS, run_tiny, tiny_cell


def test_reference_equals_the_ports_oracle():
    from colormipsearch_tpu_torch.oracle.pixel import PixelMatchOracle

    _cell, config, traffic, _bench = tiny_cell()
    p = config["params"]
    d = D.make_cell_data(SEEDS[0], config, traffic)
    ref = R.Reference(d, p, torch.device("cpu"))
    region = D.label_regions(d.height, d.width)
    for mask in d.masks[:2]:
        best, mirrored = ref.score(ref.query(mask))
        oracle = PixelMatchOracle(
            mask, p["maskThreshold"], mirror=p["mirrorMask"],
            target_threshold=p["dataThreshold"],
            z_tolerance=p["pixColorFluctuation"] / 100,
            xy_shift=p["xyShift"], excluded_region=region)
        for c in range(0, d.columns, 3):
            res = oracle.score(D.place(d.bases[d.col_base[c]],
                                       d.col_flip[c], d.col_roll[c]))
            assert res.matching_pixels == int(best[c])
            assert res.mirrored == bool(mirrored[c])


def test_ports_cpu_path_is_correct_against_the_reference():
    # the warm call is a complete call, checked like the window's
    res = run_tiny(SEEDS[1], seconds=6.0)
    assert res["checks"]["mismatched_matches"]["value"] == 0
    assert res["correct"] is True
    work = res["work"]
    assert work["emitted_per_complete_call"] in ([], [
        work["planted_per_call"]])


def test_reference_codes_follow_the_class_rule():
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (4096, 3)).astype(np.uint8)
    rgb[:64] = rgb[:64] // 8  # some below the threshold
    codes = R.target_codes(torch.from_numpy(rgb), 20).numpy()
    cls, s, p = D.classify(rgb)
    fg = (rgb > 20).any(axis=1)
    np.testing.assert_array_equal(codes, np.where(
        fg, (cls << 16) | (s << 8) | p, 0))
