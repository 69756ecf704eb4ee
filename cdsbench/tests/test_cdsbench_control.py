"""The control, the reference one precision lower in the program's
place, comes out not correct; the program does not."""

import torch

from cdsbench import limits
from cdsbench.tests.tiny_cell import SEEDS, tiny_cell


def test_float32_control_fails_on_three_seeds():
    _cell, config, traffic, _bench = tiny_cell()
    for seed in SEEDS[:3]:
        out = limits.control_reading(config, traffic, seed,
                                     torch.device("cpu"), torch.float32)
        assert out["mismatched_matches"] > 0, out
