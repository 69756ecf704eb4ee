"""A cell small enough for the CPU: the em2lm configuration at a
384 x 768 image, 32 target columns and 8 masks a call."""

from __future__ import annotations

import copy
import time

from cdsbench import run

SEEDS = [2 ** 31 + 11 * k for k in range(1, 13)]


def tiny_cell(name: str = "cds.em2lm.lib384k"):
    cell, config, traffic, bench = run.load_cell(name)
    config = copy.deepcopy(config)
    config.update(image={"height": 384, "width": 768},
                  target_foreground_pixels=5898, mask_query_pixels=6000,
                  planted_per_shard=8, distinct_targets=32,
                  mask_union_range=[14848, 16320],
                  engine_settings={"CDS_TARGET_TILE": 32})
    traffic = dict(traffic, masks_per_call=8, shard_yields=2,
                   warm_yields=1, check_masks=4)
    return cell, config, traffic, bench


def run_tiny(seed: int, *, seconds: float = 4.0, trace: bool = False,
             name: str = "cds.em2lm.lib384k", device: str = "cpu"):
    cell, config, traffic, bench = tiny_cell(name)
    return run.run_cell(cell, config, traffic, bench, seed=seed,
                        seconds=seconds, trace=trace, device=device,
                        t_start=time.time())
