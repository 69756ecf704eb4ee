"""The result line's keys, in both kinds of run, and the metric files
that BENCHMARK.json names."""

import os

from cdsbench import run
from cdsbench.tests.tiny_cell import SEEDS, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_end_to_end_result_keys():
    res = run_tiny(SEEDS[2])
    assert all(k in res for k in KEYS)
    assert list(res)[-1] == "checks"
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    _cell, _config, _traffic, bench = run.load_cell("cds.em2lm.lib384k")
    assert set(res["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_result_keys():
    res = run_tiny(SEEDS[3], seconds=20.0, trace=True)
    assert all(k in res for k in KEYS)
    assert list(res)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # the spans' readers find their counters on any device
    assert {"cds.prep_ms_per_mask", "cds.emit_ms_per_chunk",
            "cds.plan_args_ms_per_chunk"} <= set(res["metrics"])


def test_every_named_file_exists():
    _cell, _config, _traffic, bench = run.load_cell("cds.em2lm.lib384k")
    here = os.path.dirname(run.__file__)
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(here, "metrics",
                                           f"{m['name']}.py"))
    for w in bench["workloads"]:
        run.load_cell(w["name"])
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(run.ROOT, c["file"]))
