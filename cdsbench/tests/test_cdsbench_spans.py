"""The idle attribution's interval arithmetic on made-up intervals, the
per-layer numbers on made-up counters, and the tiny cell's run with the
program's spans recorded (on the CPU: the program's numbers, no device
numbers)."""

import time
from types import SimpleNamespace

import pytest

from cdsbench import spanrun, spans as S
from cdsbench.tests.test_cdsbench_imports import (
    HERE,
    PROGRAM,
    top_level_imports,
)
from cdsbench.tests.tiny_cell import SEEDS, tiny_cell


def _ev(ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "ts": ts, "dur": dur, "name": "k"}


def test_busy_intervals_merge_overlapping_streams():
    events = [_ev(10, 5), _ev(12, 10), _ev(30, 2), _ev(32, 3),
              _ev(0, 100, cat="cpu_op"), _ev(40, 0)]
    assert S.busy_intervals(events) == [(10, 22), (30, 35), (40, 40)]


@pytest.mark.parametrize("busy,lo,hi,want", [
    ([(10, 22), (30, 35)], 0, 50, [(0, 10), (22, 30), (35, 50)]),
    ([(10, 22), (30, 35)], 12, 32, [(22, 30)]),
    ([(0, 50)], 10, 20, []),
    ([], 5, 9, [(5, 9)]),
    ([(1, 2), (60, 70)], 10, 20, [(10, 20)]),
])
def test_idle_intervals_complement_the_busy_time(busy, lo, hi, want):
    assert S.idle_intervals(busy, lo, hi) == want


def test_innermost_names_the_latest_begun_open_interval():
    call = (0, 100, "cds.call")
    chunk = (10, 60, "cds.chunk")
    emit = (40, 55, "cds.emit")
    pull = (20, 30, "cds.pull")
    yielded = (60, 70, "cds.yielded")
    got = S.innermost([emit, call, yielded, chunk, pull])
    assert got == [(0, 10, "cds.call"), (10, 20, "cds.chunk"),
                   (20, 30, "cds.pull"), (30, 40, "cds.chunk"),
                   (40, 55, "cds.emit"), (55, 60, "cds.chunk"),
                   (60, 70, "cds.yielded"), (70, 100, "cds.call")]
    # on a tie of starts the shorter is the inner one; gaps are left out
    assert S.innermost([(0, 10, "a"), (0, 4, "b"), (20, 30, "c")]) == [
        (0, 4, "b"), (4, 10, "a"), (20, 30, "c")]


def test_attribute_cuts_idle_time_at_the_segments():
    segments = [(0, 10, "cds.call"), (10, 20, "cds.pull"),
                (20, 30, "cds.chunk"), (30, 40, "cds.emit"),
                (50, 60, "cds.yielded")]
    idle = [(5, 15), (18, 35), (45, 55), (70, 80)]
    assert S.attribute(idle, segments) == [
        (5, 10, "cds.call"), (10, 15, "cds.pull"), (18, 20, "cds.pull"),
        (20, 30, "cds.chunk"), (30, 35, "cds.emit"), (45, 50, S.OUTSIDE),
        (50, 55, "cds.yielded"), (70, 80, S.OUTSIDE)]


def test_idle_by_span_reads_the_spans_on_the_traces_clock():
    base = 1_700_000_000_000_000_000

    def span(name, a_us, b_us, thread=1):
        return SimpleNamespace(name=name, start_ns=base + a_us * 1000,
                               end_ns=base + b_us * 1000, thread=thread)

    spans = [span("cds.call", 0, 100), span("cds.chunk", 10, 80),
             span("cds.pull", 20, 60), span("cds.emit", 60, 80),
             span("cds.yielded", 80, 90),
             # another thread's span names nothing on the caller's
             span("cds.prep", 0, 100, thread=2)]
    events = [_ev(0, 30), _ev(50, 15), _ev(90, 5)]
    got, gaps = S.idle_by_span(spans, events, base, base,
                               base + 120 * 1000)
    want = {"cds.pull": 20, "cds.emit": 15, "cds.yielded": 10,
            "cds.call": 5, S.OUTSIDE: 20}
    assert got == pytest.approx({k: v / 1e6 for k, v in want.items()})
    assert gaps == [(pytest.approx(20e-6), S.OUTSIDE, "cds.call", None),
                    (pytest.approx(5e-6), "cds.call", "cds.yielded",
                     None)]


def test_numbers_of_made_up_counters():
    c = dict.fromkeys(S.COUNTERS, 0.0)
    c.update({"cds.prep.seconds": 6.4, "cds.masksPrepped.count": 64,
              "cds.prepWait.seconds": 0.3, "cds.pull.seconds": 12.0,
              "cds.chunks.count": 200, "cds.matchesEmitted.count": 25600,
              "cds.emitCandidates.count": 409600,
              "cds.planArgs.ready.count": 190})
    idle = {"cds.emit": 1.2, "cds.pull": 0.6, "cds.chunk": 0.15,
            S.OUTSIDE: 0.05}
    got = S.numbers(c, idle)
    assert got == pytest.approx({
        "cds.prep_busy_ms_per_mask": 100.0,
        "cds.prep_wait_ms_per_chunk": 1.5,
        "cds.pull_wait_ms_per_chunk": 60.0,
        "cds.emit_useful_pct": 6.25,
        "cds.plan_args_ready_pct": 95.0,
        "cds.idle_emit_ms_per_chunk": 6.0,
        "cds.idle_unnamed_pct": 10.0})
    # untraced, or a program without the counters: nothing to read
    assert set(S.numbers(c, None)) == set(got) - {
        "cds.idle_emit_ms_per_chunk", "cds.idle_unnamed_pct"}
    assert S.numbers(dict.fromkeys(S.COUNTERS, 0.0), None) == {}


def test_the_attribution_imports_nothing_of_the_program():
    assert PROGRAM not in top_level_imports(f"{HERE}/spans.py")


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_with_spans(trace):
    cell, config, traffic, bench = tiny_cell()
    res = spanrun.run_cell(cell, config, traffic, bench, seed=SEEDS[5],
                           seconds=4.0, trace=trace, device="cpu",
                           t_start=time.time())
    assert res["correct"] is True and list(res)[-1] == "checks"
    work = res["work"]
    assert work["spans"] > 0
    assert work["span_counters"]["cds.chunks.count"] >= work["chunks"] > 0
    numbers = {k: v["value"] for k, v in res["metrics"].items()} if trace \
        else work["span_numbers"]
    assert {"cds.prep_busy_ms_per_mask", "cds.prep_wait_ms_per_chunk",
            "cds.pull_wait_ms_per_chunk", "cds.emit_useful_pct",
            "cds.plan_args_ready_pct"} <= set(numbers)
    assert 0 < numbers["cds.emit_useful_pct"] <= 100
    # a CPU run gives no device number
    assert "cds.idle_unnamed_pct" not in numbers
    if trace:
        assert work["idle_by_span_s"] is None
        assert "cds.emit_ms_per_chunk" in res["metrics"]
