"""Spans and counters of the port's streaming search (``utils/metrics.py``,
``engine/cds.py``) on the CPU, and the spans' clock against
``torch.profiler``'s Chrome trace: on the CPU here, and on the card in
the ``cuda``-marked test (``python -m pytest tests/test_torch_spans.py
-m cuda --noconftest`` on a machine with one)."""

import json
import logging
import os
import sys
import threading
import time
from collections import defaultdict

import numpy as np
import pytest
import torch

from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.engine import cds as tcds
from colormipsearch_tpu_torch.utils import metrics as tmetrics
from colormipsearch_tpu_torch.utils.metrics import GLOBAL

torch.set_num_threads(2)

CHUNK_CHILDREN = {"cds.planArgs", "cds.launch", "cds.pull", "cds.emit"}
CALL_CHILDREN = {"cds.prepWait", "cds.shardWait", "cds.chunk",
                 "cds.yielded", "cds.warmWait"}
COUNTERS = ("cds.chunks.count", "cds.masksPrepped.count",
            "cds.matchesEmitted.count", "cds.emitCandidates.count",
            "cds.planArgs.ready.count", "cds.planArgs.joined.count",
            "cds.planArgs.built.count", "cds.scoreAllPairs.seconds",
            "cds.yielded.seconds", "cds.call.seconds", "cds.emit.seconds")


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    """20 masks and 40 targets (three shards of 16)."""
    tmp = tmp_path_factory.mktemp("spans")
    rng = np.random.default_rng(57)
    lib = testing.synthetic_library(rng, 40, 20, 64, 96, target_fg=0.08,
                                    mask_fg=0.03)
    return (testing.write_neuron_images(tmp / "m", lib.masks, "m",
                                        threads=2),
            testing.write_neuron_images(tmp / "t", lib.targets, "t",
                                        threads=2))


def _engine(monkeypatch):
    monkeypatch.setenv("CDS_TARGET_TILE", "16")
    monkeypatch.setenv("CDS_EMIT_TOPK", "8")
    return tcds.CDSearchEngine(
        tcds.CDSParams(mask_threshold=20, data_threshold=20,
                       pix_color_fluctuation=1.0, xy_shift=2,
                       mirror_mask=True, pct_positive_pixels=1.0),
        device="cpu", decode_concurrency=2)


def _tuples(chunks):
    return sorted((m.mask_image.mip_id, m.matched_image.mip_id,
                   m.matching_pixels, m.mirrored, m.matching_pixels_ratio)
                  for c in chunks for m in c)


def _search(engine, library, pause_s=0.0):
    """Every chunk of one streaming call, the caller pausing `pause_s`
    at each yield; and the engine counters' deltas over the call."""
    before = {k: GLOBAL.get(k) for k in COUNTERS}
    chunks = []
    for c in engine.find_all_matches_iter(*library):
        chunks.append(c)
        time.sleep(pause_s)
    return chunks, {k: GLOBAL.get(k) - before[k] for k in COUNTERS}


def test_spans_off_keep_nothing_and_change_no_match(library, monkeypatch):
    engine = _engine(monkeypatch)
    off, counted = _search(engine, library)
    assert GLOBAL._spans is None
    assert not getattr(GLOBAL._local, "stack", [])
    with tmetrics.record_spans() as spans:
        on, _ = _search(engine, library)
    assert spans and GLOBAL._spans is None
    assert _tuples(on) == _tuples(off) and _tuples(off)
    # a span outside any recorder adds its seconds and keeps nothing
    m = tmetrics.Metrics()
    with m.span("unit.work", chunk=3):
        pass
    with tmetrics.record_spans(m) as kept:
        pass
    assert kept == [] and m.get("unit.work.seconds") >= 0
    assert counted["cds.chunks.count"] == len(off)


def test_children_take_their_parents_ids():
    m = tmetrics.Metrics()
    with tmetrics.record_spans(m) as spans:
        with m.span("a", call=7, batch=2):
            with m.span("b", chunk=5):
                pass
            with pytest.raises(RuntimeError):
                with tmetrics.record_spans(m):
                    pass
    b, a = spans
    assert (b.name, a.name) == ("b", "a")
    assert (b.parent, b.call, b.batch, b.chunk) == (a.span_id, 7, 2, 5)
    assert a.parent is None and a.thread == b.thread
    assert a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns


def test_threads_record_every_span_with_their_own_parents():
    m = tmetrics.Metrics()
    n_threads, n_spans = 16, 300

    def work(t):
        for i in range(n_spans):
            with m.span("outer", call=t):
                with m.span("inner", chunk=i):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tmetrics.record_spans(m) as spans:
            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(spans) == 2 * n_threads * n_spans
    assert len({s.span_id for s in spans}) == len(spans)
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        if s.name == "inner":
            p = by_id[s.parent]
            assert p.name == "outer" and p.thread == s.thread
            assert s.call == p.call
        else:
            assert s.parent is None
    assert m.get("inner.seconds") >= 0


def test_stage_timer_is_a_span_with_its_log_line(caplog):
    m = tmetrics.Metrics()
    with caplog.at_level(logging.INFO), tmetrics.record_spans(m) as spans:
        with tmetrics.stage_timer("unit.stage", m, itemsDone=3):
            pass
    assert [s.name for s in spans] == ["unit.stage"]
    assert m.get("itemsDone") == 3
    assert m.get("unit.stage.seconds") == pytest.approx(
        (spans[0].end_ns - spans[0].start_ns) / 1e9)
    assert any("unit.stage finished" in r.message for r in caplog.records)


def test_each_call_is_tiled_by_its_spans(library, monkeypatch):
    engine = _engine(monkeypatch)
    with tmetrics.record_spans() as spans:
        for _ in range(2):
            _search(engine, library)
    calls = [s for s in spans if s.name == "cds.call"]
    assert len(calls) == 2 and len({c.call for c in calls}) == 2
    by_id = {s.span_id: s for s in spans}
    children = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            children[s.parent].append(s)
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
            assert s.thread == p.thread and s.call == p.call
    for call in calls:
        mine = [s for s in spans
                if s.thread == call.thread and s.call == call.call]
        for s in mine:
            if s.name == "cds.call":
                continue
            if s.name == "cds.chunk":
                assert {c.name for c in children[s.span_id]} \
                    <= CHUNK_CHILDREN
                assert {c.chunk for c in children[s.span_id]} == {s.chunk}
                assert by_id[s.parent] is call
            elif s.name not in CHUNK_CHILDREN:
                assert s.name in CALL_CHILDREN
                assert by_id[s.parent] is call
            assert not children[s.span_id] or s.name == "cds.chunk"
        leaves = sorted((s for s in mine if not children[s.span_id]),
                        key=lambda s: s.start_ns)
        for x, y in zip(leaves, leaves[1:]):
            assert x.end_ns <= y.start_ns
        covered = sum(s.end_ns - s.start_ns for s in leaves)
        for s in mine:
            if children[s.span_id]:
                covered += (s.end_ns - s.start_ns) - sum(
                    c.end_ns - c.start_ns for c in children[s.span_id])
        assert covered == call.end_ns - call.start_ns
        chunks = [s for s in mine if s.name == "cds.chunk"]
        assert sorted(c.chunk for c in chunks) == list(range(len(chunks)))
        # every batch against shard 0 (phase 1) and both further shards
        batches = {c.batch for c in chunks}
        assert len(chunks) == 3 * len(batches)
        assert {(c.batch, c.shard) for c in chunks} == {
            (b, y) for b in batches for y in range(3)}
        preps = [s for s in spans
                 if s.name == "cds.prep" and s.call == call.call]
        assert len(preps) == 20
        assert all(s.thread != call.thread for s in preps)


def test_counters_agree_with_the_run(library, monkeypatch):
    engine = _engine(monkeypatch)
    pause = 0.05
    t0 = time.time()
    chunks, c = _search(engine, library, pause_s=pause)
    wall = time.time() - t0
    n = len(chunks)
    assert n % 3 == 0 and c["cds.chunks.count"] == n
    assert c["cds.masksPrepped.count"] == 20
    assert c["cds.matchesEmitted.count"] == sum(len(x) for x in chunks) > 0
    # each mask walks its k = 8 top-k candidates a chunk
    assert c["cds.emitCandidates.count"] == 8 * 20 * 3
    assert sum(c[f"cds.planArgs.{k}.count"]
               for k in ("ready", "joined", "built")) == n
    # the caller's pauses are the yields' time, and not the engine's
    assert c["cds.yielded.seconds"] >= n * pause
    assert c["cds.call.seconds"] <= wall
    assert c["cds.scoreAllPairs.seconds"] == pytest.approx(
        c["cds.call.seconds"] - c["cds.yielded.seconds"], abs=1e-6)
    assert c["cds.scoreAllPairs.seconds"] <= wall - n * pause


def test_closing_early_ends_every_span(library, monkeypatch):
    engine = _engine(monkeypatch)
    with tmetrics.record_spans() as spans:
        gen = engine.find_all_matches_iter(*library)
        next(gen)
        gen.close()
    names = [s.name for s in spans]
    assert names.count("cds.call") == 1 and names[-1] == "cds.call"
    assert names.count("cds.yielded") == 1
    assert not getattr(GLOBAL._local, "stack", [])


def _trace(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())


def test_a_span_contains_its_profiler_marker(tmp_path):
    m = tmetrics.Metrics()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tmetrics.record_spans(m) as spans:
            with m.span("unit.outer"):
                with torch.profiler.record_function("unit.marker"):
                    torch.ones(64).sum()
    trace = _trace(prof, tmp_path)
    base = int(trace["baseTimeNanoseconds"])
    (mark,) = [e for e in trace["traceEvents"]
               if e.get("name") == "unit.marker"]
    (ev,) = tmetrics.to_chrome_events(spans, base)
    assert ev["tid"] == mark["tid"] and ev["pid"] == mark["pid"] \
        == os.getpid()
    assert ev["ts"] <= mark["ts"]
    assert mark["ts"] + mark["dur"] <= ev["ts"] + ev["dur"]


def test_maybe_profile_merges_the_spans(tmp_path, monkeypatch):
    monkeypatch.delenv("COLORMIPSEARCH_TPU_PROFILE_DIR", raising=False)
    with tmetrics.maybe_profile(str(tmp_path)):
        with GLOBAL.span("unit.profiled", call=3):
            torch.ones(8).add_(1)
    (path,) = tmp_path.glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    (ev,) = [e for e in events if e.get("name") == "unit.profiled"]
    assert ev["ph"] == "X" and ev["cat"] == "span"
    assert ev["args"]["call"] == 3 and ev["dur"] >= 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the clock of CUPTI's kernel "
                    "timestamps is the card's (the CPU's is tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_span_contains_its_kernel_on_the_card(cuda_device, tmp_path):
    m = tmetrics.Metrics()
    x = torch.ones(1 << 24, device=cuda_device)
    x.mul_(3)  # warm: the launch path and the allocator
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with tmetrics.record_spans(m) as spans:
            with m.span("unit.launch"):
                x.mul_(2)
                torch.cuda.synchronize()
    trace = _trace(prof, tmp_path)
    base = int(trace["baseTimeNanoseconds"])
    kernels = [e for e in trace["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
    assert len(kernels) == 1, [e.get("name") for e in kernels]
    (k,) = kernels
    (ev,) = tmetrics.to_chrome_events(spans, base)
    print(f"span {ev['ts']:.3f} +{ev['dur']:.3f} us; kernel "
          f"{k['ts']:.3f} +{k['dur']:.3f} us: starts "
          f"{k['ts'] - ev['ts']:.3f} us into the span, ends "
          f"{ev['ts'] + ev['dur'] - k['ts'] - k['dur']:.3f} us before "
          "its end")
    assert ev["ts"] <= k["ts"]
    assert k["ts"] + k["dur"] <= ev["ts"] + ev["dur"]
    assert float(x[0]) == 6.0
