"""The card's idle time in a traced window, named after the program's
spans, and the per-layer numbers that the spans and the engine's
counters give.

Each idle interval of the card (no kernel, copy or fill running) inside
the window is named after the innermost span open, at that instant, on
a thread that runs the engine's streaming calls (a thread with a
``cds.call`` span). Where that span is a call's or a chunk's own time,
or no span is open (``outside``), the interval is unnamed.

The spans' times are ``time.time_ns()``. A profiler Chrome trace gives
each event ``ts`` in microseconds after the trace's
``baseTimeNanoseconds``, on the same clock (tests/test_torch_spans.py
holds a span around a profiler marker on the CPU and around a kernel on
the card). Everything here is counted in those microseconds. This
module reads spans by their fields (``name``, ``start_ns``, ``end_ns``,
``thread``) and imports nothing of the program.
"""

from __future__ import annotations

import bisect
import heapq

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE = "outside"  # idle under no span of a calling thread
# the idle time that no leaf span names: a call's or a chunk's own time,
# or no span open
UNNAMED = ("cds.call", "cds.chunk", OUTSIDE)

# the engine's counters a run reports over its window: those ``numbers``
# reads, and those that show where the rest of a call's time went
COUNTERS = ("cds.prep.seconds", "cds.masksPrepped.count",
            "cds.prepWait.seconds", "cds.pull.seconds", "cds.chunks.count",
            "cds.matchesEmitted.count", "cds.emitCandidates.count",
            "cds.planArgs.ready.count", "cds.planArgs.joined.count",
            "cds.planArgs.built.count", "cds.launch.seconds",
            "cds.emit.seconds", "cds.yielded.seconds",
            "cds.shardWait.seconds", "cds.warmWait.seconds",
            "cds.call.seconds", "cds.scoreAllPairs.seconds")


def split_trace(trace: dict) -> tuple[list, int | None]:
    """(events, baseTimeNanoseconds or None) of a profiler's Chrome trace
    as ``json.load`` reads it."""
    base = trace.get("baseTimeNanoseconds")
    return trace.get("traceEvents", []), None if base is None else int(base)


def busy_intervals(events) -> list:
    """The device's busy time as sorted, disjoint [start, end) intervals
    (us): every kernel, copy and fill, overlapping streams merged."""
    raw = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                 for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    out: list = []
    for a, b in raw:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def idle_intervals(busy, lo: float, hi: float) -> list:
    """The complement of disjoint, sorted `busy` inside [lo, hi)."""
    out = []
    at = lo
    for a, b in busy:
        if b <= at:
            continue
        if a >= hi:
            break
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out


def innermost(intervals) -> list:
    """(start, end, name) segments: at each instant the innermost of the
    given (start, end, name) intervals that cover it, the one that began
    last (the shorter on a tie). Instants no interval covers are left
    out."""
    bounds = sorted({x for a, b, _ in intervals for x in (a, b)})
    starts = sorted(intervals, key=lambda s: s[0])
    heap: list = []
    out: list = []
    i = 0
    for p, q in zip(bounds, bounds[1:]):
        while i < len(starts) and starts[i][0] <= p:
            a, b, name = starts[i]
            heapq.heappush(heap, (-a, b, i, name))
            i += 1
        while heap and heap[0][1] <= p:
            heapq.heappop(heap)
        if not heap:
            continue
        name = heap[0][3]
        if out and out[-1][2] == name and out[-1][1] == p:
            out[-1] = (out[-1][0], q, name)
        else:
            out.append((p, q, name))
    return out


def attribute(idle, segments) -> list:
    """The idle intervals cut at the segments' bounds: (start, end, name)
    with the covering segment's name, or ``OUTSIDE``. Both lists sorted
    and disjoint."""
    out = []
    j = 0
    for a, b in idle:
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        at = a
        k = j
        while k < len(segments) and segments[k][0] < b:
            s, e, name = segments[k]
            if s > at:
                out.append((at, s, OUTSIDE))
            lo, hi = max(at, s), min(b, e)
            if hi > lo:
                out.append((lo, hi, name))
            at = max(at, hi)
            k += 1
        if at < b:
            out.append((at, b, OUTSIDE))
    return out


def idle_by_span(spans, events, base_ns: int, t0_ns: int,
                 t1_ns: int) -> tuple[dict, list]:
    """The device's idle time inside the window [t0_ns, t1_ns) by the
    name of the innermost span open on the engine's calling threads: a
    dict of seconds by name (``UNNAMED``'s names among them), and the
    ten longest unnamed pieces as (seconds, name, the segment before,
    the segment after)."""
    def us(ns):
        return (ns - base_ns) / 1e3

    callers = {s.thread for s in spans if s.name == "cds.call"}
    segments = innermost([(us(s.start_ns), us(s.end_ns), s.name)
                          for s in spans if s.thread in callers])
    idle = idle_intervals(busy_intervals(events), us(t0_ns), us(t1_ns))
    pieces = attribute(idle, segments)
    by_name: dict = {}
    for a, b, name in pieces:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    starts = [s for s, _e, _n in segments]
    gaps = []
    for a, b, name in sorted((p for p in pieces if p[2] in UNNAMED),
                             key=lambda p: p[0] - p[1])[:10]:
        i = bisect.bisect_right(starts, a)
        before = [n for s, e, n in segments[:i] if e <= a][-1:]
        after = segments[i][2] if i < len(segments) else None
        gaps.append(((b - a) / 1e6, name, before[0] if before else None,
                     after))
    return by_name, gaps


def numbers(counters: dict, idle_s: dict | None) -> dict:
    """The per-layer numbers of a window: `counters`, the window's deltas
    of ``COUNTERS``; `idle_s`, ``idle_by_span`` (None untraced). A number
    with nothing to read is left out."""
    c = counters
    out = {}
    chunks = c.get("cds.chunks.count", 0)
    if c.get("cds.masksPrepped.count"):
        out["cds.prep_busy_ms_per_mask"] = \
            c["cds.prep.seconds"] / c["cds.masksPrepped.count"] * 1e3
    if chunks:
        out["cds.prep_wait_ms_per_chunk"] = \
            c["cds.prepWait.seconds"] / chunks * 1e3
        out["cds.pull_wait_ms_per_chunk"] = \
            c["cds.pull.seconds"] / chunks * 1e3
        out["cds.plan_args_ready_pct"] = \
            c["cds.planArgs.ready.count"] / chunks * 100
    if c.get("cds.emitCandidates.count"):
        out["cds.emit_useful_pct"] = c["cds.matchesEmitted.count"] \
            / c["cds.emitCandidates.count"] * 100
    if idle_s:
        if chunks:
            out["cds.idle_emit_ms_per_chunk"] = \
                idle_s.get("cds.emit", 0.0) / chunks * 1e3
        total = sum(idle_s.values())
        if total > 0:
            out["cds.idle_unnamed_pct"] = sum(
                idle_s.get(k, 0.0) for k in UNNAMED) / total * 100
    return out
