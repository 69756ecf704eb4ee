"""Stage timing, spans and throughput counters.

The reference logs elapsed-ms + JVM memory at every stage boundary
(e.g. cmd/ColorDepthSearchCmd.java:293-320,
LocalColorMIPSearchProcessor.java:71-83).  This module provides the same
per-stage wall/memory logging plus named counters, and spans: every
``Metrics.span`` adds its seconds to the counter ``<name>.seconds``, and
while ``record_spans`` is entered it also keeps the span (start, end,
thread, parent, call/chunk/batch/shard ids) in memory, on
``time.time_ns()``'s clock, which is the clock of ``torch.profiler``'s
Chrome trace (``ts`` in microseconds after ``baseTimeNanoseconds``).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import resource
import threading
import time
from typing import NamedTuple

LOG = logging.getLogger(__name__)


def _rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


class Span(NamedTuple):
    """One closed span. Times are ``time.time_ns()``; `thread` is the
    native id of the thread that ran it (the profiler's ``tid``);
    `parent` is the span open on that thread when it began (None at the
    thread's top); the ids not given to ``Metrics.span`` are the
    parent's, None where no span gave one."""
    name: str
    start_ns: int
    end_ns: int
    thread: int
    span_id: int
    parent: int | None
    call: int | None
    chunk: int | None
    batch: int | None
    shard: int | None


class _OpenSpan:
    """The context manager ``Metrics.span`` returns. After it exits,
    ``seconds`` is its duration."""
    __slots__ = ("_m", "name", "call", "chunk", "batch", "shard",
                 "start_ns", "seconds", "_sink", "_id", "_parent")

    def __init__(self, m: "Metrics", name: str, call, chunk, batch, shard):
        self._m = m
        self.name = name
        self.call, self.chunk, self.batch, self.shard = \
            call, chunk, batch, shard
        self.seconds = 0.0

    def __enter__(self) -> "_OpenSpan":
        m = self._m
        self._sink = m._spans
        if self._sink is not None:
            stack = m._stack()
            top = stack[-1] if stack else None
            self._id = next(m._ids)
            self._parent = None if top is None else top._id
            if top is not None:
                if self.call is None:
                    self.call = top.call
                if self.chunk is None:
                    self.chunk = top.chunk
                if self.batch is None:
                    self.batch = top.batch
                if self.shard is None:
                    self.shard = top.shard
            stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end_ns = time.time_ns()
        m = self._m
        self.seconds = (end_ns - self.start_ns) / 1e9
        m.add(f"{self.name}.seconds", self.seconds)
        if self._sink is not None:
            stack = m._stack()
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] is self:
                    del stack[i]
                    break
            if m._spans is self._sink:
                self._sink.append(Span(
                    self.name, self.start_ns, end_ns,
                    threading.get_native_id(), self._id, self._parent,
                    self.call, self.chunk, self.batch, self.shard))
        return False


class Metrics:
    """Thread-safe named counters and spans."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._spans: list | None = None  # the recording; None = off
        self._ids = itertools.count(1)
        self._local = threading.local()

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()

    def get(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def next_id(self) -> int:
        """A process-unique id (a call's, for its spans)."""
        return next(self._ids)

    def span(self, name: str, *, call: int | None = None,
             chunk: int | None = None, batch: int | None = None,
             shard: int | None = None) -> _OpenSpan:
        """A context manager that adds its seconds to ``<name>.seconds``
        and, while ``record_spans`` is entered, keeps it as a ``Span``."""
        return _OpenSpan(self, name, call, chunk, batch, shard)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


GLOBAL = Metrics()


@contextlib.contextmanager
def record_spans(metrics: Metrics | None = None):
    """Keep every span of `metrics` (GLOBAL by default) that begins and
    ends inside the block; yields the list, whole once the block exits.
    One recording at a time."""
    m = metrics or GLOBAL
    spans: list[Span] = []
    with m._lock:
        if m._spans is not None:
            raise RuntimeError("spans are being recorded already")
        m._spans = spans
    try:
        yield spans
    finally:
        with m._lock:
            m._spans = None


def to_chrome_events(spans, base_ns: int) -> list:
    """Spans as Chrome-trace complete (``X``) events in the profiler's
    units: ``ts`` and ``dur`` in microseconds, ``ts`` after `base_ns`
    (the trace's ``baseTimeNanoseconds``), one row (``tid``) per
    thread."""
    pid = os.getpid()
    out = []
    for s in spans:
        args = {"span": s.span_id}
        for k in ("parent", "call", "chunk", "batch", "shard"):
            v = getattr(s, k)
            if v is not None:
                args[k] = v
        out.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                    "tid": s.thread, "ts": (s.start_ns - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    return out


@contextlib.contextmanager
def stage_timer(stage: str, metrics: Metrics | None = None, **counts):
    """A span named `stage` that also logs its wall time + RSS,
    mirroring the reference's per-stage elapsed/memory log lines, and
    adds `counts` to their counters."""
    m = metrics or GLOBAL
    s = m.span(stage)
    try:
        with s:
            yield
    finally:
        for k, v in counts.items():
            m.add(k, v)
        LOG.info("%s finished in %.2fs - memory usage %.0fM",
                 stage, s.seconds, _rss_mb())


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None = None):
    """torch.profiler trace when a directory is configured: CPU
    activity, plus CUDA activity when a card is visible, and the
    program's spans (``record_spans``), written as one Chrome trace
    file.  It only records; the work runs where its caller put it."""
    trace_dir = trace_dir or os.environ.get("COLORMIPSEARCH_TPU_PROFILE_DIR")
    if not trace_dir:
        yield
        return
    import torch

    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with record_spans() as spans:
            yield
    path = os.path.join(trace_dir,
                        f"trace.{os.getpid()}.{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    if spans:
        with open(path) as f:
            trace = json.load(f)
        base = trace.get("baseTimeNanoseconds") \
            if isinstance(trace, dict) else None
        if base is not None:
            trace["traceEvents"].extend(to_chrome_events(spans, int(base)))
            with open(path, "w") as f:
                json.dump(trace, f)
        else:
            LOG.warning("profiler trace has no baseTimeNanoseconds; "
                        "%d spans left out", len(spans))
    LOG.info("wrote profiler trace to %s", path)
