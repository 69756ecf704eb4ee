"""Stage timing and throughput counters.

The reference logs elapsed-ms + JVM memory at every stage boundary
(e.g. cmd/ColorDepthSearchCmd.java:293-320,
LocalColorMIPSearchProcessor.java:71-83).  This module provides the same
per-stage wall/memory logging plus throughput counters
(comparisons/sec).
"""

from __future__ import annotations

import contextlib
import logging
import resource
import threading
import time

LOG = logging.getLogger(__name__)


def _rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


class Metrics:
    """Thread-safe named counters + rate reporting."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._t0 = time.time()

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._t0 = time.time()

    def get(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._counters)
        elapsed = time.time() - self._t0
        out["elapsedSec"] = round(elapsed, 3)
        if "pairsScored" in out and elapsed > 0:
            out["pairsPerSec"] = round(out["pairsScored"] / elapsed, 1)
        return out

    def log(self, prefix: str = "metrics") -> None:
        LOG.info("%s: %s (rss %.0fM)", prefix, self.snapshot(), _rss_mb())


GLOBAL = Metrics()


@contextlib.contextmanager
def stage_timer(stage: str, metrics: Metrics | None = None, **counts):
    """Log a stage's wall time + RSS, mirroring the reference's
    per-stage elapsed/memory log lines."""
    t0 = time.time()
    try:
        yield
    finally:
        dt = time.time() - t0
        m = metrics or GLOBAL
        m.add(f"{stage}.seconds", dt)
        for k, v in counts.items():
            m.add(k, v)
        LOG.info("%s finished in %.2fs - memory usage %.0fM",
                 stage, dt, _rss_mb())
