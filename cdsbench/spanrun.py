"""One run of one cell, as ``cdsbench.run`` makes it, with the program's
spans recorded around the window.

    python3 -m cdsbench.spanrun --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Set-up, window, reference and comparison are ``cdsbench.run``'s own,
and so is the result line. The one difference: the window runs inside
the program's ``record_spans()`` (``colormipsearch_tpu_torch.utils.
metrics``), inside the profiler's trace with ``--trace 1``. So untraced
runs of the two, taken in turns, give what recording costs, and a
traced run names the card's idle time after the spans
(``cdsbench/spans.py``). The result adds the per-layer numbers of
``spans.numbers`` (to ``metrics`` with ``--trace 1``, to
``work["span_numbers"]`` with ``--trace 0``), the engine's counters over
the window (``work["span_counters"]``) and, traced on a card, the idle
seconds by span (``work["idle_by_span_s"]``) with the longest unnamed
idle pieces (``work["unnamed_idle_gaps"]``: seconds, name, the span
before, the span after).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import shutil
import sys
import tempfile
import time

from cdsbench import run
from cdsbench import spans as S

_RUN_CELL = run.run_cell


class _Window:
    """The profiler's context with the spans recorded inside it, and the
    window's ends on the spans' clock."""

    def __init__(self, profiler, record_spans):
        self.profiler = profiler
        self.record_spans = record_spans
        self.spans: list = []
        self.t0_ns = self.t1_ns = 0
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        if self.profiler is not None:
            self._stack.enter_context(self.profiler)
        self.spans = self._stack.enter_context(self.record_spans())
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1_ns = time.time_ns()
        return self._stack.__exit__(*exc)


def run_cell(cell: dict, config: dict, traffic: dict, bench: dict, *,
             seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> dict:
    """``run.run_cell`` with the window inside ``record_spans()``."""
    from colormipsearch_tpu_torch.utils.metrics import record_spans

    seen: dict = {}
    drive_window = run.drive_window
    fd, saved_trace = tempfile.mkstemp(suffix=".json")
    os.close(fd)

    def drive(program, seconds, *, profiler=None, masks_per_call):
        window = _Window(profiler, record_spans)
        saved = run.COUNTERS
        run.COUNTERS = tuple(dict.fromkeys(saved + S.COUNTERS))
        try:
            if profiler is None:
                # the untraced loop as it is, with the spans recorded
                with window:
                    out = drive_window(program, seconds,
                                       masks_per_call=masks_per_call)
            else:
                out = drive_window(program, seconds, profiler=window,
                                   masks_per_call=masks_per_call)
        finally:
            run.COUNTERS = saved
        seen.update(window=window, counters=out[1])
        if profiler is not None and device == "cuda":
            # a profiler saves its trace once: keep it, and hand the
            # harness's reader (trace.device_events) the same file
            profiler.export_chrome_trace(saved_trace)
            with open(saved_trace) as f:
                seen["trace"] = json.load(f)
            profiler.export_chrome_trace = functools.partial(
                shutil.copyfile, saved_trace)
        return out

    run.drive_window = drive
    try:
        result = _RUN_CELL(cell, config, traffic, bench, seed=seed,
                           seconds=seconds, trace=trace, device=device,
                           t_start=t_start)
    finally:
        run.drive_window = drive_window
        os.remove(saved_trace)
    window = seen["window"]
    idle = gaps = None
    if "trace" in seen:
        events, base = S.split_trace(seen.pop("trace"))
        if base is not None:
            idle, gaps = S.idle_by_span(window.spans, events, base,
                                        window.t0_ns, window.t1_ns)
    numbers = S.numbers(seen["counters"], idle)
    work = result["work"]
    work["spans"] = len(window.spans)
    work["span_counters"] = {k: seen["counters"][k] for k in S.COUNTERS}
    if trace:
        result["metrics"].update(
            {k: {"value": v, "unit": "%" if k.endswith("_pct") else "ms"}
             for k, v in numbers.items()})
        work["idle_by_span_s"] = idle
        work["unnamed_idle_gaps"] = gaps
    else:
        work["span_numbers"] = numbers
    return result


def main(argv=None) -> int:
    run.run_cell = run_cell
    try:
        return run.main(argv)
    finally:
        run.run_cell = _RUN_CELL


if __name__ == "__main__":
    sys.exit(main())
