"""The device's side of a traced window, from a ``torch.profiler``
Chrome trace: its busy time, its operations by name and its idle gaps.

Only the device's own events are read (kernels, copies, fills); their
intervals are merged, so overlapping streams count once. The names are
the kernels' ``__global__`` names, as the program declares them.
"""

from __future__ import annotations

import json
import os
import re
import tempfile

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def base_name(name: str) -> str:
    """A kernel's identifier without return type, namespaces, template
    and arguments (``void (anonymous namespace)::union_chunk_kernel<3>(int*)``
    -> ``union_chunk_kernel``); other events' names with their spaces
    and signs made ``_``."""
    head = re.sub(r"\(anonymous namespace\)::", "", name)
    head = re.sub(r"^void\s+", "", head)
    m = re.match(r"^([A-Za-z_][\w:]*)\s*[<(]", head)
    if m:
        return m.group(1).split("::")[-1]
    return re.sub(r"[^\w.-]+", "_", name).strip("_")


def device_events(prof) -> list:
    """(start_us, duration_us, name) of every device event of a finished
    profiler, in start order."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    out = [(float(e["ts"]), float(e.get("dur", 0.0)), base_name(e["name"]))
           for e in events
           if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    out.sort()
    return out


def summarise(events: list, window_s: float, top: int = 10) -> dict:
    """busy_s, the seconds and launches by operation, and the longest
    idle gaps, each named after the operation that ended it."""
    busy = 0.0
    gaps = []
    end = None
    for ts, dur, name in events:
        if end is None:
            busy += dur
            end = ts + dur
            continue
        if ts > end:
            gaps.append((f"host__then_{name}", (ts - end) / 1e6))
        busy += max(0.0, ts + dur - max(ts, end))
        end = max(end, ts + dur)
    by_name: dict = {}
    counts: dict = {}
    for _ts, dur, name in events:
        by_name[name] = by_name.get(name, 0.0) + dur / 1e6
        counts[name] = counts.get(name, 0) + 1
    span = (end - events[0][0]) / 1e6 if events else 0.0
    gaps.append(("host__outside_the_first_and_last_device_operation",
                 max(0.0, window_s - span)))
    return {
        "busy_s": busy / 1e6,
        "by_name": by_name,
        "counts": counts,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(gaps, key=lambda kv: -kv[1])[:top],
    }
