"""The comparison that decides ``correct``: the matches the timed path
emitted for the sampled masks against the reference's.

A call that ran to its end scored each mask against the shard once a
yield, so each of the reference's matches of a sampled mask is due
exactly ``yields`` times, with the reference's matching pixels and
mirrored flag, and nothing else is due. A call that the window's end
cut short owes only what it emitted: each of its matches must be one of
the reference's, and none more often than its yields.
"""

from __future__ import annotations

from collections import Counter

import numpy as np


def emitted(best: np.ndarray, mirrored: np.ndarray, query_size: int,
            pct_positive_pixels: float) -> dict:
    """column -> (matching pixels, mirrored) of every column that the
    search emits: a positive score whose share of the query passes
    pctPositivePixels (ColorMIPSearch.isMatch)."""
    out = {}
    for c in np.flatnonzero(best > 0):
        if best[c] / query_size > pct_positive_pixels / 100:
            out[int(c)] = (int(best[c]), bool(mirrored[c]))
    return out


def mismatches(calls: list, reference: dict) -> int:
    """How many due matches of the sampled masks were missing, wrong or
    extra. `calls`: (answers int64 [n, 4] of (mask, column, matching
    pixels, mirrored), yields, ran to its end); `reference`: mask ->
    column -> (matching pixels, mirrored)."""
    bad = 0
    for answers, yields, complete in calls:
        got = Counter((int(m), int(c), int(px), bool(mi))
                      for m, c, px, mi in answers if int(m) in reference)
        seen: Counter = Counter()
        for (m, c, px, mi), n in got.items():
            want = reference[m].get(c)
            if want != (px, mi):
                bad += n
            else:
                seen[(m, c)] += n
        for m, cols in reference.items():
            for c in cols:
                n = seen[(m, c)]
                bad += max(0, n - yields)
                if complete:
                    bad += max(0, yields - n)
    return bad
