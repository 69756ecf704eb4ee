"""Result grouping, partitioning, and top-k selection.

Python analogue of results/MatchEntitiesGrouping.java,
results/ItemsHandling.java:73-111 and
cmd/cdsprocess/ColorMIPProcessUtils.java:14-35 with identical
ordering/limit semantics (stable sorts, ties keep insertion order like
Java's stable Collections.sort).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence, TypeVar

from colormipsearch_tpu_torch.model import CDMatch, Neuron

T = TypeVar("T")


def partition_collection(items: Iterable[T], partition_size: int) -> list[list[T]]:
    """Split into consecutive chunks (ItemsHandling.partitionCollection:73-79)."""
    size = partition_size if partition_size > 0 else 1
    out: list[list[T]] = []
    chunk: list[T] = []
    for it in items:
        chunk.append(it)
        if len(chunk) == size:
            out.append(chunk)
            chunk = []
    if chunk:
        out.append(chunk)
    return out


@dataclasses.dataclass
class ScoredEntry:
    name: str
    score: float
    entry: list


def select_top_ranked(items: Sequence[T],
                      grouping: Callable[[T], str],
                      score: Callable[[T], float],
                      top_results: int,
                      limit_sub_results: int) -> list[ScoredEntry]:
    """ItemsHandling.selectTopRankedElements:82-111.

    Group by `grouping` (blank -> "UNKNOWN"), sort each group desc by
    score keeping at most `limit_sub_results`, rank groups by their max
    score desc, and keep the best `top_results` groups.  Both limits are
    ignored when <= 0.
    """
    groups: dict[str, list[T]] = {}
    for it in items:
        key = grouping(it)
        # defaultIfBlank: whitespace-only keys also map to UNKNOWN
        key = key if key and key.strip() else "UNKNOWN"
        groups.setdefault(key, []).append(it)
    entries = []
    for key, vals in groups.items():
        vals = sorted(vals, key=lambda v: -float(score(v)))  # stable
        if 0 < limit_sub_results < len(vals):
            vals = vals[:limit_sub_results]
        entries.append(ScoredEntry(key, float(score(vals[0])), vals))
    entries.sort(key=lambda e: -e.score)
    if 0 < top_results < len(entries):
        entries = entries[:top_results]
    return entries


def select_best_matches(matches: Sequence[CDMatch],
                        top_line_matches: int,
                        top_samples_per_line: int,
                        top_matches_per_sample: int) -> list[CDMatch]:
    """Top lines -> top samples/line -> top matches/sample
    (ColorMIPProcessUtils.selectBestMatches:14-35)."""
    top_lines = select_top_ranked(
        matches,
        lambda m: (m.matched_image.published_name or "")
        if m.matched_image else "",
        lambda m: m.matching_pixels or 0,
        top_line_matches, -1)
    out: list[CDMatch] = []
    for se in top_lines:
        for sub in select_top_ranked(
                se.entry,
                lambda m: (m.matched_image.neuron_id or "")
                if m.matched_image else "",
                lambda m: m.matching_pixels or 0,
                top_samples_per_line, top_matches_per_sample):
            out.extend(sub.entry)
    return out


def _neuron_group_key(n: Neuron | None) -> str:
    if n is None:
        return ""
    return n.mip_id or ""


def group_by_mask(matches: Sequence[CDMatch],
                  grouping: Callable[[Neuron], str] | None = None,
                  ordering: Callable[[CDMatch], tuple] | None = None
                  ) -> list[tuple[Neuron, list[CDMatch]]]:
    """Group matches per mask neuron; matches inside a group lose their
    duplicated maskImage (MatchEntitiesGrouping.groupByMaskFields:56-98).

    Returns (mask neuron, sorted matches) pairs.
    """
    key = grouping or (lambda n: _neuron_group_key(n))
    groups: dict[str, tuple[Neuron, list[CDMatch]]] = {}
    for m in matches:
        if m.matched_image is None or m.mask_image is None:
            continue
        k = key(m.mask_image)
        groups.setdefault(k, (m.mask_image, []))[1].append(m)
    out = []
    for mask, ms in groups.values():
        if ordering is not None:
            ms = sorted(ms, key=ordering)
        out.append((mask, ms))
    return out


def group_by_target(matches: Sequence[CDMatch],
                    grouping: Callable[[Neuron], str] | None = None,
                    ordering: Callable[[CDMatch], tuple] | None = None
                    ) -> list[tuple[Neuron, list[CDMatch]]]:
    """Group matches per matched (target) neuron, inverting mask/target so
    each group's results embed the mask image as `image`
    (MatchEntitiesGrouping.groupByTargetFields:113+).
    """
    inverted = []
    for m in matches:
        if m.matched_image is None or m.mask_image is None:
            continue
        inv = dataclasses.replace(
            m, mask_image=m.matched_image, matched_image=m.mask_image,
            mask_image_ref_id=m.matched_image_ref_id,
            matched_image_ref_id=m.mask_image_ref_id)
        inverted.append(inv)
    return group_by_mask(inverted, grouping, ordering)


def sort_matches_desc(matches: Sequence[CDMatch]) -> list[CDMatch]:
    """Default result ordering: normalizedScore desc then matchingPixels
    desc (reference writers sort by the match ordering comparator)."""
    return sorted(matches, key=lambda m: (
        -(m.normalized_score if m.normalized_score is not None else 0.0),
        -(m.matching_pixels or 0)))
