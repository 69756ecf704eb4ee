"""Result grouping for the grouped match files.

Python analogue of results/MatchEntitiesGrouping.java with identical
ordering semantics (stable sorts, ties keep insertion order like Java's
stable Collections.sort).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from colormipsearch_tpu_torch.model import CDMatch, Neuron


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
