"""Query-spec value objects (reference datarequests/ + dao/NeuronSelector).

NeuronSelector   — dao/NeuronSelector.java (alignmentSpace, libraries,
                   names, mipIds, tags/excludedTags, datasets, annotations,
                   processedTags)
ScoresFilter     — datarequests/ScoresFilter.java:33 (field >= min list)
SortCriteria     — datarequests/SortCriteria.java
PagedRequest     — datarequests/PagedRequest.java
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class NeuronSelector:
    alignment_space: Optional[str] = None
    libraries: list = dataclasses.field(default_factory=list)
    names: list = dataclasses.field(default_factory=list)
    mip_ids: list = dataclasses.field(default_factory=list)
    source_refs: list = dataclasses.field(default_factory=list)
    tags: list = dataclasses.field(default_factory=list)
    excluded_tags: list = dataclasses.field(default_factory=list)
    datasets: list = dataclasses.field(default_factory=list)
    annotations: list = dataclasses.field(default_factory=list)
    excluded_annotations: list = dataclasses.field(default_factory=list)
    # list of (ProcessingType value, tag) pairs, OR-of-ANDs semantics
    processed_tags: list = dataclasses.field(default_factory=list)

    def is_empty(self) -> bool:
        return not any((self.alignment_space, self.libraries, self.names,
                        self.mip_ids, self.source_refs, self.tags,
                        self.excluded_tags, self.datasets,
                        self.annotations, self.excluded_annotations,
                        self.processed_tags))

    def to_filter(self) -> dict:
        """Translate to the document-store filter language
        (NeuronSelectionHelper.java:24-96)."""
        f: dict = {}
        if self.alignment_space:
            f["alignmentSpace"] = self.alignment_space
        if self.libraries:
            f["libraryName"] = {"$in": list(self.libraries)}
        if self.names:
            f["publishedName"] = {"$in": list(self.names)}
        if self.mip_ids:
            f["mipId"] = {"$in": list(self.mip_ids)}
        if self.source_refs:
            f["sourceRefId"] = {"$in": list(self.source_refs)}
        if self.tags:
            f["tags"] = {"$in": list(self.tags)}
        if self.excluded_tags:
            f["tags"] = {**f.get("tags", {}),
                         "$nin": list(self.excluded_tags)}
        if self.datasets:
            f["datasetLabels"] = {"$in": list(self.datasets)}
        if self.annotations:
            f["neuronTerms"] = {"$in": list(self.annotations)}
        if self.excluded_annotations:
            f["neuronTerms"] = {**f.get("neuronTerms", {}),
                                "$nin": list(self.excluded_annotations)}
        if self.processed_tags:
            f["$or"] = [
                {f"processedTags.{ptype}": {"$contains": tag}}
                for ptype, tag in self.processed_tags]
        return f


@dataclasses.dataclass
class DataSourceParam:
    """A scoped neuron data source (dataio/DataSourceParam.java:16-30):
    a NeuronSelector plus an offset/size window over the selection.
    The gradientScores/normalizeGradientScores mask sources are built
    one per ``--masks-libraries`` ListArg
    (cmd/CalculateGradientScoresCmd.java:137-151)."""
    selector: NeuronSelector = dataclasses.field(
        default_factory=NeuronSelector)
    offset: int = 0
    size: int = -1

    def window(self, items: list) -> list:
        items = items[self.offset:] if self.offset > 0 else items
        return items[:self.size] if self.size > 0 else items


@dataclasses.dataclass
class ScoresFilter:
    """List of (field, min value) selectors; empty matches everything."""
    selectors: list = dataclasses.field(default_factory=list)

    def add(self, field: str, min_value) -> "ScoresFilter":
        self.selectors.append((field, min_value))
        return self

    def to_filter(self) -> dict:
        return {field: {"$gte": mn} for field, mn in self.selectors}


@dataclasses.dataclass
class SortCriteria:
    field: str
    ascending: bool = True


@dataclasses.dataclass
class PagedRequest:
    offset: int = 0
    size: int = 0
    sort: list = dataclasses.field(default_factory=list)  # [SortCriteria]

    def sort_spec(self):
        return [(s.field, 1 if s.ascending else -1) for s in self.sort]
