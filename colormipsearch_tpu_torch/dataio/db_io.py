"""DB-backed readers/writers over the persist DAOs.

The DB twins of the fs JSON readers/writers (reference dataio/db/*):
DBCDMIPsReader/Writer, DBNeuronMatchesReader/Writer, DBCDScoresOnlyWriter.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from colormipsearch_tpu_torch.model import CDMatch, Neuron, ProcessingType
from colormipsearch_tpu_torch.persist import DaosProvider
from colormipsearch_tpu_torch.persist.requests import (
    DataSourceParam,
    NeuronSelector,
    PagedRequest,
    ScoresFilter,
    SortCriteria,
)


class DBCDMIPsReader:
    def __init__(self, daos: DaosProvider):
        self._dao = daos.neuron_metadata_dao

    def read_mips(self, libraries: Sequence[str], *,
                  alignment_space=None, tags=(), names=(),
                  offset: int = 0, size: int = -1) -> list[Neuron]:
        sel = NeuronSelector(alignment_space=alignment_space,
                             libraries=list(libraries),
                             tags=list(tags), names=list(names))
        page = PagedRequest(offset=offset, size=max(size, 0))
        return self._dao.find_neurons(sel, page)


class DBCDMIPsWriter:
    def __init__(self, daos: DaosProvider):
        self._dao = daos.neuron_metadata_dao

    def write(self, neurons: Sequence[Neuron]) -> int:
        for n in neurons:
            self._dao.create_or_update(n)
        return len(neurons)

    def add_processing_tags(self, neurons, ptype: ProcessingType,
                            tags) -> int:
        return self._dao.add_processing_tags(neurons, ptype, tags)


class DBNeuronMatchesWriter:
    def __init__(self, daos: DaosProvider):
        self._dao = daos.cd_matches_dao

    def write(self, matches: Sequence[CDMatch]) -> int:
        return self._dao.create_or_update_all(matches)

    def write_updates(self, matches: Sequence[CDMatch],
                      _field_selectors=None) -> int:
        return self._dao.update_scores(matches)


class DBNeuronMatchesReader:
    def __init__(self, daos: DaosProvider):
        self._daos = daos
        self._dao = daos.cd_matches_dao

    def list_matches_locations(self, mask_sources,
                               tags=()) -> list[str]:
        """DB 'locations' are the distinct mask mip ids selected by the
        mask DataSources (DBNeuronMatchesReader.listMatchesLocations:40-61:
        distinct neuron ``mipId`` values per source, with the source's
        offset/size window). Accepts plain library-name strings for
        backward compatibility."""
        out, seen = [], set()
        for src in mask_sources:
            if isinstance(src, str):
                src = DataSourceParam(
                    selector=NeuronSelector(libraries=[src],
                                            tags=list(tags)))
            mip_ids, sub_seen = [], set()
            for n in self._daos.neuron_metadata_dao.find_neurons(
                    src.selector):
                if n.mip_id and n.mip_id not in sub_seen:
                    sub_seen.add(n.mip_id)
                    mip_ids.append(n.mip_id)
            for mid in src.window(mip_ids):
                if mid not in seen:
                    seen.add(mid)
                    out.append(mid)
        return out

    def read_matches_by_mask(self, mask_mip_id: str, *,
                             min_ratio: float = 0.0,
                             alignment_space: str | None = None,
                             mask_selector: NeuronSelector | None = None,
                             target_selector: NeuronSelector | None = None,
                             match_tags: Sequence[str] = (),
                             min_grad_score=None) -> list[CDMatch]:
        """Read one mask's matches with the reference's selection scope
        (DBNeuronMatchesReader.readMatchesByMask:71-...; called from
        CalculateGradientScoresCmd.getCDMatchesForMask:344-383)."""
        sel = mask_selector or NeuronSelector()
        sel = dataclasses.replace(
            sel, mip_ids=[mask_mip_id],
            alignment_space=alignment_space or sel.alignment_space)
        scores = ScoresFilter()
        if min_ratio > 0:
            scores.add("matchingPixelsRatio", min_ratio)
        if min_grad_score is not None:
            scores.add("gradientAreaGap", min_grad_score)
        page = PagedRequest(sort=[SortCriteria("normalizedScore",
                                               ascending=False)])
        return self._dao.find_matches_by_mask(
            sel, target_selector=target_selector, scores_filter=scores,
            page=page, match_tags=match_tags)
