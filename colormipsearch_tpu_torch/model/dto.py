"""Publish-facing metadata (NeuronBridge export JSON shape).

Mirror of the reference dto package (dto/AbstractNeuronMetadata.java:35-59,
EMNeuronMetadata.java, LMNeuronMetadata.java, AbstractMatchedTarget.java:22-29,
CDMatchedTarget.java, PPPMatchedTarget.java, ResultMatches.java) including
the "type" discriminators (EMImage/LMImage, CDSMatch/PPPMatch) and the
entity->dto mapping of EMNeuronEntity.metadata()/LMNeuronEntity.metadata().
"""

from __future__ import annotations

import dataclasses
import re as _re
from typing import Optional

from colormipsearch_tpu_torch.model.entities import (
    CDMatch,
    EMNeuron,
    LMNeuron,
    Neuron,
    PPPMatch,
)


def _clean(d: dict) -> dict:
    return {k: v for k, v in d.items()
            if v is not None and v != {} and v != []}


@dataclasses.dataclass
class NeuronMetadata:
    """dto/AbstractNeuronMetadata (publish shape of a neuron)."""
    type: str = ""
    internal_id: Optional[int] = None
    mip_id: Optional[str] = None
    library_name: Optional[str] = None
    published_name: Optional[str] = None
    full_published_name: Optional[str] = None
    alignment_space: Optional[str] = None
    anatomical_area: Optional[str] = None
    gender: Optional[str] = None
    annotations: Optional[list] = None
    files: dict = dataclasses.field(default_factory=dict)
    # EM-only
    em_ref_id: Optional[str] = None
    neuron_type: Optional[str] = None
    neuron_instance: Optional[str] = None
    state: Optional[str] = None
    # LM-only
    slide_code: Optional[str] = None
    objective: Optional[str] = None
    mounting_protocol: Optional[str] = None
    channel: Optional[int] = None

    def to_json(self) -> dict:
        out = {"type": self.type}
        out.update(_clean({
            "id": self.mip_id,
            "libraryName": self.library_name,
            "publishedName": self.published_name,
            "fullPublishedName": self.full_published_name,
            "alignmentSpace": self.alignment_space,
            "anatomicalArea": self.anatomical_area,
            "gender": self.gender,
            "annotations": self.annotations,
            "neuronType": self.neuron_type,
            "neuronInstance": self.neuron_instance,
            "state": self.state,
            "slideCode": self.slide_code,
            "objective": self.objective,
            "mountingProtocol": self.mounting_protocol,
            "channel": self.channel,
            "files": dict(self.files) or None,
        }))
        return out


def neuron_metadata(n: Neuron) -> NeuronMetadata:
    """Entity -> publish dto (EMNeuronEntity.metadata():53-67 /
    LMNeuronEntity.metadata())."""
    m = NeuronMetadata(
        internal_id=n.entity_id,
        mip_id=n.mip_id,
        library_name=n.library_name,
        published_name=n.published_name,
        alignment_space=n.alignment_space,
        annotations=n.neuron_terms,
        files=dict(n.files),
    )
    if isinstance(n, EMNeuron):
        m.type = "EMImage"
        m.em_ref_id = n.source_ref_id
        m.neuron_type = n.neuron_type
        m.neuron_instance = n.neuron_instance
        m.state = n.state
        m.full_published_name = n.published_name
    elif isinstance(n, LMNeuron):
        m.type = "LMImage"
        m.slide_code = n.slide_code
        m.objective = n.objective
        m.mounting_protocol = n.mounting_protocol
        m.channel = n.channel
        m.anatomical_area = n.anatomical_area
        m.gender = n.gender
        m.full_published_name = n.published_name
    return m


@dataclasses.dataclass
class CDMatchedTarget:
    """dto/CDMatchedTarget: one CDS result row in a publish file."""
    target: NeuronMetadata
    mirrored: bool = False
    normalized_score: Optional[float] = None
    matching_pixels: Optional[int] = None
    files: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        out = {"type": "CDSMatch"}
        out.update(_clean({
            "image": self.target.to_json(),
            "mirrored": self.mirrored,
            "normalizedScore": self.normalized_score,
            "matchingPixels": self.matching_pixels,
            "files": dict(self.files) or None,
        }))
        return out


@dataclasses.dataclass
class PPPMatchedTarget:
    """dto/PPPMatchedTarget: one PPP result row."""
    target: NeuronMetadata
    mirrored: bool = False
    rank: Optional[float] = None
    score: Optional[int] = None
    source_lm_name: Optional[str] = None
    source_objective: Optional[str] = None
    source_lm_library: Optional[str] = None
    files: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        out = {"type": "PPPMatch"}
        out.update(_clean({
            "image": self.target.to_json(),
            "mirrored": self.mirrored,
            "pppmRank": self.rank,
            "pppmScore": self.score,
            "sourceLmName": self.source_lm_name,
            "sourceObjective": self.source_objective,
            "sourceLmLibrary": self.source_lm_library,
            "files": dict(self.files) or None,
        }))
        return out


def result_matches_json(input_neuron: NeuronMetadata, results: list) -> dict:
    """dto/ResultMatches: {"inputImage": ..., "results": [...]}."""
    return {
        "inputImage": input_neuron.to_json(),
        "results": [r.to_json() for r in results],
    }


def cd_match_to_dto(m: CDMatch) -> CDMatchedTarget:
    return CDMatchedTarget(
        target=neuron_metadata(m.matched_image),
        mirrored=m.mirrored,
        normalized_score=m.normalized_score,
        matching_pixels=m.matching_pixels,
        files=dict(m.match_files),
    )


_LM_REG_RE = _re.compile(r"(.+)_REG_UNISEX_(.+)", _re.IGNORECASE)
_OBJECTIVE_RE = _re.compile(r"\d+x", _re.IGNORECASE)
_DEFAULT_OBJECTIVE = "40x"


def _lm_sample_info(source_lm_name: Optional[str]):
    """PPPMatchEntity.updateLMSampleInfo (PPPMatchEntity.java:203-219):
    strip the _REG_UNISEX_ suffix off the LM sample name; the suffix is
    the objective when it contains NNx, else the default 40x."""
    if source_lm_name is None:
        return None, None
    mt = _LM_REG_RE.match(source_lm_name)
    if not mt:
        return source_lm_name, _DEFAULT_OBJECTIVE
    candidate = mt.group(2)
    objective = candidate if _OBJECTIVE_RE.search(candidate) \
        else _DEFAULT_OBJECTIVE
    return mt.group(1), objective


def ppp_match_to_dto(m: PPPMatch) -> PPPMatchedTarget:
    score = None
    if m.coverage_score is not None:
        # (int) Math.abs(coverageScore) — truncation, not rounding
        # (PPPMatchEntity.java:190)
        score = int(abs(m.coverage_score))
    lm_name, objective = _lm_sample_info(m.source_lm_name)
    return PPPMatchedTarget(
        target=neuron_metadata(m.matched_image)
        if m.matched_image else NeuronMetadata(type="LMImage"),
        mirrored=m.mirrored,
        rank=m.rank,
        score=score,
        source_lm_name=lm_name,
        source_objective=objective,
        source_lm_library=m.source_lm_library,
    )
