"""Entity dataclasses with reference-compatible JSON serialization.

Field names and JSON shapes mirror the reference model package so result
files are interchangeable:
  * neurons   — model/AbstractNeuronEntity.java:24-50, EMNeuronEntity.java:8-33,
                LMNeuronEntity.java:11-37
  * matches   — model/AbstractMatchEntity.java:22-31, CDMatchEntity.java:11-72,
                PPPMatchEntity.java:14-37
  * file refs — model/FileData.java:22-30 (string or {dataType,fileName,entryName})
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional


class ComputeFileType(enum.Enum):
    """model/ComputeFileType.java:5-17."""
    SourceColorDepthImage = "SourceColorDepthImage"
    InputColorDepthImage = "InputColorDepthImage"
    GradientImage = "GradientImage"
    ZGapImage = "ZGapImage"
    Vol3DSegmentation = "Vol3DSegmentation"
    SkeletonSWC = "SkeletonSWC"
    SkeletonOBJ = "SkeletonOBJ"

    @classmethod
    def from_name(cls, name: str) -> Optional["ComputeFileType"]:
        for v in cls:
            if v.value.lower() == name.lower():
                return v
        return None


class MatchComputeFileType(enum.Enum):
    """model/MatchComputeFileType.java:5-9."""
    MaskColorDepthImage = "MaskColorDepthImage"
    MaskGradientImage = "MaskGradientImage"
    MaskZGapImage = "MaskZGapImage"


class FileType(enum.Enum):
    """Publish-facing file types (model/FileType.java:5-28)."""
    store = "store"
    CDM = "CDM"
    CDMThumbnail = "CDMThumbnail"
    CDMInput = "CDMInput"
    CDMMatch = "CDMMatch"
    CDMBest = "CDMBest"
    CDMBestThumbnail = "CDMBestThumbnail"
    CDMSkel = "CDMSkel"
    SignalMip = "SignalMip"
    SignalMipMasked = "SignalMipMasked"
    SignalMipMaskedSkel = "SignalMipMaskedSkel"
    Gal4Expression = "Gal4Expression"
    VisuallyLosslessStack = "VisuallyLosslessStack"
    AlignedBodySWC = "AlignedBodySWC"
    AlignedBodyOBJ = "AlignedBodyOBJ"
    CDSResults = "CDSResults"
    PPPMResults = "PPPMResults"


# PPP screenshot suffixes (model/FileType.java:11-16 optionalFileSuffix)
PPP_FILE_SUFFIXES = {
    FileType.CDMBest: "_5_ch.png",
    FileType.CDMBestThumbnail: "_5_ch.jpg",
    FileType.CDMSkel: "_6_ch_skel.png",
    FileType.SignalMip: "_1_raw.png",
    FileType.SignalMipMasked: "_2_masked_raw.png",
    FileType.SignalMipMaskedSkel: "_3_skel.png",
}


class ProcessingType(enum.Enum):
    """Per-neuron progress tags (model/ProcessingType.java:3-8)."""
    ColorDepthSearch = "ColorDepthSearch"
    GradientScore = "GradientScore"
    NormalizeGradientScore = "NormalizeGradientScore"
    PPPMatch = "PPPMatch"


@dataclasses.dataclass(frozen=True)
class FileData:
    """A file location: plain file or an entry inside a zip archive.

    Serializes as a bare string for plain files (the common, compact case)
    or as {"dataType": "zipEntry", "fileName": ..., "entryName": ...} —
    same dual shape as the reference's custom Jackson codec
    (model/json/FileDataSerializer.java / FileDataDeserializer.java).
    """
    file_name: str
    entry_name: Optional[str] = None

    @property
    def is_zip_entry(self) -> bool:
        return self.entry_name is not None

    def to_json(self):
        if self.entry_name is None:
            return self.file_name
        return {"dataType": "zipEntry", "fileName": self.file_name,
                "entryName": self.entry_name}

    @classmethod
    def from_json(cls, data) -> Optional["FileData"]:
        if data is None:
            return None
        if isinstance(data, str):
            return cls(data)
        if data.get("dataType") == "zipEntry":
            return cls(data["fileName"], data.get("entryName"))
        return cls(data["fileName"])

    @property
    def name(self) -> str:
        return self.entry_name if self.entry_name else self.file_name


def _clean(d: dict) -> dict:
    return {k: v for k, v in d.items()
            if v is not None and v != {} and v != [] and v != ""}


@dataclasses.dataclass
class Neuron:
    """Base neuron entity (model/AbstractNeuronEntity.java:24-50)."""
    mip_id: Optional[str] = None
    alignment_space: Optional[str] = None
    library_name: Optional[str] = None
    published_name: Optional[str] = None
    source_ref_id: Optional[str] = None
    entity_id: Optional[int] = None
    neuron_terms: Optional[list] = None
    compute_files: dict = dataclasses.field(default_factory=dict)
    processed_tags: dict = dataclasses.field(default_factory=dict)
    tags: set = dataclasses.field(default_factory=set)
    dataset_labels: set = dataclasses.field(default_factory=set)
    validation_errors: Optional[set] = None
    # publish-facing files map carried through result JSON
    files: dict = dataclasses.field(default_factory=dict)
    # unknown/extra JSON attributes are preserved round-trip
    extra: dict = dataclasses.field(default_factory=dict)

    JSON_CLASS = "org.janelia.colormipsearch.model.AbstractNeuronEntity"

    @property
    def neuron_id(self) -> Optional[str]:
        return self.published_name

    def compute_file(self, ftype: ComputeFileType) -> Optional[FileData]:
        return self.compute_files.get(ftype)

    def set_compute_file(self, ftype: ComputeFileType, fd) -> None:
        if isinstance(fd, str):
            fd = FileData(fd)
        self.compute_files[ftype] = fd

    def has_compute_file(self, ftype: ComputeFileType) -> bool:
        return ftype in self.compute_files

    def add_processed_tags(self, ptype: ProcessingType, tags) -> None:
        self.processed_tags.setdefault(ptype, set()).update(tags)

    def has_processed_tag(self, ptype: ProcessingType, tag: str) -> bool:
        return tag in self.processed_tags.get(ptype, ())

    def _own_json(self) -> dict:
        return {}

    def to_json(self) -> dict:
        out = {
            "class": self.JSON_CLASS,
            "entityId": str(self.entity_id) if self.entity_id is not None else None,
            "mipId": self.mip_id,
            "libraryName": self.library_name,
            "publishedName": self.published_name,
            "alignmentSpace": self.alignment_space,
            "sourceRefId": self.source_ref_id,
            "neuronTerms": sorted(self.neuron_terms) if self.neuron_terms else None,
            "computeFiles": {k.value: v.to_json()
                             for k, v in sorted(self.compute_files.items(),
                                                key=lambda kv: kv[0].value)},
            "processedTags": {k.value: sorted(v)
                              for k, v in self.processed_tags.items()} or None,
            "tags": sorted(self.tags) or None,
            "datasetLabels": sorted(self.dataset_labels) or None,
            "validationErrors": sorted(self.validation_errors)
            if self.validation_errors else None,
        }
        out.update(self._own_json())
        out.update(self.extra)
        out["files"] = {k: v for k, v in self.files.items()} or None
        return _clean(out)

    # field names that map to typed attributes (rest go to `extra`)
    # createdDate/updatedDate are deliberately NOT listed: they have no
    # typed field, so they ride `extra` and round-trip like any other
    # unknown attribute
    _KNOWN = ("class", "entityId", "mipId", "libraryName", "publishedName",
              "alignmentSpace", "sourceRefId", "neuronTerms", "computeFiles",
              "processedTags", "tags", "datasetLabels", "validationErrors",
              "files")

    @classmethod
    def _base_kwargs(cls, data: dict) -> dict:
        eid = data.get("entityId")
        return dict(
            mip_id=data.get("mipId"),
            alignment_space=data.get("alignmentSpace"),
            library_name=data.get("libraryName"),
            published_name=data.get("publishedName"),
            source_ref_id=data.get("sourceRefId"),
            entity_id=int(eid) if eid is not None else None,
            neuron_terms=data.get("neuronTerms"),
            compute_files={
                ComputeFileType.from_name(k): FileData.from_json(v)
                for k, v in (data.get("computeFiles") or {}).items()
                if ComputeFileType.from_name(k) is not None},
            # unknown processing types are skipped, like unknown
            # computeFiles keys above — a newer producer must not make
            # the whole ingest crash
            processed_tags={
                ProcessingType(k): set(v)
                for k, v in (data.get("processedTags") or {}).items()
                if k in ProcessingType._value2member_map_},
            tags=set(data.get("tags") or ()),
            dataset_labels=set(data.get("datasetLabels") or ()),
            validation_errors=set(data["validationErrors"])
            if data.get("validationErrors") else None,
            files=dict(data.get("files") or {}),
        )


@dataclasses.dataclass
class EMNeuron(Neuron):
    """EM body neuron (model/EMNeuronEntity.java:8-33)."""
    neuron_type: Optional[str] = None
    neuron_instance: Optional[str] = None
    state: Optional[str] = None

    JSON_CLASS = "org.janelia.colormipsearch.model.EMNeuronEntity"

    def _own_json(self) -> dict:
        return {"neuronType": self.neuron_type,
                "neuronInstance": self.neuron_instance,
                "state": self.state}

    _KNOWN = Neuron._KNOWN + ("neuronType", "neuronInstance", "state")

    @classmethod
    def from_json(cls, data: dict) -> "EMNeuron":
        kw = cls._base_kwargs(data)
        kw.update(neuron_type=data.get("neuronType"),
                  neuron_instance=data.get("neuronInstance"),
                  state=data.get("state"))
        n = cls(**kw)
        n.extra = {k: v for k, v in data.items() if k not in cls._KNOWN}
        return n


@dataclasses.dataclass
class LMNeuron(Neuron):
    """LM sample neuron (model/LMNeuronEntity.java:11-37)."""
    internal_line_name: Optional[str] = None
    slide_code: Optional[str] = None
    anatomical_area: Optional[str] = None
    gender: Optional[str] = None  # "f" | "m"
    objective: Optional[str] = None
    channel: Optional[int] = None
    sample_ref: Optional[str] = None
    sample_name: Optional[str] = None
    mounting_protocol: Optional[str] = None
    not_staged: Optional[bool] = None
    publish_error: Optional[str] = None

    JSON_CLASS = "org.janelia.colormipsearch.model.LMNeuronEntity"

    @property
    def neuron_id(self) -> Optional[str]:
        # LM neurons are identified by slide code (LMNeuronEntity.getNeuronId)
        return self.slide_code

    def _own_json(self) -> dict:
        return {"internalLineName": self.internal_line_name,
                "slideCode": self.slide_code,
                "anatomicalArea": self.anatomical_area,
                "gender": self.gender,
                "objective": self.objective,
                "channel": self.channel,
                "sampleRef": self.sample_ref,
                "sampleName": self.sample_name,
                "mountingProtocol": self.mounting_protocol,
                "notStaged": self.not_staged,
                "publishError": self.publish_error}

    _KNOWN = Neuron._KNOWN + (
        "internalLineName", "slideCode", "anatomicalArea", "gender",
        "objective", "channel", "sampleRef", "sampleName",
        "mountingProtocol", "notStaged", "publishError")

    @classmethod
    def from_json(cls, data: dict) -> "LMNeuron":
        kw = cls._base_kwargs(data)
        kw.update(internal_line_name=data.get("internalLineName"),
                  slide_code=data.get("slideCode"),
                  anatomical_area=data.get("anatomicalArea"),
                  gender=data.get("gender"),
                  objective=data.get("objective"),
                  channel=data.get("channel"),
                  sample_ref=data.get("sampleRef"),
                  sample_name=data.get("sampleName"),
                  mounting_protocol=data.get("mountingProtocol"),
                  not_staged=data.get("notStaged"),
                  publish_error=data.get("publishError"))
        n = cls(**kw)
        n.extra = {k: v for k, v in data.items() if k not in cls._KNOWN}
        return n


def neuron_from_json(data: dict) -> Neuron:
    """Polymorphic neuron deserialization keyed on the `class` attribute."""
    cls_name = data.get("class", "")
    if "EMNeuron" in cls_name:
        return EMNeuron.from_json(data)
    if "LMNeuron" in cls_name:
        return LMNeuron.from_json(data)
    # fall back on the shared library-name classifier
    # (io/naming.is_em_library, MIPsHandlingUtils.isEmLibrary:116)
    from colormipsearch_tpu_torch.io.naming import is_em_library
    if is_em_library(data.get("libraryName") or ""):
        return EMNeuron.from_json(data)
    return LMNeuron.from_json(data)


@dataclasses.dataclass
class CDMatch:
    """Color depth search match (model/CDMatchEntity.java:11-72)."""
    mask_image: Optional[Neuron] = None
    matched_image: Optional[Neuron] = None
    mask_image_ref_id: Optional[int] = None
    matched_image_ref_id: Optional[int] = None
    entity_id: Optional[int] = None
    session_ref_id: Optional[int] = None
    mirrored: bool = False
    matching_pixels: Optional[int] = None
    matching_pixels_ratio: Optional[float] = None
    gradient_area_gap: Optional[int] = None
    high_expression_area: Optional[int] = None
    normalized_score: Optional[float] = None
    match_found: bool = True
    errors: Optional[str] = None
    tags: set = dataclasses.field(default_factory=set)
    match_compute_files: dict = dataclasses.field(default_factory=dict)
    match_files: dict = dataclasses.field(default_factory=dict)

    JSON_CLASS = "org.janelia.colormipsearch.model.CDMatchEntity"

    def negative_score(self) -> int:
        from colormipsearch_tpu_torch.oracle.shape import negative_score
        return negative_score(self.gradient_area_gap, self.high_expression_area)

    def has_grad_score(self) -> bool:
        return (self.gradient_area_gap is not None
                and self.gradient_area_gap >= 0) or (
            self.high_expression_area is not None
            and self.high_expression_area >= 0)

    def to_json(self, *, include_neurons: bool = True) -> dict:
        out = {}
        if include_neurons and self.mask_image is not None:
            out["maskImage"] = self.mask_image.to_json()
        if self.mask_image_ref_id is not None:
            out["maskImageRefId"] = str(self.mask_image_ref_id)
        if self.entity_id is not None:
            out["entityId"] = str(self.entity_id)
        if self.session_ref_id is not None:
            out["sessionRefId"] = str(self.session_ref_id)
        out["mirrored"] = self.mirrored
        if self.match_compute_files:
            out["matchComputeFiles"] = {
                k.value if isinstance(k, MatchComputeFileType) else k:
                v.to_json() for k, v in self.match_compute_files.items()}
        if self.normalized_score is not None:
            out["normalizedScore"] = _round_f32(self.normalized_score)
        if self.matching_pixels is not None:
            out["matchingPixels"] = self.matching_pixels
        if self.matching_pixels_ratio is not None:
            out["matchingPixelsRatio"] = _round_f32(self.matching_pixels_ratio)
        if self.gradient_area_gap is not None:
            out["gradientAreaGap"] = self.gradient_area_gap
        if self.high_expression_area is not None:
            out["highExpressionArea"] = self.high_expression_area
        if self.errors:
            out["errors"] = self.errors
        if self.tags:
            out["tags"] = sorted(self.tags)
        if include_neurons and self.matched_image is not None:
            out["image"] = self.matched_image.to_json()
        if self.matched_image_ref_id is not None:
            out["matchedImageRefId"] = str(self.matched_image_ref_id)
        if self.match_files:
            out["files"] = dict(self.match_files)
        out["class"] = self.JSON_CLASS
        # match_found is deliberately not serialized: the reference marks
        # isMatchFound @JsonIgnore (CDMatchEntity.java:72-75) — it is a
        # transient result-filtering flag, recomputed per run
        return out

    @classmethod
    def from_json(cls, data: dict, *, mask_image: Neuron | None = None) -> "CDMatch":
        mi = data.get("maskImage")
        ti = data.get("image")
        mcf = {}
        for k, v in (data.get("matchComputeFiles") or {}).items():
            try:
                key: Any = MatchComputeFileType(k)
            except ValueError:
                key = k
            mcf[key] = FileData.from_json(v)
        return cls(
            mask_image=neuron_from_json(mi) if mi else mask_image,
            matched_image=neuron_from_json(ti) if ti else None,
            mask_image_ref_id=_opt_int(data.get("maskImageRefId")),
            matched_image_ref_id=_opt_int(data.get("matchedImageRefId")),
            entity_id=_opt_int(data.get("entityId")),
            session_ref_id=_opt_int(data.get("sessionRefId")),
            mirrored=bool(data.get("mirrored", False)),
            matching_pixels=data.get("matchingPixels"),
            matching_pixels_ratio=data.get("matchingPixelsRatio"),
            gradient_area_gap=data.get("gradientAreaGap"),
            high_expression_area=data.get("highExpressionArea"),
            normalized_score=data.get("normalizedScore"),
            match_found=bool(data.get("matchFound", True)),
            errors=data.get("errors"),
            tags=set(data.get("tags") or ()),
            match_compute_files=mcf,
            match_files=dict(data.get("files") or {}),
        )


@dataclasses.dataclass
class PPPSkeletonMatch:
    """Best-skeleton info of a PPP match (model/PPPSkeletonMatch)."""
    id: Optional[str] = None
    nblast_score: Optional[float] = None
    coverage: Optional[float] = None
    color: Optional[list] = None

    def to_json(self) -> dict:
        return _clean({"id": self.id, "nblastScore": self.nblast_score,
                       "coverage": self.coverage, "color": self.color})

    @classmethod
    def from_json(cls, d: dict) -> "PPPSkeletonMatch":
        return cls(d.get("id"), d.get("nblastScore"), d.get("coverage"),
                   d.get("color"))


@dataclasses.dataclass
class PPPMatch:
    """PatchPerPix match (model/PPPMatchEntity.java:14-37)."""
    mask_image: Optional[Neuron] = None        # EM neuron
    matched_image: Optional[Neuron] = None     # LM neuron
    entity_id: Optional[int] = None
    session_ref_id: Optional[int] = None
    mask_image_ref_id: Optional[int] = None    # AbstractMatchEntity refs
    matched_image_ref_id: Optional[int] = None
    mirrored: bool = False
    source_em_name: Optional[str] = None
    source_em_library: Optional[str] = None
    source_lm_name: Optional[str] = None
    source_lm_library: Optional[str] = None
    coverage_score: Optional[float] = None
    aggregate_coverage: Optional[float] = None
    rank: Optional[float] = None
    lm_published_name: Optional[str] = None
    lm_slide_code: Optional[str] = None
    lm_objective: Optional[str] = None
    input_alignment_space: Optional[str] = None
    source_image_files: dict = dataclasses.field(default_factory=dict)
    skeleton_matches: list = dataclasses.field(default_factory=list)
    tags: set = dataclasses.field(default_factory=set)

    JSON_CLASS = "org.janelia.colormipsearch.model.PPPMatchEntity"

    def to_json(self) -> dict:
        out: dict = {}
        if self.mask_image is not None:
            out["maskImage"] = self.mask_image.to_json()
        if self.matched_image is not None:
            out["image"] = self.matched_image.to_json()
        out.update(_clean({
            "entityId": str(self.entity_id)
            if self.entity_id is not None else None,
            "sessionRefId": str(self.session_ref_id)
            if self.session_ref_id is not None else None,
            "maskImageRefId": str(self.mask_image_ref_id)
            if self.mask_image_ref_id is not None else None,
            "matchedImageRefId": str(self.matched_image_ref_id)
            if self.matched_image_ref_id is not None else None,
            "mirrored": self.mirrored,
            "sourceEmName": self.source_em_name,
            "sourceEmLibrary": self.source_em_library,
            "sourceLmName": self.source_lm_name,
            "sourceLmLibrary": self.source_lm_library,
            "coverageScore": self.coverage_score,
            "aggregateCoverage": self.aggregate_coverage,
            "rank": self.rank,
            "lmPublishedName": self.lm_published_name,
            "lmSlideCode": self.lm_slide_code,
            "lmObjective": self.lm_objective,
            "inputAlignmentSpace": self.input_alignment_space,
            "sourceImageFiles": self.source_image_files or None,
            "skeletonMatches": [s.to_json() for s in self.skeleton_matches]
            or None,
            "tags": sorted(self.tags) or None,
        }))
        out["class"] = self.JSON_CLASS
        return out

    @classmethod
    def from_json(cls, data: dict) -> "PPPMatch":
        mi = data.get("maskImage")
        ti = data.get("image")
        return cls(
            mask_image=neuron_from_json(mi) if mi else None,
            matched_image=neuron_from_json(ti) if ti else None,
            entity_id=_opt_int(data.get("entityId")),
            session_ref_id=_opt_int(data.get("sessionRefId")),
            mask_image_ref_id=_opt_int(data.get("maskImageRefId")),
            matched_image_ref_id=_opt_int(data.get("matchedImageRefId")),
            mirrored=bool(data.get("mirrored", False)),
            source_em_name=data.get("sourceEmName"),
            source_em_library=data.get("sourceEmLibrary"),
            source_lm_name=data.get("sourceLmName"),
            source_lm_library=data.get("sourceLmLibrary"),
            coverage_score=data.get("coverageScore"),
            aggregate_coverage=data.get("aggregateCoverage"),
            rank=data.get("rank"),
            lm_published_name=data.get("lmPublishedName"),
            lm_slide_code=data.get("lmSlideCode"),
            lm_objective=data.get("lmObjective"),
            input_alignment_space=data.get("inputAlignmentSpace"),
            source_image_files=dict(data.get("sourceImageFiles") or {}),
            skeleton_matches=[PPPSkeletonMatch.from_json(s)
                              for s in data.get("skeletonMatches") or ()],
            tags=set(data.get("tags") or ()),
        )


@dataclasses.dataclass
class PublishedLMImage:
    """One row of the `publishedLMImage` collection: the published LM
    image of a sample+objective+area with its ancillary files (3D
    stacks, Gal4 expression CDMs) — model/PublishedLMImage.java /
    PublishedLMImageFields.java."""
    entity_id: Optional[int] = None
    sample_ref: Optional[str] = None
    line: Optional[str] = None
    area: Optional[str] = None
    tile: Optional[str] = None
    original_line: Optional[str] = None
    slide_code: Optional[str] = None
    objective: Optional[str] = None
    alignment_space: Optional[str] = None
    release_name: Optional[str] = None
    files: dict = dataclasses.field(default_factory=dict)
    # joined Gen1 GAL4/LexA expression rows for the same originalLine +
    # area (PublishedLMImageMongoDao.createQueryPipeline $lookup)
    gal4_expressions: list = dataclasses.field(default_factory=list)

    def get_file(self, file_type: str) -> Optional[str]:
        return self.files.get(file_type)

    def has_file(self, file_type: str) -> bool:
        return bool(self.files.get(file_type))

    def gal4_expression_image(self, area: Optional[str]) -> Optional[str]:
        """First Gen1 expression row matching the area (case-insensitive)
        that carries a ColorDepthMip1 file
        (PublishedLMImage.getGal4Expression4Image)."""
        for g in self.gal4_expressions:
            if area is not None and (g.area or "").lower() != area.lower():
                continue
            url = g.get_file("ColorDepthMip1")
            if url:
                return url
        return None

    def to_json(self) -> dict:
        return _clean({
            "_id": self.entity_id,
            "sampleRef": self.sample_ref,
            "line": self.line,
            "area": self.area,
            "tile": self.tile,
            "originalLine": self.original_line,
            "slideCode": self.slide_code,
            "objective": self.objective,
            "alignmentSpace": self.alignment_space,
            "releaseName": self.release_name,
            "files": dict(self.files),
        })

    @classmethod
    def from_json(cls, data: dict) -> "PublishedLMImage":
        return cls(
            entity_id=data.get("_id") or data.get("id"),
            sample_ref=data.get("sampleRef"),
            line=data.get("line"),
            area=data.get("area"),
            tile=data.get("tile"),
            original_line=data.get("originalLine"),
            slide_code=data.get("slideCode"),
            objective=data.get("objective"),
            alignment_space=data.get("alignmentSpace"),
            release_name=data.get("releaseName"),
            files=dict(data.get("files") or {}),
            gal4_expressions=[cls.from_json(g)
                              for g in data.get("gal4") or ()],
        )


def _opt_int(v) -> Optional[int]:
    return int(v) if v is not None else None


def _round_f32(v: float) -> float:
    """Java serializes Float score fields; round-trip through float32 so our
    JSON numbers match the reference's printed precision."""
    import numpy as np
    return float(np.float32(v))
