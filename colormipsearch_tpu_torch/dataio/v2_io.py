"""v2 (file-pipeline) JSON formats: MIP metadata lists and CDSMatches.

Mirrors the deprecated-but-still-authoritative v2 schemas
(api_v2/cdmips/MIPMetadata.java, api_v2/cdsearch/CDSMatches.java:73-91,
ColorMIPSearchMatchMetadata.java:74-94, ColorMIPSearchResult.java:107-190):

  * MIP list files: JSON array of {id, publishedName, libraryName,
    cdmPath, imageName, imageArchivePath, imageType, imageURL, ...}
  * result files: {maskId, maskPublishedName, maskLibraryName, results:
    [{id.. (matched target), source*.. (mask), matchingPixels,
      matchingRatio, mirrored, gradientAreaGap, highExpressionArea,
      normalizedGapScore, normalizedScore, attrs}]}
  * legacy read-compat: result rows using matched* attribute names
    (ColorMIPSearchMatchMetadata.attributeValueHandler:360-396) where the
    row's own id/publishedName are the SOURCE and matched* the target.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Optional, Sequence


_MIP_FIELDS = (
    "id", "publishedName", "libraryName", "cdmPath", "imageName",
    "imageArchivePath", "imageType", "imageURL", "thumbnailURL",
    "searchablePNG", "imageStack", "screenImage", "slideCode", "driver",
    "objective", "neuronType", "neuronInstance", "gender", "anatomicalArea",
    "alignmentSpace", "channel", "mountingProtocol", "relatedImageRefId",
    "sampleRef", "variants",
)


@dataclasses.dataclass
class MIPMetadata:
    """v2 MIP descriptor (api_v2/cdmips/MIPMetadata.java)."""
    id: Optional[str] = None
    publishedName: Optional[str] = None
    libraryName: Optional[str] = None
    cdmPath: Optional[str] = None
    imageName: Optional[str] = None
    imageArchivePath: Optional[str] = None
    imageType: Optional[str] = None  # "file" | "zipEntry"
    imageURL: Optional[str] = None
    thumbnailURL: Optional[str] = None
    searchablePNG: Optional[str] = None
    imageStack: Optional[str] = None
    screenImage: Optional[str] = None
    slideCode: Optional[str] = None
    driver: Optional[str] = None
    objective: Optional[str] = None
    neuronType: Optional[str] = None
    neuronInstance: Optional[str] = None
    gender: Optional[str] = None
    anatomicalArea: Optional[str] = None
    alignmentSpace: Optional[str] = None
    channel: Optional[str] = None
    mountingProtocol: Optional[str] = None
    relatedImageRefId: Optional[str] = None
    sampleRef: Optional[str] = None
    variants: Optional[dict] = None
    attrs: dict = dataclasses.field(default_factory=dict)

    def file_data(self):
        """Resolve the image location for loading."""
        from colormipsearch_tpu_torch.model import FileData
        if self.imageType == "zipEntry" and self.imageArchivePath:
            return FileData(self.imageArchivePath, self.imageName)
        return FileData(self.imageName or self.cdmPath)

    def variant_file_data(self, variant: str):
        """Resolve a variants-dictionary entry to a loadable FileData,
        zip-entry aware (MIPMetadata.variantAsMIP — the reference
        checks the MIP's own variants BEFORE any location/suffix
        convention, MIPsUtils.getMIPVariantInfo:223-228)."""
        from colormipsearch_tpu_torch.model import FileData
        v = (self.variants or {}).get(variant)
        if not v:
            return None
        archive = self.variants.get(variant + "ArchivePath")
        entry_type = self.variants.get(variant + "EntryType")
        if entry_type == "zipEntry" and archive:
            return FileData(archive, v)
        return FileData(v)

    def to_json(self) -> dict:
        out = {}
        for f in _MIP_FIELDS:
            v = getattr(self, f)
            if v is not None:
                out[f] = v
        if self.attrs:
            out["attrs"] = self.attrs
        return out

    @classmethod
    def from_json(cls, d: dict) -> "MIPMetadata":
        kw = {f: d.get(f) for f in _MIP_FIELDS}
        m = cls(**kw)
        m.attrs = dict(d.get("attrs") or {})
        return m


def read_mips_json(path, offset: int = 0, length: int = -1) -> list[MIPMetadata]:
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):  # {"mips": [...]} wrapper tolerated
        data = data.get("mips") or data.get("results") or []
    if offset > 0:
        data = data[offset:]
    if length > 0:
        data = data[:length]
    return [MIPMetadata.from_json(d) for d in data]


def write_mips_json(mips: Sequence[MIPMetadata], path, *, pretty=True) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump([m.to_json() for m in mips], f, indent=2 if pretty else None)


@dataclasses.dataclass
class V2Match:
    """One v2 result row (ColorMIPSearchMatchMetadata): `source*` is the
    mask side, the row's own identifiers are the matched target."""
    source: MIPMetadata
    target: MIPMetadata
    matchingPixels: int = 0
    matchingRatio: float = 0.0
    mirrored: bool = False
    gradientAreaGap: Optional[int] = None
    highExpressionArea: Optional[int] = None
    normalizedGapScore: Optional[float] = None

    @property
    def normalized_score(self) -> float:
        # ColorMIPSearchMatchMetadata.getNormalizedScore: gap score if
        # present else the matching pixels count
        if self.normalizedGapScore is not None:
            return self.normalizedGapScore
        return float(self.matchingPixels)

    def to_json(self) -> dict:
        out = {}
        t = self.target.to_json()
        out.update(t)
        s = self.source.to_json()
        for k, v in s.items():
            out["source" + k[0].upper() + k[1:]] = v
        out["matchingPixels"] = self.matchingPixels
        out["matchingRatio"] = self.matchingRatio
        if self.mirrored:
            out["mirrored"] = self.mirrored
        if self.gradientAreaGap is not None:
            out["gradientAreaGap"] = self.gradientAreaGap
        if self.highExpressionArea is not None:
            out["highExpressionArea"] = self.highExpressionArea
        if self.normalizedGapScore is not None:
            out["normalizedGapScore"] = self.normalizedGapScore
        out["normalizedScore"] = self.normalized_score
        return out

    @classmethod
    def from_json(cls, d: dict) -> "V2Match":
        attrs = d.get("attrs") or {}
        if "matchedId" in d or any(k.startswith("matched") for k in d):
            # legacy shape: own ids = source, matched* = target
            src = MIPMetadata.from_json(d)
            tgt = MIPMetadata.from_json({
                "id": d.get("matchedId"),
                "publishedName": d.get("matchedPublishedName"),
                "libraryName": d.get("matchedLibrary"),
                "imageName": d.get("matchedImageName"),
                "imageArchivePath": d.get("matchedImageArchivePath"),
                "imageType": d.get("matchedImageType"),
                "imageURL": d.get("image_path"),
                "thumbnailURL": d.get("thumbnail_path"),
            })
            # metadata attrs override (legacy files carry attrs maps)
            for k, v in attrs.items():
                kk = k.replace(" ", "")
                kk = kk[0].lower() + kk[1:]
                if getattr(tgt, kk, None) is None and kk in _MIP_FIELDS:
                    setattr(tgt, kk, v)
        else:
            tgt = MIPMetadata.from_json(d)
            src = MIPMetadata.from_json({
                k[len("source"):][0].lower() + k[len("source") + 1:]: v
                for k, v in d.items() if k.startswith("source")})

        def _num(x, conv):
            try:
                return conv(x) if x is not None else None
            except (TypeError, ValueError):
                return None

        def _first(*vals):
            # zero is a legitimate score value — only None falls through
            for v in vals:
                if v is not None:
                    return v
            return None

        return cls(
            source=src, target=tgt,
            matchingPixels=_num(_first(d.get("matchingPixels"),
                                       attrs.get("Matched pixels")),
                                int) or 0,
            matchingRatio=_num(_first(d.get("matchingRatio"),
                                      attrs.get("Score")), float) or 0.0,
            mirrored=bool(d.get("mirrored", False)),
            gradientAreaGap=_num(_first(d.get("gradientAreaGap"),
                                        attrs.get("GradientAreaGap")), int),
            highExpressionArea=_num(
                _first(d.get("highExpressionArea"),
                       attrs.get("HighExpressionArea")), int),
            normalizedGapScore=_num(
                _first(d.get("normalizedGapScore"),
                       attrs.get("NormalizedGapScore")), float),
        )


@dataclasses.dataclass
class CDSMatches:
    """A per-MIP v2 result file (api_v2/cdsearch/CDSMatches.java)."""
    maskId: Optional[str] = None
    maskPublishedName: Optional[str] = None
    maskLibraryName: Optional[str] = None
    maskImageURL: Optional[str] = None
    maskImageStack: Optional[str] = None
    maskScreenImage: Optional[str] = None
    maskSampleRef: Optional[str] = None
    maskRelatedImageRefId: Optional[str] = None
    results: list = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        out = {}
        for f in ("maskId", "maskPublishedName", "maskLibraryName",
                  "maskSampleRef", "maskRelatedImageRefId", "maskImageURL",
                  "maskImageStack", "maskScreenImage"):
            v = getattr(self, f)
            if v is not None:
                out[f] = v
        out["results"] = [r.to_json() for r in self.results]
        return out

    @classmethod
    def from_json(cls, d: dict) -> "CDSMatches":
        m = cls(
            maskId=d.get("maskId"),
            maskPublishedName=d.get("maskPublishedName"),
            maskLibraryName=d.get("maskLibraryName"),
            maskImageURL=d.get("maskImageURL"),
            maskImageStack=d.get("maskImageStack"),
            maskScreenImage=d.get("maskScreenImage"),
            maskSampleRef=d.get("maskSampleRef"),
            maskRelatedImageRefId=d.get("maskRelatedImageRefId"),
            results=[V2Match.from_json(r) for r in d.get("results") or ()],
        )
        # legacy files have no maskId; derive from the first result's source
        if m.maskId is None and m.results:
            m.maskId = m.results[0].source.id
            m.maskPublishedName = m.results[0].source.publishedName
            m.maskLibraryName = m.results[0].source.libraryName
        return m


def read_cds_matches(path) -> CDSMatches:
    with open(path) as f:
        return CDSMatches.from_json(json.load(f))


def write_cds_matches(matches: CDSMatches, path, *, pretty=True) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        json.dump(matches.to_json(), f, indent=2 if pretty else None)


def group_matches_by_target(rows: Sequence[V2Match]) -> list[CDSMatches]:
    """Group per matched target (the v2 per-library files), inverting the
    source/target roles in each row."""
    inverted = [dataclasses.replace(r, source=r.target, target=r.source)
                for r in rows]
    return group_matches_by_source(inverted)


def group_matches_by_source(rows: Sequence[V2Match]) -> list[CDSMatches]:
    """Group flat rows into per-mask CDSMatches
    (ColorMIPSearchResultUtils grouping)."""
    by_id: dict[str, CDSMatches] = {}
    for r in rows:
        key = r.source.id or r.source.publishedName or ""
        g = by_id.get(key)
        if g is None:
            g = by_id[key] = CDSMatches(
                maskId=r.source.id,
                maskPublishedName=r.source.publishedName,
                maskLibraryName=r.source.libraryName,
                maskImageURL=r.source.imageURL,
                maskSampleRef=r.source.sampleRef,
                maskRelatedImageRefId=r.source.relatedImageRefId)
        g.results.append(r)
    for g in by_id.values():
        g.results.sort(key=lambda r: -r.normalized_score)
    return list(by_id.values())
