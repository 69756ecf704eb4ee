"""PatchPerPix (PPP) raw result ingestion.

Parses the PPP pipeline's `cov_scores_<em>.json` files — nested
{emName: {lmName: rawSkeletonMatch}} maps with numpy-printed array
strings — into PPPMatch entities, mirroring
ppp/RawPPPMatchesReader.java:36-90 and the EM/LM name parsing of
model/PPPMatchEntity.java:17-19,195-215.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Iterable

from colormipsearch_tpu_torch.model import (
    EMNeuron,
    LMNeuron,
    PPPMatch,
    PPPSkeletonMatch,
)

EM_NAME_RE = re.compile(r"([0-9]+)-([^-]*)-(.*)", re.IGNORECASE)
LM_NAME_RE = re.compile(r"(.+)_REG_UNISEX_(.+)", re.IGNORECASE)
OBJECTIVE_RE = re.compile(r"\d+x", re.IGNORECASE)
DEFAULT_OBJECTIVE = "40x"


def _parse_np_list(s: str | None) -> list:
    """Parse numpy-printed or JSON list strings like
    '[  379  5477]' or '[1.5, 0.93]' or '[[31, 245, 16], ...]'."""
    if not s:
        return []
    s = s.strip()
    if not s.startswith("["):
        return []
    try:
        return json.loads(s)
    except json.JSONDecodeError:
        pass
    # numpy print format: whitespace-separated, possibly multi-line,
    # possibly with '...' ellipsis (normalizeArrayString strips it,
    # RawPPPMatchesReader.java:170-178)
    def scalars(text: str) -> list:
        out = []
        for v in text.replace(",", " ").split():
            if v == "...":
                continue
            try:
                out.append(int(v))
            except ValueError:
                try:
                    out.append(float(v))
                except ValueError:
                    pass
        return out

    inner = s.strip("[]")
    if "[" in inner:  # nested lists in numpy format
        return [scalars(p)
                for p in re.findall(r"\[([^\]]*)\]", s[1:-1])]
    return scalars(inner)


def read_raw_ppp_matches(path, *, only_best_matches: bool = True,
                         include_skeletons: bool = False) -> list[PPPMatch]:
    """One cov_scores file -> PPPMatch list (RawPPPMatchesReader:36-79)."""
    with open(path) as f:
        doc = json.load(f)
    out: list[PPPMatch] = []
    for em_name, lm_map in doc.items():
        for lm_name, raw in lm_map.items():
            m = PPPMatch(
                source_em_name=em_name,
                source_lm_name=lm_name,
                coverage_score=raw.get("cov_score"),
                aggregate_coverage=raw.get("aggregate_coverage"),
                mirrored=bool(raw.get("mirrored", False)),
                rank=raw.get("rank"),
            )
            if include_skeletons:
                # best-skeleton lists always contribute (deduped by id);
                # all-mode appends the all_* lists after them, colors
                # only when their count matches the ids
                # (RawPPPMatchesReader.getAllSkeletonMatches:105-169)
                seen: set = set()

                def add_lists(prefix: str):
                    ids = _parse_np_list(raw.get(prefix + "skel_ids"))
                    nblast = _parse_np_list(
                        raw.get(prefix + "nblast_scores"))
                    covs = _parse_np_list(raw.get(prefix + "coverages"))
                    colors = _parse_np_list(raw.get(prefix + "colors"))
                    if len(ids) != len(nblast):
                        raise ValueError(
                            f"{path}: skeleton ids and nblast scores "
                            f"counts differ for {em_name}->{lm_name}")
                    with_colors = len(colors) == len(ids)
                    for i, sid in enumerate(ids):
                        if str(sid) in seen:
                            continue
                        seen.add(str(sid))
                        m.skeleton_matches.append(PPPSkeletonMatch(
                            id=str(sid),
                            nblast_score=nblast[i]
                            if i < len(nblast) else None,
                            coverage=covs[i] if i < len(covs) else None,
                            color=colors[i] if with_colors else None))

                add_lists("")
                if not only_best_matches:
                    add_lists("all_")
            out.append(m)
    return out


def em_neuron_from_ppp_name(em_name: str, *, library=None,
                            alignment_space=None) -> EMNeuron:
    """'1599747200-PFNp_c-RT_18U' -> EM neuron (body id, type)."""
    n = EMNeuron(library_name=library, alignment_space=alignment_space)
    m = EM_NAME_RE.match(em_name)
    if m:
        n.published_name = m.group(1)
        n.neuron_type = m.group(2)
    else:
        n.published_name = em_name
    return n


def lm_neuron_from_ppp_name(lm_name: str, *, library=None,
                            alignment_space=None,
                            anatomical_area: str | None = None) -> LMNeuron:
    """'BJD_115G11_AE_01-20190507_62_F1_REG_UNISEX_40x' -> LM neuron.

    A suffix equal to `anatomical_area` is the area, not an objective
    (ImportPPPResultsCmd.updateLMMetadata:371-380)."""
    n = LMNeuron(library_name=library, alignment_space=alignment_space)
    m = LM_NAME_RE.match(lm_name)
    base = m.group(1) if m else lm_name
    objective = m.group(2) if m else None
    # the import keeps the suffix VERBATIM unless it names the
    # anatomical area (ImportPPPResultsCmd.updateLMMetadata:370-378);
    # the default-40x / NNx-pattern rules belong to the publish dto
    # (PPPMatchEntity.updateLMSampleInfo), not the import
    if objective and anatomical_area and \
            objective.lower() == anatomical_area.lower():
        objective = None
    n.objective = objective
    parts = base.split("-", 1)
    n.published_name = parts[0]
    n.internal_line_name = parts[0]
    if len(parts) > 1:
        n.slide_code = parts[1]
    return n


def find_ppp_result_files(dirs: Iterable[str], *,
                          prefix: str = "cov_scores_",
                          sub_dir: str | None = None) -> list[Path]:
    """Locate <prefix>*.json files under the given directories
    (ImportPPPResultsCmd walks em-subdirectories; --matches-prefix /
    --neuron-matches-sub-dir restrict the scan to the PPP pipeline's
    per-neuron results subdirectory)."""
    out: list[Path] = []
    for d in dirs:
        p = Path(d)
        if p.is_file():
            out.append(p)
        elif p.is_dir():
            hits = sorted(p.rglob(f"{prefix}*.json"))
            if sub_dir:
                hits = [h for h in hits if sub_dir in h.parent.parts]
            out.extend(hits)
    return out


# PPP screenshot suffix -> screenshot-type key, as serialized in
# PPPMatchEntity.sourceImageFiles (model/PPPScreenshotType.java:5-27);
# declaration order matters: findScreenshotType takes the FIRST suffix
# match, so _5_ch.png must be tested before _6_ch_skel.png etc.
SCREENSHOT_TYPES = (
    ("RAW", "_1_raw.png"),
    ("MASKED_RAW", "_2_masked_raw.png"),
    ("SKEL", "_3_skel.png"),
    ("CH", "_5_ch.png"),
    ("CH_SKEL", "_6_ch_skel.png"),
)


def find_screenshots(screenshots_dir, em_name: str, lm_name: str) -> dict:
    """Locate the per-match screenshot files.

    Mirrors ImportPPPResultsCmd.lookupScreenshots:388-396: glob
    `{emName}*{lmName}*.png` in the screenshots dir next to the results
    file and classify each hit by its FileType suffix
    (PPPMatchEntity.addSourceImageFile).  Returns {type key: path str}.
    """
    d = Path(screenshots_dir)
    if not d.is_dir():
        return {}
    out: dict = {}
    for f in sorted(d.glob(f"{em_name}*{lm_name}*.png")):
        for key, suffix in SCREENSHOT_TYPES:
            if f.name.endswith(suffix):
                out[key] = str(f)
                break
    return out


def lm_sample_name(lm_name: str) -> str:
    """LM sample name = everything before _REG_UNISEX_
    (ImportPPPResultsCmd.updateLMMetadata:371-380)."""
    m = LM_NAME_RE.match(lm_name)
    return m.group(1) if m else lm_name
