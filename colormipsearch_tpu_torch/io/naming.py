"""MIP filename parsing + segmented-image matching.

Python twin of cmd/MIPsHandlingUtils.java: extracting channel numbers,
objectives, EM body ids and neuron states from CDM file names, and
matching segmented/searchable images to their source MIPs — the logic
behind `createColorDepthSearchDataInput --segmented-mips`.
"""

from __future__ import annotations

import os
import re
from typing import Iterable, Optional

from colormipsearch_tpu_torch.model import ComputeFileType, FileData, Neuron

_CHANNEL_RE = re.compile(r"[_-]ch?(\d+)([_-]|(\.))", re.IGNORECASE)
_OBJECTIVE_RE = re.compile(r"[_-](\d+x)[_-]", re.IGNORECASE)
_EM_BODY_RE = re.compile(r"^(\d+)[_-]")
_EM_STATE_RE = re.compile(r"[0-9]+[_-]([0-9A-Z]*)_.*", re.IGNORECASE)


def extract_color_channel(mip_name: str, channel_base: int = 1) -> int:
    """Channel number normalized to 0-base; -1 when absent
    (MIPsHandlingUtils.extractColorChannelFromMIPName:96-105)."""
    m = _CHANNEL_RE.search(mip_name)
    if not m:
        return -1
    return int(m.group(1)) - channel_base


def extract_objective(mip_name: str) -> Optional[str]:
    m = _OBJECTIVE_RE.search(mip_name)
    return m.group(1).lower() if m else None


def extract_em_body_id(name: str) -> Optional[str]:
    m = _EM_BODY_RE.match(os.path.basename(name))
    return m.group(1) if m else None


def extract_em_neuron_state(name: str) -> str:
    # find() semantics like the reference pattern use
    # (MIPsHandlingUtils.java:132) — a prefix before the body id is fine
    m = _EM_STATE_RE.search(name)
    return m.group(1) if m else ""


def is_em_library(library: str | None) -> bool:
    """MIPsHandlingUtils.isEmLibrary:116-120."""
    if not library:
        return False
    low = library.lower()
    return low.startswith("flyem") or low.startswith("flywire") \
        or "_em_" in low or "hemibrain" in low or "manc" in low


def index_segmented_images(locations: Iterable[str]) -> dict:
    """neuronId -> [FileData] index over segmented-image stores
    (MIPsHandlingUtils.indexMIPStores:73-94).  The neuron id is the
    leading body id (EM) or the first filename token up to the first
    '-' (LM line/slide naming)."""
    from colormipsearch_tpu_torch.io import mips as mips_io

    index: dict[str, list[FileData]] = {}
    for loc in locations:
        for fd in mips_io.list_image_files(loc):
            base = os.path.basename(fd.name)
            body = extract_em_body_id(base)
            keys = set()
            if body:
                keys.add(body)
            keys.add(base.split("-")[0])
            keys.add(re.sub(r"\.[^.]+$", "", base))
            for k in keys:
                index.setdefault(k, []).append(fd)
    return index


def lookup_searchable_images(neuron: Neuron, index: dict, *,
                             channel_base: int = 1,
                             match_neuron_state: bool = False
                             ) -> list[FileData]:
    """Segmented images for a neuron, filtered like
    MIPsHandlingUtils.lookupSearchableNeuronImages:123-175: EM images may
    require a matching neuron state; LM images must match the source
    channel and objective when those are known."""
    neuron_id = neuron.neuron_id or neuron.published_name or ""
    candidates = index.get(neuron_id)
    if not candidates and is_em_library(neuron.library_name):
        body = extract_em_body_id(neuron_id) or \
            extract_em_body_id(neuron.mip_id or "")
        if body:
            candidates = index.get(body)
            neuron_id = body
    if not candidates:
        first = neuron_id.split("-")[0]
        candidates = index.get(first)
        if candidates:
            neuron_id = first
    if not candidates:
        return []
    if is_em_library(neuron.library_name):
        if not match_neuron_state:
            return list(candidates)
        src = neuron.compute_file(ComputeFileType.SourceColorDepthImage)
        src_state = extract_em_neuron_state(
            re.sub(r"\.\D*$", "", os.path.basename(src.name))) if src else ""
        out = []
        for fd in candidates:
            st = extract_em_neuron_state(os.path.basename(fd.name))
            if (not st and not src_state) or \
                    (src_state and st.startswith(src_state)):
                out.append(fd)
        return out
    # LM: match channel and objective parsed from the entry name with the
    # neuron id removed
    src_channel = (neuron.channel - 1) \
        if getattr(neuron, "channel", None) else -1
    src_objective = (getattr(neuron, "objective", None) or "").lower()
    out = []
    for fd in candidates:
        entry = os.path.basename(fd.name).replace(neuron_id, "")
        ch = extract_color_channel(entry, channel_base)
        obj = extract_objective(entry)
        if src_channel >= 0 and ch >= 0 and ch != src_channel:
            continue
        # objective matching (matchMIPObjectiveWithSegmentedImageObjective,
        # MIPsHandlingUtils.java:222-234): a segmented image WITH an
        # objective only matches a mip WITH one; a segmented image
        # without an objective matches anything
        if obj and not src_objective:
            continue
        if src_objective and obj and obj != src_objective:
            continue
        out.append(fd)
    return out
