"""MIP enumeration and loading from directories and zip archives.

Covers the reference's MIP-loading surface:
  * `NeuronMIPUtils.loadComputeFile/openInputStream`
    (mips/NeuronMIPUtils.java:66-80,171-236) — load a neuron's compute
    file whether it is a plain file or a zip entry (with a full-archive
    scan fallback when the entry name does not match exactly),
  * v2 `MIPsUtils.readMIPsFromLocalFiles` (api_v2/cdmips/MIPsUtils.java:314-338)
    — enumerate a directory / zip / single file with offset+length,
  * v2 variant lookup by path + suffix convention
    (api_v2/cdmips/MIPsUtils.java:218-312) — find e.g. the gradient image
    of `x/y_CDM.png` at `<variantLocation>/y_CDM<variantSuffix>.png`.

Zip listings are cached per archive (the reference keeps an archive entry
cache for the same reason — MIPsUtils.java:43,392-420).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os
import re
import threading
import zipfile
from pathlib import Path
from typing import Optional

from colormipsearch_tpu_torch.io.image import (
    ImageData,
    is_image_file,
    read_image,
)
from colormipsearch_tpu_torch.model import ComputeFileType, FileData, Neuron


@dataclasses.dataclass
class ListArg:
    """`location[:offset[:length]]` CLI input (cmd/ListArg.java)."""
    location: str
    offset: int = 0
    length: int = -1

    @classmethod
    def parse(cls, spec: str) -> "ListArg":
        parts = spec.rsplit(":", 2)
        # only treat trailing ints as offset/length (paths may contain ':')
        if len(parts) == 3 and _is_int(parts[1]) and _is_int(parts[2]):
            return cls(parts[0], int(parts[1]), int(parts[2]))
        if len(parts) >= 2 and _is_int(parts[-1]):
            return cls(":".join(parts[:-1]), int(parts[-1]), -1)
        return cls(spec)

    def apply(self, items: list) -> list:
        items = items[self.offset:] if self.offset > 0 else items
        return items[:self.length] if self.length > 0 else items


def _is_int(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False


@functools.lru_cache(maxsize=256)
def _zip_names(archive_path: str) -> tuple[str, ...]:
    with zipfile.ZipFile(archive_path) as z:
        return tuple(n for n in z.namelist() if not n.endswith("/"))


def list_image_files(location: str) -> list[FileData]:
    """Enumerate image files at a location (dir, zip archive, or file)."""
    p = Path(location)
    if p.is_dir():
        return [FileData(str(f)) for f in sorted(p.iterdir())
                if f.is_file() and is_image_file(f.name)]
    if p.suffix.lower() == ".zip":
        return [FileData(str(p), n) for n in _zip_names(str(p))
                if is_image_file(n)]
    if p.exists():
        return [FileData(str(p))]
    return []


_zip_handles = threading.local()


def _zip_handle(path: str) -> zipfile.ZipFile:
    """Per-thread open-archive cache: reading N entries of a production
    archive otherwise re-parses the whole central directory N times
    (the reference keeps archives open in a cache for the same reason,
    api_v2 MIPsUtils ARCHIVE_ENTRIES_CACHE).  ZipFile handles are not
    thread-safe, hence per-thread; a small cap bounds open fds."""
    cache = getattr(_zip_handles, "cache", None)
    if cache is None:
        cache = _zip_handles.cache = collections.OrderedDict()
    z = cache.get(path)
    if z is None:
        if len(cache) >= 8:
            _, old = cache.popitem(last=False)  # evict least recently used
            old.close()
        z = cache[path] = zipfile.ZipFile(path)
    else:
        cache.move_to_end(path)
    return z


def read_bytes(fd: FileData) -> bytes:
    """Read the raw bytes of a file or zip entry, with the reference's
    fallback scan for entries whose stored path differs
    (NeuronMIPUtils.openInputStream:205-236)."""
    if not fd.is_zip_entry:
        with open(fd.file_name, "rb") as f:
            return f.read()
    z = _zip_handle(fd.file_name)
    try:
        return z.read(fd.entry_name)
    except KeyError:
        base = os.path.basename(fd.entry_name)
        for n in _zip_names(fd.file_name):
            if os.path.basename(n) == base:
                return z.read(n)
        raise FileNotFoundError(
            f"{fd.entry_name} not found in {fd.file_name}")


def load_image(fd: FileData) -> ImageData:
    return read_image(read_bytes(fd))


def exists(fd: Optional[FileData]) -> bool:
    if fd is None:
        return False
    if not fd.is_zip_entry:
        return os.path.exists(fd.file_name)
    try:
        names = _zip_names(fd.file_name)
    except (OSError, zipfile.BadZipFile):
        return False
    if fd.entry_name in names:
        return True
    base = os.path.basename(fd.entry_name)
    return any(os.path.basename(n) == base for n in names)


@dataclasses.dataclass
class NeuronMIP:
    """A neuron + one loaded compute image (mips/NeuronMIP.java)."""
    neuron: Neuron
    file_data: Optional[FileData]
    image: Optional[ImageData]

    @property
    def has_image(self) -> bool:
        return self.image is not None


def load_compute_file(neuron: Neuron, ftype: ComputeFileType) -> NeuronMIP:
    """Load a neuron's compute file (NeuronMIPUtils.loadComputeFile:66-80).
    Missing files degrade to an empty MIP, like CachedMIPsUtils:96-103."""
    fd = neuron.compute_file(ftype)
    if fd is None:
        return NeuronMIP(neuron, None, None)
    try:
        return NeuronMIP(neuron, fd, load_image(fd))
    except (OSError, FileNotFoundError, ValueError,
            zipfile.BadZipFile):
        return NeuronMIP(neuron, fd, None)


# -------------------------------------------------------------------------
# v2 variant lookup by suffix convention
# -------------------------------------------------------------------------


def variant_candidates(mip_name: str, variant_suffix: str | None,
                       cdm_suffix: str | None = None) -> list[str]:
    """Candidate file names of a variant image for `mip_name`.

    Reproduces MIPsUtils.getMIPVariantInfo name derivation: strip the
    extension (and optionally the CDM suffix), append the variant suffix,
    and try the common image extensions.
    """
    base = os.path.basename(mip_name)
    stem = re.sub(r"\.[^.]+$", "", base)
    stems = [stem]
    if cdm_suffix and stem.endswith(cdm_suffix):
        stems.append(stem[: -len(cdm_suffix)])
    out = []
    for st in stems:
        name = st + (variant_suffix or "")
        for ext in (".png", ".tif", ".tiff"):
            out.append(name + ext)
    return out


@functools.lru_cache(maxsize=64)
def _dir_entry_index(loc: str) -> dict[str, list[str]]:
    """Recursive {basename: sorted paths} index of a variant directory,
    cached per location (the FILE_NAMES_CACHE analogue of
    mips/FileDataUtils).  Recursive (vs the v2 reference's
    parent-path-derived subpath probes) so nested production layouts
    resolve regardless of how the variant tree mirrors the CDM tree;
    same-basename collisions keep every path and are disambiguated by
    the caller."""
    out: dict[str, list[str]] = {}
    for root, _dirs, files in os.walk(loc):
        for f in files:
            out.setdefault(f, []).append(os.path.join(root, f))
    for paths in out.values():
        paths.sort()
    return out


def _pick_collision(paths: list[str], mip_fd: FileData) -> str:
    """Among same-basename candidates, prefer one whose relative path
    shares the MIP's parent directory name (the component the v2
    reference's ancestor-walk would probe,
    api_v2 MIPsUtils.getMIPVariantInfoFromFilePath:284-298)."""
    if len(paths) > 1:
        parent = os.path.basename(os.path.dirname(mip_fd.name))
        if parent:
            pref = [p for p in paths if parent in os.path.dirname(p)]
            if pref:
                return pref[0]
    return paths[0]


def _contains_stem_match(names, stem: str,
                         variant_suffix: str | None) -> Optional[str]:
    """Variant-pattern fallback: an image entry whose file name contains
    the full searchable stem (FileDataUtils variantPattern's
    `.*<searchableMIPBaseName>.*` alternative,
    cmd/CreateCDSDataInputCmd.java:418-424).  When a variant suffix is
    known it must also appear in the name — without it, a shared
    location could silently return a DIFFERENT variant type (e.g. the
    zgap as the gradient), corrupting scores the reference would
    instead leave unscored."""
    best = None
    for n in names:
        base = os.path.basename(n)
        if stem in base and is_image_file(base) \
                and (not variant_suffix or variant_suffix in base):
            if best is None or n < best:
                best = n
    return best


def find_variant(mip_fd: FileData, variant_locations: list[str],
                 variant_suffix: str | None,
                 cdm_suffix: str | None = None) -> Optional[FileData]:
    """Locate a variant (gradient/zgap) image for a MIP by convention.

    Per location: exact suffix-derived candidate names first (v2
    MIPsUtils.getMIPVariantInfo derivation), then the
    suffix-constrained contains-stem pattern fallback over a cached
    recursive index (mips/FileDataUtils.lookupVariantFileData)."""
    cands = variant_candidates(mip_fd.name, variant_suffix, cdm_suffix)
    stem = re.sub(r"\.[^.]+$", "", os.path.basename(mip_fd.name))
    for loc in variant_locations:
        p = Path(loc)
        if p.suffix.lower() == ".zip":
            try:
                names = _zip_names(str(p))
            except (OSError, zipfile.BadZipFile):
                continue
            by_base = {os.path.basename(n): n for n in names}
            for c in cands:
                if c in by_base:
                    return FileData(str(p), by_base[c])
            hit = _contains_stem_match(names, stem, variant_suffix)
            if hit is not None:
                return FileData(str(p), hit)
        elif p.is_dir():
            index = _dir_entry_index(str(p))
            for c in cands:
                if c in index:
                    return FileData(_pick_collision(index[c], mip_fd))
            hit = _contains_stem_match(
                (ps[0] for ps in index.values()), stem, variant_suffix)
            if hit is not None:
                # the matched basename may exist in several subtrees —
                # apply the same parent-directory disambiguation as the
                # exact-candidate path
                return FileData(_pick_collision(
                    index[os.path.basename(hit)], mip_fd))
    return None


def neurons_from_image_files(files: list[FileData], *,
                             library_name: str | None = None,
                             alignment_space: str | None = None,
                             neuron_cls=None) -> list[Neuron]:
    """Create minimal neuron entities from raw image files, used by the
    local-files search path (v2 readMIPsFromLocalFiles)."""
    from colormipsearch_tpu_torch.model import EMNeuron, LMNeuron

    cls = neuron_cls
    if cls is None:
        from colormipsearch_tpu_torch.io.naming import is_em_library
        cls = EMNeuron if is_em_library(library_name) else LMNeuron
    out = []
    for fd in files:
        base = os.path.basename(fd.name)
        stem = re.sub(r"\.[^.]+$", "", base)
        n = cls(mip_id=stem, library_name=library_name,
                alignment_space=alignment_space, published_name=stem)
        n.set_compute_file(ComputeFileType.InputColorDepthImage, fd)
        out.append(n)
    return out
