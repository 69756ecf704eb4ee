"""MIP loading from plain files and zip archives.

The reference's `NeuronMIPUtils.loadComputeFile/openInputStream`
(mips/NeuronMIPUtils.java:66-80,171-236): load a neuron's compute file
whether it is a plain file or a zip entry (with a full-archive scan
fallback when the entry name does not match exactly).  Zip listings are
cached per archive (MIPsUtils.java:43,392-420).
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


def neurons_from_image_files(files: list[FileData], *,
                             library_name: str | None = None,
                             alignment_space: str | None = None
                             ) -> list[Neuron]:
    """Minimal neuron entities from raw image files (the library API's
    path arguments; v2 readMIPsFromLocalFiles)."""
    from colormipsearch_tpu_torch.io.naming import is_em_library
    from colormipsearch_tpu_torch.model import EMNeuron, LMNeuron

    cls = EMNeuron if is_em_library(library_name) else LMNeuron
    out = []
    for fd in files:
        stem = re.sub(r"\.[^.]+$", "", os.path.basename(fd.name))
        n = cls(mip_id=stem, library_name=library_name,
                alignment_space=alignment_space, published_name=stem)
        n.set_compute_file(ComputeFileType.InputColorDepthImage, fd)
        out.append(n)
    return out



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
