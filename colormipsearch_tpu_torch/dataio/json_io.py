"""Filesystem JSON readers/writers for neurons and matches.

Mirrors the reference's dataio/fs implementations so result files are
interchangeable:
  * neuron input lists — JSONCDMIPsReader (dataio/fs/JSONCDMIPsReader.java:31-55):
    a JSON array of neuron objects, read with optional offset/size,
  * grouped match files — JSONNeuronMatchesWriter/Reader
    (JSONNeuronMatchesWriter.java:42-87, JSONNeuronMatchesReader.java:37-95):
    one file per mask (or target) mip id with shape
    {"inputImage": <neuron>, "results": [<match with embedded "image">]}.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from pathlib import Path
from typing import Callable, Sequence

from colormipsearch_tpu_torch.model import CDMatch, Neuron, neuron_from_json
from colormipsearch_tpu_torch.results.grouping import (
    group_by_mask,
    group_by_target,
    sort_matches_desc,
)

LOG = logging.getLogger(__name__)


def read_neurons_json(path, offset: int = 0, size: int = -1) -> list[Neuron]:
    """Read a JSON array of neuron entities (JSONCDMIPsReader semantics)."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, list):
        raise ValueError(f"{path}: expected a JSON array of neurons")
    if offset > 0:
        data = data[offset:]
    if size > 0:
        data = data[:size]
    return [neuron_from_json(d) for d in data]


def write_neurons_json(neurons: Sequence[Neuron], path, *,
                       pretty: bool = True) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump([n.to_json() for n in neurons], f,
                  indent=2 if pretty else None)


def _dump(obj, path: Path, pretty: bool) -> None:
    # atomic: a crash mid-write must not leave a truncated file that
    # loses every previously flushed match for the group
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2 if pretty else None)
    os.replace(tmp, path)


class JSONMatchesWriter:
    """Write matches grouped per mask and/or per target mip id.

    One JSON file per group named `<mipId>.json`
    (JSONNeuronMatchesWriter.java:42-87 + ItemsWriterToJSONFile).
    """

    def __init__(self, per_masks_dir=None, per_targets_dir=None, *,
                 pretty: bool = True,
                 grouping: Callable[[Neuron], str] | None = None,
                 ordering: Callable[[CDMatch], tuple] | None = None):
        self.per_masks_dir = Path(per_masks_dir) if per_masks_dir else None
        self.per_targets_dir = Path(per_targets_dir) if per_targets_dir else None
        self.pretty = pretty
        self.grouping = grouping or (lambda n: n.mip_id or "")
        self.ordering = ordering or (lambda m: (
            -(m.normalized_score if m.normalized_score is not None else 0.0),
            -(m.matching_pixels or 0)))
        # files already written by THIS writer — append flushes merge
        # into these but overwrite stale files from earlier runs
        self._written: set = set()
        # streaming state per path: serialized rows kept sorted in
        # memory (row DICTS, not entities) so a flush neither re-reads
        # nor re-parses the file; dumps are deferred until a group has
        # ROWS_PER_DUMP fresh rows (or close()), turning the
        # O(flushes x file) rewrite pattern into amortized batches
        self._acc: dict = {}

    ROWS_PER_DUMP = 256

    def write(self, matches: Sequence[CDMatch], *,
              append: bool = False) -> int:
        """Write grouped files; with `append`, merge into existing files
        (the streaming flush path — each target tile's matches land in
        the per-mip files as they are scored, bounding RAM the way the
        reference's batched writes do, ColorDepthSearchCmd.java:297-316).
        """
        n = 0
        if self.per_masks_dir is not None:
            n += self._write_grouped(
                group_by_mask(matches, self.grouping, self.ordering),
                self.per_masks_dir, append=append)
        if self.per_targets_dir is not None:
            n += self._write_grouped(
                group_by_target(matches, self.grouping, self.ordering),
                self.per_targets_dir, append=append)
        return n

    # update == rewrite of the per-mask files (JSON backend semantics)
    def write_updates(self, matches: Sequence[CDMatch], _field_selectors=None) -> int:
        if self.per_masks_dir is None:
            return 0
        return self._write_grouped(
            group_by_mask(matches, self.grouping, self.ordering),
            self.per_masks_dir)

    def _write_grouped(self, groups, out_dir: Path, *,
                       append: bool = False) -> int:
        """One file per group, written concurrently like the reference's
        parallel stream (ItemsWriterToJSONFile.writeGroupedItemsList)."""
        import concurrent.futures

        def write_one(item):
            key_neuron, ms = item
            name = self.grouping(key_neuron)
            if not name:
                # a grouped file needs a mip id for its name; dropping
                # silently would leave "wrote N matches" lying
                LOG.warning(
                    "dropping %d matches: group neuron %s has no mip id",
                    len(ms), key_neuron.published_name or "<unnamed>")
                return 0
            path = out_dir / f"{name}.json"
            if append:
                # groups arrive already in file orientation (mask ==
                # inputImage; group_by_target pre-inverts).  Rows
                # accumulate in memory as serialized dicts; the file is
                # (re)written atomically when enough fresh rows pile up
                acc = self._acc.get(path)
                if acc is None:
                    prev = JSONMatchesReader.read_matches(path) \
                        if path in self._written else []
                    acc = {"neuron": key_neuron.to_json(),
                           "rows": [(self.ordering(m), self._match_json(m))
                                    for m in prev],
                           "dirty": 0}
                    self._acc[path] = acc
                acc["rows"].extend(
                    (self.ordering(m), self._match_json(m)) for m in ms)
                acc["dirty"] += len(ms)
                self._written.add(path)
                if acc["dirty"] >= self.ROWS_PER_DUMP:
                    self._dump_acc(path, acc)
                return len(ms)
            self._written.add(path)
            doc = {
                "inputImage": key_neuron.to_json(),
                "results": [self._match_json(m)
                            for m in sorted(ms, key=self.ordering)],
            }
            _dump(doc, path, self.pretty)
            return len(ms)

        groups = list(groups)
        if len(groups) > 4:
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=min(16, len(groups))) as pool:
                counts = list(pool.map(write_one, groups))
        else:
            counts = [write_one(g) for g in groups]
        return sum(counts)

    def _dump_acc(self, path: Path, acc: dict) -> None:
        acc["rows"].sort(key=lambda kr: kr[0])
        _dump({"inputImage": acc["neuron"],
               "results": [r for _, r in acc["rows"]]}, path, self.pretty)
        acc["dirty"] = 0

    def close(self) -> None:
        """Flush deferred streaming rows (call once after the last
        append-mode write)."""
        for path, acc in self._acc.items():
            if acc["dirty"]:
                self._dump_acc(path, acc)
        self._acc.clear()

    @staticmethod
    def _match_json(m: CDMatch) -> dict:
        # inside a grouped file the mask is the file-level inputImage;
        # each result embeds only the matched neuron (as "image")
        d = m.to_json()
        d.pop("maskImage", None)
        return d


class JSONMatchesReader:
    """Read grouped match files back to flat CDMatch lists."""

    @staticmethod
    def list_matches_locations(dirs_or_files: Sequence[str],
                               offset: int = 0, size: int = -1) -> list[str]:
        out: list[str] = []
        for loc in dirs_or_files:
            p = Path(loc)
            if p.is_dir():
                out.extend(sorted(str(f) for f in p.iterdir()
                                  if f.suffix == ".json"))
            elif p.exists():
                out.append(str(p))
        if offset > 0:
            out = out[offset:]
        if size > 0:
            out = out[:size]
        return out

    @staticmethod
    def read_matches(path, *, by_target: bool = False) -> list[CDMatch]:
        """Expand one grouped file; by_target inverts mask/matched so the
        returned matches always have mask == the file's inputImage side
        (MatchEntitiesGrouping.expandResultsByMask/Target).

        Flat JSON arrays of matches with embedded maskImage (the shape
        the reference's tests serialize directly) are accepted too.
        """
        with open(path) as f:
            doc = json.load(f)
        if isinstance(doc, list):
            rows = doc
            input_image = None
        else:
            rows = doc.get("results", ())
            input_image = neuron_from_json(doc["inputImage"]) \
                if doc.get("inputImage") else None
        out = []
        for rd in rows:
            m = CDMatch.from_json(rd, mask_image=input_image)
            if by_target:
                m = dataclasses.replace(
                    m, mask_image=m.matched_image, matched_image=m.mask_image,
                    mask_image_ref_id=m.matched_image_ref_id,
                    matched_image_ref_id=m.mask_image_ref_id)
            out.append(m)
        return out


def write_cds_session(output_dir, masks_sources, targets_sources,
                      params: dict, *, pretty: bool = True) -> Path:
    """Persist the CDS run parameters for provenance
    (dataio/fs/JSONCDSSessionWriter.java)."""
    out = Path(output_dir) / "cdsParameters.json"
    doc = {
        "masks": masks_sources,
        "targets": targets_sources,
        "params": params,
    }
    _dump(doc, out, pretty)
    return out


__all__ = [
    "JSONMatchesReader",
    "JSONMatchesWriter",
    "read_neurons_json",
    "write_neurons_json",
    "write_cds_session",
    "sort_matches_desc",
]
