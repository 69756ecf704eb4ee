"""Persistent decode-once store of per-target shape-pass fields.

The shape (gradient-area-gap) pass is host-bound: per target it decodes
the CDM + GradientImage (+ ZGapImage or an r=20 dilation fallback) and
runs the slice LUT before the device kernel sees anything.  The
reference's answer is precomputed variant archives that STILL re-decode
every run (README.md:358 `_20pxRGBMAX` zips;
ShapeMatchColorDepthSearchAlgorithm.java:142-168).  In this store the
query-independent per-target fields are
computed once per library and persisted raw + mmap-able, so every later
run's per-target host work collapses to column gathers at the mask's
support rows.

Per target (one row each in three flat binary files):
  * ``zsl``  uint16 [H*W] — z-gap slice numbers (slice LUT applied to
    the ZGapImage, or to the dilation fallback when no variant exists)
  * ``grad`` uint16 [H*W] — gradient, pre-thresholded at GAP_THRESHOLD
  * ``tfg``  bitpacked [ceil(H*W/8)] — CDM foreground at maskThreshold
    (the excluded label region is applied at gather time, per mask, so
    rows are region-independent)

Rows are content-addressed: the key digests the source file identities
(path, size, mtime — zip entries include the archive identity) plus
every parameter baked into the row (mask_threshold for tfg; dilation
params + region when the z-gap fallback was used).  Appends go through
a lock + append-log index, so concurrent decode workers can write
behind; partial rows from a crash are orphaned data never referenced by
the index.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
from pathlib import Path

import numpy as np

LOG = logging.getLogger(__name__)

_FIELDS = ("zsl", "grad", "tfg")


def file_identity(fd) -> str | None:
    """Stat-based identity of a FileData source: path|size|mtime_ns
    (plus the entry name for zip members).  None if the file is absent
    (the caller falls back to the decode path)."""
    try:
        st = os.stat(fd.file_name)
    except OSError:
        return None
    base = f"{fd.file_name}|{st.st_size}|{st.st_mtime_ns}"
    if fd.entry_name:
        base += f"|{fd.entry_name}"
    return base


class ShapePackStore:
    """Append-only content-addressed store of shape-pass target rows.

    One store instance per directory; safe for concurrent appends from
    threads of one process (lock + append log).  Multiple processes may
    READ one store; concurrent multi-process builds of the same store
    are not coordinated (last index line wins — rows are immutable and
    content-addressed, so duplicates waste space but stay correct).
    """

    VERSION = 1

    def __init__(self, root: str | Path, h: int, w: int):
        self.root = Path(root)
        self.h, self.w = int(h), int(w)
        self.n_px = self.h * self.w
        self.row_bytes = {
            "zsl": self.n_px * 2,
            "grad": self.n_px * 2,
            "tfg": -(-self.n_px // 8),
        }
        self.root.mkdir(parents=True, exist_ok=True)
        meta_path = self.root / "meta.json"
        meta = {"version": self.VERSION, "h": self.h, "w": self.w}
        if meta_path.exists():
            existing = json.loads(meta_path.read_text())
            if existing != meta:
                raise ValueError(
                    f"store at {self.root} has meta {existing}, "
                    f"need {meta}")
        else:
            meta_path.write_text(json.dumps(meta))
        self._lock = threading.Lock()
        self._index: dict[str, int] = {}
        self._n_rows = 0
        self._mmaps: dict[str, np.ndarray] = {}
        # mapped row count PER FIELD: a single shared counter would stop
        # remapping the later fields after the store grows (the first
        # field's remap bumps the counter, leaving grad/tfg stale — and
        # the native tile pack would then read past the mapped region)
        self._mmap_rows: dict[str, int] = {}
        idx = self.root / "index.jsonl"
        if idx.exists():
            with idx.open() as f:
                for line in f:
                    if not line.strip():
                        continue
                    rec = json.loads(line)
                    self._index[rec["k"]] = rec["row"]
                    self._n_rows = max(self._n_rows, rec["row"] + 1)
        self.hits = 0
        self.misses = 0

    # ---- keys ----

    def entry_key(self, *, cdm_id: str, grad_id: str,
                  zgap_id: str | None, mask_threshold: int,
                  fallback_desc: str | None = None) -> str:
        """Digest of everything baked into a row.  ``zgap_id`` is the
        ZGapImage identity when a variant file exists; otherwise
        ``fallback_desc`` names the dilation parameters
        (threshold/radius/region) that produced the fallback z-gap."""
        z = zgap_id if zgap_id is not None else f"dilated[{fallback_desc}]"
        blob = "\n".join((f"v{self.VERSION}", f"{self.h}x{self.w}",
                          cdm_id, grad_id, z, f"thr={mask_threshold}"))
        return hashlib.sha1(blob.encode()).hexdigest()

    # ---- read ----

    def lookup(self, key: str) -> int | None:
        row = self._index.get(key)
        if row is None:
            self.misses += 1
        else:
            self.hits += 1
        return row

    def _field_mmap(self, field: str) -> np.ndarray:
        path = self.root / f"{field}.dat"
        rb = self.row_bytes[field]
        size = path.stat().st_size if path.exists() else 0
        n = size // rb
        mm = self._mmaps.get(field)
        if mm is None or self._mmap_rows.get(field, 0) < n:
            dtype = np.uint16 if field != "tfg" else np.uint8
            per_row = rb // dtype().itemsize
            self._mmaps[field] = np.memmap(
                path, dtype=dtype, mode="r", shape=(n, per_row))
            self._mmap_rows[field] = n
        return self._mmaps[field]

    def row(self, i: int):
        """(zsl uint16 [HW], grad uint16 [HW], tfg uint8 [ceil(HW/8)])
        memmap views of one row (no copies)."""
        with self._lock:
            return tuple(self._field_mmap(f)[i] for f in _FIELDS)

    def gather(self, field: str, rows: np.ndarray,
               cols: np.ndarray) -> np.ndarray:
        """[len(rows), len(cols)] 2D gather straight from the memmap —
        the tile-level read path (one vectorized gather per field per
        dispatch tile instead of per-target row reads)."""
        with self._lock:
            mm = self._field_mmap(field)
        return mm[np.ix_(np.asarray(rows), cols)]

    def field_maps(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(zsl, grad, tfg) row-major memmap views refreshed to the
        current row count — the zero-copy input of the native tile pack
        (io/native_decoder.shape_tile_from_store)."""
        with self._lock:
            return tuple(self._field_mmap(f) for f in _FIELDS)

    # ---- write ----

    def append(self, key: str, zsl: np.ndarray, grad_thr: np.ndarray,
               tfg_bits: np.ndarray) -> int:
        """Append one row; returns its index.  Idempotent per key."""
        assert zsl.dtype == np.uint16 and zsl.size == self.n_px
        assert grad_thr.dtype == np.uint16 and grad_thr.size == self.n_px
        assert tfg_bits.dtype == np.uint8 \
            and tfg_bits.size == self.row_bytes["tfg"]
        with self._lock:
            row = self._index.get(key)
            if row is not None:
                return row
            row = self._n_rows
            for field, arr in zip(_FIELDS, (zsl, grad_thr, tfg_bits)):
                with (self.root / f"{field}.dat").open("ab") as f:
                    f.write(arr.tobytes())
            with (self.root / "index.jsonl").open("a") as f:
                f.write(json.dumps({"k": key, "row": row}) + "\n")
            self._index[key] = row
            self._n_rows = row + 1
            return row

    def __len__(self) -> int:
        return self._n_rows


def build_row_fields(t_rgb: np.ndarray, grad: np.ndarray,
                     zgap_rgb: np.ndarray, *, mask_threshold: int):
    """Full-plane store fields from decoded images: the once-per-library
    half of ops/shape_score.select_target_cols_split.  Prefers the
    one-pass native twin (io/native_decoder.build_shape_row;
    bit-identical, tests/test_torch_shape.py); the numpy path below is
    the fallback and the test oracle."""
    from colormipsearch_tpu_torch.constants import GAP_THRESHOLD
    from colormipsearch_tpu_torch.io import native_decoder
    from colormipsearch_tpu_torch.ops.slice_lut import (
        get_slice_lut,
        slice_numbers_lut,
    )

    # gate on ALL input dtypes the native path assumes: build_shape_row
    # would silently wrap a non-uint8 image via ascontiguousarray while
    # the numpy fallback compares in the original dtype (bit-exactness)
    if grad.dtype == np.uint16 and t_rgb.dtype == np.uint8 \
            and zgap_rgb.dtype == np.uint8 and native_decoder.available():
        native = native_decoder.build_shape_row(
            t_rgb, grad, zgap_rgb, get_slice_lut(),
            mask_threshold=mask_threshold, gap_threshold=GAP_THRESHOLD)
        if native is not None:
            return native

    zsl = slice_numbers_lut(zgap_rgb).astype(np.uint16).reshape(-1)
    grad_thr = np.where(grad > GAP_THRESHOLD, grad, 0) \
        .astype(np.uint16).reshape(-1)
    tfg = (t_rgb > mask_threshold).any(axis=-1).reshape(-1)
    tfg_bits = np.packbits(tfg, bitorder="little")
    return zsl, grad_thr, tfg_bits
