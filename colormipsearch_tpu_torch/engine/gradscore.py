"""Gradient (shape) score engine on PyTorch devices.

The port of the JAX package's engine/gradscore.py. Computes the
gradient-area-gap negative scores for selected matches of a mask,
mirroring the flow of cmd/CalculateGradientScoresCmd.java:283-330: group
matches by (mask mipId, mask input file), build the query pipeline once
per group, score every match's target, then recompute normalized scores
against the per-mask maxima (:443-459).

The device path batches the targets of one mask into dispatch planes and
scores them with K5 (ops/shape_score.py). The planes come from one of
three places:

  * the default path: decoded images, support columns selected per
    target on the host and stacked into host planes;
  * the packed-variant store (``pack_store``): a host tile gather from
    the persisted per-target fields (io/shape_pack.py), no decode;
  * the device-resident store (``device_store`` or
    CDS_SHAPE_STORE_DEVICE=1): the store's fields uploaded once,
    pixel-major (K7), and each dispatch's planes built on the device
    (K6) from the mask's support positions.

With a device mesh (``use_mesh``) each dispatch's target columns are
padded to a multiple of the mesh size and scored by the sharded split-row
step (parallel/mesh.make_sharded_shape_split_step), K5 on every column
shard. The float64 oracle (oracle/shape.py) is the exact reference; with
``use_device=False`` it scores every pair.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Sequence

import numpy as np
import torch

from colormipsearch_tpu_torch.engine.cds import CDSParams
from colormipsearch_tpu_torch.io import mips as mips_io
from colormipsearch_tpu_torch.model import CDMatch, ComputeFileType
from colormipsearch_tpu_torch.oracle.shape import (
    ShapeMatchOracle,
    normalized_score,
)
from colormipsearch_tpu_torch.utils.metrics import GLOBAL

LOG = logging.getLogger(__name__)

_pool_lock = threading.Lock()
_decode_pools: dict = {}


def _shared_decode_pool(n_workers: int):
    import concurrent.futures

    with _pool_lock:
        pool = _decode_pools.get(n_workers)
        if pool is None:
            pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=n_workers,
                thread_name_prefix="gradscore-decode")
            _decode_pools[n_workers] = pool
        return pool


class GradScoreEngine:
    """Shape scoring of CDS matches.

    ``device`` is explicit: a CUDA device runs the hand-written kernels,
    the CPU runs their plain PyTorch versions. A CUDA device without a
    GPU is an error, never a silent CPU run. ``use_device=False`` scores
    every pair with the float64 oracle whatever the device is.
    ``use_mesh`` follows CDSearchEngine's rule (parallel.mesh.resolve_mesh)
    and applies to the device path only.
    """

    def __init__(self, params: CDSParams, *, device: torch.device | str,
                 use_device: bool = True, use_mesh: bool | None = None,
                 decode_workers: int | None = None,
                 pack_store: str | None = None,
                 device_store: bool | None = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {self.device} requested but CUDA is not available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        from colormipsearch_tpu_torch.parallel import mesh as pmesh

        if use_device and pmesh.world_size() > 1:
            # the JAX engine meshes across processes, then fails to pull
            # the sharded result on the host (its ops/shape_score.py:955)
            raise NotImplementedError(
                f"gradientScores across processes ({pmesh.world_size()} "
                "ranks): the JAX package has no cross-process shape pass "
                "either (ROADMAP.md §3); run it in one process")
        self._mesh = (pmesh.resolve_mesh(use_mesh, self.device)
                      if use_device else None)
        self._shape_split_step = None
        if self._mesh is not None:
            self._shape_split_step = pmesh.make_sharded_shape_split_step(
                self._mesh)
            LOG.info("shape scoring over a %d-device mesh", self._mesh.size)
        self.params = params
        self.use_device = use_device
        # device-resident shape store: None = off unless the
        # CDS_SHAPE_STORE_DEVICE env says otherwise; an explicit env
        # setting always wins over this parameter (the CLI passes the
        # >=32-mask auto-default here instead of mutating the process
        # env)
        self.device_store = device_store
        if decode_workers:
            # --cdsConcurrency: host decode/select thread count
            # (defaults to os.cpu_count via the class attribute)
            self.DECODE_WORKERS = decode_workers
        # decode-once packed-variant store (io/shape_pack.py): lazily
        # opened at the first group (needs the mask's H x W); rows are
        # written behind on decode misses, so the second run of a
        # library skips decode/dilation/LUT entirely
        self._pack_store_dir = pack_store
        self._pack_store = None
        self._dev_store_cache: dict = {}

    def score_matches(self, matches: Sequence[CDMatch], *,
                      roi_rgb: np.ndarray | None = None) -> list[CDMatch]:
        """Compute grad scores for the given (already selected) matches of
        one mask-file group set; returns only matches that got a score."""
        # group by (mask mipId, mask input file) — simpleGroupByMaskFields
        groups: dict[tuple, list[CDMatch]] = {}
        for m in matches:
            if m.mask_image is None or m.matched_image is None:
                continue
            fd = m.mask_image.compute_file(ComputeFileType.InputColorDepthImage)
            key = (m.mask_image.mip_id, fd.name if fd else None)
            groups.setdefault(key, []).append(m)

        def load_and_prep(group):
            """Mask decode + query pack for one group — prefetched on
            the pool one group ahead, because the r=60/r=20 dilations
            cost ~0.5 s serially at each group's head."""
            mask_mip = mips_io.load_compute_file(
                group[0].mask_image, ComputeFileType.InputColorDepthImage)
            if not mask_mip.has_image:
                return None
            mask_rgb = mask_mip.image.as_rgb()
            h, w = mask_rgb.shape[:2]
            region = self.params.shape_excluded_region(h, w)
            prep = self._prep_group_query(mask_rgb, region, roi_rgb) \
                if self.use_device else None
            return mask_rgb, region, prep

        scored: list[CDMatch] = []
        scored_by_mask: dict = {}
        items = list(groups.items())
        pool = self._decode_pool()
        fut = pool.submit(load_and_prep, items[0][1]) if items else None
        for i, ((mip_id, _), group) in enumerate(items):
            t0 = time.time()
            res = fut.result()
            fut = pool.submit(load_and_prep, items[i + 1][1]) \
                if i + 1 < len(items) else None
            if res is None:
                LOG.error("no image found for mask %s", mip_id)
                continue
            mask_rgb, region, prep = res
            h, w = mask_rgb.shape[:2]
            if self.use_device:
                n_ok = self._score_group_device(
                    mask_rgb, region, roi_rgb, group, (h, w), prep=prep)
            else:
                n_ok = self._score_group_oracle(
                    mask_rgb, region, roi_rgb,
                    self._iter_group_tiles(group, (h, w), region))
            ok = [m for m in group if m.has_grad_score()]
            scored.extend(ok)
            scored_by_mask.setdefault(mip_id, []).extend(ok)
            LOG.info("grad-scored %d/%d matches of %s in %.1fs",
                     n_ok, len(group), mip_id, time.time() - t0)

        if matches and not scored:
            LOG.warning(
                "0 matches grad-scored: every target lacked a usable "
                "GradientImage variant (or a mask-shaped CDM).  Provide "
                "gradient/zgap variants via the input's computeFiles")
        # normalization maxima are PER MASK — the reference computes them
        # over one mask mipId's matches (CalculateGradientScoresCmd:443-459)
        for mask_matches in scored_by_mask.values():
            update_normalized_scores(mask_matches)
        return scored

    # tile lookahead: while the device scores tile i, tile i+1..i+N
    # decode+pack (the per-target work inside a tile parallelizes over
    # DECODE_WORKERS, so 2 in-flight tiles suffice to hide the device)
    PREFETCH_WORKERS = 2
    # per-target decode+select threads shared by all tiles: native
    # decode and numpy gathers release the GIL, so this scales with
    # cores
    DECODE_WORKERS = None  # default: os.cpu_count()

    def _iter_group_tiles(self, group, mask_shape, region, prep=None,
                          select=None, store_ctx=None):
        """Stream GROUP_TILE-sized lists of loaded targets with
        PREFETCH_WORKERS-deep lookahead (in-order yield): while the
        device scores tile i, tiles i+1..i+N decode.  The per-target
        work inside each tile fans out over the shared decode pool (see
        _load_group_targets).

        `select` runs per target inside the decode workers (entries
        become (match, select_result)); `prep` runs on the loaded tile
        and its result is what gets yielded — the device path passes
        the support-column slice and the tile assembly here so both
        overlap the previous tile's device dispatch."""
        import collections
        import concurrent.futures

        def load(chunk):
            loaded = self._load_group_targets(chunk, mask_shape, region,
                                              select=select,
                                              store_ctx=store_ctx)
            return prep(loaded) if prep is not None else loaded

        chunks = [group[i:i + self.GROUP_TILE]
                  for i in range(0, len(group), self.GROUP_TILE)]
        if len(chunks) <= 1:
            for c in chunks:
                yield load(c)
            return
        n_workers = max(1, self.PREFETCH_WORKERS)
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=n_workers) as pool:
            pending = collections.deque(
                pool.submit(load, c) for c in chunks[:n_workers])
            nxt = n_workers
            while pending:
                loaded = pending.popleft().result()
                if nxt < len(chunks):
                    pending.append(pool.submit(load, chunks[nxt]))
                    nxt += 1
                yield loaded

    def _decode_pool(self):
        """Per-target decode/select pool, shared process-wide by size
        (engines are created per command; a per-engine pool would leak
        idle threads across test runs)."""
        return _shared_decode_pool(self.DECODE_WORKERS
                                   or os.cpu_count() or 4)

    def _get_pack_store(self, mask_shape):
        if self._pack_store_dir is None:
            return None
        if self._pack_store is None:
            from colormipsearch_tpu_torch.io.shape_pack import (
                ShapePackStore,
            )

            self._pack_store = ShapePackStore(
                self._pack_store_dir, *mask_shape)
            LOG.info("packed-variant store %s: %d rows",
                     self._pack_store_dir, len(self._pack_store))
        return self._pack_store

    def _device_store_fields(self, store):
        """Device-resident store fields (CDS_SHAPE_STORE_DEVICE=1, or the
        engine's device_store): uploaded once per store and reused by
        every mask's device tile build. Returns (fields, row count) or
        None when the device store is off."""
        env = os.environ.get("CDS_SHAPE_STORE_DEVICE")
        if env is not None:
            if env != "1":
                return None  # explicit off wins over the auto-default
        elif not self.device_store:
            return None
        from colormipsearch_tpu_torch.ops import common, shape_score

        # small dict keyed by store identity: fields upload ONCE per
        # store and are PINNED at their upload-time row count — when
        # the store grows mid-run (every mask appends a few missed rows
        # while the store is being built), re-uploading the multi-GB
        # fields per growth would dominate the run.  Rows beyond the
        # pinned count are served by the HOST tile pack (the caller
        # partitions on dev_len); the next run uploads the then-complete
        # store.
        cache = self._dev_store_cache
        cached = cache.get(id(store))
        if cached is not None and cached[0] is store:
            if len(store) > cached[2] and not cached[3]:
                LOG.info("device store fields pinned at %d rows; the "
                         "%d newer rows use the host tile pack this "
                         "run", cached[2], len(store) - cached[2])
                cache[id(store)] = cached[:3] + (True,)
            return cached[1], cached[2]
        while len(cache) >= 2:  # two stores may alternate; bound memory
            cache.pop(next(iter(cache)))
        t_up = time.time()
        fields = shape_score.device_store_fields(store, self.device)
        common.synchronize(self.device)  # honest stage timing
        n_bytes = sum(f.numel() * f.element_size() for f in fields)
        GLOBAL.add("gs.storeUpload.seconds", time.time() - t_up)
        GLOBAL.add("gs.storeUploadBytes", n_bytes)
        dev_len = fields[0].shape[1]
        cache[id(store)] = (store, fields, dev_len, False)
        LOG.info("uploaded %d store rows to %s (%.1f GB) in %.1fs",
                 dev_len, self.device, n_bytes / 1e9, time.time() - t_up)
        return fields, dev_len

    def _store_ctx(self, mask_shape, region, pos_gap, n_gap_pad,
                   pos_he, n_he_w):
        """Once-per-group state for the packed-store fast path: the
        store handle, the mask's gather plan, and the row-key builder
        (region fingerprint folded into the dilation-fallback key)."""
        store = self._get_pack_store(mask_shape)
        if store is None:
            return None
        import hashlib

        from colormipsearch_tpu_torch.io.shape_pack import file_identity
        from colormipsearch_tpu_torch.ops import shape_score

        p = self.params
        gather_plan = shape_score.split_gather_plan(
            pos_gap, pos_he, mask_shape[1], mirror=p.mirror_mask,
            excluded=region)
        region_fp = hashlib.sha1(
            np.packbits(region).tobytes()).hexdigest()[:12] \
            if region is not None else "none"
        fallback_desc = (f"thr={p.mask_threshold},r={p.negative_radius},"
                         f"region={region_fp}")

        def key_of(target, *, zgap_used: bool | None):
            """Row key for a target.  zgap_used=None (lookup time) keys
            optimistically on the variant file when one exists; the
            append after a decode passes what was actually used, so a
            shape-mismatched variant can never alias the fallback row."""
            cdm = target.compute_file(ComputeFileType.InputColorDepthImage)
            grad = target.compute_file(ComputeFileType.GradientImage)
            if cdm is None or grad is None:
                return None
            cdm_id = file_identity(cdm)
            grad_id = file_identity(grad)
            if cdm_id is None or grad_id is None:
                return None
            zgap = target.compute_file(ComputeFileType.ZGapImage)
            zgap_id = file_identity(zgap) if zgap is not None else None
            if zgap_used is False:
                zgap_id = None
            return store.entry_key(
                cdm_id=cdm_id, grad_id=grad_id, zgap_id=zgap_id,
                mask_threshold=p.mask_threshold,
                fallback_desc=fallback_desc)

        return store, gather_plan, key_of, (pos_gap, n_gap_pad, n_he_w)

    def _load_group_targets(self, group, mask_shape, region, select=None,
                            store_ctx=None):
        """Load target/gradient/zgap images for each match; matches with
        missing target or gradient get gradientAreaGap = -1 (the
        reference's hasGradScore filter then drops them).

        Targets decode in parallel on the shared decode pool.  With
        `select`, each worker applies it to (t_rgb, grad, zgap) right
        after decoding and the entry becomes (match, select_result) —
        the device path passes the per-target support-column slice
        here, so the multi-MB images are dropped per TARGET and never
        accumulate per tile."""
        from colormipsearch_tpu_torch.io import cache as mips_cache
        from colormipsearch_tpu_torch.oracle.shape import (
            clear_region,
            dilate_rgb,
            mask_rgb as mask_fn,
        )

        def load_one(m):
            target = m.matched_image
            t_mip = mips_cache.load_mip(
                target, ComputeFileType.InputColorDepthImage)
            if not t_mip.has_image or \
                    t_mip.image.pixels.shape[:2] != mask_shape:
                m.gradient_area_gap = -1
                m.high_expression_area = -1
                return None
            g_mip = mips_cache.load_mip(
                target, ComputeFileType.GradientImage)
            if not g_mip.has_image:
                # shape scoring requires the gradient variant
                # (ShapeMatchColorDepthSearchAlgorithm:142-144)
                m.gradient_area_gap = -1
                m.high_expression_area = -1
                return None
            grad = g_mip.image.pixels
            if grad.ndim == 3:
                # gradient images are 16-bit gray; tolerate RGB encodes
                grad = grad.astype(np.int32).max(axis=-1)
            if grad.shape != mask_shape:
                m.gradient_area_gap = -1
                m.high_expression_area = -1
                return None
            z_mip = mips_cache.load_mip(
                target, ComputeFileType.ZGapImage)
            t_rgb = t_mip.image.as_rgb()
            zgap_used = z_mip.has_image and \
                z_mip.image.pixels.shape[:2] == mask_shape
            if zgap_used:
                zgap = z_mip.image.as_rgb()
            else:
                # on-the-fly dilation fallback
                # (ShapeMatchColorDepthSearchAlgorithm:166-168)
                zgap = dilate_rgb(
                    mask_fn(clear_region(t_rgb, region),
                            self.params.mask_threshold),
                    self.params.negative_radius)
            grad = grad.astype(np.uint16)
            if store_ctx is not None:
                # write behind: persist the full-plane fields so every
                # later run of this library skips the decode path
                from colormipsearch_tpu_torch.io.shape_pack import (
                    build_row_fields,
                )

                store, _, key_of, _ = store_ctx
                key = key_of(target, zgap_used=zgap_used)
                if key:
                    store.append(key, *build_row_fields(
                        t_rgb, grad, zgap,
                        mask_threshold=self.params.mask_threshold))
            if select is not None:
                return (m, select(t_rgb, grad, zgap))
            return (m, t_rgb, grad, zgap)

        results = self._decode_pool().map(load_one, group)
        return [r for r in results if r is not None]

    # targets per decode/pack chunk (the device path holds full images
    # only per in-flight DECODE_WORKER; tiles carry the small
    # support-column slices; the oracle path still holds a full tile)
    GROUP_TILE = 512
    # targets per device dispatch: packed chunks accumulate to this
    # width before scoring (wide columns amortize dispatch overhead),
    # narrowed for dense masks so one dispatch plane stays under
    # DISPATCH_PLANE_BYTES. Both keep the JAX engine's values, so the
    # two packages dispatch alike (PERF.md, open questions).
    DISPATCH_TILE = 4096
    DISPATCH_PLANE_BYTES = 512e6

    def _prep_group_query(self, mask_rgb, region, roi_rgb):
        """Per-mask query packing (r=60/r=20 dilations) — the serial
        ~0.5 s head of each group, so score_matches prefetches the NEXT
        group's prep on the pool while the current group streams.
        Returns (q_gap, q_he, pos_gap, n_gap_pad, pos_he, n_he_w)."""
        from colormipsearch_tpu_torch.ops import shape_score
        from colormipsearch_tpu_torch.oracle.shape import clear_region

        p = self.params
        roi_keep = None
        roi_keep_m = None
        if roi_rgb is not None:
            roi = clear_region(roi_rgb, region)
            roi_keep = roi.astype(np.int32).sum(axis=-1) > 0
            roi_keep_m = roi_keep[:, ::-1]
        t_qp = time.time()
        q_pack = shape_score.pack_query(
            mask_rgb, excluded_region=region, roi_keep=roi_keep)
        GLOBAL.add("gs.queryPack.seconds", time.time() - t_qp)
        q_pack_m = None
        if p.mirror_mask and roi_keep is not None:
            q_pack_m = shape_score.pack_query(
                mask_rgb, excluded_region=region, roi_keep=roi_keep_m)
        # split support rows: gap rows (query non-black — grad|slice
        # data) and he rows (r=60 ring — one foreground bit); disjoint
        # by construction, so each row runs only the term it can affect
        pos_gap, pos_he = shape_score.support_split(q_pack, q_pack_m)
        n_gap_pad = shape_score.support_bucket(pos_gap.size, minimum=1024)
        n_he_w = shape_score.he_words(pos_he.size)
        packs = [q_pack] + ([q_pack_m] if q_pack_m is not None
                            else [q_pack] if p.mirror_mask else [])
        qs = [shape_score.sparse_query_split(qp, pos_gap, n_gap_pad,
                                             pos_he, n_he_w)
              for qp in packs]
        q_gap = np.stack([g for g, _ in qs])
        q_he = np.stack([h for _, h in qs])
        return q_gap, q_he, pos_gap, n_gap_pad, pos_he, n_he_w

    def _score_group_device(self, mask_rgb, region, roi_rgb,
                            group, mask_shape, prep=None) -> int:
        from colormipsearch_tpu_torch.ops import common, shape_score

        p = self.params
        if prep is None:
            prep = self._prep_group_query(mask_rgb, region, roi_rgb)
        q_gap, q_he, pos_gap, n_gap_pad, pos_he, n_he_w = prep

        def select_cols(t_rgb, grad, zgap):
            # runs per target inside the decode workers: the support
            # columns are sliced right after decode and the multi-MB
            # images dropped per target (select_target_cols_split)
            return shape_score.select_target_cols_split(
                t_rgb, grad, zgap, pos_gap, n_gap_pad, pos_he, n_he_w,
                mask_threshold=p.mask_threshold, excluded=region,
                mirror=p.mirror_mask)

        def pack_tile(loaded):
            # runs inside the prefetch worker: tile assembly (stack of
            # the per-target columns) overlaps the previous tile's
            # device dispatch
            if not loaded:
                return [], None
            t_gap, t_he = shape_score.assemble_target_rows_split(
                [c for _, c in loaded], n_gap_pad, n_he_w,
                mirror=p.mirror_mask)
            return [m for m, _ in loaded], (t_gap, t_he)

        # decode/pack streams in GROUP_TILE chunks (host-image bound),
        # but the packed planes are small, so accumulate them HOST-side
        # and dispatch DISPATCH_TILE-wide: wide columns amortize
        # per-dispatch overhead, and one upload per dispatch keeps
        # device memory at a single plane set
        n = 0
        acc: list[tuple[list, object, object]] = []
        acc_t = 0
        bytes_per_target = 2 * (n_gap_pad + n_he_w) * 4
        dispatch_tile = max(512, min(
            self.DISPATCH_TILE,
            int(self.DISPATCH_PLANE_BYTES / bytes_per_target)))

        def flush():
            nonlocal n, acc, acc_t
            if not acc:
                return
            if len(acc) == 1:
                matches, t_gap, t_he = acc[0]
            else:
                matches = [m for ms, _, _ in acc for m in ms]
                t_gap = np.concatenate([g for _, g, _ in acc], axis=2)
                t_he = np.concatenate([h for _, _, h in acc], axis=2)
            t_pad = shape_score.support_bucket(len(matches), minimum=512)
            if t_pad > len(matches):
                padw = ((0, 0), (0, 0), (0, t_pad - len(matches)))
                t_gap = np.pad(t_gap, padw)
                t_he = np.pad(t_he, padw)
            n += self._score_group_tile(q_gap, q_he, matches,
                                        (t_gap, t_he))
            acc, acc_t = [], 0

        store_ctx = self._store_ctx(mask_shape, region, pos_gap,
                                    n_gap_pad, pos_he, n_he_w)
        if store_ctx is not None:
            # store fast lane: targets with a persisted row skip the
            # decode stream entirely — one vectorized tile gather per
            # dispatch (select_target_tile_from_store); only the misses
            # go through decode (and write their rows behind)
            store, gather_plan, key_of, _ = store_ctx
            t_lookup = time.time()
            hits, misses = [], []
            for m in group:
                key = key_of(m.matched_image, zgap_used=None)
                row = store.lookup(key) if key else None
                (hits if row is not None else misses).append((m, row))
            group = [m for m, _ in misses]
            # ascending store rows: neighbouring plane columns gather
            # neighbouring field bytes (each match keeps its own column)
            hits.sort(key=lambda hr: hr[1])
            GLOBAL.add("gs.storeLookup.seconds", time.time() - t_lookup)
            dev = self._device_store_fields(store) if hits else None
            dev_fields = dev[0] if dev else None
            if dev_fields is not None:
                # rows appended AFTER the one-time field upload are
                # served by the host tile pack this run (the fields stay
                # pinned at their upload-time row count)
                dev_len = dev[1]
                late = [hr for hr in hits if hr[1] >= dev_len]
                hits = [hr for hr in hits if hr[1] < dev_len]
            else:
                late = []
            chunks = [(hits[i:i + dispatch_tile], dev_fields is not None)
                      for i in range(0, len(hits), dispatch_tile)]
            chunks += [(late[i:i + dispatch_tile], False)
                       for i in range(0, len(late), dispatch_tile)]
            tile_pos = None
            for chunk, on_device in chunks:
                if on_device:
                    # device-resident store: only the mask's support
                    # positions (once per group) and the chunk's row
                    # indices cross to the device, and the built planes
                    # STAY there (the T-axis pad runs there too)
                    t_build = time.time()
                    if tile_pos is None:
                        g_pos, h_pos, keep_he = gather_plan
                        tile_pos = shape_score.tile_positions(
                            pos_gap, g_pos, h_pos, keep_he,
                            n_gap_pad=n_gap_pad, n_he_words=n_he_w,
                            mirror=p.mirror_mask, device=self.device)
                        GLOBAL.add("gs.wireBytes", sum(
                            a.numel() * a.element_size()
                            for a in tile_pos[:4]))
                    # on the host: K6 checks its range there
                    rows_sel = torch.tensor([r for _, r in chunk],
                                            dtype=torch.int32)
                    GLOBAL.add("gs.wireBytes", 4 * len(chunk))
                    t_gap, t_he = shape_score.shape_tile_device(
                        dev_fields, rows_sel, tile_pos,
                        n_gap_pad=n_gap_pad, n_he_words=n_he_w)
                    t_pad_d = shape_score.support_bucket(
                        len(chunk), minimum=512)
                    if t_pad_d > len(chunk):
                        padw = (0, t_pad_d - len(chunk))
                        t_gap = torch.nn.functional.pad(t_gap, padw)
                        t_he = torch.nn.functional.pad(t_he, padw)
                    common.synchronize(self.device)  # honest stage time
                    GLOBAL.add("gs.deviceTileBuild.seconds",
                               time.time() - t_build)
                    n += self._score_group_tile(
                        q_gap, q_he, [m for m, _ in chunk],
                        (t_gap, t_he))
                    continue
                t_gather = time.time()
                t_gap, t_he = \
                    shape_score.select_target_tile_from_store(
                        store, [r for _, r in chunk], pos_gap,
                        n_gap_pad, n_he_w, gather_plan,
                        mirror=p.mirror_mask)
                GLOBAL.add("gs.storeGather.seconds",
                           time.time() - t_gather)
                GLOBAL.add("gs.wireBytes", t_gap.nbytes + t_he.nbytes)
                t_pad = shape_score.support_bucket(len(chunk), minimum=512)
                if t_pad > len(chunk):
                    padw = ((0, 0), (0, 0), (0, t_pad - len(chunk)))
                    t_gap = np.pad(t_gap, padw)
                    t_he = np.pad(t_he, padw)
                n += self._score_group_tile(q_gap, q_he,
                                            [m for m, _ in chunk],
                                            (t_gap, t_he))
            if hits or late:
                n_hit = len(hits) + len(late)
                LOG.info("packed store: %d/%d targets served without "
                         "decode", n_hit, n_hit + len(group))
            if not group:
                return n
        for matches, planes in self._iter_group_tiles(
                group, mask_shape, region, prep=pack_tile,
                select=select_cols, store_ctx=store_ctx):
            if matches:
                acc.append((matches, planes[0], planes[1]))
                acc_t += len(matches)
                if acc_t >= dispatch_tile:
                    flush()
        flush()
        return n

    def _pairs_split_fn(self, n_targets: int):
        """The mesh's sharded split-row step over column shards of the
        planes, or None (no mesh, or n_targets does not divide)."""
        if self._mesh is None or n_targets % self._mesh.size:
            return None
        from colormipsearch_tpu_torch.parallel.mesh import (
            shard_target_planes,
        )

        def fn(t_gap, q_gap, t_he, q_he):
            return self._shape_split_step(
                shard_target_planes(self._mesh, t_gap), q_gap,
                shard_target_planes(self._mesh, t_he), q_he)

        return fn

    def _score_group_tile(self, q_gap, q_he, matches, planes) -> int:
        from colormipsearch_tpu_torch.ops import shape_score

        t_gap, t_he = planes
        n_real = len(matches)
        if self._mesh is not None:
            # pad T to the mesh size so the mesh path always applies
            # (zero columns are neutral: no foreground, zero gaps)
            pad = (-t_gap.shape[2]) % self._mesh.size
            if pad and isinstance(t_gap, torch.Tensor):
                t_gap = torch.nn.functional.pad(t_gap, (0, pad))
                t_he = torch.nn.functional.pad(t_he, (0, pad))
            elif pad:
                t_gap = np.pad(t_gap, ((0, 0), (0, 0), (0, pad)))
                t_he = np.pad(t_he, ((0, 0), (0, 0), (0, pad)))
        t_disp = time.time()
        gap, he, _ = shape_score.score_shape_batch_split(
            t_gap, t_he, q_gap, q_he, device=self.device,
            pairs_split_fn=self._pairs_split_fn(t_gap.shape[2]))
        GLOBAL.add("gs.dispatch.seconds", time.time() - t_disp)
        gap, he = gap[:n_real], he[:n_real]
        for i, m in enumerate(matches):
            m.gradient_area_gap = int(gap[i])
            m.high_expression_area = int(he[i])
            # note: the shape pass does not change the pixel-match
            # `mirrored` flag on the entity (reference keeps the CDS one)
        return len(matches)

    def _score_group_oracle(self, mask_rgb, region, roi_rgb, tiles) -> int:
        oracle = ShapeMatchOracle(
            mask_rgb, self.params.mask_threshold,
            mirror=self.params.mirror_mask,
            negative_radius=self.params.negative_radius,
            excluded_region=region,
            roi_mask_rgb=roi_rgb)
        n = 0
        for loaded in tiles:
            for m, t_rgb, grad, zgap in loaded:
                res = oracle.score(t_rgb, grad, zgap)
                m.gradient_area_gap = res.gradient_area_gap
                m.high_expression_area = res.high_expression_area
            n += len(loaded)
        return n


def update_normalized_scores(matches: list[CDMatch]) -> None:
    """Per-mask-group normalization
    (CalculateGradientScoresCmd.updateNormalizedScores:443-459)."""
    if not matches:
        return
    max_pixels = max((m.matching_pixels if m.matching_pixels is not None
                      else -1) for m in matches)
    max_neg = max(m.negative_score() for m in matches)
    for m in matches:
        m.normalized_score = float(normalized_score(
            m.matching_pixels or 0, m.gradient_area_gap,
            m.high_expression_area, max_pixels, max_neg))
