"""Color depth search engine (pixel-match pass) on PyTorch devices.

The port of the JAX package's engine/cds.py, replacing the reference's
per-pair threaded loop
(cmd/cdsprocess/LocalColorMIPSearchProcessor.java:51-124):

  * targets are decoded once per shard and packed into pixel-major
    planes resident on the device: rank-key planes (sparse COO upload +
    K1, or the dense stack + K8 with CDS_DENSE_UPLOAD=1) or, on the
    packed path, summary planes (dense stack + K8),
  * each mask is compiled into a plan and a batch of masks is scored
    against a whole target shard in one kernel launch. The kernel is
    chosen as the JAX engine chooses it: the full-union lane kernel (K3,
    lane tables expanded on the device by K2; the default), the x-union
    lane kernel (K3 with one row set per dy), the classic key kernel
    (K10) or the packed banded kernel (K9); with CDS_SPLIT_PLANES=1 the
    packed path without a top-k re-encodes each shard's summary planes
    into the 3-byte split pair (K12) at first use and scores on it (K11),
  * on the packed path the device also counts, per pair, the elements
    whose verdict lies in the f32 ambiguity band; flagged pairs are
    rescored by the float64 PixelMatchOracle,
  * an optional negative query (PixelMatchColorDepthSearchAlgorithm:
    29-57, 195-217) is scored by K10 on key planes or K9 on summary
    planes and subtracted,
  * with a positive pctPositivePixels the union paths pull only a
    per-mask top-k (K4), with a lossless dense fallback when a dropped
    pair could still emit,
  * with a device mesh (``use_mesh``, parallel/mesh.py) each target shard's
    planes are cut into D contiguous column shards, one a mesh device,
    and the sharded steps score every mask batch against all of them; a
    per-mask top-k is then taken per column shard and merged. A mesh
    across processes (parallel.mesh.init_distributed) holds in each
    process only its block of columns, and each process emits only the
    matches of its own columns (per-process sharded writes, as the JAX
    engine does under jax.distributed),
  * matches are assembled into CDMatch entities with the semantics of
    AbstractColorMIPSearchProcessor.findPixelMatch:59-90 (matchingPixels,
    matchingPixelsRatio == initial normalizedScore, mirrored, isMatch
    filter from ColorMIPSearch.isMatch:42-45).

Every path's final scores are exact (interval tables bisected against
the float64 oracle; the banded path's flagged pairs rescored by it), so
they are bit-identical to the JAX package's.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import os
import threading
import time
import zipfile
from typing import Iterable, Sequence

import numpy as np
import torch

from colormipsearch_tpu_torch import convert
from colormipsearch_tpu_torch.io import mips as mips_io
from colormipsearch_tpu_torch.model import (
    CDMatch,
    ComputeFileType,
    Neuron,
    ProcessingType,
)
from colormipsearch_tpu_torch.oracle.pixel import (
    PixelMatchOracle,
    label_regions_mask,
    shift_offsets,
)
from colormipsearch_tpu_torch.ops import common, pixel_match
from colormipsearch_tpu_torch.parallel import mesh as pmesh
from colormipsearch_tpu_torch.utils.metrics import GLOBAL as _METRICS

LOG = logging.getLogger(__name__)


# the items of ROADMAP.md §1 ("Modules still to port") that a caller of
# not_ported can name
ROADMAP_ITEMS = {7: "the network clients"}


def not_ported(what: str, item: int) -> NotImplementedError:
    """The error for a configuration the port does not have yet; `item`
    is its entry in ROADMAP.md §1."""
    return NotImplementedError(
        f"{what} is not in the PyTorch port yet; it comes with "
        f"{ROADMAP_ITEMS[item]} (ROADMAP.md §1, port item {item})")


@dataclasses.dataclass
class CDSParams:
    """Shared CDS parameters (cmd/AbstractColorDepthMatchArgs.java)."""
    mask_threshold: int = 100
    data_threshold: int = 100
    pix_color_fluctuation: float = 2.0
    xy_shift: int = 0
    mirror_mask: bool = False
    pct_positive_pixels: float = 0.0
    negative_radius: int = 20
    border_size: int = 0
    with_name_label_region: bool = False
    with_color_scale_region: bool = False
    processing_partition_size: int = 100

    def __post_init__(self):
        if self.xy_shift % 2 != 0:
            # reference validates xyShift is even (factory :59-61)
            raise ValueError("xyShift must be an even value")
        if not (float(self.pix_color_fluctuation) >= 0):
            # the interval tables' exactness proofs cover z >= 0 only
            raise ValueError("pixColorFluctuation must be >= 0")

    def excluded_region(self, height: int, width: int) -> np.ndarray | None:
        if not (self.with_name_label_region or self.with_color_scale_region):
            return None
        return label_regions_mask(
            width, height,
            with_name_label=self.with_name_label_region,
            with_color_scale_label=self.with_color_scale_region)

    def shape_excluded_region(self, height: int,
                              width: int) -> np.ndarray | None:
        """Label regions + the borderSize frame — the shape provider
        creates the query LImage with borders
        (ColorDepthSearchAlgorithmProviderFactory:113); the pixel-match
        pass does not use the border."""
        region = self.excluded_region(height, width)
        if self.border_size <= 0:
            return region
        b = self.border_size
        border = np.ones((height, width), dtype=bool)
        if height > 2 * b and width > 2 * b:
            border[b:height - b, b:width - b] = False
        return border if region is None else (region | border)

    def as_map(self) -> dict:
        """CDS parameter audit map (ColorMIPSearch.getCDSParameters)."""
        return {
            "mirrorMask": str(self.mirror_mask),
            "dataThreshold": str(self.data_threshold),
            "pixColorFluctuation": str(self.pix_color_fluctuation),
            "xyShift": str(self.xy_shift),
            "negativeRadius": str(self.negative_radius),
            "borderSize": str(self.border_size),
            "pctPositivePixels": str(self.pct_positive_pixels),
            "defaultMaskThreshold": str(self.mask_threshold),
        }


@dataclasses.dataclass
class TargetShard:
    """Packed targets of one image shape, device-resident.

    ``kind`` "keys": int32 [P+1, t_pad] rank-key planes; "packed": int32
    [P, t_pad] summary planes (uint32 bits), beside them the split pair
    (int16 [P, t_pad] (p << 8) | s bits, uint8 [P, t_pad] cls) once the
    split-plane kernel asks for it (``split_planes``). Raw pixels are not
    kept once packed (a flagged pair re-decodes its one target,
    host_rgb), except that shards after the first hold their decoded
    uint8 stack on the HOST (``host_stack``) until the consumer packs
    them, so only one packed plane set is ever resident on the device
    (ensure_planes)."""
    neurons: list[Neuron]
    shape: tuple[int, int]                 # (H, W)
    planes: torch.Tensor | None
    device: torch.device
    kind: str = "keys"
    file_type: ComputeFileType = ComputeFileType.InputColorDepthImage
    # the data threshold folded into the planes (the kernels then run
    # with target_threshold=-1)
    packed_threshold: int = 0
    # padded target-axis width (kernel shape)
    t_pad: int = 0
    host_stack: np.ndarray | None = None
    # lazy split-plane pair (CDS_SPLIT_PLANES=1), made from `planes`
    # (its column shards under a mesh)
    split_planes: tuple | None = None
    # the column shards of `planes` over the engine's mesh (lazy; the
    # unsharded planes are released once they exist)
    device_planes: tuple | None = None

    def __post_init__(self):
        if not self.t_pad and self.planes is not None:
            self.t_pad = self.planes.shape[1]

    @property
    def count(self) -> int:
        return len(self.neurons)

    def ensure_planes(self) -> None:
        """Pack the deferred host stack onto the device (no-op for
        eagerly-packed shards).  Callers release the PREVIOUS shard
        first so only one packed plane set is ever resident."""
        if self.planes is not None or self.host_stack is None:
            return
        t0 = time.time()
        self.planes = _pack_target_stack(self.host_stack, self.t_pad,
                                         self.kind, self.packed_threshold,
                                         self.device)
        common.synchronize(self.device)  # honest stage timing
        _METRICS.add("cds.packUpload.seconds", time.time() - t0)
        self.host_stack = None

    def split_pair(self) -> tuple:
        """The split-plane pair of the summary planes, made by K12 at
        first use (JAX engine/cds.py _split_planes); the summary planes
        stay for a negative query's pass."""
        if self.split_planes is None:
            self.split_planes = common.split_planes_from_packed(self.planes)
        return self.split_planes

    def release(self) -> None:
        """Drop this shard's device planes (their column shards and their
        split pair) so the next shard's pack has the memory."""
        self.planes = None
        self.split_planes = None
        self.device_planes = None
        self.host_stack = None

    def host_rgb(self, t_idx: int) -> np.ndarray:
        """Re-decode one target's RGB (ambiguity-flagged rescore only)."""
        from colormipsearch_tpu_torch.io import cache as mips_cache

        mip = mips_cache.load_mip(self.neurons[t_idx], self.file_type)
        return mip.image.as_rgb()


def load_target_shards(targets: Sequence[Neuron], *, device: torch.device,
                       pack_threshold: int,
                       file_type: ComputeFileType =
                       ComputeFileType.InputColorDepthImage,
                       tile_size: int = 4096,
                       plane_kind: str = "keys",
                       defer_pack: bool = False) -> list[TargetShard]:
    """Decode target CDMs and pack them into device key planes, grouped
    by image shape and tiled to bound single-allocation size.

    Same-shape RGB TIFF/PNG batches go through the native multithreaded
    decoder (io/native_decoder.py) when it is available; everything else
    decodes one image at a time (io/image.py).
    """
    from colormipsearch_tpu_torch.io import native_decoder

    native_ok = native_decoder.available()
    by_shape: dict[tuple[int, int], tuple[list[Neuron], list]] = {}
    pending: dict[tuple[int, int], tuple[list[Neuron], list[bytes]]] = {}
    skipped = 0
    t_decode0 = time.time()

    def skip(n: Neuron, where: str, reason) -> None:
        nonlocal skipped
        skipped += 1
        LOG.warning("skipped target %s (%s): %s", n.mip_id, where, reason)

    def add(n: Neuron, img) -> None:
        rgb = img.as_rgb()
        by_shape.setdefault(rgb.shape[:2], ([], []))[0].append(n)
        by_shape[rgb.shape[:2]][1].append(rgb)

    for n in targets:
        fd = n.compute_file(file_type)
        if fd is None:
            skip(n, "no file", f"no {file_type.value}")
            continue
        where = _file_name(fd)
        try:
            blob = mips_io.read_bytes(fd)
        except (OSError, zipfile.BadZipFile) as e:
            skip(n, where, e)
            continue
        info = native_decoder.img_info(blob) if native_ok else None
        if info is not None and info[2] == 3 and info[3] == 8:
            pending.setdefault((info[1], info[0]), ([], []))[0].append(n)
            pending[(info[1], info[0])][1].append(blob)
            continue
        img, reason = _decode(blob)
        if img is None:
            skip(n, where, reason)
        else:
            add(n, img)

    # batch-decode the native-eligible groups
    for (h, w), (neurons, blobs) in pending.items():
        arena, ok = native_decoder.decode_img_batch(
            blobs, width=w, height=h, channels=3)
        dst = by_shape.setdefault((h, w), ([], []))
        for i, n in enumerate(neurons):
            if ok[i]:
                dst[0].append(n)
                dst[1].append(arena[i])
                continue
            # per-image fallback: the native decoder rejects some valid
            # encodings (e.g. interlaced PNG)
            img, reason = _decode(blobs[i])
            if img is None:
                skip(n, _file_name(n.compute_file(file_type)), reason)
            else:
                add(n, img)
    if skipped:
        LOG.warning("skipped %d targets with missing/corrupt images", skipped)
    _METRICS.add("cds.decodeTargets.seconds", time.time() - t_decode0)

    shards = []
    for shape, (neurons, rgbs) in by_shape.items():
        for i in range(0, len(neurons), tile_size):
            stack = np.stack(rgbs[i:i + tile_size])
            shard = TargetShard(
                neurons[i:i + tile_size], shape, None, device,
                kind=plane_kind, file_type=file_type,
                packed_threshold=pack_threshold,
                t_pad=_target_bucket(stack.shape[0]), host_stack=stack)
            if not defer_pack:
                # the first shard packs while the masks prep
                shard.ensure_planes()
            shards.append(shard)
    return shards


def _pack_target_stack(stack: np.ndarray, t_pad: int, plane_kind: str,
                       pack_threshold: int,
                       device: torch.device) -> torch.Tensor:
    """Pack a decoded uint8 [T, H, W, 3] stack into device planes, the
    data threshold folded and the target axis padded to t_pad (zero
    columns never score).

    Key planes take the sparse COO upload of the ~2% foreground + K1,
    or with CDS_DENSE_UPLOAD=1 (read per call) the dense stack + K8 in
    its key mode; summary planes (the packed path) the dense stack + K8
    in its summary mode."""
    dense_keys = os.environ.get("CDS_DENSE_UPLOAD", "0") == "1"
    if plane_kind == "keys" and not dense_keys:
        return common.pack_target_planes_keys_sparse(
            stack, pack_threshold, common.rank_lut_tensor(device), t_pad,
            device)
    rgb = torch.from_numpy(np.ascontiguousarray(stack)).to(device)
    if plane_kind == "keys":
        return common.pack_target_planes_keys(
            rgb, pack_threshold, common.rank_lut_tensor(device),
            t_pad=t_pad)
    return common.pack_target_planes(rgb, pack_threshold, t_pad=t_pad)


def _target_bucket(t: int, minimum: int = 32) -> int:
    n = minimum
    while n < t:
        n *= 2
    return n


def _trim_per_mask(matches: list[CDMatch], k: int) -> list[CDMatch]:
    """Keep the k best matches (by matchingPixels desc) per mask."""
    by_mask: dict[int, list[CDMatch]] = {}
    for m in matches:
        by_mask.setdefault(id(m.mask_image), []).append(m)
    out: list[CDMatch] = []
    for ms in by_mask.values():
        ms.sort(key=lambda m: -(m.matching_pixels or 0))
        out.extend(ms[:k])
    return out


def _decode(blob: bytes):
    """(ImageData, None), or (None, the decoder's reason)."""
    from colormipsearch_tpu_torch.io.image import read_image
    try:
        return read_image(blob), None
    except (OSError, ValueError) as e:
        return None, e


def _file_name(fd) -> str:
    return f"{fd.file_name}:{fd.entry_name}" if fd.is_zip_entry \
        else fd.file_name


def iter_target_shards(targets: Sequence[Neuron], *, device: torch.device,
                       pack_threshold: int,
                       file_type: ComputeFileType =
                       ComputeFileType.InputColorDepthImage,
                       tile_size: int = 4096, plane_kind: str = "keys"):
    """Stream target shards tile by tile with background prefetch.

    While the device scores tile i, a worker thread decodes tile i+1.
    Only the FIRST chunk packs eagerly; later chunks decode in the
    prefetch thread but defer their device pack to the consumer, which
    releases the previous shard first (one packed plane set resident).
    """
    chunks = [list(targets[i:i + tile_size])
              for i in range(0, len(targets), tile_size)]
    kw = dict(device=device, pack_threshold=pack_threshold,
              file_type=file_type, tile_size=tile_size,
              plane_kind=plane_kind)
    if len(chunks) <= 1:
        for ci, chunk in enumerate(chunks):
            yield from load_target_shards(chunk, defer_pack=ci > 0, **kw)
        return
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    try:
        fut = pool.submit(load_target_shards, chunks[0], **kw)
        for nxt in chunks[1:]:
            shards = fut.result()
            fut = pool.submit(load_target_shards, nxt, defer_pack=True, **kw)
            yield from shards
        yield from fut.result()
    finally:
        # on abnormal close do NOT join the in-flight next-chunk decode
        pool.shutdown(wait=False, cancel_futures=True)


class CDSearchEngine:
    """All-pairs masked CDS scoring (pixel-match pass).

    ``device`` is explicit: a CUDA device runs the hand-written kernels,
    the CPU runs their plain PyTorch versions. A CUDA device without a
    GPU is an error, never a silent CPU run. ``use_mesh`` (None, True,
    False or a parallel.mesh.Mesh; see parallel.mesh.resolve_mesh)
    distributes each target shard's columns over a device mesh, as the
    JAX engine does whenever JAX sees several devices; a shard whose
    padded width does not divide over the mesh runs on ``device`` alone.
    Both give identical matches.
    """

    def __init__(self, params: CDSParams, *, device: torch.device | str,
                 use_mesh: bool | None = None,
                 neg_query_rgb: np.ndarray | None = None,
                 neg_query_threshold: int | None = None,
                 mirror_neg_query: bool = False,
                 decode_concurrency: int = 8,
                 use_key_planes: bool | None = None,
                 use_union_keys: bool | str | None = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {self.device} requested but CUDA is not available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self._mesh = pmesh.resolve_mesh(use_mesh, self.device)
        self._sharded_steps: dict = {}
        if self._mesh is not None:
            LOG.info("scoring over a %d-device mesh", self._mesh.size)
        self.params = params
        # the kernel choice of the JAX engine (its engine/cds.py:470-506);
        # the port reads the variables per engine, not at import
        self.use_key_planes, self.use_union_keys = _resolve_kernel(
            params.xy_shift, use_key_planes, use_union_keys)
        # CDS_SPLIT_PLANES=1 selects the split-plane kernel where the JAX
        # engine would run it: the packed path with no top-k
        self._use_split = os.environ.get("CDS_SPLIT_PLANES", "0") == "1"
        self._key_plans: dict = {}
        self.decode_concurrency = max(1, decode_concurrency)
        # optional negative query applied to every mask
        # (PixelMatchColorDepthSearchAlgorithm:29-57 negQueryImage)
        self.neg_query_rgb = neg_query_rgb
        self.neg_query_threshold = (params.mask_threshold
                                    if neg_query_threshold is None
                                    else neg_query_threshold)
        self.mirror_neg_query = mirror_neg_query
        self._plan_args_cache: dict = {}
        self._plan_args_inflight: dict = {}
        self._plan_args_lock = threading.Lock()
        self._itabs = None  # device interval tables
        # re-read the env at construction so in-process callers can tune
        # the dispatch width per run
        self.MASK_BATCH = int(os.environ.get(
            "CDS_MASK_BATCH", str(type(self).MASK_BATCH)))

    # query plans scored per kernel launch
    MASK_BATCH = 8

    _KEY_PLANS_MAX = 512

    def _key_plan(self, plan, n_pixels: int):
        """The classic key plan of a QueryPlan, cached. Entries hold a
        strong reference to the source plan, so a recycled object id can
        never alias a freed plan's slot; n_pixels is part of the key
        because the sentinel encoding depends on the plane shape."""
        key = (id(plan), n_pixels)
        cached = self._key_plans.get(key)
        if cached is not None and cached[0] is plan:
            return cached[1]
        kp = pixel_match.key_plan_from_query_plan(
            plan, n_pixels, self.params.pix_color_fluctuation)
        if len(self._key_plans) >= self._KEY_PLANS_MAX:
            self._key_plans.pop(next(iter(self._key_plans)))
        self._key_plans[key] = (plan, kp)
        return kp

    def _step(self, key, make):
        """A sharded step of the mesh, built once per configuration."""
        if key not in self._sharded_steps:
            self._sharded_steps[key] = make()
        return self._sharded_steps[key]

    def _sharded_step(self, n_straight: int, ztol, top_k: int = 0,
                      target_threshold: int = -1):
        return self._step(
            ("packed", n_straight, ztol, top_k, target_threshold),
            lambda: pmesh.make_sharded_batch_step(
                self._mesh, target_threshold=target_threshold,
                ztol_num=ztol[0], ztol_den=ztol[1], n_straight=n_straight,
                top_k=top_k))

    def _split_step(self, n_straight: int, ztol):
        return self._step(
            ("split", n_straight, ztol),
            lambda: pmesh.make_sharded_batch_step_split(
                self._mesh, ztol_num=ztol[0], ztol_den=ztol[1],
                n_straight=n_straight))

    def _keys_step(self, n_straight: int, top_k: int = 0):
        return self._step(
            ("keys", n_straight, top_k),
            lambda: pmesh.make_sharded_batch_step_keys(
                self._mesh, n_straight=n_straight, top_k=top_k))

    def _union_keys_step(self, top_k: int = 0, u2: int | None = None):
        return self._step(
            ("ukeys", top_k, u2),
            lambda: pmesh.make_sharded_batch_step_union_keys(
                self._mesh, top_k=top_k, u2=u2))

    def _mesh_planes(self, shard: TargetShard) -> tuple:
        """The shard's planes cut over the mesh, made at first use; the
        unsharded planes are released once the column shards exist, so the
        full stack and its shards coexist only for that moment."""
        if shard.device_planes is None:
            shard.device_planes = pmesh.shard_target_planes(self._mesh,
                                                            shard.planes)
            shard.planes = None
        return shard.device_planes

    def _split_planes(self, shard: TargetShard, on_mesh: bool) -> tuple:
        """The split pair of the shard's summary planes (K12 at first use),
        cut over the mesh when the batch scores there; the unsharded
        summary planes are then released unless a negative query still
        scores on them (JAX engine/cds.py _split_planes)."""
        if not on_mesh:
            return shard.split_pair()
        if shard.split_planes is None:
            pair = common.split_planes_from_packed(shard.planes)
            shard.split_planes = tuple(
                pmesh.shard_target_planes(self._mesh, x) for x in pair)
            del pair
            if self.neg_query_rgb is None:
                shard.planes = None
        return shard.split_planes

    def _stacked_key_args(self, plans, n_pixels: int):
        """(pos, lo, span) tensors of a batch of classic key plans."""
        def build():
            kplans = [self._key_plan(pl, n_pixels) for pl in plans]
            return tuple(convert.as_tensor(np.stack([getattr(kp, f)
                                                     for kp in kplans]),
                                           self.device)
                         for f in ("positions", "lo", "span"))

        return self._cached_plan_args(("keys", n_pixels), plans, build)

    def _stacked_plan_args(self, plans):
        """(pos, q_cls, q_s, q_p) tensors of a batch of QueryPlans."""
        def build():
            return tuple(convert.as_tensor(np.stack([getattr(pl, f)
                                                     for pl in plans]),
                                           self.device)
                         for f in ("positions", "q_cls", "q_s", "q_p"))

        return self._cached_plan_args("packed", plans, build)

    def _interval_tables_device(self):
        """The shared per-tolerance interval tables on the device
        (uploaded once per engine)."""
        if self._itabs is None:
            arrs = pixel_match.interval_table_arrays(
                float(self.params.pix_color_fluctuation) / 100.0)
            assert arrs is not None  # positional plans exist => tables do
            self._itabs = convert.interval_tables(arrs, self.device)
        return self._itabs

    def _stacked_union_args(self, batch, n_pixels: int):
        """Stacked union plan tensors for one mask batch:
        (u_pos, mu_pos, lane_lo, lane_span, u2).

        On the pure full-union path the prep pass built the union plans;
        otherwise (the x-union form, or a negative query) they are built
        here, per batch, from the decoded masks. Full-union plans prefer
        the POSITIONAL wire form (the per-lane tables are expanded on the
        device by K2); masks with >= 65,535 query pixels have no
        positional form, and x-union plans none at all: those batches
        stack the host-built tables. Cached on the batch plans'
        identities, so each batch uploads once for all target shards."""
        plans = [e[3] for e in batch]
        p = self.params
        builder = (pixel_match.build_full_union_key_plan
                   if self.use_union_keys == "full"
                   else pixel_match.build_union_key_plan)

        def build_one(entry):
            _mask, mask_rgb, region, _plan, _neg = entry
            up = builder(
                mask_rgb, p.mask_threshold, mirror=p.mirror_mask,
                xy_shift=p.xy_shift,
                pix_color_fluctuation=p.pix_color_fluctuation,
                excluded_region=region)
            assert up is not None  # grid-checked at engine init
            return up

        def build():
            dev = self.device
            if isinstance(plans[0], pixel_match.UnionKeyPlan):
                ups = plans
            else:
                with concurrent.futures.ThreadPoolExecutor(
                        max_workers=min(len(batch),
                                        self.decode_concurrency)) as pool:
                    ups = list(pool.map(build_one, batch))
            pa = None
            if self.use_union_keys == "full":
                pa = pixel_match.stack_union_pos_args(ups, n_pixels)
            if pa is not None:
                u_pos, mu_pos, q_pos, key_list, u2 = pa
                h, w = batch[0][1].shape[:2]
                offs = tuple((int(dx), int(dy)) for dx, dy
                             in shift_offsets(self.params.xy_shift))
                u_dev = convert.as_tensor(u_pos, dev)  # upload ONCE, reuse
                lane_lo, lane_span = \
                    pixel_match.expand_union_tables_from_pos(
                        u_dev, convert.as_tensor(q_pos, dev),
                        convert.as_tensor(key_list, dev),
                        *self._interval_tables_device(),
                        offsets=offs, w=w, h=h)
                return (u_dev, convert.as_tensor(mu_pos, dev), lane_lo,
                        lane_span, u2)
            # plans pad to the batch's common union bucket AND interval
            # slot count; the trailing u2 stays a host int
            return convert.stacked_args(
                pixel_match.stack_union_plan_args(ups, n_pixels), dev)

        return self._cached_plan_args(
            ("ukeys", self.use_union_keys, n_pixels), plans, build)

    # stacked plan tensors, cached so a batch re-scored against every
    # streamed target shard uploads its plans ONCE; bounded FIFO
    _ARGS_CACHE_MAX = 4

    def _cached_plan_args(self, tag, plans, build):
        """id()-keyed device-args cache.  Each entry pins the source
        plan objects, so an id can only hit while its plan is alive.
        Locked: the warm-ahead thread and the scoring thread both mutate
        the FIFO; concurrent requesters of the SAME key share one
        in-flight build via a per-key future."""
        key = (tag,) + tuple(id(pl) for pl in plans)
        with self._plan_args_lock:
            cached = self._plan_args_cache.get(key)
            if cached is not None and all(
                    a is b for a, b in zip(cached[0], plans)):
                return cached[1]
            fut = self._plan_args_inflight.get(key)
            if fut is None:
                fut = concurrent.futures.Future()
                self._plan_args_inflight[key] = fut
                owner = True
            else:
                owner = False
        if not owner:
            return fut.result()
        try:
            args = build()
        except BaseException as e:
            fut.set_exception(e)
            with self._plan_args_lock:
                self._plan_args_inflight.pop(key, None)
            raise
        with self._plan_args_lock:
            while len(self._plan_args_cache) >= self._ARGS_CACHE_MAX:
                self._plan_args_cache.pop(
                    next(iter(self._plan_args_cache)), None)
            self._plan_args_cache[key] = (tuple(plans), args)
            self._plan_args_inflight.pop(key, None)
        fut.set_result(args)
        return args

    def find_all_matches(self, masks: Sequence[Neuron],
                         targets: Sequence[Neuron], *,
                         tags: Iterable[str] = (),
                         session_ref_id: int | None = None,
                         max_matches_per_mask: int = 0) -> list[CDMatch]:
        """Score masks x targets; returns entities for found matches only
        (LocalColorMIPSearchProcessor filters isMatchFound :110)."""
        matches: list[CDMatch] = []
        for chunk in self.find_all_matches_iter(
                masks, targets, tags=tags, session_ref_id=session_ref_id,
                max_matches_per_mask=max_matches_per_mask):
            matches.extend(chunk)
        if max_matches_per_mask > 0:
            matches = _trim_per_mask(matches, max_matches_per_mask)
        return matches

    def find_all_matches_iter(self, masks: Sequence[Neuron],
                              targets: Sequence[Neuron], *,
                              tags: Iterable[str] = (),
                              session_ref_id: int | None = None,
                              max_matches_per_mask: int = 0):
        """Streaming variant: yields lists of CDMatch per scored
        (target tile x mask batch).  With `max_matches_per_mask`, each
        target tile contributes at most that many matches per mask; the
        list wrapper applies the final global per-mask trim."""
        from colormipsearch_tpu_torch.utils.metrics import stage_timer

        t0 = time.time()
        p = self.params
        tags = set(tags)
        # on the pure full-union path prep builds the union plan directly
        # (light: no expanded lane tables) and drops the decoded image,
        # which only the flagged-pair rescore (never on this path: its
        # verdicts are exact) would read
        union_prep = (self.use_union_keys == "full"
                      and self.neg_query_rgb is None)

        region_cache: dict = {}
        region_lock = threading.Lock()

        def shared_region(h, w):
            # one region array per image shape instead of per mask
            with region_lock:
                key = (h, w)
                if key not in region_cache:
                    region_cache[key] = p.excluded_region(h, w)
                return region_cache[key]

        def prep_mask(mask):
            mask_mip = mips_io.load_compute_file(
                mask, ComputeFileType.InputColorDepthImage)
            if not mask_mip.has_image:
                LOG.warning("mask %s has no loadable image", mask.mip_id)
                return None
            mask_rgb = mask_mip.image.as_rgb()
            h, w = mask_rgb.shape[:2]
            region = shared_region(h, w)
            if union_prep:
                plan = pixel_match.build_full_union_key_plan(
                    mask_rgb, p.mask_threshold, mirror=p.mirror_mask,
                    xy_shift=p.xy_shift,
                    pix_color_fluctuation=p.pix_color_fluctuation,
                    excluded_region=region, light=True)
                # a zero-byte stub keeps the shape for the group key and
                # fails loudly on any accidental pixel use
                mask_rgb = np.empty((h, w, 0), np.uint8)
            else:
                plan = pixel_match.build_query_plan(
                    mask_rgb, p.mask_threshold, mirror=p.mirror_mask,
                    xy_shift=p.xy_shift,
                    pix_color_fluctuation=p.pix_color_fluctuation,
                    excluded_region=region)
            if plan.query_size == 0:
                return None
            neg_plan = None
            if self.neg_query_rgb is not None:
                neg_plan = pixel_match.build_neg_query_plan(
                    mask_rgb, p.mask_threshold,
                    self.neg_query_rgb, self.neg_query_threshold,
                    mirror_neg_query=self.mirror_neg_query,
                    xy_shift=p.xy_shift,
                    pix_color_fluctuation=p.pix_color_fluctuation,
                    excluded_region=region)
            return (mask, mask_rgb, region, plan, neg_plan)

        # start decoding + packing the FIRST target shard while the
        # masks prep (CDS_TARGET_TILE: shard width, default 4096)
        shard_iter = iter_target_shards(
            list(targets), device=self.device,
            pack_threshold=p.data_threshold,
            tile_size=int(os.environ.get("CDS_TARGET_TILE", "4096")),
            plane_kind="keys" if self.use_key_planes else "packed")
        shard0_pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        shard0_fut = shard0_pool.submit(lambda: next(shard_iter, None))

        # mask prep STREAMS into shard-0 scoring: all prep futures are
        # submitted at once; batches form as results arrive IN SUBMIT
        # ORDER (deterministic batch composition), and each full batch
        # scores against the first target shard while later masks are
        # still prepping.  Remaining shards iterate the recorded batches.
        prep_t0 = time.time()
        prep_done_ts: list[float] = []

        def prep_one(mask):
            try:
                return prep_mask(mask)
            finally:
                prep_done_ts.append(time.time())

        prep_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.decode_concurrency)
        prep_futs = [prep_pool.submit(prep_one, m) for m in masks]

        def entry_key(entry):
            # a batch shares the image shape, the padded query width and
            # the padded negative-plan width (or has no negative plans)
            _, mask_rgb, _, plan, neg_plan = entry
            q_pad = (plan.u_pos.shape[1] if union_prep
                     else plan.positions.shape[1])
            return (mask_rgb.shape[:2], q_pad,
                    None if neg_plan is None
                    else neg_plan.positions.shape[1])

        def stream_batches():
            pending: dict[tuple, list] = {}
            for fut in prep_futs:
                entry = fut.result()
                if entry is None:
                    continue
                k = entry_key(entry)
                pending.setdefault(k, []).append(entry)
                if len(pending[k]) >= self.MASK_BATCH:
                    yield k, pending.pop(k)
            prep_pool.shutdown()
            span = (max(prep_done_ts) - prep_t0) if prep_done_ts else 0.0
            _METRICS.add("cds.prepMasks.seconds", span)
            LOG.info("cds.prepMasks finished in %.2fs (overlapped with "
                     "shard-0 scoring)", span)
            for k, b in pending.items():
                if b:
                    yield k, b

        n_matches = 0
        n_targets = 0
        n_pairs = 0
        first_shard = None
        all_batches: list[tuple[tuple, list]] = []

        def warm(key, batch):
            # build+upload a batch's plan tensors on a worker thread
            # while the device scores the previous batch
            n_px = key[0][0] * key[0][1]
            try:
                if self.use_union_keys:
                    self._stacked_union_args(batch, n_px)
                elif self.use_key_planes:
                    self._stacked_key_args([e[3] for e in batch], n_px)
            except Exception:  # noqa: BLE001 - warm only
                pass  # the real call surfaces the error

        def score(key, batch, shard):
            nonlocal n_pairs, n_matches
            out = self._score_batch(batch, shard, tags, session_ref_id,
                                    top_k=max_matches_per_mask)
            _METRICS.add("pairsScored", len(batch) * shard.count)
            n_pairs += len(batch) * shard.count
            n_matches += len(out)
            return out

        warm_pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        try:
          with stage_timer("cds.scoreAllPairs"):
            # phase 1: shard 0 scores each mask batch as prep yields it
            prev = None
            for kb in stream_batches():
                all_batches.append(kb)
                if first_shard is None:
                    # first usable batch: now (and only now) consume the
                    # prefetched shard
                    first_shard = shard0_fut.result()
                    shard0_pool.shutdown()
                    if first_shard is not None:
                        first_shard.ensure_planes()
                        n_targets += first_shard.count
                if first_shard is None:
                    continue  # no targets: just record batches
                warm_pool.submit(warm, *kb)
                if prev is not None and prev[0][0] == first_shard.shape:
                    yield score(prev[0], prev[1], first_shard)
                prev = kb
            if prev is not None and first_shard is not None \
                    and prev[0][0] == first_shard.shape:
                yield score(prev[0], prev[1], first_shard)
            warm_pool.shutdown()
            if not all_batches:
                if masks:
                    LOG.warning(
                        "no usable masks: every mask image failed to "
                        "load or produced an EMPTY query (threshold %d "
                        "over the non-excluded region — note the "
                        "name/color-scale label regions cover "
                        "x<330/y<100 and the right corner and are "
                        "excluded by default)", p.mask_threshold)
                # release shard 0's planes once its in-flight pack ends
                shard0_fut.cancel()

                def _drop(fut):
                    if fut.cancelled() or fut.exception() is not None:
                        return
                    if fut.result() is not None:
                        fut.result().release()

                shard0_fut.add_done_callback(_drop)
                return
            # phase 2: remaining shards iterate the recorded batches;
            # the previous shard's planes are RELEASED before the next
            # shard packs (one packed plane set resident at a time)
            prev_shard = first_shard
            for shard in shard_iter:
                if prev_shard is not None:
                    prev_shard.release()
                prev_shard = shard
                n_targets += shard.count
                matching = [kb for kb in all_batches
                            if kb[0][0] == shard.shape]
                if not matching:
                    continue  # never pack a shard no batch can score
                shard.ensure_planes()
                with concurrent.futures.ThreadPoolExecutor(
                        max_workers=1) as argpool:
                    fut = None
                    for bi, kb in enumerate(matching):
                        if bi + 1 < len(matching):
                            fut = argpool.submit(warm, *matching[bi + 1])
                        yield score(kb[0], kb[1], shard)
                        if fut is not None:
                            fut.result()
                            fut = None
        finally:
            # a scoring failure must not leave queued prep tasks grinding
            # through mask decodes; on normal completion these are no-ops
            prep_pool.shutdown(wait=False, cancel_futures=True)
            warm_pool.shutdown(wait=False, cancel_futures=True)
            shard0_pool.shutdown(wait=False, cancel_futures=True)
        _METRICS.add("matchesFound", n_matches)
        if n_pairs == 0 and all_batches and n_targets > 0:
            LOG.warning(
                "0 pairs scored: no target tile matched any mask's image "
                "shape (the reference requires target size == query "
                "size); mask shapes: %s",
                sorted({k[0] for k, _ in all_batches}))
        LOG.info("found %d matches for %d masks x %d targets in %.1fs "
                 "(%.0f pairs/s)",
                 n_matches, len(masks), n_targets, time.time() - t0,
                 n_pairs / max(time.time() - t0, 1e-9))

    def _emit_select_k(self, top_k: int) -> int:
        """Device-side emit-selection width (0 = disabled).

        With a positive pctPositivePixels threshold and no negative
        query, only pairs with score/querySize > pct/100 can emit (the
        reference's isMatch filter), so a union-path launch pulls a
        [B, k] per-mask top-k selection instead of the dense [B, T] rows.
        Lossless by construction: the caller checks every mask's k-th
        (smallest selected) score against the emit test and falls back
        to the dense rows if a dropped pair could still emit.
        CDS_EMIT_TOPK overrides the width (0 disables)."""
        if (top_k > 0 or self.neg_query_rgb is not None
                or self.params.pct_positive_pixels <= 0):
            return 0
        return max(0, int(os.environ.get("CDS_EMIT_TOPK", "256")))

    def _topk_kth_emittable(self, kth: np.ndarray, batch) -> bool:
        """True if any mask's k-th selected score passes the emit test
        (score > 0 and score/querySize > pct/100) — a dropped pair could
        then also pass, so the caller must pull dense."""
        pct = self.params.pct_positive_pixels / 100.0
        for b, e in enumerate(batch):
            qsize = e[3].query_size
            for s in np.ravel(kth[b]):
                if s > 0 and s / qsize > pct:
                    return True
        return False

    def _score_batch(self, batch, shard: TargetShard, tags: set,
                     session_ref_id, top_k: int = 0) -> list[CDMatch]:
        p = self.params
        # the data threshold is folded into every shard's planes, so the
        # banded kernel's per-element threshold test is skipped
        assert shard.packed_threshold == p.data_threshold
        thr = -1
        if self.neg_query_rgb is not None:
            # the negative subtraction changes the ranking, so a top-k
            # preselection on positive scores would be wrong
            top_k = 0
        plans = [e[3] for e in batch]
        n_pixels = shard.shape[0] * shard.shape[1]
        use_keys = shard.kind == "keys"
        # CDS_SPLIT_PLANES=1: the split-plane kernel on the packed path
        # (the planes' threshold is always folded); a top-k stays on the
        # summary planes, as in the JAX engine
        use_split = not use_keys and self._use_split and top_k == 0
        pair_flags = None  # structurally zero on the key paths
        t_args0 = time.time()
        if not use_keys:
            args = self._stacked_plan_args(plans)
        elif self.use_union_keys:
            *kargs, u2 = self._stacked_union_args(batch, n_pixels)
        else:
            kargs = self._stacked_key_args(plans, n_pixels)
        _METRICS.add("cds.planArgs.seconds", time.time() - t_args0)
        t_disp0 = time.time()
        # the classic plans' tolerance and variant split (the union
        # path's light plans carry neither and need neither)
        ztol = (getattr(plans[0], "ztol_num", None),
                getattr(plans[0], "ztol_den", None))
        n_straight = getattr(plans[0], "n_straight", None)
        # the mesh steps need the padded width to divide over the mesh;
        # otherwise the batch runs on the engine's device alone, which a
        # mesh across processes must not do (every rank would write every
        # column). Every branch below is taken alike in every rank: each
        # decision reads values the steps reduced or gathered.
        on_mesh = self._mesh is not None \
            and shard.t_pad % self._mesh.size == 0
        if self._mesh is not None and self._mesh.world_size > 1 \
                and not on_mesh:
            raise ValueError(
                f"{shard.t_pad} padded target columns do not divide over "
                f"the {self._mesh.size} shards of a mesh across "
                f"{self._mesh.world_size} processes")
        if use_split:
            t_sp, t_c8 = self._split_planes(shard, on_mesh)
            if on_mesh:
                best, mirrored, pair_flags, _gmax = self._split_step(
                    n_straight, ztol)(t_sp, t_c8, *args)
            else:
                best, mirrored, pair_flags = \
                    pixel_match.score_query_batch_split(
                        t_sp, t_c8, *args, ztol_num=ztol[0],
                        ztol_den=ztol[1], n_straight=n_straight)
        elif not use_keys and on_mesh:
            planes = self._mesh_planes(shard)
            if top_k > 0:
                # per-shard top-k: only D*k candidates a mask reach the
                # host, unless flagged pairs fell outside the selection
                # (their exact score could beat a selected fast score)
                scores_k, idx_k, mirr_k, flags_k, _gmax, n_flagged = \
                    self._sharded_step(n_straight, ztol, top_k, thr)(
                        planes, *args)
                flags_k = flags_k.cpu().numpy()
                idx_k = idx_k.cpu().numpy()
                valid = (idx_k >= 0) & (idx_k < shard.count)
                selected = ((flags_k > 0) & valid).sum(axis=1)
                if not (n_flagged.cpu().numpy() > selected).any():
                    _METRICS.add("cds.dispatch.seconds",
                                 time.time() - t_disp0)
                    return self._emit_from_topk(
                        batch, shard, scores_k.cpu().numpy(), idx_k,
                        mirr_k.cpu().numpy(), flags_k, tags,
                        session_ref_id)
                _METRICS.add("cds.topkFlagDense.count", 1)
            best, mirrored, pair_flags, _gmax = self._sharded_step(
                n_straight, ztol, target_threshold=thr)(planes, *args)
        elif not use_keys:
            best, mirrored, pair_flags = pixel_match.score_query_batch(
                shard.planes, *args, target_threshold=thr,
                ztol_num=ztol[0], ztol_den=ztol[1], n_straight=n_straight)
        elif on_mesh:
            planes = self._mesh_planes(shard)
            if top_k > 0:
                step = (self._union_keys_step(top_k, u2)
                        if self.use_union_keys
                        else self._keys_step(n_straight, top_k))
                scores_k, idx_k, mirr_k, flags_k, _gmax, _nf = step(
                    planes, *kargs)
                _METRICS.add("cds.dispatch.seconds", time.time() - t_disp0)
                return self._emit_from_topk(
                    batch, shard, *(x.cpu().numpy() for x in (
                        scores_k, idx_k, mirr_k, flags_k)), tags,
                    session_ref_id)
            sel_k = self._emit_select_k(top_k) if self.use_union_keys \
                else 0
            if sel_k and sel_k < shard.t_pad // self._mesh.size:
                # threshold-emit selection, per column shard: [B, D*k]
                scores_k, idx_k, mirr_k, flags_k, _gmax, _nf = \
                    self._union_keys_step(sel_k, u2)(planes, *kargs)
                sk = scores_k.cpu().numpy()
                kth = sk.reshape(sk.shape[0], -1, sel_k)[:, :, -1]
                if not self._topk_kth_emittable(kth, batch):
                    _METRICS.add("cds.emitSelect.count", 1)
                    _METRICS.add("cds.dispatch.seconds",
                                 time.time() - t_disp0)
                    return self._emit_from_topk(
                        batch, shard, sk, *(x.cpu().numpy() for x in (
                            idx_k, mirr_k, flags_k)), tags, session_ref_id)
                _METRICS.add("cds.emitSelectFallback.count", 1)
            step = (self._union_keys_step(u2=u2) if self.use_union_keys
                    else self._keys_step(n_straight))
            best, mirrored, _flags, _gmax = step(planes, *kargs)
        elif self.use_union_keys:
            sel_k = self._emit_select_k(top_k)
            if sel_k and sel_k < shard.t_pad:
                # threshold-emit selection: pull only the [B, k] top-k;
                # the dense rows stay on the device as the no-recompute
                # fallback
                sk, ik, mk, best, mirrored = \
                    pixel_match.score_query_batch_union_keys_topk(
                        shard.planes, *kargs, u2=u2, k=sel_k)
                sk = sk.cpu().numpy()
                if not self._topk_kth_emittable(sk[:, -1], batch):
                    del best, mirrored  # free the device buffers
                    ik, mk = ik.cpu().numpy(), mk.cpu().numpy()
                    _METRICS.add("cds.emitSelect.count", 1)
                    _METRICS.add("cds.dispatch.seconds",
                                 time.time() - t_disp0)
                    return self._emit_from_topk(
                        batch, shard, sk, ik, mk, np.zeros_like(sk), tags,
                        session_ref_id)
                _METRICS.add("cds.emitSelectFallback.count", 1)
            else:
                best, mirrored = pixel_match.score_query_batch_union_keys(
                    shard.planes, *kargs, u2=u2)
        else:
            best, mirrored = pixel_match.score_query_batch_keys(
                shard.planes, *kargs, n_straight=n_straight)

        # optional negative-query pass: the same kind of kernel over the
        # per-mask negative plans; the overall max (straight vs mirrored)
        # is the negative score to subtract. The group key pins the
        # padded negative width, so a batch has negative plans for every
        # mask or for none. On the mesh it scores the column shards; the
        # split path keeps the summary planes for it.
        neg_plans = [e[4] for e in batch]
        neg_best = neg_flags = None
        pull = pmesh.pull_target_cols
        if neg_plans[0] is not None:
            ref = neg_plans[0]
            neg_on_mesh = on_mesh and shard.device_planes is not None
            if use_keys:
                neg_kargs = self._stacked_key_args(neg_plans, n_pixels)
                if neg_on_mesh:
                    nb, _nm, _nf, _g = self._keys_step(ref.n_straight)(
                        shard.device_planes, *neg_kargs)
                else:
                    nb, _nm = pixel_match.score_query_batch_keys(
                        shard.planes, *neg_kargs,
                        n_straight=ref.n_straight)
            else:
                neg_args = self._stacked_plan_args(neg_plans)
                neg_ztol = (ref.ztol_num, ref.ztol_den)
                if neg_on_mesh:
                    nb, _nm, nf, _g = self._sharded_step(
                        ref.n_straight, neg_ztol, target_threshold=thr)(
                            shard.device_planes, *neg_args)
                else:
                    nb, _nm, nf = pixel_match.score_query_batch(
                        shard.planes, *neg_args, target_threshold=thr,
                        ztol_num=neg_ztol[0], ztol_den=neg_ztol[1],
                        n_straight=ref.n_straight)
                neg_flags = pull(nf)[:, :shard.count]
            neg_best = np.maximum(pull(nb), 0)[:, :shard.count]

        # drop the zero-padded target columns (see _target_bucket); across
        # processes the pull keeps only this process's target columns
        # (zeros elsewhere), so each process emits its own share of the
        # matches and rescores only its own flagged pairs
        best = pull(best)[:, :shard.count]
        mirrored = pull(mirrored)[:, :shard.count]
        pair_flags = (np.zeros_like(best) if pair_flags is None
                      else pull(pair_flags)[:, :shard.count])
        _METRICS.add("cds.dispatch.seconds", time.time() - t_disp0)
        t_emit0 = time.time()

        out: list[CDMatch] = []
        for b, (mask, mask_rgb, region, plan, neg_plan) in enumerate(batch):
            flags_b = pair_flags[b]
            if neg_flags is not None and neg_plan is not None:
                flags_b = flags_b + neg_flags[b]
            # flagged pairs join the candidates even at fast score 0: the
            # oracle rescore may flip them to a positive exact score
            cand = np.flatnonzero((best[b] > 0) | (flags_b > 0))
            if top_k > 0 and cand.size > top_k:
                # interval-safe preselection: the exact score lies in
                # [best - flags, best + flags]; keep every candidate
                # whose upper bound reaches the k-th largest lower bound
                # (the caller's final per-mask trim ranks exact scores)
                lower = best[b][cand] - flags_b[cand]
                upper = best[b][cand] + flags_b[cand]
                kth = -np.partition(-lower, top_k - 1)[top_k - 1]
                cand = cand[upper >= kth]
            out.extend(self._emit_matches(
                mask, mask_rgb, region, plan, shard, cand, best[b],
                mirrored[b], flags_b, tags, session_ref_id,
                neg_plan=neg_plan,
                neg_best=None if neg_plan is None or neg_best is None
                else neg_best[b]))
        _METRICS.add("cds.emit.seconds", time.time() - t_emit0)
        return out

    def _emit_from_topk(self, batch, shard, scores_k, idx_k, mirr_k,
                        flags_k, tags, session_ref_id) -> list[CDMatch]:
        """Emit from the per-mask top-k candidates [B, k]. The mesh's
        candidates are every process's, so across processes each keeps
        only those of its own target columns (per-process sharded writes,
        as the dense pull)."""
        out: list[CDMatch] = []
        t_emit0 = time.time()
        lmask = pmesh.local_target_mask(None, shard.t_pad)
        for b, (mask, mask_rgb, region, plan, _neg) in enumerate(batch):
            best = np.zeros(shard.count, scores_k.dtype)
            mirrored = np.zeros(shard.count, bool)
            flags = np.zeros(shard.count, flags_k.dtype)
            keep = (idx_k[b] < shard.count) & (idx_k[b] >= 0) \
                & lmask[np.clip(idx_k[b], 0, shard.t_pad - 1)]
            ti = idx_k[b][keep]
            best[ti] = scores_k[b][keep]
            mirrored[ti] = mirr_k[b][keep].astype(bool)
            flags[ti] = flags_k[b][keep]
            out.extend(self._emit_matches(
                mask, mask_rgb, region, plan, shard, np.unique(ti), best,
                mirrored, flags, tags, session_ref_id))
        _METRICS.add("cds.emit.seconds", time.time() - t_emit0)
        return out

    def _emit_matches(self, mask, mask_rgb, region, plan, shard,
                      candidates, best, mirrored, pair_flags, tags,
                      session_ref_id, *, neg_plan=None,
                      neg_best=None) -> list[CDMatch]:
        p = self.params
        oracle = None  # built lazily, at the first flagged pair
        out: list[CDMatch] = []
        for t_idx in candidates:
            if best[t_idx] <= 0 and pair_flags[t_idx] <= 0:
                continue
            score = int(best[t_idx])
            is_mirrored = bool(mirrored[t_idx])
            ratio = score / plan.query_size
            if neg_best is not None:
                # Java Math.round(double) == floor(x + 0.5)
                neg = int(neg_best[t_idx])
                score = int(np.floor(
                    float(score)
                    - float(neg) * plan.query_size / neg_plan.query_size
                    + 0.5))
                ratio -= neg / neg_plan.query_size
            if pair_flags[t_idx] > 0:
                # an element of this pair lies in the f32 ambiguity band:
                # the float64 oracle decides the whole pair
                if oracle is None:
                    oracle = PixelMatchOracle(
                        mask_rgb, p.mask_threshold, mirror=p.mirror_mask,
                        target_threshold=p.data_threshold,
                        z_tolerance=p.pix_color_fluctuation / 100,
                        xy_shift=p.xy_shift, excluded_region=region,
                        neg_query_rgb=self.neg_query_rgb,
                        neg_query_threshold=self.neg_query_threshold,
                        mirror_neg_query=self.mirror_neg_query)
                t_r0 = time.time()
                res = oracle.score(shard.host_rgb(t_idx))
                _METRICS.add("cds.rescore.seconds", time.time() - t_r0)
                _METRICS.add("cds.rescore.count", 1)
                score, is_mirrored = res.matching_pixels, res.mirrored
                ratio = res.matching_pixels_ratio
                if score <= 0:
                    continue
            if not (score > 0 and ratio > p.pct_positive_pixels / 100):
                continue
            target = shard.neurons[t_idx]
            mask.add_processed_tags(ProcessingType.ColorDepthSearch, tags)
            target.add_processed_tags(ProcessingType.ColorDepthSearch, tags)
            out.append(CDMatch(
                mask_image=mask,
                matched_image=target,
                mask_image_ref_id=mask.entity_id,
                matched_image_ref_id=target.entity_id,
                session_ref_id=session_ref_id,
                mirrored=is_mirrored,
                matching_pixels=score,
                matching_pixels_ratio=ratio,
                normalized_score=ratio,
                match_found=True,
                tags=set(tags),
            ))
        return out


def _resolve_kernel(xy_shift: int, use_key_planes, use_union_keys):
    """(use_key_planes, use_union_keys) as the JAX engine resolves them.

    CDS_KEY_PLANES=1 selects the key planes and CDS_UNION_KEYS (default
    "full"; "0" = off) the union form, but only when the caller pinned
    neither argument: an explicit use_key_planes=False runs the packed
    kernel and use_key_planes=True the classic key kernel. Every bare
    opt-in (True, 1, "1") means "full"; "x" falls back to the classic key
    kernel (with a warning) when the shift offsets do not form a
    {dx} x {dy} grid (xyShift > 2); a union form implies key planes."""
    keys = os.environ.get("CDS_KEY_PLANES", "0") == "1" \
        if use_key_planes is None else use_key_planes
    if use_union_keys is None:
        env = os.environ.get("CDS_UNION_KEYS", "full")
        union = (False if env == "0" else env) if use_key_planes is None \
            else False
    else:
        union = use_union_keys
    if union in (True, 1, "1"):
        union = "full"
    if union in (False, 0, "0", "off", None):
        union = False
    if union not in (False, "x", "full"):
        raise ValueError(f"use_union_keys: {union!r} "
                         "(expected False, 'x' or 'full')")
    if union == "x" and not pixel_match.offsets_form_grid(xy_shift):
        LOG.warning("x-union keys disabled: xyShift %d offsets are not a "
                    "{dx} x {dy} grid", xy_shift)
        return True, False
    return bool(keys or union), union
