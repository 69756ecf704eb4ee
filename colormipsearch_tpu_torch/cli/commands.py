"""CLI subcommands of the port: colorDepthSearch
(cmd/ColorDepthSearchCmd.java:52-440) and gradientScores
(cmd/CalculateGradientScoresCmd.java:67-461).

The same flags and file formats as the JAX package's commands, plus
``--device {cuda,cpu}``; the FS (JSON) storage backend only.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from pathlib import Path

import torch

from colormipsearch_tpu_torch.cli import common
from colormipsearch_tpu_torch.dataio.json_io import (
    JSONMatchesReader,
    JSONMatchesWriter,
    read_neurons_json,
    write_cds_session,
)
from colormipsearch_tpu_torch.engine.cds import (
    CDSParams,
    CDSearchEngine,
    not_ported,
)
from colormipsearch_tpu_torch.io import mips as mips_io
from colormipsearch_tpu_torch.io.mips import ListArg
from colormipsearch_tpu_torch.model import (
    ComputeFileType,
    FileData,
    Neuron,
    ProcessingType,
)
from colormipsearch_tpu_torch.results.grouping import select_best_matches

LOG = logging.getLogger(__name__)


# -------------------------------------------------------------------------
# shared argument groups
# -------------------------------------------------------------------------


def _add_cds_params(sp):
    """Shared CDS params (cmd/AbstractColorDepthMatchArgs.java)."""
    sp.add_argument("--dataThreshold", type=int, default=100)
    sp.add_argument("--maskThreshold", type=int, default=100)
    sp.add_argument("--pixColorFluctuation", type=float, default=2.0)
    sp.add_argument("--xyShift", type=int, default=0)
    sp.add_argument("--mirrorMask", action="store_true")
    sp.add_argument("--pctPositivePixels", type=float, default=0.0)
    sp.add_argument("--negativeRadius", type=int, default=20)
    sp.add_argument("--border", type=int, default=0)
    sp.add_argument("--no-name-labels", dest="noNameLabels",
                    action="store_true",
                    help="do not exclude the name label region")
    sp.add_argument("--no-colormap-labels", dest="noColormapLabels",
                    action="store_true",
                    help="do not exclude the color scale label region")
    sp.add_argument("--processingPartitionSize", "-ps",
                    "--libraryPartitionSize", type=int, default=100)
    sp.add_argument("--query-roi-mask", dest="queryROIMask", default=None)
    sp.add_argument("--masksFilter", "-mf", nargs="*", default=[],
                    help="only score masks whose name/id contains one of "
                         "these (case-insensitive)")
    sp.add_argument("--libraryFilter", "-lf", nargs="*", default=[],
                    help="only score targets whose name/id contains one "
                         "of these (case-insensitive)")
    sp.add_argument("--app", default="ColorMIPSearch",
                    help="accepted for reference parity")
    # default=SUPPRESS so the subcommand flag does not clobber a value
    # given before the subcommand (the global --cdsConcurrency)
    sp.add_argument("--cdsConcurrency", "--task-concurrency", "-tc",
                    "-cdc", dest="cdsConcurrency", type=int,
                    default=argparse.SUPPRESS,
                    help="decode-thread concurrency (reference "
                         "--cdsConcurrency); device dispatch is batched")
    sp.add_argument("--use-key-planes", action="store_true",
                    default=None,
                    help="rank-key interval kernel: exact device "
                         "verdicts with no oracle fallback (also "
                         "CDS_KEY_PLANES=1); alone it selects the classic "
                         "key kernel")
    sp.add_argument("--use-union-keys", nargs="?", const="full",
                    choices=["x", "full", "off"], default=None,
                    help="union lane form of the rank-key kernel (default "
                         "'full': one dilated union per orientation); 'x' "
                         "gathers the x-dilated union per dy-set, 'off' "
                         "falls back to the classic kernels; implies "
                         "--use-key-planes (also CDS_UNION_KEYS=full|x|0)")


def _neuron_name_filter(neurons, patterns):
    """Case-insensitive substring filter over mip id / published name /
    input image name (CommonArgs.toLowerCase + readMIPs filters)."""
    if not patterns:
        return neurons
    pats = [p.lower() for p in patterns if p]

    def hit(n):
        fd = n.compute_file(ComputeFileType.InputColorDepthImage)
        hay = " ".join(filter(None, (
            n.mip_id, n.published_name,
            fd.name if fd is not None else None))).lower()
        return any(p in hay for p in pats)

    return [n for n in neurons if hit(n)]


def _add_output_args(sp):
    sp.add_argument("-od", "--outputDir", "--output-dir",
                    required=False, default=None)
    sp.add_argument("--perMaskSubdir", default=None)
    sp.add_argument("--perTargetSubdir", default=None)
    sp.add_argument("--no-pretty-print", dest="noPrettyPrint",
                    action="store_true")
    sp.add_argument("--results-storage", dest="resultsStorage",
                    choices=["FS", "DB"], default="FS")
    sp.add_argument("--config", dest="configFile", default=None,
                    help="properties file for the DB storage backend")


def _cds_params(args) -> CDSParams:
    return CDSParams(
        mask_threshold=args.maskThreshold,
        data_threshold=args.dataThreshold,
        pix_color_fluctuation=args.pixColorFluctuation,
        xy_shift=args.xyShift,
        mirror_mask=args.mirrorMask,
        pct_positive_pixels=args.pctPositivePixels,
        negative_radius=args.negativeRadius,
        border_size=args.border,
        with_name_label_region=not args.noNameLabels,
        with_color_scale_region=not args.noColormapLabels,
        processing_partition_size=args.processingPartitionSize,
    )


def _out_dirs(args):
    if not args.outputDir:
        # without this the JSON writer is a silent no-op and a long
        # search would be discarded after computing
        raise ValueError(
            "--outputDir is required with --results-storage FS "
            "(results would be written nowhere)")
    out = Path(args.outputDir)
    per_mask = out / args.perMaskSubdir if args.perMaskSubdir else out
    per_target = out / args.perTargetSubdir if args.perTargetSubdir else None
    return per_mask, per_target


# -------------------------------------------------------------------------
# v3: colorDepthSearch
# -------------------------------------------------------------------------


def configure_color_depth_search(sp):
    sp.add_argument("-m", "--masks", nargs="+", required=True,
                    help="neuron-metadata JSON file(s) with the masks "
                         "(location[:offset[:length]])")
    sp.add_argument("-i", "--targets", nargs="+", required=True,
                    help="neuron-metadata JSON file(s) with the targets")
    sp.add_argument("--masks-index", type=int, default=0)
    sp.add_argument("--masks-length", type=int, default=-1)
    sp.add_argument("--targets-index", type=int, default=0)
    sp.add_argument("--targets-length", type=int, default=-1)
    sp.add_argument("--masks-tags", nargs="*", default=None)
    sp.add_argument("--targets-tags", nargs="*", default=None)
    sp.add_argument("--masks-published-names", nargs="*", default=None)
    sp.add_argument("--targets-published-names", nargs="*", default=None)
    sp.add_argument("--masks-datasets", nargs="*", default=None)
    sp.add_argument("--targets-datasets", nargs="*", default=None)
    sp.add_argument("--masks-terms", nargs="*", default=None,
                    help="neuron annotations (terms) required on masks")
    sp.add_argument("--targets-terms", nargs="*", default=None)
    sp.add_argument("--excluded-masks-terms", nargs="*", default=None)
    sp.add_argument("--excluded-targets-terms", nargs="*", default=None)
    sp.add_argument("--excluded-mips", nargs="*", default=None,
                    help="mip ids (or @files listing them) to skip — the "
                         "resume mechanism of partial re-runs")
    sp.add_argument("--alignment-space", "-as", default=None)
    sp.add_argument("--processing-tag", dest="processingTag", default="")
    sp.add_argument("--mips-storage", dest="mipsStorage",
                    choices=["FS", "DB"], default="FS",
                    help="FS: -m/-i are neuron JSON files (the port has "
                         "no DB backend)")
    sp.add_argument("--update-matches", dest="updateMatches",
                    action="store_true")
    sp.add_argument("--max-matches-per-mask", dest="maxMatchesPerMask",
                    type=int, default=0,
                    help="keep only the N best matches per mask (0 = keep "
                         "all, the reference behavior)")
    sp.add_argument("--write-batch-size", dest="writeBatchSize",
                    type=int, default=10000,
                    help="flush results to storage every N matches "
                         "instead of holding the full set in RAM")
    sp.add_argument("--parallel-write-results", dest="parallelWrite",
                    action="store_true",
                    help="accepted for reference parity; grouped-file "
                         "writes already run on a thread pool")
    sp.add_argument("--use-spark", dest="useSpark", action="store_true",
                    help="accepted for reference parity")
    _add_device_arg(sp)
    _add_cds_params(sp)
    _add_output_args(sp)


def _add_device_arg(sp):
    sp.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: the hand-written CUDA kernels (an error "
                         "without a GPU); cpu: their plain PyTorch "
                         "versions")


def _load_excluded_mips(specs) -> set:
    """Excluded mip ids, given inline, as @file lists (one id per line or
    a JSON array of ids/neurons), or as paths to such files.

    The parser's ``fromfile_prefix_chars='@'`` expands ``@file`` argv
    tokens into per-line arguments BEFORE parsing, so a line-per-id file
    arrives here as individual ids and a single-line JSON-array file as
    one ``[...]`` string; both are handled, as are literal ``@file``
    specs from programmatic callers and plain paths to list files."""
    def add_json_items(items):
        for item in items:
            out.add(item if isinstance(item, str)
                    else item.get("mipId") or item.get("id"))

    def add_text(text):
        text = text.strip()
        if text.startswith("["):
            add_json_items(json.loads(text))
        else:
            out.update(line.strip() for line in text.splitlines()
                       if line.strip())

    out: set = set()
    for spec in specs or ():
        if spec.startswith("@"):
            with open(spec[1:]) as f:
                add_text(f.read())
        elif spec.startswith("["):
            add_json_items(json.loads(spec))
        elif spec.endswith(".json") and os.path.exists(spec):
            with open(spec) as f:
                add_text(f.read())
        else:
            out.add(spec)
    out.discard(None)
    return out


def _read_neuron_sources(specs, index, length, tags, names,
                         datasets=None, terms=None,
                         excluded_terms=None) -> list[Neuron]:
    out: list[Neuron] = []
    for spec in specs:
        arg = ListArg.parse(spec)
        out.extend(read_neurons_json(arg.location, arg.offset, arg.length))
    if index > 0:
        out = out[index:]
    if length > 0:
        out = out[:length]
    if tags:
        out = [n for n in out if n.tags & set(tags)]
    if names:
        out = [n for n in out if n.published_name in set(names)]
    if datasets:
        out = [n for n in out if n.dataset_labels & set(datasets)]
    if terms:
        out = [n for n in out if set(n.neuron_terms or ()) & set(terms)]
    if excluded_terms:
        out = [n for n in out
               if not set(n.neuron_terms or ()) & set(excluded_terms)]
    return out


def cmd_color_depth_search(args) -> int:
    if args.mipsStorage == "DB" or args.resultsStorage == "DB":
        raise not_ported("the DB storage backend (--mips-storage DB / "
                          "--results-storage DB)",
                          "host-only CLI commands")
    device = torch.device(args.device)
    masks = _read_neuron_sources(
        args.masks, args.masks_index, args.masks_length,
        args.masks_tags, args.masks_published_names,
        args.masks_datasets, args.masks_terms, args.excluded_masks_terms)
    targets = _read_neuron_sources(
        args.targets, args.targets_index, args.targets_length,
        args.targets_tags, args.targets_published_names,
        args.targets_datasets, args.targets_terms,
        args.excluded_targets_terms)
    excluded = _load_excluded_mips(args.excluded_mips)
    if excluded:
        masks = [m for m in masks if m.mip_id not in excluded]
        targets = [t for t in targets if t.mip_id not in excluded]
    masks = _neuron_name_filter(masks, args.masksFilter)
    targets = _neuron_name_filter(targets, args.libraryFilter)
    LOG.info("colorDepthSearch: %d masks x %d targets on %s",
             len(masks), len(targets), device)
    params = _cds_params(args)
    engine = CDSearchEngine(
        params, device=device,
        # --cdsConcurrency sizes the host decode/plan threads; default
        # to the core count
        decode_concurrency=getattr(args, "cdsConcurrency", 0)
        if getattr(args, "cdsConcurrency", 0) > 0
        else max(2, os.cpu_count() or 1),
        use_key_planes=getattr(args, "use_key_planes", None),
        use_union_keys=getattr(args, "use_union_keys", None))
    tags = [args.processingTag] if args.processingTag else []
    cap = max(args.maxMatchesPerMask, 0)
    batch_size = max(args.writeBatchSize, 1)

    # streaming result writes: flush every --write-batch-size matches
    # instead of holding the full match set in RAM (the reference writes
    # in partitions too — ColorDepthSearchCmd.java:297-316)
    per_mask, per_target = _out_dirs(args)
    write_cds_session(args.outputDir, [str(s) for s in args.masks],
                      [str(s) for s in args.targets], params.as_map(),
                      pretty=not args.noPrettyPrint)
    writer = JSONMatchesWriter(
        per_masks_dir=per_mask, per_targets_dir=per_target,
        pretty=not args.noPrettyPrint,
        # CDS results are ordered by matching pixels desc
        # (ColorDepthSearchCmd.java:383)
        ordering=lambda m: -(m.matching_pixels or 0))

    total = 0
    if cap > 0:
        # the cap already bounds memory (masks x cap), and the global
        # per-mask trim needs all tiles — collect then write once
        matches = engine.find_all_matches(masks, targets, tags=tags,
                                          max_matches_per_mask=cap)
        writer.write(matches, append=True)
        total = len(matches)
    else:
        pending: list = []
        first_flush = True
        for chunk in engine.find_all_matches_iter(masks, targets,
                                                  tags=tags):
            pending.extend(chunk)
            if len(pending) >= batch_size:
                writer.write(pending, append=True)
                total += len(pending)
                first_flush = False
                pending = []
        if pending or first_flush:
            writer.write(pending, append=True)
            total += len(pending)
    writer.close()  # flush deferred streaming rows
    LOG.info("wrote %d matches to grouped files", total)
    # one machine-parseable line with every stage counter
    LOG.info("cds stage seconds: %s", json.dumps(stage_seconds()))
    return 0


_STAGES = {
    "cds": ("prepMasks", "decodeTargets", "packUpload", "scoreAllPairs",
            "planArgs", "dispatch", "emit", "rescore", "packSelect",
            "packScatter"),
    "gs": ("queryPack", "storeLookup", "storeUpload", "deviceTileBuild",
           "storeGather", "dispatch"),
}


def stage_seconds(engine: str = "cds") -> dict:
    """The per-stage seconds so far of the pixel-match ("cds") or the
    shape ("gs") engine (utils/metrics GLOBAL)."""
    from colormipsearch_tpu_torch.utils.metrics import GLOBAL

    return {s: round(GLOBAL.get(f"{engine}.{s}.seconds"), 2)
            for s in _STAGES[engine]}


# -------------------------------------------------------------------------
# v3: gradientScores
# -------------------------------------------------------------------------


def configure_gradient_scores(sp):
    sp.add_argument("--matches", "--masks-libraries", "-md", nargs="+",
                    required=True, dest="matches",
                    help="mask match sources, lib[:offset[:length]] "
                         "(AbstractGradientScoresArgs --masks-libraries): "
                         "directories/files of per-mask grouped match "
                         "JSON")
    sp.add_argument("--matches-index", type=int, default=0)
    sp.add_argument("--matches-length", type=int, default=-1)
    common.add_gradient_selector_args(sp)
    sp.add_argument("--nBestLines", type=int, default=-1)
    sp.add_argument("--nBestSamplesPerLine", type=int, default=-1)
    sp.add_argument("--nBestMatchesPerSample", type=int, default=-1)
    sp.add_argument("--processing-tag", dest="processingTag", default="")
    sp.add_argument("--process-partitions-concurrently",
                    dest="partitionsConcurrently", action="store_true",
                    help="accepted for reference parity; mask groups "
                         "already stream through batched device tiles")
    sp.add_argument("--use-device", action="store_true", default=True,
                    help="score with the shape kernels (default)")
    sp.add_argument("--no-use-device", dest="use_device",
                    action="store_false",
                    help="score every pair with the float64 oracle")
    sp.add_argument("--packed-variants-store", dest="packStore",
                    default=None, metavar="DIR",
                    help="decode-once packed-variant store directory "
                         "(io/shape_pack.py): per-target shape fields "
                         "persist across runs, so rescoring a library "
                         "skips image decode/dilation entirely; built "
                         "on first use (also CDS_SHAPE_PACK_DIR)")
    _add_device_arg(sp)
    _add_cds_params(sp)
    _add_output_args(sp)


def cmd_gradient_scores(args) -> int:
    from colormipsearch_tpu_torch.engine.gradscore import GradScoreEngine

    if args.resultsStorage == "DB":
        raise not_ported("the DB storage backend (--results-storage DB)",
                         "host-only CLI commands")
    params = _cds_params(args)
    pack_store = args.packStore or os.environ.get("CDS_SHAPE_PACK_DIR") \
        or None
    engine = GradScoreEngine(
        params, device=torch.device(args.device),
        use_device=args.use_device,
        decode_workers=getattr(args, "cdsConcurrency", 0) or None,
        pack_store=pack_store)
    locations = JSONMatchesReader.list_matches_locations(
        args.matches, args.matches_index, args.matches_length)
    per_mask, _ = _out_dirs(args)
    writer = JSONMatchesWriter(
        per_masks_dir=per_mask, pretty=not args.noPrettyPrint,
        ordering=lambda m: -(m.normalized_score or 0.0))
    LOG.info("gradientScores over %d match files on %s", len(locations),
             engine.device)

    # Device-resident shape store auto-default: at 32 or more mask files
    # the one-time field upload amortizes over enough masks (the JAX
    # package's measured break-even was ~27 masks); 0 disables the
    # auto-default, and an explicit CDS_SHAPE_STORE_DEVICE env always
    # wins. A per-invocation engine parameter, never a process-env
    # mutation.
    auto_thr = int(os.environ.get("CDS_SHAPE_STORE_DEVICE_AUTO_MASKS",
                                  "32"))
    if (pack_store and "CDS_SHAPE_STORE_DEVICE" not in os.environ
            and auto_thr > 0 and len(locations) >= auto_thr):
        engine.device_store = True
        LOG.info("device-resident shape store auto-enabled: %d mask "
                 "files >= %d (set CDS_SHAPE_STORE_DEVICE=0 to force "
                 "the host tile pack)", len(locations), auto_thr)

    roi_rgb = None
    if args.queryROIMask:
        roi_rgb = mips_io.load_image(FileData(args.queryROIMask)).as_rgb()

    for loc in locations:
        matches = JSONMatchesReader.read_matches(loc)
        if args.pctPositivePixels > 0:
            thr = args.pctPositivePixels / 100
            matches = [m for m in matches
                       if (m.matching_pixels_ratio or 0) >= thr]
        selected = select_best_matches(
            matches, args.nBestLines, args.nBestSamplesPerLine,
            args.nBestMatchesPerSample)
        scored = engine.score_matches(selected, roi_rgb=roi_rgb)
        if scored:
            if args.processingTag:
                for m in scored:
                    for n in (m.mask_image, m.matched_image):
                        if n is not None:
                            n.add_processed_tags(
                                ProcessingType.GradientScore,
                                [args.processingTag])
            writer.write_updates(scored)
    LOG.info("gs stage seconds: %s", json.dumps(stage_seconds("gs")))
    return 0
