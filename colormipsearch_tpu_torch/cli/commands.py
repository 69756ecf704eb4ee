"""CLI subcommands of the port (FS/JSON storage backend).

Each command mirrors its reference counterpart's flags and file formats:
  * colorDepthSearch            — cmd/ColorDepthSearchCmd.java:52-440
  * gradientScores              — cmd/CalculateGradientScoresCmd.java:67-461
  * normalizeGradientScores     — cmd/NormalizeGradientScoresCmd.java:92-239
  * createColorDepthSearchDataInput — cmd/CreateCDSDataInputCmd.java (local and JACS modes)
  * searchFromJSON / searchLocalFiles — cmd_v2/ColorDepthSearch*Cmd.java
  * mergeResults                — cmd_v2/MergeResultsCmd.java

The same flags and file formats as the JAX package's commands; the
commands that run the device also take ``--device {cuda,cpu}``.
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import re
from pathlib import Path

import torch

from colormipsearch_tpu_torch.cli import common
from colormipsearch_tpu_torch.dataio import v2_io
from colormipsearch_tpu_torch.dataio.json_io import (
    JSONMatchesReader,
    JSONMatchesWriter,
    read_neurons_json,
    write_cds_session,
    write_neurons_json,
)
from colormipsearch_tpu_torch.engine.cds import CDSParams, CDSearchEngine
from colormipsearch_tpu_torch.io import mips as mips_io
from colormipsearch_tpu_torch.io.mips import ListArg
from colormipsearch_tpu_torch.model import (
    ComputeFileType,
    EMNeuron,
    FileData,
    LMNeuron,
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


def _out_dirs(args, *, required: bool = False):
    out = Path(args.outputDir) if args.outputDir else None
    if out is None:
        if required:
            # without this the JSON writer is a silent no-op and a long
            # search would be discarded after computing
            raise ValueError(
                "--outputDir is required with --results-storage FS "
                "(results would be written nowhere)")
        return None, None
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
                    help="FS: -m/-i are neuron JSON files; DB: they are "
                         "library names in the metadata store")
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


def _daos(args):
    """The DAOs of the store that ``--config`` names (persist/)."""
    from colormipsearch_tpu_torch.persist import Config, DaosProvider

    return DaosProvider(Config(getattr(args, "configFile", None)))


def _read_db_neuron_sources(daos, alignment_space, specs, index, length,
                            tags, names, datasets=None, terms=None,
                            excluded_terms=None) -> list[Neuron]:
    """--mips-storage DB: each spec is a library name
    (location[:offset[:length]]) selected in the neuron store."""
    from colormipsearch_tpu_torch.persist.requests import (
        NeuronSelector,
        PagedRequest,
    )

    out: list[Neuron] = []
    for spec in specs:
        arg = ListArg.parse(spec)
        sel = NeuronSelector(
            alignment_space=alignment_space, libraries=[arg.location],
            tags=list(tags or ()), names=list(names or ()),
            datasets=list(datasets or ()), annotations=list(terms or ()),
            excluded_annotations=list(excluded_terms or ()))
        page = PagedRequest(offset=arg.offset, size=max(arg.length, 0))
        out.extend(daos.neuron_metadata_dao.find_neurons(sel, page))
    if index > 0:
        out = out[index:]
    if length > 0:
        out = out[:length]
    return out


def cmd_color_depth_search(args) -> int:
    device = torch.device(args.device)
    daos = _daos(args) if "DB" in (args.mipsStorage, args.resultsStorage) \
        else None
    read = functools.partial(_read_db_neuron_sources, daos,
                             args.alignment_space) \
        if args.mipsStorage == "DB" else _read_neuron_sources
    masks = read(
        args.masks, args.masks_index, args.masks_length,
        args.masks_tags, args.masks_published_names,
        args.masks_datasets, args.masks_terms, args.excluded_masks_terms)
    targets = read(
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
    # in partitions too — ColorDepthSearchCmd.java:297-316); DB flushes
    # are idempotent upserts, FS flushes merge into the grouped files
    if args.resultsStorage == "DB":
        from colormipsearch_tpu_torch.dataio.db_io import (
            DBNeuronMatchesWriter,
        )

        db_writer = DBNeuronMatchesWriter(daos)

        def flush(ms):
            # neurons read from files get their entity ids here (not
            # atomic across processes, as in the JAX package)
            for m in ms:
                for n in (m.mask_image, m.matched_image):
                    if n.entity_id is None:
                        daos.neuron_metadata_dao.create_or_update(n)
                m.mask_image_ref_id = m.mask_image.entity_id
                m.matched_image_ref_id = m.matched_image.entity_id
            return db_writer.write(ms)

        finish = None
    else:
        per_mask, per_target = _out_dirs(args, required=True)
        write_cds_session(args.outputDir, [str(s) for s in args.masks],
                          [str(s) for s in args.targets], params.as_map(),
                          pretty=not args.noPrettyPrint)
        writer = JSONMatchesWriter(
            per_masks_dir=per_mask, per_targets_dir=per_target,
            pretty=not args.noPrettyPrint,
            # CDS results are ordered by matching pixels desc
            # (ColorDepthSearchCmd.java:383)
            ordering=lambda m: -(m.matching_pixels or 0))

        def flush(ms):
            return writer.write(ms, append=True)

        finish = writer.close  # flush deferred streaming rows

    total = 0
    if cap > 0:
        # the cap already bounds memory (masks x cap), and the global
        # per-mask trim needs all tiles — collect then write once
        matches = engine.find_all_matches(masks, targets, tags=tags,
                                          max_matches_per_mask=cap)
        flush(matches)
        total = len(matches)
    else:
        pending: list = []
        first_flush = True
        for chunk in engine.find_all_matches_iter(masks, targets,
                                                  tags=tags):
            pending.extend(chunk)
            if len(pending) >= batch_size:
                flush(pending)
                total += len(pending)
                first_flush = False
                pending = []
        if pending or first_flush:
            flush(pending)
            total += len(pending)
    if finish is not None:
        finish()
    LOG.info("wrote %d matches to %s", total, "the DB store"
             if args.resultsStorage == "DB" else "grouped files")
    # one machine-parseable line with every stage counter
    LOG.info("cds stage seconds: %s", json.dumps(stage_seconds()))
    if daos is not None:
        LOG.info("db stage seconds: %s", json.dumps(stage_seconds("db")))
    return 0


_STAGES = {
    "cds": ("prepMasks", "decodeTargets", "packUpload", "scoreAllPairs",
            "planArgs", "dispatch", "emit", "rescore", "packSelect",
            "packScatter"),
    "gs": ("queryPack", "storeLookup", "storeUpload", "deviceTileBuild",
           "storeGather", "dispatch"),
    # the DB store's writes (each with its commit) and reads
    # (persist/store.py)
    "db": ("write", "read"),
}


def stage_seconds(engine: str = "cds") -> dict:
    """The per-stage seconds so far of the pixel-match ("cds") or the
    shape ("gs") engine, or of the DB store ("db") (utils/metrics
    GLOBAL)."""
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

    params = _cds_params(args)
    pack_store = args.packStore or os.environ.get("CDS_SHAPE_PACK_DIR") \
        or None
    engine = GradScoreEngine(
        params, device=torch.device(args.device),
        use_device=args.use_device,
        decode_workers=getattr(args, "cdsConcurrency", 0) or None,
        pack_store=pack_store)
    use_db = args.resultsStorage == "DB"
    if use_db:
        from colormipsearch_tpu_torch.dataio.db_io import (
            DBNeuronMatchesReader,
            DBNeuronMatchesWriter,
        )

        daos = _daos(args)
        db_reader = DBNeuronMatchesReader(daos)
        locations = db_reader.list_matches_locations(
            common.gradient_mask_sources(args))
        if args.matches_index > 0:
            locations = locations[args.matches_index:]
        if args.matches_length > 0:
            locations = locations[:args.matches_length]
        mask_selector = common.gradient_mask_selector(args)
        target_selector = common.gradient_target_selector(args)
        writer = DBNeuronMatchesWriter(daos)
    else:
        locations = JSONMatchesReader.list_matches_locations(
            args.matches, args.matches_index, args.matches_length)
        per_mask, _ = _out_dirs(args, required=True)
        writer = JSONMatchesWriter(
            per_masks_dir=per_mask, pretty=not args.noPrettyPrint,
            ordering=lambda m: -(m.normalized_score or 0.0))
    LOG.info("gradientScores over %d match %s on %s", len(locations),
             "mask ids" if use_db else "files", engine.device)

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
        if use_db:
            matches = db_reader.read_matches_by_mask(
                loc, min_ratio=args.pctPositivePixels / 100,
                alignment_space=args.alignmentSpace,
                mask_selector=mask_selector,
                target_selector=target_selector,
                match_tags=args.match_tags)
        else:
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
            if use_db and args.processingTag:
                # persist the tag on mask and target neurons
                # (CalculateGradientScoresCmd.updateProcessingTag)
                _tag_neurons(daos, scored, ProcessingType.GradientScore,
                             args.processingTag)
    LOG.info("gs stage seconds: %s", json.dumps(stage_seconds("gs")))
    if use_db:
        LOG.info("db stage seconds: %s", json.dumps(stage_seconds("db")))
    return 0


def _tag_neurons(daos, matches, ptype, tag) -> None:
    """Add a processing tag to the stored mask and target neurons of
    `matches`, each neuron once."""
    neurons = {id(n): n for m in matches
               for n in (m.mask_image, m.matched_image)
               if n is not None and n.entity_id is not None}
    daos.neuron_metadata_dao.add_processing_tags(neurons.values(), ptype,
                                                 [tag])


# -------------------------------------------------------------------------
# v3: normalizeGradientScores
# -------------------------------------------------------------------------


def configure_normalize_scores(sp):
    # NormalizeGradientScoresArgs extends AbstractGradientScoresArgs
    # extends AbstractColorDepthMatchArgs, so the normalize command
    # accepts the full CDS-param + selector surface
    # (cmd/NormalizeGradientScoresCmd.java:62)
    sp.add_argument("--matches", "--masks-libraries", "-md", nargs="+",
                    required=True, dest="matches",
                    help="mask match sources, lib[:offset[:length]]: "
                         "match files/dirs")
    sp.add_argument("--processing-tag", dest="processingTag", default="")
    common.add_gradient_selector_args(sp)
    _add_cds_params(sp)
    _add_output_args(sp)


def cmd_normalize_scores(args) -> int:
    """Recompute normalizedScore against per-mask maxima
    (cmd/NormalizeGradientScoresCmd.java:92-239)."""
    from colormipsearch_tpu_torch.engine.gradscore import (
        update_normalized_scores,
    )

    use_db = args.resultsStorage == "DB"
    if use_db:
        from colormipsearch_tpu_torch.dataio.db_io import (
            DBNeuronMatchesReader,
            DBNeuronMatchesWriter,
        )

        daos = _daos(args)
        db_reader = DBNeuronMatchesReader(daos)
        locations = db_reader.list_matches_locations(
            common.gradient_mask_sources(args))
        mask_selector = common.gradient_mask_selector(args)
        target_selector = common.gradient_target_selector(args)
        writer = DBNeuronMatchesWriter(daos)
    else:
        locations = JSONMatchesReader.list_matches_locations(args.matches)
        per_mask, _ = _out_dirs(args, required=True)
        writer = JSONMatchesWriter(
            per_masks_dir=per_mask, pretty=not args.noPrettyPrint,
            ordering=lambda m: -(m.normalized_score or 0.0))
    for loc in locations:
        if use_db:
            # the DB read pre-filters on gradientAreaGap >= 0 and the
            # selector scope (NormalizeGradientScoresCmd:232-251)
            matches = db_reader.read_matches_by_mask(
                loc, min_ratio=args.pctPositivePixels / 100,
                alignment_space=args.alignmentSpace,
                mask_selector=mask_selector,
                target_selector=target_selector,
                match_tags=args.match_tags, min_grad_score=0)
        else:
            matches = JSONMatchesReader.read_matches(loc)
        eligible = [m for m in matches
                    if m.gradient_area_gap is not None
                    and m.gradient_area_gap >= 0
                    and (m.matching_pixels_ratio or 0)
                    >= args.pctPositivePixels / 100]
        if not eligible:
            continue
        update_normalized_scores(eligible)
        writer.write_updates(eligible)
        if use_db and args.processingTag:
            # NormalizeGradientScoresCmd.updateProcessingTag:218-233
            _tag_neurons(daos, eligible,
                         ProcessingType.NormalizeGradientScore,
                         args.processingTag)
    if use_db:
        LOG.info("db stage seconds: %s", json.dumps(stage_seconds("db")))
    return 0


# -------------------------------------------------------------------------
# v3: createColorDepthSearchDataInput
# -------------------------------------------------------------------------


def configure_create_data_input(sp):
    sp.add_argument("-i", "--input", required=False, default=None,
                    help="image library location (dir or zip), "
                         "location[:offset[:length]]")
    sp.add_argument("--jacs-url", "--jacsURL", "--data-url",
                    dest="jacsURL", default=None,
                    help="JACS config server URL (or file:// dir of page "
                         "dumps) to ingest a library from instead of "
                         "local files")
    sp.add_argument("--authorization", default=None,
                    help="bearer token for the JACS server")
    sp.add_argument("--libraries-variants", "--librariesVariants",
                    "--libraryVariants", dest="librariesVariants",
                    nargs="*", default=[],
                    help="variantType:location[:suffix] mappings for "
                         "JACS ingest (e.g. GradientImage:/grad:_gradient)")
    sp.add_argument("-l", "--library", default=None,
                    help="library name recorded on the neurons")
    sp.add_argument("--alignment-space", "-as", default=None)
    sp.add_argument("--type", choices=["em", "lm", "auto"], default="auto")
    sp.add_argument("--gradients-location", nargs="*", default=[])
    sp.add_argument("--gradient-suffix", default="_gradient")
    sp.add_argument("--zgap-location", nargs="*", default=[])
    sp.add_argument("--zgap-suffix", default="_20pxRGB")
    sp.add_argument("--segmented-mips", nargs="*", default=[],
                    help="segmented/searchable image locations; each "
                         "matching image becomes a searchable neuron "
                         "entry (MIPsHandlingUtils.lookupSearchable...)")
    sp.add_argument("--segmentation-channel-base", type=int, default=1)
    sp.add_argument("--match-neuron-state", action="store_true")
    sp.add_argument("--tag", nargs="*", default=[],
                    help="tags stamped on every created neuron")
    sp.add_argument("--datasets", nargs="*", default=[],
                    help="JACS dataset filter for the ingest query")
    sp.add_argument("--releases", "-r", nargs="*", default=[],
                    help="JACS release filter for the ingest query")
    sp.add_argument("--mips", nargs="*", default=[],
                    help="only create inputs for these specific mip ids")
    sp.add_argument("--included-libraries", nargs="*", default=[],
                    help="MIPs must also be in ALL these libraries "
                         "(CreateCDSDataInputCmd.checkLibraries)")
    sp.add_argument("--excluded-libraries", nargs="*", default=[],
                    help="MIPs must not be in ANY of these libraries")
    sp.add_argument("--for-update", dest="forUpdate",
                    action="store_true",
                    help="merge into an existing output file instead of "
                         "overwriting")
    sp.add_argument("--excluded-neurons", nargs="*", default=[],
                    help="mip ids / published names to skip")
    sp.add_argument("--included-neurons", "--included-published-names",
                    dest="includedNeurons", nargs="*", default=[],
                    help="only ingest these mip ids / published names")
    sp.add_argument("--output-filename", default=None)
    sp.add_argument("--mips-storage", dest="mipsStorage",
                    choices=["FS", "DB"], default="FS")
    _add_output_args(sp)


def cmd_create_data_input(args) -> int:
    if args.jacsURL:
        return _create_data_input_from_jacs(args)
    if not args.input:
        raise SystemExit("either -i/--input or --jacs-url is required")
    arg = ListArg.parse(args.input)
    files = arg.apply(mips_io.list_image_files(arg.location))
    lib = args.library or os.path.basename(arg.location.rstrip("/"))
    cls = {"em": EMNeuron, "lm": LMNeuron, "auto": None}[args.type]
    neurons = mips_io.neurons_from_image_files(
        files, library_name=lib, alignment_space=args.alignment_space,
        neuron_cls=cls)
    if args.segmented_mips:
        # expand each source MIP into one searchable neuron per matching
        # segmented image (CreateCDSDataInputCmd --segmented-mips)
        import dataclasses as _dc

        from colormipsearch_tpu_torch.io import naming

        index = naming.index_segmented_images(args.segmented_mips)
        expanded = []
        for n in neurons:
            src = n.compute_file(ComputeFileType.InputColorDepthImage)
            n.set_compute_file(
                ComputeFileType.SourceColorDepthImage, src)
            found = naming.lookup_searchable_images(
                n, index, channel_base=args.segmentation_channel_base,
                match_neuron_state=args.match_neuron_state)
            if not found:
                expanded.append(n)
                continue
            for fd2 in found:
                dup = _dc.replace(
                    n, compute_files=dict(n.compute_files),
                    tags=set(n.tags))
                dup.set_compute_file(
                    ComputeFileType.InputColorDepthImage, fd2)
                expanded.append(dup)
        neurons = expanded
    for n in neurons:
        fd = n.compute_file(ComputeFileType.InputColorDepthImage)
        if args.gradients_location:
            g = mips_io.find_variant(fd, args.gradients_location,
                                     args.gradient_suffix)
            if g is not None:
                n.set_compute_file(ComputeFileType.GradientImage, g)
        if args.zgap_location:
            z = mips_io.find_variant(fd, args.zgap_location,
                                     args.zgap_suffix)
            if z is not None:
                n.set_compute_file(ComputeFileType.ZGapImage, z)
    return _write_data_input(args, neurons, lib)


def _write_data_input(args, neurons, lib) -> int:
    # neuron include/exclude filters + created-neuron tags
    # (CreateCDSDataInputCmd --excluded-neurons/--included-neurons/--tag)
    excluded = set(args.excluded_neurons)
    included = set(args.includedNeurons)
    if excluded:
        neurons = [n for n in neurons
                   if n.mip_id not in excluded
                   and (n.published_name or "") not in excluded]
    if included:
        neurons = [n for n in neurons
                   if n.mip_id in included
                   or (n.published_name or "") in included]
    only_mips = set(args.mips)
    if only_mips:
        neurons = [n for n in neurons if n.mip_id in only_mips]
    for tag in args.tag:
        for n in neurons:
            n.tags.add(tag)
    if args.mipsStorage == "DB":
        from colormipsearch_tpu_torch.dataio.db_io import DBCDMIPsWriter

        n = DBCDMIPsWriter(_daos(args)).write(neurons)
        LOG.info("wrote %d neurons to the DB store", n)
        LOG.info("db stage seconds: %s", json.dumps(stage_seconds("db")))
        return 0
    out_name = args.output_filename or f"{lib}.json"
    out_dir = args.outputDir or "."
    out_path = Path(out_dir) / out_name
    if args.forUpdate and out_path.exists():
        # --for-update: merge into the existing file, replacing entries
        # with the same mipId (CreateCDSDataInputCmd args.forUpdate)
        merged = {n.mip_id: n for n in read_neurons_json(out_path)}
        merged.update({n.mip_id: n for n in neurons})
        neurons = list(merged.values())
    write_neurons_json(neurons, out_path, pretty=not args.noPrettyPrint)
    LOG.info("wrote %d neurons to %s", len(neurons), out_path)
    return 0


def _create_data_input_from_jacs(args) -> int:
    """JACS-backed ingest (CreateCDSDataInputCmd online mode)."""
    from colormipsearch_tpu_torch.io.jacs import (
        JacsClient,
        load_library_neurons,
    )

    if not args.library:
        raise SystemExit("--library is required with --jacs-url")
    variant_locations: dict = {}
    variant_suffixes: dict = {}
    for spec in args.librariesVariants:
        parts = spec.split(":")
        if len(parts) < 2:
            continue
        vtype, location = parts[0], parts[1]
        variant_locations.setdefault(vtype, []).append(location)
        if len(parts) > 2:
            variant_suffixes[vtype] = parts[2]
    client = JacsClient(args.jacsURL, auth_token=args.authorization)
    neurons = load_library_neurons(
        client, library=args.library,
        alignment_space=args.alignment_space,
        variant_locations=variant_locations or None,
        variant_suffixes=variant_suffixes or None,
        datasets=args.datasets, releases=args.releases, mips=args.mips,
        included_libraries=args.included_libraries,
        excluded_libraries=args.excluded_libraries)
    return _write_data_input(args, neurons, args.library)


# -------------------------------------------------------------------------
# v2: searchFromJSON / searchLocalFiles
# -------------------------------------------------------------------------


def _add_v2_variant_args(sp):
    """v2 variant lookup + fused shape scoring flags
    (cmd_v2/AbstractColorDepthMatchArgs.java:42-63)."""
    sp.add_argument("--with-grad-scores", dest="withGradScores",
                    action="store_true",
                    help="also compute negative/shape scores in the same "
                         "pass when gradient images are available")
    sp.add_argument("--gradientPath", "-gp", nargs="*", default=[])
    sp.add_argument("--gradientSuffix", default="_gradient")
    sp.add_argument("--zgapPath", "-zgp", nargs="*", default=[])
    sp.add_argument("--zgapSuffix", default="_20pxRGB")
    sp.add_argument("--librarySuffix", default=None,
                    help="suffix stripped from the library image name "
                         "before appending the variant suffix")
    sp.add_argument("--gradientVariant", default="gradient",
                    help="variant-dictionary key for gradient images")
    sp.add_argument("--zgapVariant", default="zgap",
                    help="variant-dictionary key for zgap images")
    sp.add_argument("--perLibrarySubdir", default=None,
                    help="also write results grouped per matched target "
                         "(cmd_v2 AbstractColorDepthMatchArgs:88-92)")


def configure_search_from_json(sp):
    sp.add_argument("-m", "--masks", nargs="+", required=True,
                    help="v2 MIP-list JSON file(s), location[:offset[:length]]")
    sp.add_argument("-i", "--images", "--targets", dest="targets", nargs="+",
                    required=True)
    sp.add_argument("--masks-index", type=int, default=0,
                    help="start offset applied to mask lists without an "
                         "inline :offset (ColorDepthSearchJSONInputCmd)")
    sp.add_argument("--masks-length", type=int, default=0)
    sp.add_argument("--images-index", type=int, default=0,
                    help="start offset applied to target lists without "
                         "an inline :offset")
    sp.add_argument("--images-length", type=int, default=0)
    _add_device_arg(sp)
    _add_cds_params(sp)
    _add_v2_variant_args(sp)
    _add_output_args(sp)


def configure_search_local_files(sp):
    sp.add_argument("-m", "-q", "--queries", dest="masks", nargs="+",
                    required=True, help="mask images location (dir/zip/file)")
    sp.add_argument("-i", "-t", "--targets", dest="targets", nargs="+",
                    required=True, help="target images location")
    sp.add_argument("--search-name", dest="searchName", default=None,
                    help="name for the saved cds parameters record "
                         "(default <masks>-<targets>-cdsparams.json)")
    sp.add_argument("--viewableTargets", nargs="*", default=[],
                    help="accepted for reference parity; viewable image "
                         "substitution happens at export time")
    _add_device_arg(sp)
    _add_cds_params(sp)
    _add_v2_variant_args(sp)
    _add_output_args(sp)


def _mip_to_neuron(mip: v2_io.MIPMetadata) -> Neuron:
    lib = (mip.libraryName or "").lower()
    cls = EMNeuron if ("flyem" in lib or "_em_" in lib) else LMNeuron
    n = cls(mip_id=mip.id, library_name=mip.libraryName,
            published_name=mip.publishedName,
            alignment_space=mip.alignmentSpace)
    n.set_compute_file(ComputeFileType.InputColorDepthImage, mip.file_data())
    return n


def _neuron_to_mip(n: Neuron) -> v2_io.MIPMetadata:
    fd = n.compute_file(ComputeFileType.InputColorDepthImage)
    m = v2_io.MIPMetadata(
        id=n.mip_id, publishedName=n.published_name,
        libraryName=n.library_name, alignmentSpace=n.alignment_space)
    if fd is not None:
        if fd.is_zip_entry:
            m.imageArchivePath = fd.file_name
            m.imageName = fd.entry_name
            m.imageType = "zipEntry"
        else:
            m.imageName = fd.file_name
            m.imageType = "file"
    return m


def _cds_name(args) -> str:
    """v2 cds parameters record name
    (ColorDepthSearchLocalMIPsCmd.getCDSName:193-200)."""
    if getattr(args, "searchName", None):
        return args.searchName
    def stem(specs):
        return "+".join(Path(ListArg.parse(s).location).stem
                        for s in specs)
    return f"{stem(args.masks)}-{stem(args.targets)}-cdsparams.json"


def _run_v2_search(args, masks, targets, mip_by_key) -> int:
    params = _cds_params(args)
    device = torch.device(args.device)
    engine = CDSearchEngine(
        params, device=device,
        use_key_planes=getattr(args, "use_key_planes", None),
        use_union_keys=getattr(args, "use_union_keys", None))
    if getattr(args, "outputDir", None):
        out_dir = Path(args.outputDir)
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / _cds_name(args), "w") as f:
            json.dump(params.as_map(), f, indent=2)
    LOG.info("v2 search: %d masks x %d targets on %s", len(masks),
             len(targets), device)
    matches = engine.find_all_matches(masks, targets)

    # fused pixel + shape pass (v2 PixelMatchWithNegativeScore
    # ColorDepthSearchAlgorithm:53-63): when requested and gradient
    # variants can be located, the matches found by the pixel pass get
    # their negative scores in the same run
    if getattr(args, "withGradScores", False) and args.gradientPath:
        from colormipsearch_tpu_torch.engine.gradscore import (
            GradScoreEngine,
        )

        for m in matches:
            t_fd = m.matched_image.compute_file(
                ComputeFileType.InputColorDepthImage)
            if t_fd is None:
                continue
            g = mips_io.find_variant(t_fd, args.gradientPath,
                                     args.gradientSuffix,
                                     cdm_suffix=args.librarySuffix)
            if g is not None:
                m.matched_image.set_compute_file(
                    ComputeFileType.GradientImage, g)
            z = mips_io.find_variant(t_fd, args.zgapPath, args.zgapSuffix,
                                     cdm_suffix=args.librarySuffix)
            if z is not None:
                m.matched_image.set_compute_file(
                    ComputeFileType.ZGapImage, z)
        GradScoreEngine(
            params, device=device,
            decode_workers=getattr(args, "cdsConcurrency", 0) or None,
        ).score_matches(matches)

    rows = []
    for m in matches:
        src = mip_by_key.get(id(m.mask_image)) or _neuron_to_mip(m.mask_image)
        tgt = mip_by_key.get(id(m.matched_image)) \
            or _neuron_to_mip(m.matched_image)
        row = v2_io.V2Match(
            source=src, target=tgt,
            matchingPixels=m.matching_pixels or 0,
            matchingRatio=m.matching_pixels_ratio or 0.0,
            mirrored=m.mirrored)
        if m.gradient_area_gap is not None and m.gradient_area_gap >= 0:
            row.gradientAreaGap = m.gradient_area_gap
            row.highExpressionArea = m.high_expression_area
            row.normalizedGapScore = m.normalized_score
        rows.append(row)
    per_mask, _ = _out_dirs(args)
    if per_mask is None:
        per_mask = Path(".")

    def write_groups(groups, out_dir):
        for g in groups:
            name = g.maskId or g.maskPublishedName or "results"
            name = re.sub(r"[^A-Za-z0-9._-]", "_", name)
            v2_io.write_cds_matches(g, out_dir / f"{name}.json",
                                    pretty=not args.noPrettyPrint)
        LOG.info("wrote %d v2 result files to %s", len(groups), out_dir)

    write_groups(v2_io.group_matches_by_source(rows), per_mask)
    if getattr(args, "perLibrarySubdir", None) and args.outputDir:
        write_groups(v2_io.group_matches_by_target(rows),
                     Path(args.outputDir) / args.perLibrarySubdir)
    return 0


def cmd_search_from_json(args) -> int:
    mip_by_key: dict[int, v2_io.MIPMetadata] = {}

    def load(specs, index=0, length=0):
        neurons = []
        for spec in specs:
            arg = ListArg.parse(spec)
            offset = arg.offset if arg.offset > 0 else index
            n_items = arg.length if arg.length > 0 else length
            for mip in v2_io.read_mips_json(arg.location, offset,
                                            n_items):
                n = _mip_to_neuron(mip)
                mip_by_key[id(n)] = mip
                neurons.append(n)
        return neurons

    return _run_v2_search(
        args,
        _neuron_name_filter(
            load(args.masks, args.masks_index, args.masks_length),
            args.masksFilter),
        _neuron_name_filter(
            load(args.targets, args.images_index, args.images_length),
            args.libraryFilter),
        mip_by_key)


def cmd_search_local_files(args) -> int:
    def load(specs):
        neurons = []
        for spec in specs:
            arg = ListArg.parse(spec)
            files = arg.apply(mips_io.list_image_files(arg.location))
            neurons.extend(mips_io.neurons_from_image_files(
                files, library_name=os.path.basename(arg.location.rstrip("/"))))
        return neurons

    return _run_v2_search(
        args,
        _neuron_name_filter(load(args.masks), args.masksFilter),
        _neuron_name_filter(load(args.targets), args.libraryFilter),
        {})


# -------------------------------------------------------------------------
# v2: mergeResults
# -------------------------------------------------------------------------


def configure_merge_results(sp):
    sp.add_argument("-rd", "--resultsDir", nargs="*", default=[],
                    help="directories of per-mask result files to merge")
    sp.add_argument("-rf", "--resultsFile", nargs="*", default=[],
                    help="explicit result files to merge (files with the "
                         "same basename combine into one output)")
    sp.add_argument("--pctPositivePixels", type=float, default=0.0,
                    help="only keep results with matchingRatio*100 > pct")
    sp.add_argument("-cleanup", "--cleanup", dest="cleanup",
                    action="store_true",
                    help="strip internal image-path/sampleRef fields "
                         "(ColorMIPSearchMatchMetadata.createReleaseCopy)")
    sp.add_argument("--excluded-names", nargs="*", default=[],
                    help="published names excluded from the merge")
    _add_output_args(sp)


def _release_copy(r: "v2_io.V2Match") -> "v2_io.V2Match":
    """Strip non-production fields
    (ColorMIPSearchMatchMetadata.createReleaseCopy:24-40)."""
    import dataclasses as _dc

    r = _dc.replace(r, source=_dc.replace(r.source),
                    target=_dc.replace(r.target))
    for side in (r.source, r.target):
        side.cdmPath = None
        side.imageType = None
        side.imageName = None
        side.imageArchivePath = None
    # only the target-side sampleRef is reset; sourceSampleRef survives
    # (ColorMIPSearchMatchMetadata.createReleaseCopy:24-40)
    r.target.sampleRef = None
    return r


def cmd_merge_results(args) -> int:
    """Merge per-mask result files across libraries, deduping pairs and
    keeping the best score (cmd_v2/MergeResultsCmd.java)."""
    if not args.resultsDir and not args.resultsFile:
        raise SystemExit("either --resultsDir or --resultsFile required")
    by_name: dict[str, list[Path]] = {}
    if args.resultsFile:
        # -rf takes precedence over -rd (MergeResultsCmd:106-110)
        for f in args.resultsFile:
            p = Path(f)
            by_name.setdefault(p.name, []).append(p)
    else:
        for d in args.resultsDir:
            for f in sorted(Path(d).glob("*.json")):
                by_name.setdefault(f.name, []).append(f)
    excluded = set(args.excluded_names or ())
    per_mask, _ = _out_dirs(args)
    if per_mask is None:
        per_mask = Path(".")
    for name, paths in by_name.items():
        merged: dict[tuple, v2_io.V2Match] = {}
        header = None
        for p in paths:
            g = v2_io.read_cds_matches(p)
            if header is None:
                header = g
            for r in g.results:
                # unconditional ratio gate (MergeResultsCmd:144):
                # matchingRatio 0 rows drop even at the 0.0 default
                if not r.matchingRatio * 100 > args.pctPositivePixels:
                    continue
                if excluded and (r.source.publishedName in excluded
                                 or r.target.publishedName in excluded):
                    continue
                if args.cleanup:
                    r = _release_copy(r)
                key = (r.source.id, r.target.id)
                cur = merged.get(key)
                # duplicates resolve by normalized score (gap score when
                # present), MergeResultsCmd's selectTopRankedElements
                if cur is None or r.normalized_score > \
                        cur.normalized_score:
                    merged[key] = r
        if header is None:
            continue
        header.results = sorted(merged.values(),
                                key=lambda r: -r.normalized_score)
        v2_io.write_cds_matches(header, per_mask / name,
                                pretty=not args.noPrettyPrint)
    LOG.info("merged %d result files", len(by_name))
    return 0
