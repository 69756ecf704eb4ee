"""v2 file-pipeline subcommands beyond search.

  * gradientScore                    — cmd_v2/CalculateNegativeScoresCmd.java:107-331
  * gradientScoresFromMatchedResults — cmd_v2/UpdateGradientScoresFromReverseSearchResultsCmd.java:176-321
  * createColorDepthSearchJSONInput  — cmd_v2/CreateColorDepthSearchJSONInputCmd.java
  * groupMIPsByPublishedName         — cmd_v2/GroupMIPsByPublishedNameCmd.java
  * replaceAttributes                — cmd_v2/ReplaceMIPsMetadataAttributesCmd.java
  * mergeMips                        — cmd_v2/MergeMipsCmd.java

The same flags and file formats as the JAX package's commands;
gradientScore also takes ``--device {cuda,cpu}``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
from pathlib import Path

import numpy as np
import torch

from colormipsearch_tpu_torch.cli.commands import _add_device_arg
from colormipsearch_tpu_torch.dataio import v2_io
from colormipsearch_tpu_torch.io import mips as mips_io
from colormipsearch_tpu_torch.io.mips import ListArg
from colormipsearch_tpu_torch.oracle.shape import ShapeMatchOracle, normalized_score
from colormipsearch_tpu_torch.oracle.pixel import label_regions_mask
from colormipsearch_tpu_torch.results.grouping import select_top_ranked

LOG = logging.getLogger(__name__)


def _result_files(args) -> list[str]:
    # -rf takes precedence over -rd, as in every reference command that
    # declares both (e.g. UpdateGradientScoresFromReverse...Cmd:166)
    if getattr(args, "resultsFile", None):
        return list(args.resultsFile)
    files: list[str] = []
    if getattr(args, "resultsDir", None):
        arg = ListArg.parse(args.resultsDir)
        listed = sorted(str(p) for p in Path(arg.location).glob("*.json"))
        files.extend(arg.apply(listed))
    return files


def _extract_publishing_name(image_name: str | None) -> str:
    """ColorMIPSearchResultUtils.extractPublishingNameCandidateFromImageName."""
    if not image_name:
        return ""
    base = os.path.basename(image_name)
    return base.split("_")[0].split("-")[0]


def _select_best_v2_rows(rows, top_lines, top_samples, top_matches):
    """Top lines (published name) -> top samples (slide code) per line
    -> top matches per sample, ranked by matching pixels
    (ColorMIPProcessUtils.selectBestMatches over v2 rows)."""
    top = select_top_ranked(
        rows,
        lambda r: (r.target.publishedName
                   or _extract_publishing_name(r.target.imageName)),
        lambda r: r.matchingPixels,
        top_lines, -1)
    out = []
    for se in top:
        for sub in select_top_ranked(
                se.entry,
                lambda r: r.target.slideCode or r.target.sampleRef or "",
                lambda r: r.matchingPixels,
                top_samples, top_matches):
            out.extend(sub.entry)
    return out


def select_for_grad_score(rows, top_lines, top_samples, top_matches):
    """pickBestPublishedNameAndSampleMatches (:141-165) over v2 rows."""
    for r in rows:
        r.gradientAreaGap = -1
    return _select_best_v2_rows(rows, top_lines, top_samples,
                                top_matches)


# -------------------------------------------------------------------------
# gradientScore (v2)
# -------------------------------------------------------------------------


def configure_gradient_score_v2(sp):
    sp.add_argument("--resultsDir", "-rd", default=None)
    sp.add_argument("--resultsFile", "-rf", nargs="*", default=None)
    sp.add_argument("--topPublishedNameMatches", type=int, default=-1)
    sp.add_argument("--topPublishedSampleMatches", type=int, default=-1)
    sp.add_argument("--topMatchesPerSample", type=int, default=-1)
    sp.add_argument("--maskThreshold", type=int, default=100)
    sp.add_argument("--mirrorMask", action="store_true")
    sp.add_argument("--negativeRadius", type=int, default=20)
    sp.add_argument("--gradientPath", "-gp", nargs="*", default=[])
    sp.add_argument("--gradientSuffix", default="_gradient")
    sp.add_argument("--zgapPath", "-zgp", nargs="*", default=[])
    sp.add_argument("--zgapSuffix", default="_20pxRGB")
    sp.add_argument("--no-name-labels", dest="noNameLabels",
                    action="store_true")
    sp.add_argument("--no-colormap-labels", dest="noColormapLabels",
                    action="store_true")
    sp.add_argument("--librarySuffix", default=None,
                    help="suffix stripped from the target image name "
                         "before appending the variant suffix")
    sp.add_argument("--gradientVariant", default="gradient",
                    help="variants-dictionary key tried before the "
                         "gradientPath lookup")
    sp.add_argument("--zgapVariant", default="zgap",
                    help="variants-dictionary key tried before the "
                         "zgapPath lookup")
    sp.add_argument("--with-grad-scores", dest="withGradScores",
                    action="store_true",
                    help="accepted for reference parity (this command "
                         "always computes the negative scores)")
    sp.add_argument("--dataThreshold", type=int, default=100,
                    help="accepted for reference parity")
    sp.add_argument("--pixColorFluctuation", type=float, default=2.0,
                    help="accepted for reference parity")
    sp.add_argument("--xyShift", type=int, default=0,
                    help="accepted for reference parity")
    sp.add_argument("--pctPositivePixels", type=float, default=0.0,
                    help="accepted for reference parity")
    sp.add_argument("--border", type=int, default=0)
    sp.add_argument("--query-roi-mask", dest="queryROIMask", default=None,
                    help="accepted for reference parity")
    sp.add_argument("--masksFilter", "-mf", nargs="*", default=[],
                    help="accepted for reference parity")
    sp.add_argument("--libraryFilter", "-lf", nargs="*", default=[],
                    help="accepted for reference parity")
    sp.add_argument("--perMaskSubdir", default=None)
    sp.add_argument("--perLibrarySubdir", default=None,
                    help="accepted for reference parity")
    sp.add_argument("--processingPartitionSize", "-ps",
                    "--libraryPartitionSize", type=int, default=100,
                    help="accepted for reference parity")
    sp.add_argument("--app", default="ColorMIPSearch",
                    help="accepted for reference parity")
    # SUPPRESS so the global pre-subcommand --cdsConcurrency survives;
    # all four aliases are one option (cmd/CommonArgs.java:16-17)
    sp.add_argument("--cdsConcurrency", "--task-concurrency", "-tc",
                    "-cdc", dest="cdsConcurrency", type=int,
                    default=argparse.SUPPRESS,
                    help="decode-thread concurrency")
    sp.add_argument("-od", "--outputDir", "--output-dir", required=True)
    sp.add_argument("--no-pretty-print", dest="noPrettyPrint",
                    action="store_true")
    sp.add_argument("--use-device", action="store_true", default=True,
                    help="score with the split shape kernel (default)")
    sp.add_argument("--no-use-device", dest="use_device",
                    action="store_false",
                    help="score every pair with the float64 oracle")
    sp.add_argument("--packed-variants-store", dest="packStore",
                    default=None, metavar="DIR",
                    help="decode-once packed-variant store "
                         "(io/shape_pack.py) — same store as the v3 "
                         "gradientScores command (also CDS_SHAPE_PACK_DIR)")
    _add_device_arg(sp)


def _score_rows_device(mask_rgb, region, args, rows, device):
    """Batched scoring on `device` of one mask's selected v2 rows via the
    split (gap-row / he-row) kernel K5 — same kernel as the v3
    GradScoreEngine.  rows: [(r, ("img", t_rgb, grad, zgap))] or
    [(r, ("row", zsl, grad_thr, tfg_bits))] (packed-store hits) with
    mask-shaped fields; mutates r.gradientAreaGap /
    r.highExpressionArea."""
    from colormipsearch_tpu_torch.ops import shape_score

    q_pack = shape_score.pack_query(
        mask_rgb, excluded_region=region)
    pos_gap, pos_he = shape_score.support_split(q_pack)
    n_gap = shape_score.support_bucket(pos_gap.size, minimum=1024)
    n_he = shape_score.he_words(pos_he.size)
    qg, qh = shape_score.sparse_query_split(q_pack, pos_gap, n_gap,
                                            pos_he, n_he)
    n_or = 2 if args.mirrorMask else 1
    q_gap = np.stack([qg] * n_or)
    q_he = np.stack([qh] * n_or)
    gather_plan = shape_score.split_gather_plan(
        pos_gap, pos_he, mask_rgb.shape[1], mirror=args.mirrorMask,
        excluded=region)
    cols = []
    for _, payload in rows:
        if payload[0] == "row":
            cols.append(shape_score.select_target_cols_split_from_row(
                payload[1], payload[2], payload[3], pos_gap, n_gap,
                n_he, gather_plan, mirror=args.mirrorMask))
        else:
            cols.append(shape_score.select_target_cols_split(
                payload[1], payload[2], payload[3], pos_gap, n_gap,
                pos_he, n_he, mask_threshold=args.maskThreshold,
                excluded=region, mirror=args.mirrorMask))
    t_gap, t_he = shape_score.assemble_target_rows_split(
        cols, n_gap, n_he, mirror=args.mirrorMask)
    gap, he, _ = shape_score.score_shape_batch_split(
        t_gap, t_he, q_gap, q_he, device=device)
    for i, (r, _) in enumerate(rows):
        r.gradientAreaGap = int(gap[i])
        r.highExpressionArea = int(he[i])


def cmd_gradient_score_v2(args) -> int:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available")
    pack_store = args.packStore or os.environ.get("CDS_SHAPE_PACK_DIR") \
        or None
    out_dir = Path(args.outputDir)
    for f in _result_files(args):
        g = v2_io.read_cds_matches(f)
        if not g.results:
            continue
        selected = select_for_grad_score(
            g.results, args.topPublishedNameMatches,
            args.topPublishedSampleMatches, args.topMatchesPerSample)
        # load the mask image (all rows share the source MIP)
        src_fd = g.results[0].source.file_data()
        try:
            mask_rgb = mips_io.load_image(src_fd).as_rgb()
        except (OSError, FileNotFoundError):
            LOG.error("cannot load mask image %s for %s", src_fd, f)
            continue
        h, w = mask_rgb.shape[:2]
        region = None
        if not (args.noNameLabels and args.noColormapLabels):
            region = label_regions_mask(
                w, h, with_name_label=not args.noNameLabels,
                with_color_scale_label=not args.noColormapLabels)
        if args.border > 0:
            # borderSize excludes the outer frame from the query region
            # (reference provider semantics)
            border = np.ones((h, w), bool)
            b = args.border
            border[b:h - b, b:w - b] = False
            region = border if region is None else (region | border)
        use_device = getattr(args, "use_device", True)
        oracle = None
        if not use_device:
            oracle = ShapeMatchOracle(
                mask_rgb, args.maskThreshold, mirror=args.mirrorMask,
                negative_radius=args.negativeRadius,
                excluded_region=region)
        store = None
        region_fp = "none"
        if use_device and pack_store:
            from colormipsearch_tpu_torch.io.shape_pack import ShapePackStore

            store = ShapePackStore(pack_store, h, w)
            if region is not None:
                import hashlib

                region_fp = hashlib.sha1(
                    np.packbits(region).tobytes()).hexdigest()[:12]

        def store_key(t_fd, grad_fd, z_fd, *, zgap_used):
            from colormipsearch_tpu_torch.io.shape_pack import file_identity

            cdm_id = file_identity(t_fd)
            grad_id = file_identity(grad_fd)
            if cdm_id is None or grad_id is None:
                return None
            zgap_id = file_identity(z_fd) if z_fd is not None else None
            if zgap_used is False:
                zgap_id = None
            return store.entry_key(
                cdm_id=cdm_id, grad_id=grad_id, zgap_id=zgap_id,
                mask_threshold=args.maskThreshold,
                fallback_desc=f"thr={args.maskThreshold},"
                              f"r={args.negativeRadius},"
                              f"region={region_fp}")

        def load_row(r):
            t_fd = r.target.file_data()
            # the MIP's own variants dictionary wins over location
            # conventions (MIPsUtils.getMIPVariantInfo:223-228)
            grad_fd = r.target.variant_file_data(args.gradientVariant) \
                or mips_io.find_variant(
                    t_fd, args.gradientPath, args.gradientSuffix,
                    cdm_suffix=args.librarySuffix)
            if grad_fd is None:
                return None
            z_fd = r.target.variant_file_data(args.zgapVariant) \
                or mips_io.find_variant(t_fd, args.zgapPath,
                                        args.zgapSuffix)
            if store is not None:
                key = store_key(t_fd, grad_fd, z_fd, zgap_used=None)
                row = store.lookup(key) if key else None
                if row is not None:
                    return (r, ("row", *store.row(row)))
            try:
                t_rgb = mips_io.load_image(t_fd).as_rgb()
                grad_img = mips_io.load_image(grad_fd).pixels
            except (OSError, FileNotFoundError, ValueError):
                return None
            if grad_img.ndim == 3:
                grad_img = grad_img.astype(np.int32).max(axis=-1)
            if t_rgb.shape[:2] != (h, w) or grad_img.shape != (h, w):
                return None
            zgap_rgb = None
            if z_fd is not None:
                try:
                    zgap_rgb = mips_io.load_image(z_fd).as_rgb()
                except (OSError, FileNotFoundError):
                    zgap_rgb = None
            zgap_used = zgap_rgb is not None \
                and zgap_rgb.shape[:2] == (h, w)
            if not zgap_used:
                # on-the-fly dilation fallback
                # (ShapeMatchColorDepthSearchAlgorithm:166-168)
                from colormipsearch_tpu_torch.oracle.shape import (
                    clear_region, dilate_rgb, mask_rgb as mask_fn)

                zgap_rgb = dilate_rgb(
                    mask_fn(clear_region(t_rgb, region),
                            args.maskThreshold), args.negativeRadius)
            grad_img = grad_img.astype(np.uint16)
            if store is not None:
                from colormipsearch_tpu_torch.io.shape_pack import (
                    build_row_fields)

                key = store_key(t_fd, grad_fd, z_fd, zgap_used=zgap_used)
                if key:
                    store.append(key, *build_row_fields(
                        t_rgb, grad_img, zgap_rgb,
                        mask_threshold=args.maskThreshold))
            return (r, ("img", t_rgb, grad_img, zgap_rgb))

        # decode the selected targets in parallel (same shared pool as
        # the v3 shape pass; decode and dilation release the GIL)
        from colormipsearch_tpu_torch.engine.gradscore import _shared_decode_pool

        n_workers = (getattr(args, "cdsConcurrency", 0)
                     or os.cpu_count() or 4)
        rows = [r for r in _shared_decode_pool(n_workers).map(
            load_row, selected) if r is not None]
        max_pixels, max_neg = -1, -1
        if rows and use_device:
            _score_rows_device(mask_rgb, region, args, rows, device)
        elif rows:
            for r, payload in rows:
                res = oracle.score(payload[1], payload[2], payload[3])
                r.gradientAreaGap = res.gradient_area_gap
                r.highExpressionArea = res.high_expression_area
        for r, _ in rows:
            max_pixels = max(max_pixels, r.matchingPixels)
            max_neg = max(max_neg,
                          r.gradientAreaGap + r.highExpressionArea // 2)
        for r in selected:
            if r.gradientAreaGap is not None and r.gradientAreaGap >= 0:
                r.normalizedGapScore = normalized_score(
                    r.matchingPixels, r.gradientAreaGap,
                    r.highExpressionArea, max_pixels, max_neg)
        g.results = sorted(selected, key=lambda r: -r.normalized_score)
        v2_io.write_cds_matches(g, out_dir / Path(f).name,
                                pretty=not args.noPrettyPrint)
        LOG.info("grad-scored %d results of %s", len(selected), f)
    return 0


# -------------------------------------------------------------------------
# gradientScoresFromMatchedResults (reverse transfer)
# -------------------------------------------------------------------------


def configure_reverse_transfer(sp):
    sp.add_argument("--resultsDir", "-rd", default=None)
    sp.add_argument("--resultsFile", "-rf", nargs="*", default=None)
    sp.add_argument("--reverseResultsDir", "-revd", required=True)
    sp.add_argument("--processingPartitionSize", "-ps", type=int,
                    default=10, help="accepted for reference parity")
    sp.add_argument("--topPublishedNameMatches", type=int, default=0,
                    help="only transfer scores for the top N lines per "
                         "mask (by matching pixels); all rows are still "
                         "written")
    sp.add_argument("--topPublishedSampleMatches", type=int, default=0,
                    help="top M samples per line")
    sp.add_argument("--topMatchesPerSample", type=int, default=0,
                    help="top K matches per sample")
    sp.add_argument("-od", "--outputDir", required=True)
    sp.add_argument("--no-pretty-print", dest="noPrettyPrint",
                    action="store_true")


def cmd_reverse_transfer(args) -> int:
    """Copy negative scores from reverse (EM->LM) result files into
    LM->EM files (UpdateGradientScoresFromReverseSearchResultsCmd:240-321):
    for each row, load the reverse file named after the row's target id,
    index its rows by their target id, look up this row's source id, match
    exactly by image name first, then at MIP level."""
    from collections import OrderedDict

    rev_dir = Path(args.reverseResultsDir)
    # LRU-bounded: reverse-file locality is per source file, so a small
    # bound loses almost no hits while keeping memory flat on
    # production-size runs (tens of thousands of distinct targets)
    rev_cache: OrderedDict[str, dict] = OrderedDict()
    rev_cache_max = 256

    def reverse_rows(mip_id: str) -> dict:
        if mip_id in rev_cache:
            rev_cache.move_to_end(mip_id)
            return rev_cache[mip_id]
        rows: dict[str, list] = {}
        p = rev_dir / f"{mip_id}.json"
        if p.exists():
            g = v2_io.read_cds_matches(str(p))
            for r in g.results:
                if r.gradientAreaGap is None or r.gradientAreaGap < 0:
                    continue
                rows.setdefault(r.target.id or "", []).append(r)
        rev_cache[mip_id] = rows
        while len(rev_cache) > rev_cache_max:
            rev_cache.popitem(last=False)
        return rows

    out_dir = Path(args.outputDir)
    for f in _result_files(args):
        g = v2_io.read_cds_matches(f)
        # the top* flags limit which rows GET a score transfer; every
        # row is still written (the reference declares these args but
        # updates and writes all rows — data must never be dropped here)
        if args.topPublishedNameMatches > 0 or \
                args.topPublishedSampleMatches > 0 or \
                args.topMatchesPerSample > 0:
            eligible = set(map(id, _select_best_v2_rows(
                g.results, args.topPublishedNameMatches,
                args.topPublishedSampleMatches,
                args.topMatchesPerSample)))
        else:
            eligible = None
        n_updates = 0
        for r in g.results:
            if eligible is not None and id(r) not in eligible:
                continue
            candidates = reverse_rows(r.target.id or "").get(
                r.source.id or "")
            if not candidates:
                continue
            rev = next(
                (c for c in candidates
                 if c.target.imageName and r.source.imageName
                 and os.path.basename(c.target.imageName)
                 == os.path.basename(r.source.imageName)),
                candidates[0])
            r.gradientAreaGap = rev.gradientAreaGap
            r.highExpressionArea = rev.highExpressionArea
            r.normalizedGapScore = rev.normalizedGapScore
            n_updates += 1
        g.results.sort(key=lambda r: -r.normalized_score)
        v2_io.write_cds_matches(g, out_dir / Path(f).name,
                                pretty=not args.noPrettyPrint)
        LOG.info("updated %d/%d results in %s", n_updates,
                 len(g.results), f)
    return 0


# -------------------------------------------------------------------------
# createColorDepthSearchJSONInput (local mode) / groupMIPsByPublishedName
# -------------------------------------------------------------------------


def configure_create_json_input_v2(sp):
    sp.add_argument("-i", "--input", required=False, default=None,
                    help="image library (dir or zip), location[:off[:len]]"
                         " (local mode)")
    sp.add_argument("-l", "--library", "--libraries", nargs="*",
                    default=None)
    sp.add_argument("--jacs-url", "--data-url", "--jacsURL",
                    dest="jacsURL", default=None,
                    help="JACS base URL (or file:// page-dump dir) — the "
                         "online mode of "
                         "CreateColorDepthSearchJSONInputCmd")
    sp.add_argument("--authorization", default=None)
    sp.add_argument("--config-url", dest="configURL", default=None,
                    help="config service /cdm_library mapping of internal "
                         "library ids to published display names")
    sp.add_argument("--alignment-space", "-as", default=None)
    sp.add_argument("--datasets", nargs="*", default=[],
                    help="JACS dataset filter")
    sp.add_argument("--releases", "-r", nargs="*", default=[],
                    help="JACS release filter")
    sp.add_argument("--included-libraries", nargs="*", default=[],
                    help="MIPs must also be in ALL these libraries")
    sp.add_argument("--excluded-libraries", nargs="*", default=[],
                    help="MIPs must not be in ANY of these libraries")
    sp.add_argument("--librariesVariants", "--libraryVariants",
                    dest="librariesVariants", nargs="*", default=[],
                    help="'library:variantType:location[:suffix]' variant "
                         "descriptors (MIPVariantArg)")
    sp.add_argument("--color-depth-mips-variant", dest="cdmVariantName",
                    default=None,
                    help="variants-dictionary entry naming the color "
                         "depth mips themselves")
    sp.add_argument("--segmented-mips-variant", dest="segmentedMips",
                    nargs="*", default=[],
                    help="segmented-image locations (or the name of a "
                         "--librariesVariants entry) matched to each MIP")
    sp.add_argument("--segmented-image-handling", type=lambda s: int(s, 0),
                    dest="segmentedImageHandling", default=0,
                    help="0: segmented if found else the original; 0x1: "
                         "original only when a segmentation exists; 0x2: "
                         "segmented only; 0x4: original + segmentations")
    sp.add_argument("--segmentation-channel-base", type=int, default=1,
                    choices=[0, 1])
    sp.add_argument("--include-mips-without-publishing-name",
                    dest="includeUnpublished", action="store_true")
    sp.add_argument("--excluded-names", nargs="*", default=[])
    sp.add_argument("--excluded-mips", nargs="*", default=[])
    sp.add_argument("--default-gender", default=None)
    sp.add_argument("--keep-dups", dest="keepDups", action="store_true")
    sp.add_argument("--urls-relative-to", dest="urlsRelativeTo",
                    type=int, default=-1)
    sp.add_argument("--append-output", dest="appendOutput",
                    action="store_true")
    sp.add_argument("--output-filename", default=None)
    sp.add_argument("-od", "--outputDir", default=".")
    sp.add_argument("--no-pretty-print", dest="noPrettyPrint",
                    action="store_true")


def _library_name_mapping(args) -> dict:
    """--config-url display-name mapping (shared with exportData)."""
    from colormipsearch_tpu_torch.cli.commands_export import (
        _load_library_name_mapping,
    )

    return _load_library_name_mapping(getattr(args, "configURL", None))


def _first_library(args) -> str | None:
    libs = args.library
    if isinstance(libs, str):
        return libs
    return libs[0] if libs else None


def _relative_url(path: str | None, index: int) -> str | None:
    if not path or index < 0:
        return path
    parts = [p for p in path.split("/") if p]
    return "/".join(parts[index:]) if index < len(parts) else path


def _jacs_mip_to_v2(rec: dict, library: str, args) -> v2_io.MIPMetadata:
    """JACS ColorDepthMIP record -> v2 MIPMetadata
    (CreateColorDepthSearchJSONInputCmd's asMIPInfo mapping over
    cmd/jacsdata/ColorDepthMIP.java fields)."""
    from colormipsearch_tpu_torch.io import naming

    sample = rec.get("sample") or {}
    em_body = rec.get("emBody") or {}
    is_em = naming.is_em_library(library)
    body = rec.get("bodyId") or em_body.get("name")
    published = (str(body) if is_em and body is not None
                 else sample.get("publishingName") or sample.get("line"))
    m = v2_io.MIPMetadata(
        id=rec.get("id") or rec.get("_id"),
        publishedName=published,
        libraryName=library,
        alignmentSpace=rec.get("alignmentSpace") or args.alignment_space,
        cdmPath=rec.get("filepath"),
        imageName=rec.get("filepath"),
        imageType="file",
        imageURL=_relative_url(rec.get("filepath"), args.urlsRelativeTo),
        slideCode=sample.get("slideCode"),
        objective=rec.get("objective"),
        anatomicalArea=rec.get("anatomicalArea"),
        channel=rec.get("channelNumber"),
        mountingProtocol=sample.get("mountingProtocol"),
        gender=sample.get("gender") or args.default_gender,
        neuronType=em_body.get("neuronType"),
        neuronInstance=em_body.get("neuronInstance"),
        sampleRef=rec.get("sampleRef"),
    )
    return m


def _create_json_input_v2_jacs(args) -> int:
    """Online mode: page the JACS libraries, map to v2 MIPMetadata,
    optionally substitute segmented searchable images, filter and write
    (CreateColorDepthSearchJSONInputCmd.java — the JACS-driven
    machinery)."""
    from colormipsearch_tpu_torch.io import naming
    from colormipsearch_tpu_torch.io.jacs import JacsClient

    client = JacsClient(args.jacsURL, auth_token=args.authorization)
    libraries = args.library if isinstance(args.library, list) \
        else [args.library]
    if not libraries or not libraries[0]:
        LOG.error("online mode requires -l/--libraries")
        return 1
    excluded_names = set(args.excluded_names or ())
    excluded_mips = set(args.excluded_mips or ())
    included_libs = set(args.included_libraries or ())
    excluded_libs = set(args.excluded_libraries or ())
    lib_names = _library_name_mapping(args)
    # variant descriptors 'library:variantType:location[:suffix]'
    # (MIPVariantArg); the segmentation variant's locations feed the
    # segmented-image substitution
    variants_by_lib: dict[tuple, list] = {}
    for spec in args.librariesVariants:
        parts = spec.split(":")
        if len(parts) >= 3:
            variants_by_lib.setdefault(
                (parts[0], parts[1]), []).append(parts[2])
    seg_locations = list(args.segmentedMips)
    for (lib, vtype), locs in variants_by_lib.items():
        if vtype in set(args.segmentedMips) or (
                not args.segmentedMips
                and vtype.lower() in ("segmentation", "searchable_neurons")):
            seg_locations.extend(locs)
    seg_locations = [loc for loc in seg_locations
                     if loc and os.path.exists(str(loc))]
    seg_index = naming.index_segmented_images(seg_locations) \
        if seg_locations else None
    handling = args.segmentedImageHandling

    out_mips: list = []
    seen = set()
    for library in libraries:
        for rec in client.color_depth_mips_with_samples(
                library=library, alignment_space=args.alignment_space,
                datasets=args.datasets, releases=args.releases):
            rec_libs = set(rec.get("libraries") or ())
            if included_libs and not included_libs <= rec_libs:
                continue
            if excluded_libs and rec_libs & excluded_libs:
                continue
            m = _jacs_mip_to_v2(rec, library, args)
            m.libraryName = lib_names.get(m.libraryName, m.libraryName)
            if m.id in excluded_mips:
                continue
            if not m.publishedName and not args.includeUnpublished:
                continue
            if m.publishedName in excluded_names:
                continue
            if not args.keepDups:
                key = (m.publishedName, m.slideCode, m.objective,
                       m.channel, m.cdmPath)
                if key in seen:
                    continue
                seen.add(key)
            if seg_index is not None:
                segmented = _matched_segmentations(m, seg_index, args)
                # --segmented-image-handling bitmask
                # (CreateColorDepthSearchJSONInputCmd.java:144-149)
                if handling & 0x4:
                    out_mips.append(m)
                    out_mips.extend(segmented)
                elif handling & 0x2:
                    out_mips.extend(segmented)
                elif handling & 0x1:
                    if segmented:
                        out_mips.append(m)
                else:
                    out_mips.extend(segmented if segmented else [m])
            else:
                out_mips.append(m)
    lib_name = libraries[0]
    out = Path(args.outputDir) / (
        args.output_filename or f"{lib_name.replace('/', '_')}.json")
    if args.appendOutput and out.exists():
        existing = v2_io.read_mips_json(out)
        known = {mm.id for mm in existing}
        out_mips = existing + [mm for mm in out_mips
                               if mm.id not in known]
    out.parent.mkdir(parents=True, exist_ok=True)
    v2_io.write_mips_json(out_mips, out, pretty=not args.noPrettyPrint)
    LOG.info("wrote %d MIPs to %s", len(out_mips), out)
    return 0


def _matched_segmentations(m: v2_io.MIPMetadata, seg_index, args) -> list:
    """One output MIP per matched segmented image, id-suffixed the way
    the reference emits a MIP per searchable segmentation."""
    import dataclasses as _dc

    from colormipsearch_tpu_torch.io import naming
    from colormipsearch_tpu_torch.model import EMNeuron, LMNeuron

    if naming.is_em_library(m.libraryName):
        neuron = EMNeuron(mip_id=m.id, published_name=m.publishedName)
    else:
        try:
            channel = int(m.channel) if m.channel is not None else None
        except (TypeError, ValueError):
            channel = None
        neuron = LMNeuron(mip_id=m.id, published_name=m.publishedName,
                          slide_code=m.slideCode, objective=m.objective,
                          channel=channel)
    files = naming.lookup_searchable_images(
        neuron, seg_index, channel_base=args.segmentation_channel_base)
    out = []
    for i, fd in enumerate(files):
        mm = _dc.replace(m) if i == 0 else _dc.replace(
            m, id=f"{m.id}-{i}" if m.id else None)
        mm.searchablePNG = fd.name
        mm.imageName = fd.file_name
        if fd.is_zip_entry:
            mm.imageArchivePath = fd.file_name
            mm.imageName = fd.entry_name
            mm.imageType = "zipEntry"
        out.append(mm)
    return out


def cmd_create_json_input_v2(args) -> int:
    if args.jacsURL:
        return _create_json_input_v2_jacs(args)
    if not args.input:
        LOG.error("local mode requires -i/--input")
        return 1
    arg = ListArg.parse(args.input)
    files = arg.apply(mips_io.list_image_files(arg.location))
    lib = _first_library(args) or os.path.basename(arg.location.rstrip("/"))
    mips = []
    for fd in files:
        base = os.path.basename(fd.name)
        stem = re.sub(r"\.[^.]+$", "", base)
        m = v2_io.MIPMetadata(
            id=stem, publishedName=_extract_publishing_name(base),
            libraryName=lib, alignmentSpace=args.alignment_space)
        if fd.is_zip_entry:
            m.imageArchivePath = fd.file_name
            m.imageName = fd.entry_name
            m.imageType = "zipEntry"
        else:
            m.imageName = fd.file_name
            m.imageType = "file"
        mips.append(m)
    out = Path(args.outputDir) / (args.output_filename or f"{lib}.json")
    v2_io.write_mips_json(mips, out, pretty=not args.noPrettyPrint)
    LOG.info("wrote %d MIPs to %s", len(mips), out)
    return 0


def configure_group_mips(sp):
    sp.add_argument("-i", "--input", nargs="*", default=[],
                    help="v2 MIP JSON list file(s) (local mode)")
    sp.add_argument("-l", "--library", "--libraries", nargs="*",
                    default=None, help="JACS libraries (online mode)")
    sp.add_argument("--jacs-url", "--data-url", "--jacsURL",
                    dest="jacsURL", default=None)
    sp.add_argument("--authorization", default=None)
    sp.add_argument("--config-url", dest="configURL", default=None,
                    help="config service /cdm_library display-name map")
    sp.add_argument("--alignment-space", "-as", default=None)
    sp.add_argument("--datasets", nargs="*", default=[],
                    help="JACS dataset filter")
    sp.add_argument("--included-libraries", nargs="*", default=[],
                    help="MIPs must also be in ALL these libraries")
    sp.add_argument("--excluded-libraries", nargs="*", default=[],
                    help="MIPs must not be in ANY of these libraries")
    sp.add_argument("--include-mips-without-publishing-name",
                    dest="includeUnpublished", action="store_true")
    sp.add_argument("--keep-dups", dest="keepDups", action="store_true")
    sp.add_argument("--skeletons-directory", "-emdir",
                    dest="skeletonsOutput", default="by_body",
                    help="EM grouped-output subdirectory name")
    sp.add_argument("--lines-directory", "-lmdir",
                    dest="linesOutput", default="by_line",
                    help="LM grouped-output subdirectory name")
    sp.add_argument("--librariesVariants", nargs="*", default=[],
                    help="accepted for reference parity (variant files "
                         "are resolved at search time here)")
    sp.add_argument("--segmented-mips-variant", dest="segmentedMips",
                    nargs="*", default=[],
                    help="accepted for reference parity")
    sp.add_argument("--segmentation-channel-base", type=int, default=1,
                    choices=[0, 1], help="accepted for reference parity")
    sp.add_argument("--segmented-image-handling", type=lambda s: int(s, 0),
                    default=0, help="accepted for reference parity")
    sp.add_argument("--urls-relative-to", dest="urlsRelativeTo",
                    type=int, default=-1)
    sp.add_argument("--default-gender", default=None)
    sp.add_argument("-od", "--outputDir", required=True)
    sp.add_argument("--no-pretty-print", dest="noPrettyPrint",
                    action="store_true")


def cmd_group_mips(args) -> int:
    """Group MIPs by published name into by-name JSON files
    (GroupMIPsByPublishedNameCmd): local mode groups existing v2 MIP
    lists; with --jacs-url the MIPs are paged from JACS per library and
    written into by_line/ (LM) or by_body/ (EM) subdirs like the
    reference's NeuronBridge upload layout."""
    from colormipsearch_tpu_torch.io import naming

    out_dir = Path(args.outputDir)
    n_mips = 0
    n_files = 0

    def write_groups(by_name: dict, sub: Path):
        nonlocal n_mips, n_files
        for name, mips in by_name.items():
            safe = re.sub(r"[^A-Za-z0-9._-]", "_", name or "UNKNOWN")
            v2_io.write_mips_json(mips, sub / f"{safe}.json",
                                  pretty=not args.noPrettyPrint)
            n_mips += len(mips)
            n_files += 1

    if args.jacsURL:
        from colormipsearch_tpu_torch.io.jacs import JacsClient

        client = JacsClient(args.jacsURL, auth_token=args.authorization)
        libraries = args.library or []
        if not libraries:
            LOG.error("online mode requires -l/--libraries")
            return 1
        included_libs = set(args.included_libraries or ())
        excluded_libs = set(args.excluded_libraries or ())
        lib_names = _library_name_mapping(args)
        for library in libraries:
            by_name: dict[str, list] = {}
            seen = set()
            for rec in client.color_depth_mips_with_samples(
                    library=library,
                    alignment_space=args.alignment_space,
                    datasets=args.datasets):
                rec_libs = set(rec.get("libraries") or ())
                if included_libs and not included_libs <= rec_libs:
                    continue
                if excluded_libs and rec_libs & excluded_libs:
                    continue
                m = _jacs_mip_to_v2(rec, library, args)
                m.libraryName = lib_names.get(m.libraryName,
                                              m.libraryName)
                if not m.publishedName and not args.includeUnpublished:
                    continue
                if not args.keepDups:
                    key = (m.publishedName, m.slideCode, m.objective,
                           m.channel, m.cdmPath)
                    if key in seen:
                        continue
                    seen.add(key)
                by_name.setdefault(m.publishedName or "UNKNOWN",
                                   []).append(m)
            sub = out_dir / (args.skeletonsOutput
                             if naming.is_em_library(library)
                             else args.linesOutput)
            write_groups(by_name, sub)
    else:
        if not args.input:
            LOG.error("local mode requires -i/--input")
            return 1
        by_name = {}
        for src in args.input:
            for m in v2_io.read_mips_json(src):
                name = m.publishedName or \
                    _extract_publishing_name(m.imageName)
                by_name.setdefault(name, []).append(m)
        write_groups(by_name, out_dir)
    LOG.info("grouped %d MIPs into %d files", n_mips, n_files)
    return 0


# -------------------------------------------------------------------------
# replaceAttributes / mergeMips
# -------------------------------------------------------------------------


def configure_replace_attrs(sp):
    sp.add_argument("--input", "-i", "--input-files", dest="input",
                    nargs="*", default=[],
                    help="result/MIP JSON files to update")
    sp.add_argument("--input-dirs", nargs="*", default=[],
                    help="directories of JSON files to update")
    sp.add_argument("--attributes-values", "-av",
                    "--new-mips-attributes", "-attrs",
                    dest="attributes_values", required=True,
                    help="JSON file of {id: {attr: value}} replacements "
                         "or a MIP list with the new attribute values")
    sp.add_argument("--id-field", default="id",
                    help="indexing field, 'srcField[:docField]' "
                         "(ReplaceMIPsMetadataAttributesCmd MappedFieldArg)")
    sp.add_argument("--fields-toUpdate", dest="fieldsToUpdate",
                    nargs="*", default=[],
                    help="restrict updates to these fields, each "
                         "'srcField[:docField]'; empty = all fields")
    sp.add_argument("-od", "--outputDir", required=True)
    sp.add_argument("--no-pretty-print", dest="noPrettyPrint",
                    action="store_true")


def _mapped_field(spec: str) -> tuple[str, str]:
    """'src[:dst]' -> (src, dst) (cmd_v2/MappedFieldArg.java)."""
    src, _, dst = spec.partition(":")
    return src, dst or src


def cmd_replace_attrs(args) -> int:
    """Replace metadata attributes by id
    (ReplaceMIPsMetadataAttributesCmd)."""
    inputs = list(args.input)
    for d in args.input_dirs:
        inputs.extend(sorted(str(p) for p in Path(d).glob("*.json")))
    if not inputs:
        raise SystemExit("no inputs: use -i / --input-dirs")
    with open(args.attributes_values) as f:
        repl = json.load(f)
    id_src, id_dst = _mapped_field(args.id_field)
    if isinstance(repl, list):  # a MIP list with new attribute values
        repl = {m[id_src]: m for m in repl if m.get(id_src)}
    field_map = [_mapped_field(s) for s in args.fieldsToUpdate]
    out_dir = Path(args.outputDir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for src in inputs:
        with open(src) as f:
            doc = json.load(f)
        n = 0

        def patch(obj):
            nonlocal n
            if isinstance(obj, dict):
                oid = obj.get(id_dst) or obj.get("id") or obj.get("mipId")
                if oid in repl:
                    new = repl[oid]
                    pairs = field_map or [(k, k) for k in new
                                          if k != id_src]
                    for f_src, f_dst in pairs:
                        if f_src in new:
                            obj[f_dst] = new[f_src]
                    n += 1
                for v in obj.values():
                    patch(v)
            elif isinstance(obj, list):
                for v in obj:
                    patch(v)

        patch(doc)
        with open(out_dir / Path(src).name, "w") as f:
            json.dump(doc, f, indent=None if args.noPrettyPrint else 2)
        LOG.info("replaced attributes on %d entries in %s", n, src)
    return 0


def configure_merge_mips(sp):
    sp.add_argument("-i", "--input", nargs="*", default=[])
    sp.add_argument("-rf", "--resultsFile", nargs="*", default=[],
                    help="MIP list files to merge (MergeMipsCmd -rf)")
    sp.add_argument("-rd", "--resultsDir", nargs="*", default=[],
                    help="directories of MIP list files to merge")
    sp.add_argument("--output-filename", required=True)
    sp.add_argument("-od", "--outputDir", default=".")
    sp.add_argument("--no-pretty-print", dest="noPrettyPrint",
                    action="store_true")


def cmd_merge_mips(args) -> int:
    """Concatenate MIP lists, deduping by (id, imageName)
    (MergeMipsCmd)."""
    # -rf takes precedence over -rd (MergeMipsCmd:81-84); -i merges in
    # as explicit files for backward compatibility
    sources = list(args.input)
    if args.resultsFile:
        sources.extend(args.resultsFile)
    else:
        for d in args.resultsDir:
            sources.extend(sorted(str(p)
                                  for p in Path(d).glob("*.json")))
    if not sources:
        raise SystemExit("no inputs: use -i / -rf / -rd")
    seen = set()
    merged = []
    for src in sources:
        for m in v2_io.read_mips_json(src):
            key = (m.id, m.imageName)
            if key in seen:
                continue
            seen.add(key)
            merged.append(m)
    out = Path(args.outputDir) / args.output_filename
    v2_io.write_mips_json(merged, out, pretty=not args.noPrettyPrint)
    LOG.info("merged %d MIPs to %s", len(merged), out)
    return 0
