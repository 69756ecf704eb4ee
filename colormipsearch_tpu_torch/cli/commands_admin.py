"""Administrative / migration subcommands.

  * legacyImport (importV2CDMatches) — cmd/ImportV2CDMatchesCmd.java +
    cmd/v2dataimport/: v2 per-mask result files -> v3 match entities
  * validateDBData — cmd/ValidateNBDBDataCmd.java (offline checks)
  * copyToMipsStore — cmd/CopyToMIPsStore.java (local file store layout)
  * convertPPPResults — cmd_v2/ConvertPPPResultsCmd.java
  * copyPPPMatches — cmd_v2/CopyPPPMatchesCmd.java
  * copyMIPSegmentation — cmd_v2/CopyColorDepthMIPVariantsCmd.java
  * precomputeVariants — the GradientImage / ZGapImage variants of CDMs

The JAX package's cli/commands_admin.py, changed only in imports and in
precomputeVariants, which writes its PNGs with io/png.py (the GPU hosts
have no PIL).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from pathlib import Path

from colormipsearch_tpu_torch.dataio import v2_io
from colormipsearch_tpu_torch.dataio.json_io import (
    JSONMatchesWriter,
    read_neurons_json,
    write_neurons_json,
)
from colormipsearch_tpu_torch.io import mips as mips_io
from colormipsearch_tpu_torch.io import ppp as ppp_io
from colormipsearch_tpu_torch.model import (
    CDMatch,
    ComputeFileType,
    EMNeuron,
    FileData,
    LMNeuron,
)

LOG = logging.getLogger(__name__)


# -------------------------------------------------------------------------
# legacyImport: v2 results -> v3 entities
# -------------------------------------------------------------------------


def configure_legacy_import(sp):
    sp.add_argument("--resultsDir", "-rd", nargs="*", default=[])
    sp.add_argument("--resultsFile", "-rf", nargs="*", default=[])
    sp.add_argument("--results", "-r", nargs="*", default=[],
                    help="v2 result files or dirs, location[:off[:len]] "
                         "(ImportV2CDMatchesCmd --results)")
    sp.add_argument("--imported-neuron-tag", default="Created by import",
                    help="tag stamped on neurons this import creates")
    sp.add_argument("--suspicious-match-tag", default="Suspicious match",
                    help="tag for matches whose neurons had to be "
                         "created (no valid store reference)")
    sp.add_argument("--processingPartitionSize", "-ps",
                    "--libraryPartitionSize", type=int, default=100,
                    help="accepted for reference parity")
    sp.add_argument("--mask-library", default=None)
    sp.add_argument("--target-library", default=None)
    sp.add_argument("--alignment-space", "-as", default=None)
    sp.add_argument("--tag", default="legacy-import")
    sp.add_argument("-od", "--outputDir", default=None)
    sp.add_argument("--results-storage", dest="resultsStorage",
                    choices=["FS", "DB"], default="FS")
    sp.add_argument("--config", dest="configFile", default=None)
    sp.add_argument("--no-pretty-print", dest="noPrettyPrint",
                    action="store_true")


def _v2_mip_to_neuron(mip: v2_io.MIPMetadata, library_override=None,
                      alignment_space=None):
    lib = library_override or mip.libraryName or ""
    cls = EMNeuron if ("flyem" in lib.lower() or "_em_" in lib.lower()
                       or "hemibrain" in lib.lower()) else LMNeuron
    n = cls(mip_id=mip.id, library_name=lib,
            published_name=mip.publishedName,
            alignment_space=mip.alignmentSpace or alignment_space)
    if isinstance(n, LMNeuron):
        n.slide_code = mip.slideCode
        n.objective = mip.objective
        n.gender = mip.gender
        n.anatomical_area = mip.anatomicalArea
        n.mounting_protocol = mip.mountingProtocol
        if mip.channel is not None:
            try:
                n.channel = int(mip.channel)
            except (TypeError, ValueError):
                pass
    else:
        n.neuron_type = mip.neuronType
        n.neuron_instance = mip.neuronInstance
    fd = mip.file_data()
    if fd.file_name:
        n.set_compute_file(ComputeFileType.InputColorDepthImage, fd)
    return n


def cmd_legacy_import(args) -> int:
    from colormipsearch_tpu_torch.io.mips import ListArg

    files = list(args.resultsFile or [])
    for d in args.resultsDir or []:
        files.extend(sorted(str(p) for p in Path(d).glob("*.json")))
    for spec in args.results or []:
        arg = ListArg.parse(str(spec))
        p = Path(arg.location)
        if p.is_dir():
            files.extend(arg.apply(
                sorted(str(q) for q in p.glob("*.json"))))
        else:
            files.append(str(p))
    matches: list[CDMatch] = []
    neurons: dict[str, object] = {}

    def neuron_for(mip: v2_io.MIPMetadata, lib_override):
        key = (mip.id, mip.imageName)
        if key not in neurons:
            neurons[key] = _v2_mip_to_neuron(
                mip, lib_override, args.alignment_space)
        return neurons[key]

    for f in files:
        g = v2_io.read_cds_matches(f)
        for r in g.results:
            mask = neuron_for(r.source, args.mask_library)
            target = neuron_for(r.target, args.target_library)
            matches.append(CDMatch(
                mask_image=mask, matched_image=target,
                mirrored=r.mirrored,
                matching_pixels=r.matchingPixels,
                matching_pixels_ratio=r.matchingRatio,
                gradient_area_gap=r.gradientAreaGap,
                high_expression_area=r.highExpressionArea,
                normalized_score=r.normalizedGapScore
                if r.normalizedGapScore is not None
                else float(r.matchingPixels),
                tags={args.tag} if args.tag else set(),
            ))
    LOG.info("imported %d v2 matches from %d files", len(matches),
             len(files))

    if args.resultsStorage == "DB":
        from colormipsearch_tpu_torch.persist import Config, DaosProvider
        from colormipsearch_tpu_torch.persist.requests import NeuronSelector

        daos = DaosProvider(Config(args.configFile))
        # neurons with no pre-existing store entry get the import tag;
        # matches referencing any such neuron are marked suspicious
        # (ImportV2CDMatchesCmd:255-278)
        mip_ids = sorted({n.mip_id for n in neurons.values() if n.mip_id})
        existing = daos.neuron_metadata_dao.find_neurons(
            NeuronSelector(mip_ids=mip_ids)) if mip_ids else []
        known = {n.mip_id for n in existing
                 if args.imported_neuron_tag not in n.tags}
        created = set()
        for n in neurons.values():
            if n.mip_id not in known:
                n.tags.add(args.imported_neuron_tag)
                created.add(id(n))
            daos.neuron_metadata_dao.create_or_update(n)
        for m in matches:
            if id(m.mask_image) in created or \
                    id(m.matched_image) in created:
                m.tags.add(args.suspicious_match_tag)
            m.mask_image_ref_id = m.mask_image.entity_id
            m.matched_image_ref_id = m.matched_image.entity_id
        daos.cd_matches_dao.create_or_update_all(matches)
        return 0
    out = Path(args.outputDir or ".")
    JSONMatchesWriter(per_masks_dir=out,
                      pretty=not args.noPrettyPrint).write(matches)
    return 0


# -------------------------------------------------------------------------
# validateDBData
# -------------------------------------------------------------------------


def configure_validate(sp):
    sp.add_argument("-i", "--input", nargs="*", default=[],
                    help="neuron JSON files to validate (FS mode)")
    sp.add_argument("--config", dest="configFile", default=None)
    sp.add_argument("--results-storage", dest="resultsStorage",
                    choices=["FS", "DB"], default="FS")
    sp.add_argument("--alignment-space", "-as", default=None)
    sp.add_argument("-l", "--library", "--libraries", dest="libraries",
                    nargs="*", default=[])
    sp.add_argument("--excluded-libraries", nargs="*", default=[])
    sp.add_argument("--validated-samples", nargs="*", default=[],
                    help="only validate these sample/body refs")
    sp.add_argument("--validated-names", nargs="*", default=[])
    sp.add_argument("--validated-releases", nargs="*", default=[],
                    help="dataset labels to validate")
    sp.add_argument("--validated-tags", nargs="*", default=[])
    sp.add_argument("--offset", type=int, default=0)
    sp.add_argument("--size", type=int, default=0)
    sp.add_argument("--no-grad-files-check", dest="checkGradFiles",
                    action="store_false", default=True,
                    help="skip GradientImage/ZGapImage existence checks")
    sp.add_argument("--check-files", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="check compute-file existence "
                         "(--no-check-files for metadata-only runs)")
    sp.add_argument("--apply-error-tags", action="store_true")
    sp.add_argument("--apply-error-tag-to-em-cdmatches",
                    action="store_true",
                    help="also stamp the error tag on cd matches whose "
                         "EM side failed validation")
    sp.add_argument("--apply-error-tag-to-lm-cdmatches",
                    action="store_true")
    sp.add_argument("--error-tag", default="validationError")
    sp.add_argument("--jacs-url", "--data-url", dest="dataServiceURL",
                    default=None, help="accepted for reference parity")
    sp.add_argument("--config-url", dest="configURL", default=None,
                    help="accepted for reference parity")
    sp.add_argument("--authorization", default=None)
    sp.add_argument("--read-batch-size", type=int, default=1000,
                    help="accepted for reference parity")
    sp.add_argument("--processingPartitionSize", "-ps",
                    "--libraryPartitionSize", type=int, default=5000,
                    help="accepted for reference parity")


def cmd_validate(args) -> int:
    """Consistency checks over neuron metadata: missing/unreadable compute
    files, duplicate mip ids (ValidateNBDBDataCmd, offline subset)."""
    dangling = 0
    daos = None
    if args.resultsStorage == "DB":
        from colormipsearch_tpu_torch.persist import Config, DaosProvider
        from colormipsearch_tpu_torch.persist.requests import NeuronSelector

        daos = DaosProvider(Config(args.configFile))
        selector = NeuronSelector(
            alignment_space=args.alignment_space,
            libraries=list(args.libraries or ()),
            names=list(args.validated_names or ()),
            source_refs=list(args.validated_samples or ()),
            datasets=list(args.validated_releases or ()),
            tags=list(args.validated_tags or ()))
        neurons = daos.neuron_metadata_dao.find_neurons(selector)
        if args.excluded_libraries:
            excluded = set(args.excluded_libraries)
            neurons = [n for n in neurons
                       if n.library_name not in excluded]
        if args.offset > 0:
            neurons = neurons[args.offset:]
        if args.size > 0:
            neurons = neurons[:args.size]
        sources = {"DB": neurons}
        # match integrity: every cdMatch must reference existing neurons.
        # `known` is the FULL neuron id set — a match whose other side
        # falls outside the validated selector/page is not dangling
        known = set(daos.neuron_metadata_dao._col.distinct("_id", {}))
        for doc in daos.cd_matches_dao._col.find({}):
            for side in ("maskImageRefId", "matchedImageRefId"):
                ref = doc.get(side)
                if ref is not None and ref not in known:
                    dangling += 1
                    LOG.warning("match %s has dangling %s %s",
                                doc.get("_id"), side, ref)
    else:
        sources = {src: read_neurons_json(src) for src in args.input}

    grad_types = {ComputeFileType.GradientImage, ComputeFileType.ZGapImage}
    total_errors = 0
    error_neuron_ids = []
    for src, neurons in sources.items():
        seen_mips: dict = {}
        n_missing = 0
        src_errors = 0
        for n in neurons:
            errors = []
            key = (n.mip_id, n.compute_file(
                ComputeFileType.InputColorDepthImage))
            if key in seen_mips:
                errors.append(f"duplicate mipId {n.mip_id}")
            seen_mips[key] = n
            if args.check_files:
                for ftype, fd in n.compute_files.items():
                    if ftype in grad_types and not args.checkGradFiles:
                        continue
                    if not mips_io.exists(fd):
                        errors.append(
                            f"missing {ftype.value}: {fd.name}")
                        n_missing += 1
            if errors:
                total_errors += 1
                src_errors += 1
                if args.apply_error_tags:
                    n.validation_errors = set(errors)
                    n.tags.add(args.error_tag)
                if n.entity_id is not None:
                    error_neuron_ids.append(str(n.entity_id))
                LOG.warning("%s %s: %s", src, n.mip_id, "; ".join(errors))
        LOG.info("%s: %d neurons, %d with errors (%d missing files)",
                 src, len(neurons), src_errors, n_missing)
        if args.apply_error_tags and args.resultsStorage != "DB":
            write_neurons_json(neurons, src)
        elif args.apply_error_tags and daos is not None:
            for n in neurons:
                if n.validation_errors:
                    daos.neuron_metadata_dao.create_or_update(n)
    # --apply-error-tag-to-{em,lm}-cdmatches: stamp the error tag on
    # matches whose failing neuron is the mask (EM) / target (LM) side
    # (ValidateNBDBDataCmd error-tag propagation)
    n_tagged_matches = 0
    if daos is not None and error_neuron_ids and (
            args.apply_error_tag_to_em_cdmatches
            or args.apply_error_tag_to_lm_cdmatches):
        # indexed ref-id lookups instead of a full-collection scan
        sides = []
        if args.apply_error_tag_to_em_cdmatches:
            sides.append("maskImageRefId")
        if args.apply_error_tag_to_lm_cdmatches:
            sides.append("matchedImageRefId")
        seen_match_ids = set()
        for side in sides:
            for i in range(0, len(error_neuron_ids), 500):
                chunk = error_neuron_ids[i:i + 500]
                for doc in daos.cd_matches_dao._col.find(
                        {side: {"$in": chunk}}):
                    if doc["_id"] in seen_match_ids:
                        continue
                    seen_match_ids.add(doc["_id"])
                    tags = set(doc.get("tags") or ())
                    tags.add(args.error_tag)
                    daos.cd_matches_dao._col.update_fields(
                        doc["_id"], {"tags": sorted(tags)})
                    n_tagged_matches += 1
    print(json.dumps({"neuronsChecked": sum(len(v) for v in
                                            sources.values()),
                      "neuronsWithErrors": total_errors,
                      "danglingMatchRefs": dangling,
                      "errorTaggedMatches": n_tagged_matches}))
    return 0


# -------------------------------------------------------------------------
# copyToMipsStore
# -------------------------------------------------------------------------


def configure_copy_to_store(sp):
    sp.add_argument("-i", "--input", nargs="+", required=True,
                    help="neuron JSON files")
    sp.add_argument("--store-dir", "--targetDirectory", dest="store_dir",
                    required=True)
    sp.add_argument("--file-types", nargs="*",
                    default=["InputColorDepthImage", "GradientImage",
                             "ZGapImage"])
    sp.add_argument("--mipsFilter", nargs="*", default=[],
                    help="only copy files for these mip ids / names")
    sp.add_argument("--update-metadata",
                action=argparse.BooleanOptionalAction, default=True,
                help="rewrite source JSON with the new store "
                     "locations (--no-update-metadata to copy "
                     "files only)")
    sp.add_argument("--force", "-f", action="store_true",
                    help="overwrite files already present in the store")
    sp.add_argument("--lmIgnoreMissingSegmentation", action="store_true",
                    help="accepted for reference parity; missing files "
                         "are warned and skipped here")
    sp.add_argument("--dry-run", "-n", dest="dry_run",
                    action="store_true")


def cmd_copy_to_store(args) -> int:
    """Copy compute files into a store layout
    `<store>/<alignmentSpace>/<library>/<variant>/...` and update the
    neurons' computeFiles to the new locations (CopyToMIPsStore)."""
    store = Path(args.store_dir)
    ftypes = [ComputeFileType.from_name(t) for t in args.file_types]
    subdir = {ComputeFileType.InputColorDepthImage: "cdm",
              ComputeFileType.SourceColorDepthImage: "",
              ComputeFileType.GradientImage: "grad",
              ComputeFileType.ZGapImage: "zgap"}
    wanted = {w.lower() for w in args.mipsFilter}
    n_copied = 0
    for src in args.input:
        neurons = read_neurons_json(src)
        for n in neurons:
            if wanted and (n.mip_id or "").lower() not in wanted \
                    and (n.published_name or "").lower() not in wanted:
                continue
            base = store / (n.alignment_space or "UNKNOWN") / \
                (n.library_name or "UNKNOWN")
            for ftype in ftypes:
                fd = n.compute_file(ftype)
                if fd is None:
                    continue
                dst_dir = base / subdir.get(ftype, ftype.value.lower())
                dst = dst_dir / os.path.basename(fd.name)
                if dst.exists() and not args.force:
                    n.set_compute_file(ftype, FileData(str(dst)))
                    continue
                if args.dry_run:
                    LOG.info("would copy %s -> %s", fd.name, dst)
                    continue
                dst_dir.mkdir(parents=True, exist_ok=True)
                try:
                    data = mips_io.read_bytes(fd)
                except (OSError, FileNotFoundError):
                    LOG.warning("cannot read %s", fd.name)
                    continue
                dst.write_bytes(data)
                n.set_compute_file(ftype, FileData(str(dst)))
                n_copied += 1
        if args.update_metadata and not args.dry_run:
            write_neurons_json(neurons, src)
    LOG.info("copied %d files into %s", n_copied, store)
    return 0


# -------------------------------------------------------------------------
# convertPPPResults / copyPPPMatches (v2)
# -------------------------------------------------------------------------


def configure_convert_ppp(sp):
    sp.add_argument("--results-dir", "-rd", nargs="*", default=[])
    sp.add_argument("--results-file", "-rf", nargs="*", default=[],
                    help="explicit raw cov_scores files to convert")
    sp.add_argument("--matches-prefix", default="cov_scores_")
    sp.add_argument("--neuron-matches-sub-dir", default=None,
                    help="only scan results inside this per-neuron "
                         "subdirectory")
    sp.add_argument("--screenshots-dir", dest="screenshotsDir",
                    default="screenshots")
    sp.add_argument("--alignment-space", "-as",
                    default="JRC2018_Unisex_20x_HR")
    sp.add_argument("--anatomical-area", "-area", default="Brain")
    sp.add_argument("--only-best-skeleton-matches", action="store_true")
    sp.add_argument("--em-dataset", default="hemibrain")
    sp.add_argument("--em-dataset-version", default="1.2.1")
    sp.add_argument("--em-library", default=None,
                    help="defaults to flyem_<em-dataset>_<version>")
    sp.add_argument("--lm-library", default=None)
    sp.add_argument("--jacs-url", "--data-url", dest="dataServiceURL",
                    nargs="*", default=[],
                    help="accepted for parity; neuron data come from the "
                         "result-file names offline")
    sp.add_argument("--authorization", default=None)
    sp.add_argument("--jacs-read-batch-size", type=int, default=5000,
                    help="accepted for reference parity")
    sp.add_argument("--processing-partition-size", "-ps",
                    type=int, default=500,
                    help="accepted for reference parity")
    sp.add_argument("-od", "--outputDir", required=True)
    sp.add_argument("--no-pretty-print", dest="noPrettyPrint",
                    action="store_true")


def cmd_convert_ppp(args) -> int:
    """Raw PPP results -> per-EM v2-style pppresults JSON
    (ConvertPPPResultsCmd)."""
    em_library = args.em_library or "flyem_{}_{}".format(
        args.em_dataset, args.em_dataset_version.replace(".", "_"))
    if not args.results_dir and not args.results_file:
        raise SystemExit("no inputs: use -rd / -rf")
    if args.results_file:
        # -rf takes precedence over -rd (ConvertPPPResultsCmd:166)
        files = [Path(f) for f in args.results_file]
    else:
        files = ppp_io.find_ppp_result_files(
            args.results_dir, prefix=args.matches_prefix,
            sub_dir=args.neuron_matches_sub_dir)
    out_dir = Path(args.outputDir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for f in files:
        matches = ppp_io.read_raw_ppp_matches(
            f, include_skeletons=True,
            only_best_matches=args.only_best_skeleton_matches)
        if not matches:
            continue
        em_name = matches[0].source_em_name
        em = ppp_io.em_neuron_from_ppp_name(
            em_name, library=em_library,
            alignment_space=args.alignment_space)
        screenshots = f.parent / args.screenshotsDir
        results = []
        for m in sorted(matches,
                        key=lambda m: m.rank if m.rank is not None else 1e9):
            lm = ppp_io.lm_neuron_from_ppp_name(
                m.source_lm_name, library=args.lm_library,
                alignment_space=args.alignment_space,
                anatomical_area=args.anatomical_area)
            # same gate as importPPPResults: missing rank attaches nothing
            # (the reference's Double rank is never null in practice)
            if screenshots.is_dir() and m.rank is not None and m.rank < 500:
                m.source_image_files = ppp_io.find_screenshots(
                    screenshots, em_name, m.source_lm_name or "")
            results.append({
                "sourceEmName": m.source_em_name,
                "sourceLmName": m.source_lm_name,
                "neuronName": em.published_name,
                "neuronType": em.neuron_type,
                "lmPublishedName": lm.published_name,
                "lmSlideCode": lm.slide_code,
                "lmObjective": lm.objective,
                "coverageScore": m.coverage_score,
                "aggregateCoverage": m.aggregate_coverage,
                "mirrored": m.mirrored,
                "rank": m.rank,
                "alignmentSpace": args.alignment_space,
                "anatomicalArea": args.anatomical_area,
                "sourceImageFiles": m.source_image_files or None,
                "skeletonMatches": [s.to_json()
                                    for s in m.skeleton_matches],
            })
        doc = {"maskPublishedName": em.published_name, "results": results}
        with open(out_dir / f"{em.published_name}.json", "w") as fh:
            json.dump(doc, fh, indent=None if args.noPrettyPrint else 2)
        n += 1
    LOG.info("converted %d PPP result files", n)
    return 0


def configure_copy_ppp(sp):
    sp.add_argument("--inputDir", "-i", default=None)
    sp.add_argument("--resultsDir", "-rd", nargs="*", default=[])
    sp.add_argument("--resultsFile", "-rf", nargs="*", default=[])
    sp.add_argument("-od", "--outputDir", required=True)
    sp.add_argument("--top", type=int, default=-1)
    sp.add_argument("--filterInternalFields", action="store_true",
                    help="strip sampleName/sourceImageFiles/"
                         "skeletonMatches (PublishedEmPPPMatch's ignored "
                         "properties)")
    sp.add_argument("--truncatePartialResults", action="store_true",
                    help="drop results without sourceImageFiles")
    sp.add_argument("--emDatasetMapping", default=None,
                    help="override sourceEmDataset on every result")
    sp.add_argument("--lmDatasetMapping", default=None,
                    help="override sourceLmDataset on every result")
    sp.add_argument("--processingPartitionSize", "-ps", type=int,
                    default=100, help="accepted for reference parity")


# internal fields hidden from published PPP rows
# (api_v2/pppsearch/PublishedEmPPPMatch.java:21-23)
_PPP_INTERNAL_FIELDS = ("sampleName", "sourceImageFiles",
                        "skeletonMatches")


def cmd_copy_ppp(args) -> int:
    """Copy/trim PPP match files (CopyPPPMatchesCmd)."""
    # -rf takes precedence over directory scans (CopyPPPMatchesCmd)
    if args.resultsFile:
        files = [Path(f) for f in args.resultsFile]
    else:
        files = []
        if args.inputDir:
            files.extend(sorted(Path(args.inputDir).glob("*.json")))
        for d in args.resultsDir:
            files.extend(sorted(Path(d).glob("*.json")))
    if not files:
        raise SystemExit("no inputs: use -i / -rd / -rf")
    out = Path(args.outputDir)
    out.mkdir(parents=True, exist_ok=True)
    n = 0
    for f in files:
        with open(f) as fh:
            doc = json.load(fh)
        results = doc.get("results")
        if isinstance(results, list):
            if args.truncatePartialResults:
                results = [r for r in results
                           if r.get("sourceImageFiles")]
            if args.filterInternalFields:
                results = [{k: v for k, v in r.items()
                            if k not in _PPP_INTERNAL_FIELDS}
                           for r in results]
            for r in results:
                if args.emDatasetMapping:
                    r["sourceEmDataset"] = args.emDatasetMapping
                if args.lmDatasetMapping:
                    r["sourceLmDataset"] = args.lmDatasetMapping
            if args.top > 0:
                results = results[:args.top]
            doc["results"] = results
            if not results:
                LOG.info("no valid PPP matches in %s; skipping", f)
                continue
        with open(out / f.name, "w") as fh:
            json.dump(doc, fh, indent=2)
        n += 1
    LOG.info("copied %d PPP files", n)
    return 0


# -------------------------------------------------------------------------
# copyMIPSegmentation (variant copy)
# -------------------------------------------------------------------------


def configure_copy_segmentation(sp):
    sp.add_argument("-i", "--input", required=True,
                    help="v2 MIP list JSON")
    sp.add_argument("--source-dirs", nargs="+", required=True,
                    help="where the variant images live")
    sp.add_argument("--variant-suffix", default="")
    sp.add_argument("--mipsFilter", nargs="*", default=[],
                    help="only copy variants for these mip ids / "
                         "published names")
    sp.add_argument("-od", "--outputDir", "--targetDirectory",
                    dest="outputDir", required=True)
    sp.add_argument("--dry-run", "-n", dest="dry_run",
                    action="store_true",
                    help="only show what would be copied")
    sp.add_argument("--injective-variants", nargs="*", default=[],
                    help="accepted for reference parity; variants here "
                         "are resolved per-MIP so the mapping is always "
                         "one-to-one")


def cmd_copy_segmentation(args) -> int:
    """Copy variant/segmentation images matching the MIP list into one
    directory (CopyColorDepthMIPVariantsCmd)."""
    mips = v2_io.read_mips_json(args.input)
    if args.mipsFilter:
        wanted = {w.lower() for w in args.mipsFilter}
        mips = [m for m in mips
                if (m.id or "").lower() in wanted
                or (m.publishedName or "").lower() in wanted]
    out = Path(args.outputDir)
    n = 0
    for m in mips:
        fd = m.file_data()
        v = mips_io.find_variant(fd, args.source_dirs, args.variant_suffix)
        if v is None:
            continue
        if args.dry_run:
            LOG.info("would copy %s", v.name)
            n += 1
            continue
        out.mkdir(parents=True, exist_ok=True)
        data = mips_io.read_bytes(v)
        (out / os.path.basename(v.name)).write_bytes(data)
        n += 1
    LOG.info("copied %d variant images to %s", n, out)
    return 0


# -------------------------------------------------------------------------
# precomputeVariants (not in the reference)
# -------------------------------------------------------------------------


def configure_precompute_variants(sp):
    sp.add_argument("-i", "--input", nargs="+", required=True,
                    help="CDM image dirs/files to derive variants from")
    sp.add_argument("-od", "--outputDir", required=True)
    sp.add_argument("--gradient-subdir", default="grad")
    sp.add_argument("--zgap-subdir", default="zgap")
    sp.add_argument("--gradient-suffix", default="_gradient")
    sp.add_argument("--zgap-suffix", default="_20pxRGB")
    sp.add_argument("--maskThreshold", type=int, default=20)
    sp.add_argument("--negativeRadius", type=int, default=20)
    sp.add_argument("--no-gradient", dest="withGradient",
                    action="store_false", default=True)
    sp.add_argument("--no-zgap", dest="withZgap",
                    action="store_false", default=True)


def cmd_precompute_variants(args) -> int:
    """Generate the GradientImage / ZGapImage variants from CDMs.

    The reference consumes these variants but never produces them (they
    come from an external Fiji pipeline; see README.md:349-360 of the
    reference — the `..._gradient` and `..._20pxRGBMAX` archives).  This
    command makes the framework self-sufficient:

      * ZGapImage: EXACTLY the reference's on-the-fly fallback —
        mask(maskThreshold) then the ImageJ-exact circular dilation of
        radius --negativeRadius
        (ShapeMatchColorDepthSearchAlgorithm.java:166-168), so
        precomputed and on-the-fly scoring are bit-identical.
      * GradientImage: 16-bit euclidean distance from the nearest
        above-threshold pixel (rounded), the standard construction for
        the area-gap penalty.
    """
    from pathlib import Path

    import numpy as np
    from scipy import ndimage

    from colormipsearch_tpu_torch.io import mips as mips_io
    from colormipsearch_tpu_torch.io.image import read_image
    from colormipsearch_tpu_torch.io.png import write_png
    from colormipsearch_tpu_torch.oracle.shape import dilate_rgb, mask_rgb

    out = Path(args.outputDir)
    grad_dir = out / args.gradient_subdir
    zgap_dir = out / args.zgap_subdir
    if args.withGradient:
        grad_dir.mkdir(parents=True, exist_ok=True)
    if args.withZgap:
        zgap_dir.mkdir(parents=True, exist_ok=True)

    n = 0
    for loc in args.input:
        for fd in mips_io.list_image_files(str(loc)):
            try:
                rgb = read_image(fd.name if not fd.is_zip_entry
                                 else fd).as_rgb()
            except (OSError, ValueError):
                LOG.warning("skipping unreadable %s", fd.name)
                continue
            stem = Path(fd.entry_name if fd.is_zip_entry
                        else fd.file_name).stem
            fg = (rgb > args.maskThreshold).any(axis=-1)
            if args.withGradient:
                dist = ndimage.distance_transform_edt(~fg)
                grad = np.minimum(np.rint(dist), 0xFFFF).astype(np.uint16)
                write_png(grad_dir / f"{stem}{args.gradient_suffix}.png",
                          grad)
            if args.withZgap:
                zgap = dilate_rgb(mask_rgb(rgb, args.maskThreshold),
                                  args.negativeRadius)
                write_png(zgap_dir / f"{stem}{args.zgap_suffix}.png", zgap)
            n += 1
    LOG.info("precomputed variants for %d images into %s", n, out)
    return 0
