"""Administrative / migration subcommands: the two readers of raw PPP
results.

  * convertPPPResults — cmd_v2/ConvertPPPResultsCmd.java
  * copyPPPMatches — cmd_v2/CopyPPPMatchesCmd.java

The PPP part of the JAX package's cli/commands_admin.py, changed only in
imports. The rest of that module (legacyImport, validateDBData,
copyToMipsStore, copyMIPSegmentation, precomputeVariants) comes with
ROADMAP.md §1, port item 6.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

from colormipsearch_tpu_torch.io import ppp as ppp_io

LOG = logging.getLogger(__name__)


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
