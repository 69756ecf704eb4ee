"""Export + import + tagging subcommands.

  * exportData        — cmd/ExportData4NBCmd.java:50-392 + cmd/dataexport/
                        FS and DB read paths, publishedURLs/publishedLMImage
                        enrichment, URL transform + image-store mapping
  * importPPPResults  — cmd/ImportPPPResultsCmd.java
  * tag               — cmd/TagNeuronMetadataCmd.java

The JAX package's cli/commands_export.py, changed only in imports.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

from colormipsearch_tpu_torch.dataio.json_io import (
    JSONMatchesReader,
    read_neurons_json,
    write_neurons_json,
)
from colormipsearch_tpu_torch.io import ppp as ppp_io
from colormipsearch_tpu_torch.model import dto
from colormipsearch_tpu_torch.model.entities import ProcessingType
from colormipsearch_tpu_torch.model.ids import TimebasedIdGenerator

LOG = logging.getLogger(__name__)


# -------------------------------------------------------------------------
# exportData
# -------------------------------------------------------------------------


EXPORT_TYPES = ("EM_CD_MATCHES", "LM_CD_MATCHES", "EM_PPP_MATCHES",
                "EM_MIPS", "LM_MIPS")


def configure_export_data(sp):
    sp.add_argument("--exported-result-type", required=True,
                    choices=EXPORT_TYPES)
    sp.add_argument("--matches", "-md", nargs="*", default=[],
                    help="per-mask grouped match files/dirs to export "
                         "(FS mode)")
    sp.add_argument("--mips", nargs="*", default=[],
                    help="neuron JSON files (for *_MIPS exports)")
    sp.add_argument("--results-storage", dest="resultsStorage",
                    choices=["FS", "DB"], default="FS",
                    help="DB: read matches per mask from the match store "
                         "(ExportData4NBCmd's DBNeuronMatchesReader path)")
    sp.add_argument("--config", dest="configFile", default=None)
    sp.add_argument("--jacs-url", "--data-url", dest="dataServiceURL",
                    default=None,
                    help="JACS data service base URL (or file:// page "
                         "dumps); accepted for parity — neuron metadata "
                         "here is already embedded in the match rows")
    sp.add_argument("--config-url", dest="configURL", default=None,
                    help="config service whose /cdm_library entry maps "
                         "internal library ids to published display "
                         "names (JacsDataGetter.retrieveLibraryNameMapping"
                         "; also accepts file://<json>)")
    sp.add_argument("--authorization", default=None,
                    help="JACS authorization header value")
    sp.add_argument("--published-alignment-space-alias", nargs="*",
                    dest="publishedAlignmentSpaceAliases", default=[],
                    help="'<alignmentSpace>=<alias>' pairs used when "
                         "matching published LM images by alignment "
                         "space (PublishedDataGetter.findPublishedImage)")
    sp.add_argument("--alignment-space", "-as", default=None)
    sp.add_argument("-l", "--library", "--libraries", dest="libraries",
                    nargs="*", default=[],
                    help="mask libraries to export (DB mode)")
    sp.add_argument("--exported-names", nargs="*", default=[],
                    help="mask published names to export (DB mode)")
    sp.add_argument("--exported-mips", nargs="*", default=[],
                    help="mask mip ids to export")
    sp.add_argument("--neuron-tags", nargs="*", default=[])
    sp.add_argument("--excluded-neuron-tags", nargs="*", default=[])
    sp.add_argument("--neuron-terms", nargs="*", default=[])
    sp.add_argument("--excluded-neuron-terms", nargs="*", default=[])
    sp.add_argument("--target-library", nargs="*", default=[],
                    help="only export matches whose target is in these "
                         "libraries")
    sp.add_argument("--target-tags", nargs="*", default=[])
    sp.add_argument("--excluded-target-tags", nargs="*", default=[])
    sp.add_argument("--target-terms", nargs="*", default=[])
    sp.add_argument("--excluded-target-terms", nargs="*", default=[])
    sp.add_argument("--excluded-matches-tags", nargs="*", default=[],
                    help="skip matches carrying any of these tags")
    sp.add_argument("--offset", type=int, default=0,
                    help="offset into the exported mask set")
    sp.add_argument("--size", type=int, default=0,
                    help="number of masks to export (0 = all)")
    sp.add_argument("--processingPartitionSize", "-ps",
                    "--libraryPartitionSize", type=int, default=5000,
                    help="accepted for reference parity (exports stream "
                         "per mask already)")
    sp.add_argument("--read-batch-size", type=int, default=1000,
                    help="accepted for reference parity")
    sp.add_argument("--pctPositivePixels", type=float, default=0.0,
                    help="only export matches with matchingPixelsRatio "
                         ">= pct/100 (ExportData4NBCmd.getCDScoresFilter)")
    sp.add_argument("--ignore-grad-scores", dest="ignoreGradScores",
                    action="store_true",
                    help="export matches without gradientAreaGap >= 0")
    sp.add_argument("--default-relative-url-index", type=int, default=-1,
                    dest="defaultRelativeURLIndex",
                    help="strip URL path components before this index "
                         "(ExportData4NBCmd --default-relative-url-index; "
                         "-1 leaves URLs untouched)")
    sp.add_argument("--relative-url-indexes-by-filetype", nargs="*",
                    dest="relativeURLIndexesByFileType", default=[],
                    help="per-FileType overrides 'FileType:index[:bool]' "
                         "(bool = also transform non-http paths)")
    sp.add_argument("--default-image-store", dest="defaultImageStore",
                    default=None,
                    help="image store recorded as files.store on every "
                         "exported neuron")
    sp.add_argument("--image-stores-per-neuron-meta", nargs="*",
                    dest="imageStoresPerMetadata", default=[],
                    help="'<alignmentSpace>[,<library>]:<store>' overrides")
    sp.add_argument("--published-urls", dest="publishedURLs", default=None,
                    help="JSON file {mipId: {FileType: url}} merged into "
                         "exported neuron files (the offline stand-in for "
                         "the publishedURLs collection / JACS enrichment)")
    sp.add_argument("-od", "--outputDir", required=True)
    sp.add_argument("--subdir", default=None)
    sp.add_argument("--no-pretty-print", dest="noPrettyPrint",
                    action="store_true")


def cmd_export_data(args) -> int:
    out_dir = Path(args.outputDir)
    if args.subdir:
        out_dir = out_dir / args.subdir
    out_dir.mkdir(parents=True, exist_ok=True)
    pretty = not args.noPrettyPrint
    args._url_map = {}
    if getattr(args, "publishedURLs", None):
        with open(args.publishedURLs) as f:
            args._url_map = json.load(f)
    args._url_transformer = _make_url_transformer(args)
    args._image_store = _make_image_store(args)
    args._library_names = _load_library_name_mapping(
        getattr(args, "configURL", None))
    args._published_urls_by_id = {}
    args._published_lm_images_by_sample = {}
    args._as_aliases = {}
    for spec in getattr(args, "publishedAlignmentSpaceAliases", None) or ():
        name, sep, vals = spec.replace(":", "=", 1).partition("=")
        if sep:
            args._as_aliases.setdefault(name, set()).update(
                v for v in vals.split(",") if v)

    if args.exported_result_type in ("EM_MIPS", "LM_MIPS"):
        return _export_mips(args, out_dir, pretty)
    if args.exported_result_type == "EM_PPP_MATCHES":
        return _export_ppp_matches(args, out_dir, pretty)
    return _export_cd_matches(args, out_dir, pretty)


def _relativize_url(url: str, index: int, change_non_http: bool) -> str:
    """Strip leading path components from a URL
    (cmd/dataexport/URLTransformer.relativizeURL:52-83)."""
    if not url:
        return ""
    if index < 0:
        return url
    from urllib.parse import urlparse

    low = url.lower()
    if low.startswith("http://") or low.startswith("https://"):
        path = urlparse(url.replace(" ", "+")).path
    elif change_non_http:
        path = url
    else:
        return url
    parts = [p for p in path.split("/") if p]
    if index >= len(parts):
        LOG.warning("URL %s has fewer components than index %d; left "
                    "as is", url, index)
        return url
    return "/".join(parts[index:])


def _make_url_transformer(args):
    """(file_type_name, url) -> transformed url
    (ExportData4NBCmd.createURLTransformer:371-392)."""
    per_type = {}
    for spec in args.relativeURLIndexesByFileType or ():
        name, _, rest = spec.partition(":")
        idx_s, _, flag = rest.partition(":")
        per_type[name] = (int(idx_s), flag.lower() == "true")
    default = (args.defaultRelativeURLIndex, False)

    def transform(file_type: str, url: str) -> str:
        idx, non_http = per_type.get(file_type, default)
        return _relativize_url(url, idx, non_http)

    return transform


def _load_library_name_mapping(config_url: str | None) -> dict:
    """{internal library id -> published display name} from the config
    service's /cdm_library entry
    (JacsDataGetter.retrieveLibraryNameMapping:167-187). Accepts
    file://<json-file> for offline use; failures log and return {}."""
    if not config_url:
        return {}
    try:
        if config_url.startswith("file://"):
            with open(config_url[len("file://"):]) as f:
                doc = json.load(f)
        else:
            import urllib.request

            with urllib.request.urlopen(
                    config_url.rstrip("/") + "/cdm_library",
                    timeout=60) as resp:
                doc = json.load(resp)
        config = doc.get("config")
        if not isinstance(config, dict):
            raise ValueError("config entry is not a map")
        return {lid: ldata.get("name")
                for lid, ldata in config.items()
                if isinstance(ldata, dict) and ldata.get("name")}
    except Exception as e:  # noqa: BLE001 - enrichment is best-effort
        LOG.error("could not load library name mapping from %s: %s",
                  config_url, e)
        return {}


def _make_image_store(args):
    """neuron metadata -> image store name
    (cmd/dataexport/ImageStoreMapping: (alignmentSpace, library) key,
    then alignmentSpace key, then the default)."""
    mapping = {}
    for spec in args.imageStoresPerMetadata or ():
        key, _, store = spec.rpartition(":")
        parts = tuple(k.strip() for k in key.split(",") if k.strip())
        mapping[parts] = store
    default = args.defaultImageStore

    def lookup(meta) -> str | None:
        alignment = getattr(meta, "alignment_space", None) or ""
        library = getattr(meta, "library_name", None) or ""
        return (mapping.get((alignment, library))
                or mapping.get((alignment,)) or default)

    return lookup


# publishedURL collection "uploaded" keys -> publish FileType names
# (jacsdata/ColorDepthMIP.java:25-28 updateEMNeuron/updateLMNeuron)
_UPLOADED_KEY_FILETYPES = (("cdm", "CDM"),
                           ("cdm_thumbnail", "CDMThumbnail"),
                           ("skeletonswc", "AlignedBodySWC"),
                           ("skeletonobj", "AlignedBodyOBJ"))


def _apply_published_lm_images(meta, neuron, args, *,
                               include_gal4: bool = True) -> None:
    """LM-neuron 3D-stack enrichment from the publishedLMImage
    collection: VisuallyLosslessStack from the sample's published image
    in the same (or aliased) alignment space, Gal4Expression from the
    joined Gen1 rows for the anatomical area
    (ColorDepthMIP.updateLMNeuron:212-213,
    PublishedDataGetter.update3DStack:61-65).  With include_gal4=False
    (the PPP exporter) only the 3D stack is attached, and selection
    requires the image to carry it
    (EMPPPMatchesExporter.findPublishedLM3DStack:239-253)."""
    by_sample = getattr(args, "_published_lm_images_by_sample", None)
    sample_ref = getattr(neuron, "sample_ref", None)
    if not by_sample or not sample_ref or meta.type != "LMImage" \
            or meta.alignment_space is None:
        return
    aliases = getattr(args, "_as_aliases", {}).get(
        meta.alignment_space, set())
    # findFirst() semantics: ONE published image per sample decides both
    # files (PublishedDataGetter.findPublishedImage), and its values
    # overwrite whatever was there (updateLMNeuron sets unconditionally)
    image = next((im for im in by_sample.get(sample_ref, ())
                  if (im.alignment_space == meta.alignment_space
                      or im.alignment_space in aliases)
                  and (include_gal4
                       or im.has_file("VisuallyLosslessStack"))), None)
    if image is None:
        return
    files = dict(meta.files)
    stack = image.get_file("VisuallyLosslessStack")
    if stack:
        files["VisuallyLosslessStack"] = stack
    if include_gal4:
        gal4 = image.gal4_expression_image(meta.anatomical_area)
        if gal4:
            files["Gal4Expression"] = gal4
    meta.files = files


def _load_published_lm_images(daos, neurons, args) -> dict:
    """{sampleRef: [PublishedLMImage]} for the exported LM neurons
    (CachedDataHelper -> PublishedDataGetter.retrievePublishedImages;
    alignment space unfiltered here, filtered per neuron at use)."""
    refs = sorted({n.sample_ref for n in neurons
                   if n is not None and getattr(n, "sample_ref", None)})
    if not refs:
        return {}
    dao = daos.published_lm_images_dao
    out = dao.get_published_images_with_gal4_by_sample_objectives(
        None, refs)
    if out:
        LOG.info("loaded published LM images for %d of %d samples",
                 len(out), len(refs))
    return out


def _finalize_neuron_files(meta, neuron, args) -> None:
    """Per-exported-neuron enrichment: published URLs merge, published
    LM image 3D stacks, image-store stamp (files.store), library
    display-name mapping, then URL transforms over every file entry
    (AbstractDataExporter.updateNeuronFiles + transformAllNeuronFiles)."""
    _apply_urls(meta, neuron, args._url_map)
    _apply_published_lm_images(meta, neuron, args)
    uploaded = args._published_urls_by_id.get(
        getattr(neuron, "entity_id", None))
    if uploaded:
        for key, ft in _UPLOADED_KEY_FILETYPES:
            if uploaded.get(key):
                meta.files = {**meta.files, ft: uploaded[key]}
    store = args._image_store(meta)
    if store:
        meta.files = {**meta.files, "store": store}
    # library display name AFTER the store lookup: the image-store
    # mapping is keyed on the internal name (AbstractDataExporter:48-51)
    if args._library_names and meta.library_name in args._library_names:
        meta.library_name = args._library_names[meta.library_name]
    transform = args._url_transformer
    meta.files = {ft: (transform(ft, url) if ft != "store" else url)
                  for ft, url in meta.files.items()}


# PPP screenshot type -> (publish FileType, thumbnail FileType)
# (model/PPPScreenshotType.java:5-10)
_PPP_SCREENSHOT_FILETYPES = {
    "RAW": ("SignalMip", None),
    "MASKED_RAW": ("SignalMipMasked", None),
    "SKEL": ("SignalMipMaskedSkel", None),
    "CH": ("CDMBest", "CDMBestThumbnail"),
    "CH_SKEL": ("CDMSkel", None),
}


def _ppp_match_files(m, pppm_urls: dict, transform) -> dict:
    """Publish files for one PPP match row: uploaded URLs from the
    pppmURL collection when available, else the raw screenshot file
    names (EMPPPMatchesExporter:213-227)."""
    if not m.source_image_files:
        return {}
    urls = pppm_urls.get(m.entity_id) or {}
    uploaded = urls.get("uploadedFiles") or {}
    thumbs = urls.get("uploadedThumbnails") or {}
    files = {}
    for stype, fname in m.source_image_files.items():
        ft, thumb_ft = _PPP_SCREENSHOT_FILETYPES.get(stype, (None, None))
        if ft is None:
            continue
        files[ft] = transform(ft, uploaded.get(stype) or fname)
        if thumb_ft and thumbs.get(stype):
            files[thumb_ft] = transform(thumb_ft, thumbs[stype])
    return files


def _export_ppp_matches(args, out_dir: Path, pretty: bool) -> int:
    """Per-EM PPP publish files (cmd/dataexport/EMPPPMatchesExporter):
    reads importPPPResults output — grouped files, or pppMatches store
    rows with --results-storage DB — and maps to the PPPMatchedTarget
    dto shape."""
    from colormipsearch_tpu_torch.model.entities import PPPMatch

    pppm_urls: dict = {}
    groups: list[tuple] = []  # (em neuron, [PPPMatch], fallback name)
    if args.resultsStorage == "DB":
        from colormipsearch_tpu_torch.persist import Config, DaosProvider

        daos = DaosProvider(Config(args.configFile))
        # uploaded screenshot URLs per match internal id
        # (model/PPPmURLs.java storeName pppmURL)
        for doc in daos.store.collection("pppmURL").find({}):
            try:
                pppm_urls[int(doc["_id"])] = doc
            except (KeyError, TypeError, ValueError):
                continue
        all_ppp = daos.ppp_matches_dao.find_all()
        args._published_lm_images_by_sample = _load_published_lm_images(
            daos, [m.matched_image for m in all_ppp], args)
        by_em: dict[str, list] = {}
        for m in all_ppp:
            em = m.mask_image
            name = (em.published_name if em is not None else None) \
                or m.source_em_name or ""
            by_em.setdefault(name, []).append(m)
        for name, ms in sorted(by_em.items()):
            em = next((m.mask_image for m in ms
                       if m.mask_image is not None), None)
            if em is None:
                continue
            ms.sort(key=lambda m: m.rank if m.rank is not None else 1e9)
            groups.append((em, ms, name))
    else:
        from colormipsearch_tpu_torch.model import neuron_from_json

        for f in JSONMatchesReader.list_matches_locations(args.matches):
            with open(f) as fh:
                doc = json.load(fh)
            em = neuron_from_json(doc["inputImage"]) \
                if doc.get("inputImage") else None
            if em is None:
                continue
            ms = []
            for rd in doc.get("results", ()):
                m = PPPMatch.from_json(rd)
                m.mask_image = em
                ms.append(m)
            groups.append((em, ms, Path(f).stem))

    n = 0
    for em, ms, fallback in groups:
        results = []
        for m in ms:
            row = dto.ppp_match_to_dto(m)
            _apply_published_lm_images(row.target, m.matched_image, args,
                                       include_gal4=False)
            if row.target.files:
                row.target.files = {
                    ft: args._url_transformer(ft, url)
                    for ft, url in row.target.files.items()}
            row.files = {
                **_ppp_match_files(m, pppm_urls, args._url_transformer),
                **{ft: args._url_transformer(ft, url)
                   for ft, url in (row.files or {}).items()}}
            results.append(row)
        em_meta = dto.neuron_metadata(em)
        _finalize_neuron_files(em_meta, em, args)
        publish = dto.result_matches_json(em_meta, results)
        name = em.published_name or em.mip_id or fallback
        with open(out_dir / f"{name}.json", "w") as fh:
            json.dump(publish, fh, indent=2 if pretty else None)
        n += 1
    LOG.info("exported %d PPP publish files to %s", n, out_dir)
    return 0


def _read_db_matches(args):
    """DB read path: per-mask aggregation reads keyed by the mask
    selector (ExportData4NBCmd's DBNeuronMatchesReader over
    findNeuronMatches)."""
    from colormipsearch_tpu_torch.persist import Config, DaosProvider
    from colormipsearch_tpu_torch.persist.requests import NeuronSelector

    daos = DaosProvider(Config(args.configFile))
    sel = NeuronSelector(alignment_space=args.alignment_space,
                         libraries=list(args.libraries or ()),
                         names=list(args.exported_names or ()),
                         tags=list(args.neuron_tags or ()))
    mip_ids = daos.cd_matches_dao.mask_mip_ids(sel)
    out = []
    for mip_id in mip_ids:
        out.extend(daos.cd_matches_dao.find_matches_by_mask(
            NeuronSelector(mip_ids=[mip_id])))
    LOG.info("read %d matches for %d masks from the DB store",
             len(out), len(mip_ids))
    neurons = [n for m in out for n in (m.mask_image, m.matched_image)]
    args._published_urls_by_id = _load_published_urls(daos, neurons)
    args._published_lm_images_by_sample = _load_published_lm_images(
        daos, neurons, args)
    return out


def _load_published_urls(daos, neurons) -> dict:
    """{neuron internal id: uploaded urls} from the publishedURL
    collection, fetched only for the given neurons
    (CachedDataHelper.retrievePublishedURLs queries per neuron batch,
    not the whole collection)."""
    needed = sorted({n.entity_id for n in neurons
                     if n is not None and n.entity_id is not None})
    coll = daos.store.collection("publishedURL")
    urls: dict = {}
    for i in range(0, len(needed), 500):
        for doc in coll.find({"_id": {"$in": needed[i:i + 500]}}):
            try:
                urls[int(doc["_id"])] = doc.get("uploaded") or {}
            except (KeyError, TypeError, ValueError):
                continue
    if urls:
        LOG.info("loaded published URLs for %d of %d exported neurons",
                 len(urls), len(needed))
    return urls


def _export_cd_matches(args, out_dir: Path, pretty: bool) -> int:
    """Per-mask publish files: dedupe to best match per (mask, target) MIP
    pair (AbstractCDMatchesExporter.selectBestMatchPerMIPPair:66-85), group
    by mask published name."""
    if args.resultsStorage == "DB":
        matches_in = _read_db_matches(args)
    else:
        matches_in = []
        for f in JSONMatchesReader.list_matches_locations(args.matches):
            matches_in.extend(JSONMatchesReader.read_matches(f))
    def neuron_ok(n, tags, ex_tags, terms, ex_terms, libs=()):
        if n is None:
            return False
        if libs and n.library_name not in libs:
            return False
        ntags = set(n.tags or ())
        nterms = set(getattr(n, "neuron_terms", None) or ())
        if tags and not ntags.intersection(tags):
            return False
        if ex_tags and ntags.intersection(ex_tags):
            return False
        if terms and not nterms.intersection(terms):
            return False
        if ex_terms and nterms.intersection(ex_terms):
            return False
        return True

    ex_match_tags = set(args.excluded_matches_tags or ())
    n_tags = set(args.neuron_tags or ())
    n_ex_tags = set(args.excluded_neuron_tags or ())
    n_terms = set(args.neuron_terms or ())
    n_ex_terms = set(args.excluded_neuron_terms or ())
    t_tags = set(args.target_tags or ())
    t_ex_tags = set(args.excluded_target_tags or ())
    t_terms = set(args.target_terms or ())
    t_ex_terms = set(args.excluded_target_terms or ())
    t_libs = set(args.target_library or ())
    matches_in = [
        m for m in matches_in
        if not (ex_match_tags and set(m.tags or ()) & ex_match_tags)
        and neuron_ok(m.mask_image, n_tags, n_ex_tags, n_terms,
                      n_ex_terms)
        and neuron_ok(m.matched_image, t_tags, t_ex_tags, t_terms,
                      t_ex_terms, libs=t_libs)
    ]
    if args.exported_mips:
        wanted = set(args.exported_mips)
        matches_in = [m for m in matches_in
                      if m.mask_image and m.mask_image.mip_id in wanted]

    # score filters (ExportData4NBCmd.getCDScoresFilter:209-218): ratio
    # floor plus gradientAreaGap >= 0 unless grad scores are ignored
    if args.pctPositivePixels > 0:
        thr = args.pctPositivePixels / 100
        matches_in = [m for m in matches_in
                      if (m.matching_pixels_ratio or 0) >= thr]
    if not args.ignoreGradScores:
        matches_in = [m for m in matches_in
                      if m.gradient_area_gap is not None
                      and m.gradient_area_gap >= 0]
    by_published: dict[str, list] = {}
    for m in matches_in:
        if m.mask_image is None or m.matched_image is None:
            continue
        name = m.mask_image.published_name or m.mask_image.mip_id
        by_published.setdefault(name, []).append(m)

    names_ordered = sorted(by_published)
    if args.offset > 0:
        names_ordered = names_ordered[args.offset:]
    if args.size > 0:
        names_ordered = names_ordered[:args.size]
    by_published = {k: by_published[k] for k in names_ordered}

    n = 0
    n_invalid = 0
    for name, matches in by_published.items():
        best: dict[tuple, object] = {}
        for m in matches:
            key = (m.mask_image.mip_id, m.matched_image.mip_id)
            cur = best.get(key)
            if cur is None or (m.normalized_score or 0) > \
                    (cur.normalized_score or 0):
                best[key] = m
        # required-attribute validation, mirroring the reference's
        # validating serializer (cmd/dataexport ValidatingSerializer):
        # published name + library are mandatory on every exported image
        selected = []
        for m in sorted(best.values(),
                        key=lambda m: -(m.normalized_score or 0)):
            errs = _validate_for_export(m)
            if errs:
                n_invalid += 1
                LOG.warning("skipping invalid match %s->%s: %s",
                            m.mask_image.mip_id, m.matched_image.mip_id,
                            "; ".join(errs))
                continue
            selected.append(m)
        if not selected:
            continue
        input_meta = dto.neuron_metadata(selected[0].mask_image)
        _finalize_neuron_files(input_meta, selected[0].mask_image, args)
        rows = []
        for m in selected:
            row = dto.cd_match_to_dto(m)
            _finalize_neuron_files(row.target, m.matched_image, args)
            if args._published_urls_by_id:
                # match CDMInput/CDMMatch come from each side's uploaded
                # searchable_neurons URL; matches missing either are
                # dropped (AbstractCDMatchesExporter:119-163,
                # EMCDMatchesExporter:174-179)
                transform = args._url_transformer
                mask_up = args._published_urls_by_id.get(
                    m.mask_image.entity_id) or {}
                tgt_up = args._published_urls_by_id.get(
                    m.matched_image.entity_id) or {}
                cdm_in = mask_up.get("searchable_neurons")
                cdm_match = tgt_up.get("searchable_neurons")
                if not cdm_in or not cdm_match:
                    LOG.warning("no searchable neuron URL for match "
                                "%s->%s; skipping",
                                m.mask_image.mip_id,
                                m.matched_image.mip_id)
                    continue
                row.files = {**row.files,
                             "CDMInput": transform("CDMInput", cdm_in),
                             "CDMMatch": transform("CDMMatch", cdm_match)}
                mask_store = input_meta.files.get("store")
                tgt_store = row.target.files.get("store")
                if mask_store and mask_store == tgt_store:
                    row.files["store"] = tgt_store
                elif mask_store != tgt_store:
                    LOG.error("image stores for mask %s and target %s "
                              "do not match", mask_store, tgt_store)
            rows.append(row)
        if not rows:
            continue
        doc = dto.result_matches_json(input_meta, rows)
        with open(out_dir / f"{name}.json", "w") as f:
            json.dump(doc, f, indent=2 if pretty else None)
        n += 1
    LOG.info("exported %d publish files to %s (%d invalid matches "
             "skipped)", n, out_dir, n_invalid)
    return 0


def _apply_urls(meta, neuron, url_map: dict) -> None:
    """Merge published URLs for a neuron's mip into its files map
    (the CachedDataHelper / publishedURLs enrichment of the reference's
    exporters, from an offline map)."""
    if not url_map or neuron is None:
        return
    urls = url_map.get(neuron.mip_id) or \
        url_map.get(neuron.published_name or "")
    if urls:
        meta.files = {**urls, **meta.files}


def _validate_for_export(m) -> list[str]:
    errs = []
    for side, neuron in (("mask", m.mask_image), ("target",
                                                  m.matched_image)):
        if not neuron.published_name:
            errs.append(f"{side} has no published name")
        if not neuron.library_name:
            errs.append(f"{side} has no library")
    if m.matching_pixels is None:
        errs.append("no matching pixels score")
    return errs


def _export_mips(args, out_dir: Path, pretty: bool) -> int:
    """by_body / by_line MIP export (cmd/dataexport/MIPsExporter)."""
    if args.resultsStorage == "DB":
        from colormipsearch_tpu_torch.persist import Config, DaosProvider
        from colormipsearch_tpu_torch.persist.requests import NeuronSelector

        daos = DaosProvider(Config(args.configFile))
        neurons = daos.neuron_metadata_dao.find_neurons(NeuronSelector(
            alignment_space=args.alignment_space,
            libraries=list(args.libraries or ()),
            names=list(args.exported_names or ()),
            tags=list(args.neuron_tags or ())))
        args._published_urls_by_id = _load_published_urls(daos, neurons)
        args._published_lm_images_by_sample = _load_published_lm_images(
            daos, neurons, args)
    else:
        neurons = []
        for src in args.mips:
            neurons.extend(read_neurons_json(src))
    by_name: dict[str, list] = {}
    for n in neurons:
        name = n.published_name or n.mip_id
        by_name.setdefault(name, []).append(n)
    for name, neurons in by_name.items():
        metas = []
        for n in neurons:
            meta = dto.neuron_metadata(n)
            _finalize_neuron_files(meta, n, args)
            metas.append(meta)
        doc = {"results": [meta.to_json() for meta in metas]}
        with open(out_dir / f"{name}.json", "w") as f:
            json.dump(doc, f, indent=2 if pretty else None)
    LOG.info("exported %d MIP files to %s", len(by_name), out_dir)
    return 0


# -------------------------------------------------------------------------
# importPPPResults
# -------------------------------------------------------------------------


def configure_import_ppp(sp):
    sp.add_argument("--results-dir", "-rd", nargs="*", default=[],
                    help="PPP results dirs (em subdirs w/ cov_scores_*.json)")
    sp.add_argument("--em-library", default=None)
    sp.add_argument("--lm-library", default=None)
    sp.add_argument("--alignment-space", "-as", default=None)
    sp.add_argument("--only-best-skeleton-matches", action="store_true")
    sp.add_argument("--include-skeletons",
                    "--include-raw-skeleton-matches",
                    dest="include_skeletons",
                    action="store_true", default=True)
    sp.add_argument("--results-file", "-rf", nargs="*", default=[],
                    help="explicit cov_scores result files (in addition "
                         "to --results-dir scans)")
    sp.add_argument("--matches-prefix", default="cov_scores_",
                    help="filename prefix of the PPP score result files")
    sp.add_argument("--neuron-matches-sub-dir",
                    default=None,
                    help="only scan results inside this per-neuron "
                         "subdirectory (the PPP pipeline writes e.g. "
                         "lm_cable_length_20_v4_adj_by_cov_numba_agglo_aT)")
    sp.add_argument("--anatomical-area", "-area", default="Brain",
                    help="suffix equal to this area is NOT an objective "
                         "(ImportPPPResultsCmd.updateLMMetadata)")
    sp.add_argument("--em-tags", nargs="*", default=[],
                    help="tags stamped on resolved/created EM neurons")
    sp.add_argument("--processing-partition-size", "-ps",
                    type=int, default=100,
                    help="accepted for reference parity")
    sp.add_argument("--jacs-read-batch-size", type=int, default=1000,
                    help="accepted for reference parity")
    sp.add_argument("--screenshots-dir", dest="screenshotsDir",
                    default="screenshots",
                    help="screenshots dir name next to each results file "
                         "(ImportPPPResultsCmd --screenshots-dir)")
    sp.add_argument("--processing-tag", dest="processingTag", default="")
    sp.add_argument("--jacs-url", "--data-url", dest="jacsURL",
                    default=None,
                    help="JACS base URL (or file:// dump) to resolve LM "
                         "sample publishing names / slide codes "
                         "(CachedDataHelper.retrieveLMSamplesByName)")
    sp.add_argument("--authorization", default=None)
    sp.add_argument("--mips-storage", dest="mipsStorage",
                    choices=["FS", "DB"], default="FS",
                    help="DB: resolve EM mask neurons from the metadata "
                         "store and stamp PPPMatch processing tags")
    sp.add_argument("--results-storage", dest="resultsStorage",
                    choices=["FS", "DB"], default="FS")
    sp.add_argument("--config", dest="configFile", default=None)
    sp.add_argument("-od", "--outputDir", required=False, default=None)
    sp.add_argument("--no-pretty-print", dest="noPrettyPrint",
                    action="store_true")


def cmd_import_ppp(args) -> int:
    """Parse raw PPP files to pppMatches grouped per EM neuron
    (ImportPPPResultsCmd): resolves EM mask neurons from the metadata
    store when --mips-storage DB, attaches per-match screenshot files
    (rank < 500) from the sibling screenshots dir, and writes grouped
    JSON or DB rows."""
    gen = TimebasedIdGenerator()
    if not args.results_dir and not args.results_file:
        raise SystemExit("no inputs: use -rd / -rf")
    if args.results_file:
        # -rf takes precedence over -rd (ImportPPPResultsCmd:157-162)
        files = [Path(f) for f in args.results_file]
    else:
        files = ppp_io.find_ppp_result_files(
            args.results_dir, prefix=args.matches_prefix,
            sub_dir=args.neuron_matches_sub_dir)
    out_dir = Path(args.outputDir) if args.outputDir else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)

    daos = None
    registered_em = {}
    if args.mipsStorage == "DB" or args.resultsStorage == "DB":
        from colormipsearch_tpu_torch.persist import Config, DaosProvider

        daos = DaosProvider(Config(args.configFile))
    if daos is not None and args.mipsStorage == "DB":
        from colormipsearch_tpu_torch.persist.requests import NeuronSelector

        sel = NeuronSelector(
            libraries=[args.em_library] if args.em_library else [])
        for n in daos.neuron_metadata_dao.find_neurons(sel):
            if n.published_name:
                registered_em.setdefault(n.published_name, n)

    samples_client = None
    if args.jacsURL:
        from colormipsearch_tpu_torch.io.jacs import SamplesClient

        samples_client = SamplesClient(args.jacsURL,
                                       auth_token=args.authorization)

    n_matches = 0
    used_em = []
    for f in files:
        matches = ppp_io.read_raw_ppp_matches(
            f, only_best_matches=args.only_best_skeleton_matches,
            include_skeletons=args.include_skeletons)
        if not matches:
            continue
        samples = {}
        if samples_client is not None:
            names = {ppp_io.lm_sample_name(m.source_lm_name or "")
                     for m in matches}
            samples = samples_client.samples_by_names(names)
        em = ppp_io.em_neuron_from_ppp_name(
            matches[0].source_em_name, library=args.em_library,
            alignment_space=args.alignment_space)
        # DB neuron resolution: the registered neuron (by body id)
        # becomes the mask reference (ImportPPPResultsCmd
        # retrieveEMNeurons + setMaskImage)
        for t in args.em_tags or ():
            em.tags.add(t)
        db_em = registered_em.get(em.published_name or "")
        if db_em is not None:
            em = db_em
            for t in args.em_tags or ():
                em.tags.add(t)
            if args.processingTag:
                em.add_processed_tags(ProcessingType.PPPMatch,
                                      [args.processingTag])
            used_em.append(em)
        elif em.entity_id is None:
            em.entity_id = gen.generate_id()
        screenshots_dir = f.parent / args.screenshotsDir
        for m in matches:
            m.mask_image = em
            m.mask_image_ref_id = em.entity_id
            m.matched_image = ppp_io.lm_neuron_from_ppp_name(
                m.source_lm_name, library=args.lm_library,
                alignment_space=args.alignment_space,
                anatomical_area=args.anatomical_area)
            sample = samples.get(
                ppp_io.lm_sample_name(m.source_lm_name or ""))
            if sample:
                # JACS sample enrichment (updateLMSampleInfo:382-387)
                if sample.get("publishingName"):
                    m.matched_image.published_name = \
                        sample["publishingName"]
                if sample.get("slideCode"):
                    m.matched_image.slide_code = sample["slideCode"]
            m.entity_id = gen.generate_id()
            m.source_em_library = args.em_library
            m.source_lm_library = args.lm_library
            if args.processingTag:
                m.tags.add(args.processingTag)
            if m.rank is not None and m.rank < 500:
                # screenshot attachment (lookupScreenshots:388-396)
                shots = ppp_io.find_screenshots(
                    screenshots_dir, m.source_em_name or "",
                    m.source_lm_name or "")
                if shots:
                    m.source_image_files.update(shots)
        matches.sort(key=lambda m: m.rank if m.rank is not None else 1e9)
        if daos is not None and args.resultsStorage == "DB":
            daos.ppp_matches_dao.save_all(matches)
        if out_dir is not None:
            doc = {
                "inputImage": em.to_json(),
                "results": [_ppp_result_json(m) for m in matches],
            }
            name = em.published_name or f.stem
            with open(out_dir / f"{name}.json", "w") as fh:
                json.dump(doc, fh,
                          indent=None if args.noPrettyPrint else 2)
        n_matches += len(matches)
    if daos is not None and used_em and args.processingTag:
        daos.neuron_metadata_dao.add_processing_tags(
            used_em, ProcessingType.PPPMatch, [args.processingTag])
    LOG.info("imported %d PPP matches from %d files", n_matches, len(files))
    return 0


def _ppp_result_json(m) -> dict:
    d = m.to_json()
    d.pop("maskImage", None)
    return d


# -------------------------------------------------------------------------
# tag
# -------------------------------------------------------------------------


def configure_tag(sp):
    sp.add_argument("-i", "--input", nargs="*", default=[],
                    help="neuron JSON files to tag (FS mode; omit for "
                         "the DB store)")
    sp.add_argument("--config", dest="configFile", default=None)
    sp.add_argument("--tag", nargs="+", required=True)
    sp.add_argument("--alignment-space", "-as", default=None)
    sp.add_argument("-l", "--library", "--libraries", dest="libraries",
                    nargs="*", default=None)
    sp.add_argument("--published-names", nargs="*", default=None)
    sp.add_argument("--mip-ids", nargs="*", default=None)
    sp.add_argument("--source-refs", nargs="*", default=None,
                    help="Sample/Body references to tag")
    sp.add_argument("--data-labels", nargs="*", default=None,
                    help="dataset labels to select")
    sp.add_argument("--data-tags", nargs="*", default=None,
                    help="only tag neurons already carrying one of these")
    sp.add_argument("--excluded-data-tags", nargs="*", default=None,
                    help="skip neurons carrying any of these tags")
    sp.add_argument("--processing-tags", nargs="*", default=[],
                    help="'<ProcessingType>=<tag>' selections")
    sp.add_argument("--processing-type", default=None,
                    choices=[p.value for p in ProcessingType])
    sp.add_argument("--no-pretty-print", dest="noPrettyPrint",
                    action="store_true")


def _tag_selector(args):
    from colormipsearch_tpu_torch.persist.requests import NeuronSelector

    processed = []
    for spec in args.processing_tags or ():
        ptype, _, tag = spec.partition("=")
        if tag:
            processed.append((ptype, tag))
    return NeuronSelector(
        alignment_space=args.alignment_space,
        libraries=list(args.libraries or ()),
        names=list(args.published_names or ()),
        mip_ids=list(args.mip_ids or ()),
        source_refs=list(args.source_refs or ()),
        datasets=list(args.data_labels or ()),
        tags=list(args.data_tags or ()),
        excluded_tags=list(args.excluded_data_tags or ()),
        processed_tags=processed)


def cmd_tag(args) -> int:
    """Bulk-tag neuron metadata (TagNeuronMetadataCmd): FS files in
    place, or the DB store via the full neuron selector."""
    if not args.input:
        # DB mode: selector-driven append (TagNeuronMetadataCmd:94-107)
        from colormipsearch_tpu_torch.persist import Config, DaosProvider

        daos = DaosProvider(Config(args.configFile))
        neurons = daos.neuron_metadata_dao.find_neurons(_tag_selector(args))
        for neuron in neurons:
            if args.processing_type:
                neuron.add_processed_tags(
                    ProcessingType(args.processing_type), args.tag)
            else:
                neuron.tags.update(args.tag)
            daos.neuron_metadata_dao.create_or_update(neuron)
        LOG.info("tagged %d neurons in the DB store", len(neurons))
        return 0

    names = set(args.published_names or ())
    libs = set(args.libraries or ())
    mips = set(args.mip_ids or ())
    refs = set(args.source_refs or ())
    dtags = set(args.data_tags or ())
    ex_dtags = set(args.excluded_data_tags or ())
    labels = set(args.data_labels or ())
    for src in args.input:
        neurons = read_neurons_json(src)
        n = 0
        for neuron in neurons:
            if names and neuron.published_name not in names:
                continue
            if libs and neuron.library_name not in libs:
                continue
            if mips and neuron.mip_id not in mips:
                continue
            if refs and (neuron.source_ref_id or "") not in refs:
                continue
            if args.alignment_space and \
                    neuron.alignment_space != args.alignment_space:
                continue
            if dtags and not neuron.tags & dtags:
                continue
            if ex_dtags and neuron.tags & ex_dtags:
                continue
            if labels and not neuron.dataset_labels & labels:
                continue
            if args.processing_type:
                neuron.add_processed_tags(
                    ProcessingType(args.processing_type), args.tag)
            else:
                neuron.tags.update(args.tag)
            n += 1
        write_neurons_json(neurons, src, pretty=not args.noPrettyPrint)
        LOG.info("tagged %d/%d neurons in %s", n, len(neurons), src)
    return 0
