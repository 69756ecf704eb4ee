"""JACS REST ingestion client.

Minimal twin of the reference's Jersey clients (cmd/jacsdata/
JacsDataGetter.java, HttpHelper.java): page through a config server's
`/data/colorDepthMIPsWithSamples` endpoint and map the returned
ColorDepthMIP records to neuron entities, the online mode of
createColorDepthSearchDataInput (cmd/CreateCDSDataInputCmd.java:56-679).

This environment has no egress, so the transport is pluggable:
`http(s)://` via urllib (with bearer auth), or `file://` pointing at a
directory of page JSON dumps — which is also how the client is tested.
"""

from __future__ import annotations

import json
import logging
import os
import urllib.parse
import urllib.request
from typing import Iterator, Optional

from colormipsearch_tpu_torch.model import (
    ComputeFileType,
    EMNeuron,
    LMNeuron,
    Neuron,
)

LOG = logging.getLogger(__name__)

DEFAULT_PAGE_SIZE = 10000


class JacsClient:
    def __init__(self, base_url: str, *, auth_token: str | None = None,
                 page_size: int = DEFAULT_PAGE_SIZE):
        self.base_url = base_url.rstrip("/")
        self.auth_token = auth_token
        self.page_size = page_size

    def _get(self, path: str, params) -> list:
        """params: dict or urlencode-compatible sequence of pairs."""
        if self.base_url.startswith("file://"):
            # offline mode: directory with <endpoint>_<offset>.json dumps
            root = self.base_url[len("file://"):]
            name = path.strip("/").replace("/", "_")
            offset = (dict(params) if not isinstance(params, dict)
                      else params).get("offset", 0)
            page_file = os.path.join(root, f"{name}_{offset}.json")
            if not os.path.exists(page_file):
                return []
            with open(page_file) as f:
                return json.load(f)
        url = f"{self.base_url}{path}?" + urllib.parse.urlencode(params)
        req = urllib.request.Request(url)
        if self.auth_token:
            req.add_header("Authorization", f"Bearer {self.auth_token}")
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.load(resp)

    def color_depth_mips_with_samples(self, *, library: str,
                                      alignment_space: str | None = None,
                                      datasets=None, releases=None,
                                      mips=None) -> Iterator[dict]:
        """Page through the library's MIPs
        (JacsDataGetter paging over /data/colorDepthMIPsWithSamples;
        dataset/release/id filters as comma lists,
        CreateCDSDataInputCmd.java:552-567)."""
        offset = 0
        while True:
            params = {"libraryName": library, "offset": offset,
                      "length": self.page_size}
            if alignment_space:
                params["alignmentSpace"] = alignment_space
            filtered = False
            for key, vals in (("dataset", datasets), ("release", releases),
                              ("id", mips)):
                vals = [v for v in (vals or ()) if v]
                if vals:
                    params[key] = ",".join(vals)
                    filtered = filtered or key != "id"
            if filtered and offset == 0 \
                    and self.base_url.startswith("file://"):
                # the page-dump transport cannot filter server-side; id
                # filters are re-applied client-side but dataset/release
                # membership is not part of the MIP records
                LOG.warning("dataset/release filters are IGNORED by the "
                            "file:// page-dump transport")
            page = self._get("/data/colorDepthMIPsWithSamples", params)
            if not page:
                return
            yield from page
            if len(page) < self.page_size:
                return
            offset += len(page)


def _chunked(seq, n):
    for i in range(0, len(seq), n):
        yield seq[i:i + n]


class SamplesClient(JacsClient):
    """LM sample lookups (JacsDataGetter.retrieveLMSamplesByName /
    PublishedDataGetter): /data/samples filtered by sample name."""

    def samples_by_names(self, names) -> dict:
        """{sample name: sample record}."""
        names = [n for n in names if n]
        if not names:
            return {}
        out = {}
        if self.base_url.startswith("file://"):
            # offline dump: one page file, filtered client-side
            recs = self._get("/data/samples", {"offset": 0})
            wanted = set(names)
            for rec in recs:
                if rec.get("name") in wanted:
                    out[rec["name"]] = rec
            return out
        for chunk in _chunked(sorted(names), 100):
            for rec in self._get("/data/samples",
                                 [("name", n) for n in chunk]):
                if rec.get("name"):
                    out[rec["name"]] = rec
        return out


def _is_em_library(library: str) -> bool:
    """One shared classifier (naming.is_em_library,
    MIPsHandlingUtils.isEmLibrary:116)."""
    from colormipsearch_tpu_torch.io.naming import is_em_library
    return is_em_library(library)


def mip_record_to_neuron(rec: dict, library: str) -> Optional[Neuron]:
    """Map a JACS ColorDepthMIP record (cmd/jacsdata/ColorDepthMIP.java)
    to a neuron entity with computeFiles."""
    filepath = rec.get("filepath")
    if not filepath:
        return None
    if _is_em_library(library):
        n: Neuron = EMNeuron(
            neuron_type=(rec.get("emBody") or {}).get("neuronType"),
            neuron_instance=(rec.get("emBody") or {}).get("neuronInstance"),
        )
        # publishedName is the bodyId ONLY (ColorDepthMIP.emBodyId:131,
        # CreateCDSDataInputCmd.asEMNeuron:478) — null when absent, no
        # emBody.name fallback
        body = rec.get("bodyId")
        n.published_name = str(body) if body is not None else None
        n.source_ref_id = rec.get("emBodyRef") or \
            ((rec.get("emBody") or {}).get("_id"))
        # EM skeleton compute files ride the emBody record
        # (CreateCDSDataInputCmd.java:485-491)
        body_files = (rec.get("emBody") or {}).get("files") or {}
        if body_files.get("SkeletonSWC"):
            n.set_compute_file(ComputeFileType.SkeletonSWC,
                               body_files["SkeletonSWC"])
        if body_files.get("SkeletonOBJ"):
            n.set_compute_file(ComputeFileType.SkeletonOBJ,
                               body_files["SkeletonOBJ"])
    else:
        sample = rec.get("sample") or {}
        # slideCode/publishedName come from the SAMPLE only
        # (ColorDepthMIP.lmLineName:87/lmSlideCode:92,
        # CreateCDSDataInputCmd.asLMNeuron:504-505) — records without a
        # published sample keep them null rather than falling back to
        # internal names (publishedName is the nBestLines grouping key)
        n = LMNeuron(
            slide_code=sample.get("slideCode"),
            gender=sample.get("gender"),
            objective=rec.get("objective"),
            anatomical_area=rec.get("anatomicalArea"),
            mounting_protocol=sample.get("mountingProtocol"),
            sample_ref=rec.get("sampleRef"),
            sample_name=sample.get("name"),
            internal_line_name=sample.get("line"),
        )
        n.published_name = sample.get("publishingName")
        ch = rec.get("channelNumber")
        if ch is not None:
            try:
                n.channel = int(ch)
            except (TypeError, ValueError):
                pass
        n.source_ref_id = rec.get("sampleRef")
    rid = rec.get("id") or rec.get("_id")
    n.mip_id = str(rid) if rid is not None else None
    n.library_name = library
    n.alignment_space = rec.get("alignmentSpace")
    n.set_compute_file(ComputeFileType.SourceColorDepthImage, filepath)
    n.set_compute_file(ComputeFileType.InputColorDepthImage, filepath)
    return n


def load_library_neurons(client: JacsClient, *, library: str,
                         alignment_space: str | None = None,
                         variant_locations: dict | None = None,
                         variant_suffixes: dict | None = None,
                         datasets=None, releases=None, mips=None,
                         included_libraries=None,
                         excluded_libraries=None) -> list[Neuron]:
    """Fetch a library and attach variant compute files by convention
    (--librariesVariants semantics of CreateCDSDataInputCmd:116-118).
    dataset/release/mip-id filters go into the JACS query; the
    included/excluded-libraries check runs on each record's `libraries`
    list (CreateCDSDataInputCmd.checkLibraries:459-468)."""
    from colormipsearch_tpu_torch.io import mips as mips_io

    included_libraries = set(included_libraries or ())
    excluded_libraries = set(excluded_libraries or ())
    mip_ids = {str(m) for m in (mips or ()) if m}
    out = []
    for rec in client.color_depth_mips_with_samples(
            library=library, alignment_space=alignment_space,
            datasets=datasets, releases=releases, mips=mips):
        rec_libs = set(rec.get("libraries") or ())
        if included_libraries and not included_libraries <= rec_libs:
            continue
        if excluded_libraries and rec_libs & excluded_libraries:
            continue
        # re-applied client-side for the file:// page-dump transport,
        # which cannot filter server-side
        rec_id = rec.get("id") or rec.get("_id")
        if mip_ids and str(rec_id) not in mip_ids:
            continue
        n = mip_record_to_neuron(rec, library)
        if n is None:
            continue
        if variant_locations:
            base_fd = n.compute_file(ComputeFileType.InputColorDepthImage)
            for ftype_name, locations in variant_locations.items():
                ftype = ComputeFileType.from_name(ftype_name)
                if ftype is None:
                    continue
                suffix = (variant_suffixes or {}).get(ftype_name, "")
                fd = mips_io.find_variant(base_fd, locations, suffix)
                if fd is not None:
                    n.set_compute_file(ftype, fd)
        out.append(n)
    LOG.info("loaded %d neurons from JACS library %s", len(out), library)
    return out
