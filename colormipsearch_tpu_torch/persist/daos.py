"""DAOs over the document store.

Mirrors the reference's Mongo DAO semantics:
  * NeuronMetadataDao — dao/mongo/NeuronMetadataMongoDao.java: CRUD +
    createOrUpdate keyed on (mipId, libraryName, InputColorDepthImage),
    distinct mipIds, bulk addProcessingTags
  * CDMatchesDao — dao/mongo/AbstractNeuronMatchesMongoDao.java:
    createOrUpdateAll upsert keyed on (maskImageRefId, matchedImageRefId)
    :112-160, findNeuronMatches aggregation that re-embeds the mask/target
    neurons into each match :275-295, score-only updates
  * PPPMatchesDao — dao/mongo/PPPMatchesMongoDao.java
  * DaosProvider — dao/DaosProvider.java

The JAX package's persist/daos.py, changed only in imports.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

from colormipsearch_tpu_torch.model import (
    CDMatch,
    Neuron,
    PPPMatch,
    ProcessingType,
    PublishedLMImage,
    neuron_from_json,
)
from colormipsearch_tpu_torch.model.entities import _round_f32
from colormipsearch_tpu_torch.model.ids import TimebasedIdGenerator
from colormipsearch_tpu_torch.persist.config import Config
from colormipsearch_tpu_torch.persist.requests import (
    NeuronSelector,
    PagedRequest,
    ScoresFilter,
)
from colormipsearch_tpu_torch.persist.store import open_store


class NeuronMetadataDao:
    COLLECTION = "neuronMetadata"  # @PersistenceInfo storeName

    def __init__(self, store, id_gen: TimebasedIdGenerator):
        self._col = store.collection(self.COLLECTION)
        self._ids = id_gen

    # -- write --

    def save(self, neuron: Neuron) -> Neuron:
        if neuron.entity_id is None:
            neuron.entity_id = self._ids.generate_id()
        doc = neuron.to_json()
        doc["_id"] = str(neuron.entity_id)
        self._col.replace_one(doc)
        return neuron

    def create_or_update(self, neuron: Neuron) -> Neuron:
        """Upsert keyed on (mipId, libraryName, input image name)
        (NeuronMetadataMongoDao.createOrUpdate).

        DB-accumulated bookkeeping (processedTags, tags,
        validationErrors, datasetLabels) survives the update — the
        reference updates fields rather than replacing the document, so
        a re-import must not erase pipeline progress."""
        from colormipsearch_tpu_torch.model import ComputeFileType

        fd = neuron.compute_file(ComputeFileType.InputColorDepthImage)
        filt = {"mipId": neuron.mip_id,
                "libraryName": neuron.library_name}
        if fd is not None:
            # canonical serialized form: a plain string for files, the
            # {dataType: zipEntry, ...} object for zip entries — the
            # store compares non-$ dicts by equality
            filt["computeFiles.InputColorDepthImage"] = fd.to_json()
        existing = self._col.find_one(filt)
        if existing is not None:
            neuron.entity_id = int(existing["_id"])
            for ptype, vals in (existing.get("processedTags") or {}).items():
                pt = ProcessingType(ptype) \
                    if not isinstance(ptype, ProcessingType) else ptype
                cur = set(neuron.processed_tags.get(pt, ()))
                neuron.processed_tags[pt] = cur | set(vals)
            neuron.tags |= set(existing.get("tags") or ())
            old_errors = set(existing.get("validationErrors") or ())
            if old_errors:
                neuron.validation_errors = \
                    (neuron.validation_errors or set()) | old_errors
            neuron.dataset_labels |= set(existing.get("datasetLabels")
                                         or ())
        return self.save(neuron)

    def add_processing_tags(self, neurons: Iterable[Neuron],
                            ptype: ProcessingType,
                            tags: Sequence[str]) -> int:
        n = 0
        for neuron in neurons:
            if neuron.entity_id is None:
                continue
            neuron.add_processed_tags(ptype, tags)
            doc = self._col.find_one({"_id": str(neuron.entity_id)})
            if doc is None:
                continue
            pt = doc.get("processedTags") or {}
            cur = set(pt.get(ptype.value) or [])
            cur.update(tags)
            pt[ptype.value] = sorted(cur)
            self._col.update_fields(neuron.entity_id,
                                    {"processedTags": pt})
            n += 1
        return n

    # -- read --

    def find_by_id(self, entity_id) -> Optional[Neuron]:
        doc = self._col.find_one({"_id": str(entity_id)})
        return self._from_doc(doc) if doc else None

    def find_by_ids(self, entity_ids) -> dict:
        """Batch primary-key read: {str(id): Neuron}."""
        ids = [str(i) for i in entity_ids if i is not None]
        docs = self._col.find({"_id": {"$in": ids}})
        return {str(d["_id"]): self._from_doc(d) for d in docs}

    def find_neurons(self, selector: NeuronSelector,
                     page: PagedRequest | None = None) -> list[Neuron]:
        page = page or PagedRequest()
        docs = self._col.find(selector.to_filter(), limit=page.size,
                              offset=page.offset, sort=page.sort_spec())
        return [self._from_doc(d) for d in docs]

    def distinct_mip_ids(self, selector: NeuronSelector) -> list[str]:
        return self._col.distinct("mipId", selector.to_filter())

    @staticmethod
    def _from_doc(doc: dict) -> Neuron:
        d = {k: v for k, v in doc.items() if k != "_id"}
        n = neuron_from_json(d)
        if n.entity_id is None:
            n.entity_id = int(doc["_id"])
        return n


class CDMatchesDao:
    COLLECTION = "cdMatches"

    def __init__(self, store, id_gen: TimebasedIdGenerator,
                 neurons: NeuronMetadataDao):
        self._col = store.collection(self.COLLECTION)
        self._ids = id_gen
        self._neurons = neurons

    def create_or_update_all(self, matches: Sequence[CDMatch],
                             update_fields: Sequence[str] = ()) -> int:
        """Bulk upsert keyed on (maskImageRefId, matchedImageRefId)
        (AbstractNeuronMatchesMongoDao:112-160)."""
        n = 0
        for m in matches:
            filt = {"maskImageRefId": str(m.mask_image_ref_id),
                    "matchedImageRefId": str(m.matched_image_ref_id)}
            existing = self._col.find_one(filt)
            if existing is not None and update_fields:
                doc_json = m.to_json(include_neurons=False)
                self._col.update_fields(
                    existing["_id"],
                    {f: doc_json.get(f) for f in update_fields
                     if f in doc_json})
                n += 1
                continue
            if existing is not None:
                m.entity_id = int(existing["_id"])
            elif m.entity_id is None:
                m.entity_id = self._ids.generate_id()
            doc = m.to_json(include_neurons=False)
            doc["_id"] = str(m.entity_id)
            doc["maskImageRefId"] = str(m.mask_image_ref_id)
            doc["matchedImageRefId"] = str(m.matched_image_ref_id)
            self._col.replace_one(doc)
            n += 1
        return n

    def update_scores(self, matches: Sequence[CDMatch]) -> int:
        """Score-only field updates (DBCDScoresOnlyWriter)."""
        n = 0
        for m in matches:
            if m.entity_id is None:
                continue
            ok = self._col.update_fields(m.entity_id, {
                "gradientAreaGap": m.gradient_area_gap,
                "highExpressionArea": m.high_expression_area,
                # float32 round-trip like the FS writer (CDMatch.to_json)
                # and the reference's Float fields, so DB- and FS-backed
                # runs normalize from identical inputs
                "normalizedScore": None if m.normalized_score is None
                else _round_f32(m.normalized_score),
            })
            n += bool(ok)
        return n

    def find_matches_by_mask(self, mask_selector: NeuronSelector,
                             target_selector: NeuronSelector | None = None,
                             scores_filter: ScoresFilter | None = None,
                             page: PagedRequest | None = None,
                             match_tags: Sequence[str] = (),
                             ) -> list[CDMatch]:
        """The aggregation read: filter matches, join + embed the mask and
        matched neurons, then filter by neuron selectors
        (AbstractNeuronMatchesMongoDao.findNeuronMatches:275-295).
        ``match_tags`` filters on the match document's own tags
        (NeuronSelectionHelper.getNeuronsMatchFilter tags $in)."""
        page = page or PagedRequest()
        filt = scores_filter.to_filter() if scores_filter else {}
        if match_tags:
            filt = dict(filt)
            filt["tags"] = {"$in": list(match_tags)}
        if not mask_selector.is_empty():
            # resolve the mask side first so the match read is an indexed
            # maskImageRefId IN (...) instead of a collection scan
            mask_refs = [str(n.entity_id)
                         for n in self._neurons.find_neurons(mask_selector)]
            filt = dict(filt)
            filt["maskImageRefId"] = {"$in": mask_refs}
        docs = self._col.find(filt, sort=page.sort_spec())
        # batch-join the referenced neurons (one indexed read per side)
        mask_by_id = self._neurons.find_by_ids(
            {doc.get("maskImageRefId") for doc in docs})
        target_by_id = self._neurons.find_by_ids(
            {doc.get("matchedImageRefId") for doc in docs})
        out = []
        # selector verdicts memoized per distinct neuron (a mask's matches
        # all share the same mask entity — no per-row re-serialization)
        mask_ok: dict = {}
        target_ok: dict = {}
        for doc in docs:
            mask = mask_by_id.get(doc.get("maskImageRefId"))
            target = target_by_id.get(doc.get("matchedImageRefId"))
            if mask is None or target is None:
                continue
            if not mask_selector.is_empty():
                v = mask_ok.get(id(mask))
                if v is None:
                    v = _neuron_matches(mask, mask_selector)
                    mask_ok[id(mask)] = v
                if not v:
                    continue
            if target_selector and not target_selector.is_empty():
                v = target_ok.get(id(target))
                if v is None:
                    v = _neuron_matches(target, target_selector)
                    target_ok[id(target)] = v
                if not v:
                    continue
            m = CDMatch.from_json(
                {k: v for k, v in doc.items() if k != "_id"})
            m.entity_id = int(doc["_id"])
            m.mask_image = mask
            m.matched_image = target
            out.append(m)
        if page.offset:
            out = out[page.offset:]
        if page.size:
            out = out[:page.size]
        return out

    def mask_mip_ids(self, mask_selector: NeuronSelector) -> list[str]:
        """Distinct mask mipIds having matches."""
        neurons = self._neurons.find_neurons(mask_selector)
        by_ref = {str(n.entity_id): n for n in neurons}
        out, seen = [], set()
        refs = self._col.distinct("maskImageRefId",
                                  {"maskImageRefId":
                                   {"$in": list(by_ref)}})
        for ref in refs:
            n = by_ref.get(ref)
            if n is not None and n.mip_id not in seen:
                seen.add(n.mip_id)
                out.append(n.mip_id)
        return out


def _neuron_matches(n: Neuron, sel: NeuronSelector) -> bool:
    from colormipsearch_tpu_torch.persist.store import _matches
    return _matches(n.to_json(), sel.to_filter())


class PPPMatchesDao:
    COLLECTION = "pppMatches"

    def __init__(self, store, id_gen: TimebasedIdGenerator):
        self._col = store.collection(self.COLLECTION)
        self._ids = id_gen

    def save_all(self, matches: Sequence[PPPMatch]) -> int:
        docs = []
        for m in matches:
            if m.entity_id is None:
                m.entity_id = self._ids.generate_id()
            doc = m.to_json()
            doc["_id"] = str(m.entity_id)
            docs.append(doc)
        return self._col.insert_many(docs)

    def find_all(self, filt: dict | None = None) -> list[PPPMatch]:
        return [PPPMatch.from_json(
            {k: v for k, v in d.items() if k != "_id"})
            for d in self._col.find(filt or {})]


class PublishedLMImageDao:
    """`publishedLMImage` collection: published LM images per sample /
    objective / area, with the Gen1 GAL4/LexA expression self-join
    (dao/mongo/PublishedLMImageMongoDao.java)."""

    COLLECTION = "publishedLMImage"
    GAL4_RELEASES = ("Gen1 GAL4", "Gen1 LexA")

    def __init__(self, store, id_gen: TimebasedIdGenerator):
        self._col = store.collection(self.COLLECTION)
        self._ids = id_gen

    def save_all(self, images: Sequence[PublishedLMImage]) -> int:
        docs = []
        for im in images:
            if im.entity_id is None:
                im.entity_id = self._ids.generate_id()
            doc = im.to_json()
            doc["_id"] = str(im.entity_id)
            docs.append(doc)
        return self._col.insert_many(docs)

    def get_published_images(self, alignment_space, sample_refs,
                             objective=None) -> dict:
        """{sampleRef: [PublishedLMImage]} filtered like
        PublishedLMImageMongoDao.getPublishedImages."""
        refs = [r for r in (sample_refs or ()) if r]
        if not refs:
            return {}
        filt: dict = {"sampleRef": {"$in": refs}}
        if alignment_space:
            filt["alignmentSpace"] = alignment_space
        if objective:
            filt["objective"] = objective
        out: dict = {}
        for d in self._col.find(filt):
            im = PublishedLMImage.from_json(d)
            out.setdefault(im.sample_ref, []).append(im)
        return out

    def get_published_images_with_gal4_by_sample_objectives(
            self, alignment_space, sample_refs, objective=None) -> dict:
        """The $lookup pipeline of getPublishedImagesWithGal4BySampleObjectives:
        each published image joins the Gen1 GAL4/LexA rows that share its
        originalLine + area."""
        by_ref = self.get_published_images(alignment_space, sample_refs,
                                           objective)
        lines = sorted({im.original_line
                        for ims in by_ref.values() for im in ims
                        if im.original_line})
        gal4_rows: dict = {}
        if lines:
            for d in self._col.find({
                    "originalLine": {"$in": lines},
                    "releaseName": {"$in": list(self.GAL4_RELEASES)}}):
                g = PublishedLMImage.from_json(d)
                gal4_rows.setdefault((g.original_line, g.area), []).append(g)
        for ims in by_ref.values():
            for im in ims:
                im.gal4_expressions = list(
                    gal4_rows.get((im.original_line, im.area), ()))
        return by_ref


class DaosProvider:
    """Builds the store + DAO set from config (dao/DaosProvider.java)."""

    def __init__(self, config: Config | None = None, store=None):
        self.config = config or Config()
        self.store = store if store is not None else open_store(self.config)
        self.id_gen = TimebasedIdGenerator(
            self.config.get_int("TimebasedId.Context", 0))
        self.neuron_metadata_dao = NeuronMetadataDao(self.store, self.id_gen)
        self.cd_matches_dao = CDMatchesDao(self.store, self.id_gen,
                                           self.neuron_metadata_dao)
        self.ppp_matches_dao = PPPMatchesDao(self.store, self.id_gen)
        self.published_lm_images_dao = PublishedLMImageDao(self.store,
                                                           self.id_gen)
