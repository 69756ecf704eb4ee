"""The port's DB storage backend (persist/, dataio/db_io.py) against the
JAX package's.

Every store and DAO operation of the JAX tests/test_persist.py, and the
rest of the DAO surface the CLI reaches, is one case of a table. Each
case runs on both packages, each on a store of its own (sqlite, and the
Mongo shim over a fake pymongo written here); the two results must be
equal, and so must the two stores in canonical form
(testing.canonical_store: no entity ids, references by mipId).
"""

import sys
import types
from pathlib import Path

import pytest

import colormipsearch_tpu.dataio.db_io as j_db_io
import colormipsearch_tpu.model as j_model
import colormipsearch_tpu.model.entities as j_entities
import colormipsearch_tpu.persist as j_persist
import colormipsearch_tpu.persist.mongo_store as j_mongo
import colormipsearch_tpu.persist.requests as j_requests
import colormipsearch_tpu.persist.store as j_store
import colormipsearch_tpu_torch.dataio.db_io as t_db_io
import colormipsearch_tpu_torch.model as t_model
import colormipsearch_tpu_torch.model.entities as t_entities
import colormipsearch_tpu_torch.persist as t_persist
import colormipsearch_tpu_torch.persist.mongo_store as t_mongo
import colormipsearch_tpu_torch.persist.requests as t_requests
import colormipsearch_tpu_torch.persist.store as t_store
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.utils.metrics import GLOBAL

PKGS = {
    "jax": types.SimpleNamespace(
        model=j_model, entities=j_entities, persist=j_persist,
        req=j_requests, store=j_store, mongo=j_mongo, db_io=j_db_io),
    "port": types.SimpleNamespace(
        model=t_model, entities=t_entities, persist=t_persist,
        req=t_requests, store=t_store, mongo=t_mongo, db_io=t_db_io),
}


# ---------------------------------------------------------------------------
# a fake pymongo: the surface persist/mongo_store.py calls, with Mongo's
# matching rules (a bare value or $eq matches an array member, null
# matches a missing field)
# ---------------------------------------------------------------------------


def _get(doc, path):
    for part in path.split("."):
        if not isinstance(doc, dict):
            return None
        doc = doc.get(part)
    return doc


def _member(val, arg):
    return val == arg or (isinstance(val, list) and arg in val)


def _any_in(val, args):
    return any(_member(val, a) for a in args)


_OPS = {
    "$eq": _member,
    "$ne": lambda v, a: not _member(v, a),
    "$in": _any_in,
    "$nin": lambda v, a: not _any_in(v, a),
    "$gte": lambda v, a: v is not None and v >= a,
    "$gt": lambda v, a: v is not None and v > a,
    "$lte": lambda v, a: v is not None and v <= a,
}


def _mongo_match(doc, filt) -> bool:
    for key, cond in (filt or {}).items():
        if key == "$or":
            if not any(_mongo_match(doc, sub) for sub in cond):
                return False
            continue
        val = _get(doc, key)
        if isinstance(cond, dict) and cond and \
                all(k.startswith("$") for k in cond):
            if not all(_OPS[op](val, arg) for op, arg in cond.items()):
                return False
        elif not _member(val, cond):
            return False
    return True


class _Cursor(list):
    def sort(self, spec):
        out = list(self)
        for key, direction in reversed(spec):
            out.sort(key=lambda d: (d.get(key) is not None, d.get(key)),
                     reverse=direction < 0)
        return _Cursor(out)

    def skip(self, n):
        return _Cursor(self[n:])

    def limit(self, n):
        return _Cursor(self[:n])


class _Collection:
    def __init__(self, name):
        self.name = name
        self.docs = {}
        self.indexes = []

    def create_index(self, field):
        self.indexes.append(field)

    def bulk_write(self, ops, ordered=True):
        matched = sum(op.filter["_id"] in self.docs for op in ops)
        for op in ops:
            self.docs[op.filter["_id"]] = dict(op.replacement)
        return types.SimpleNamespace(upserted_count=len(ops) - matched,
                                     matched_count=matched)

    def replace_one(self, filt, doc, upsert=False):
        self.docs[filt["_id"]] = dict(doc)

    def update_one(self, filt, update):
        doc = self.docs.get(filt["_id"])
        if doc is not None:
            doc.update(update["$set"])
        return types.SimpleNamespace(matched_count=int(doc is not None))

    def delete_many(self, filt):
        gone = [k for k, d in self.docs.items() if _mongo_match(d, filt)]
        for k in gone:
            del self.docs[k]
        return types.SimpleNamespace(deleted_count=len(gone))

    def find(self, filt=None):
        return _Cursor(dict(d) for d in self.docs.values()
                       if _mongo_match(d, filt))

    def find_one(self, filt=None):
        found = self.find(filt)
        return found[0] if found else None

    def count_documents(self, filt):
        return len(self.find(filt))

    def distinct(self, field, filt=None):
        out = []
        for d in self.find(filt):
            if d.get(field) not in out:
                out.append(d.get(field))
        return out


class _Database(dict):
    def __missing__(self, name):
        self[name] = _Collection(name)
        return self[name]


class _Client:
    def __init__(self, url="mongodb://fake", **kwargs):
        self.url, self.kwargs = url, kwargs
        self.databases = {}
        self.closed = False

    def __getitem__(self, name):
        return self.databases.setdefault(name, _Database())

    def close(self):
        self.closed = True


@pytest.fixture()
def fake_pymongo(monkeypatch):
    mod = types.ModuleType("pymongo")
    mod.MongoClient = _Client
    mod.ReplaceOne = lambda filt, replacement, upsert=False: \
        types.SimpleNamespace(filter=filt, replacement=replacement)
    monkeypatch.setitem(sys.modules, "pymongo", mod)
    return mod


# ---------------------------------------------------------------------------
# the operations, each run on both packages
# ---------------------------------------------------------------------------


def _em(pkg, mip, name, lib="FlyEM_Hemibrain", **kw):
    n = pkg.model.EMNeuron(mip_id=mip, published_name=name,
                           library_name=lib, alignment_space="AS", **kw)
    n.set_compute_file(pkg.model.ComputeFileType.InputColorDepthImage,
                       f"/imgs/{mip}.tif")
    return n


def _lm(pkg, mip, name, lib="MCFO", **kw):
    n = pkg.model.LMNeuron(mip_id=mip, published_name=name,
                           library_name=lib, alignment_space="AS", **kw)
    n.set_compute_file(pkg.model.ComputeFileType.InputColorDepthImage,
                       f"/imgs/{mip}.png")
    return n


def _neuron_set(pkg, daos):
    """Six neurons that differ in every field a NeuronSelector reads."""
    dao = daos.neuron_metadata_dao
    pt = pkg.model.ProcessingType
    ns = [
        _em(pkg, "e1", "100", tags={"a"}, dataset_labels={"d1"},
            neuron_terms=["t1"], source_ref_id="s1"),
        _em(pkg, "e2", "200", tags={"a", "b"}, neuron_terms=["t2"]),
        _em(pkg, "e3", "300", lib="OtherEM", tags={"c"},
            dataset_labels={"d2"}),
        _lm(pkg, "l1", "lineA", tags={"b"}, slide_code="sc1",
            source_ref_id="s2"),
        _lm(pkg, "l2", "lineA", neuron_terms=["t1", "t3"]),
        _lm(pkg, "l3", "lineB", lib="Gen1"),
    ]
    ns[5].alignment_space = "OtherAS"
    for n in ns:
        dao.save(n)
    dao.add_processing_tags(ns[:2], pt.ColorDepthSearch, ["cds1"])
    dao.add_processing_tags(ns[3:5], pt.GradientScore, ["gs1"])
    return ns


def _mips(neurons):
    return [n.mip_id for n in neurons]


SELECTORS = {
    "alignment_space": dict(alignment_space="OtherAS"),
    "libraries": dict(libraries=["FlyEM_Hemibrain", "Gen1"]),
    "names": dict(names=["lineA", "300"]),
    "mip_ids": dict(mip_ids=["e2", "l3"]),
    "source_refs": dict(source_refs=["s1", "s2"]),
    "tags": dict(tags=["b"]),
    "excluded_tags": dict(excluded_tags=["a"]),
    "tags_and_excluded_tags": dict(tags=["a", "c"], excluded_tags=["b"]),
    "datasets": dict(datasets=["d2"]),
    "annotations": dict(annotations=["t1"]),
    "excluded_annotations": dict(excluded_annotations=["t1"]),
    "annotations_and_excluded": dict(annotations=["t1", "t2"],
                                     excluded_annotations=["t3"]),
    "processed_tags": dict(processed_tags=[("ColorDepthSearch", "cds1"),
                                           ("GradientScore", "gs1")]),
    "processed_tags_other_type": dict(
        processed_tags=[("GradientScore", "cds1")]),
}


def op_selector(field):
    def op(pkg, daos):
        _neuron_set(pkg, daos)
        dao = daos.neuron_metadata_dao
        sel = pkg.req.NeuronSelector(**SELECTORS[field])
        return {"filter": sel.to_filter(), "is_empty": sel.is_empty(),
                "found": sorted(_mips(dao.find_neurons(sel))),
                "distinct": sorted(dao.distinct_mip_ids(sel))}
    return op


def op_paging(pkg, daos):
    _neuron_set(pkg, daos)
    req = pkg.req
    dao = daos.neuron_metadata_dao
    out = {}
    for name, page in {
            "offset": req.PagedRequest(offset=2),
            "size": req.PagedRequest(size=3),
            "window": req.PagedRequest(offset=1, size=2),
            "sorted": req.PagedRequest(
                sort=[req.SortCriteria("publishedName", ascending=False),
                      req.SortCriteria("mipId")]),
            "sorted_window": req.PagedRequest(
                offset=1, size=3,
                sort=[req.SortCriteria("mipId", ascending=False)])}.items():
        found = _mips(dao.find_neurons(req.NeuronSelector(), page))
        out[name] = found if page.sort else len(found)
    return out


def op_create_or_update(pkg, daos):
    dao = daos.neuron_metadata_dao
    first = dao.create_or_update(_em(pkg, "m1", "100"))
    again = dao.create_or_update(_em(pkg, "m1", "100-renamed"))
    other = dao.create_or_update(_em(pkg, "m2", "200"))
    return {"same_id": again.entity_id == first.entity_id,
            "renamed": dao.find_by_id(first.entity_id).published_name,
            "new_id": other.entity_id != first.entity_id,
            "count": daos.store.collection("neuronMetadata").count()}


def op_create_or_update_keeps_bookkeeping(pkg, daos):
    """processedTags, tags, validationErrors and datasetLabels of the
    stored neuron survive a re-import that lacks them."""
    dao = daos.neuron_metadata_dao
    pt = pkg.model.ProcessingType
    n = _em(pkg, "m1", "100", tags={"stored"}, dataset_labels={"ds"},
            validation_errors={"e1"})
    dao.create_or_update(n)
    dao.add_processing_tags([n], pt.ColorDepthSearch, ["run-1"])
    again = dao.create_or_update(_em(pkg, "m1", "100", tags={"new"}))
    stored = dao.find_by_id(n.entity_id)
    return {"same_id": again.entity_id == n.entity_id,
            "tags": sorted(stored.tags),
            "datasets": sorted(stored.dataset_labels),
            "errors": sorted(stored.validation_errors),
            "processed": stored.has_processed_tag(pt.ColorDepthSearch,
                                                  "run-1")}


def op_zip_entry_idempotent(pkg, daos):
    dao = daos.neuron_metadata_dao
    pt = pkg.model.ProcessingType

    def mk():
        n = pkg.model.LMNeuron(mip_id="zm1", library_name="lib")
        n.set_compute_file(
            pkg.model.ComputeFileType.InputColorDepthImage,
            pkg.entities.FileData("/archives/seg.zip", "inner/zm1.tif"))
        return n

    first = dao.create_or_update(mk())
    dao.add_processing_tags([first], pt.ColorDepthSearch, ["run-1"])
    second = dao.create_or_update(mk())
    return {"same_id": second.entity_id == first.entity_id,
            "count": daos.store.collection("neuronMetadata").count({}),
            "processed": dao.find_by_id(first.entity_id).has_processed_tag(
                pt.ColorDepthSearch, "run-1")}


def _pair(pkg, daos):
    ndao = daos.neuron_metadata_dao
    em = ndao.save(_em(pkg, "em1", "111"))
    lm = ndao.save(_lm(pkg, "lm1", "lineX", slide_code="sc1"))
    return em, lm


def _match(pkg, em, lm, **kw):
    return pkg.model.CDMatch(mask_image=em, matched_image=lm,
                             mask_image_ref_id=em.entity_id,
                             matched_image_ref_id=lm.entity_id, **kw)


def op_match_upsert_and_join(pkg, daos):
    mdao = daos.cd_matches_dao
    req = pkg.req
    em, lm = _pair(pkg, daos)
    m = _match(pkg, em, lm, matching_pixels=87, matching_pixels_ratio=0.05,
               normalized_score=0.05)
    written = mdao.create_or_update_all([m])
    m2 = _match(pkg, em, lm, matching_pixels=90, matching_pixels_ratio=0.06,
                normalized_score=0.06, tags={"r2"})
    mdao.create_or_update_all([m2])
    joined = mdao.find_matches_by_mask(
        req.NeuronSelector(libraries=["FlyEM_Hemibrain"]))
    return {"written": written, "same_id": m2.entity_id == m.entity_id,
            "rows": [(x.mask_image.published_name,
                      x.matched_image.slide_code, x.matching_pixels,
                      sorted(x.tags), x.entity_id == m.entity_id)
                     for x in joined],
            "filtered_out": mdao.find_matches_by_mask(
                req.NeuronSelector(),
                scores_filter=req.ScoresFilter().add("matchingPixels",
                                                     95)),
            "mask_mip_ids": mdao.mask_mip_ids(req.NeuronSelector())}


def op_match_update_fields(pkg, daos):
    """create_or_update_all with update_fields updates only those fields
    of an existing match."""
    mdao = daos.cd_matches_dao
    em, lm = _pair(pkg, daos)
    mdao.create_or_update_all([_match(pkg, em, lm, matching_pixels=10,
                                      matching_pixels_ratio=0.5)])
    n = mdao.create_or_update_all(
        [_match(pkg, em, lm, matching_pixels=20, matching_pixels_ratio=0.9)],
        update_fields=["matchingPixels"])
    got = mdao.find_matches_by_mask(pkg.req.NeuronSelector())[0]
    return {"n": n, "pixels": got.matching_pixels,
            "ratio": got.matching_pixels_ratio}


def _match_set(pkg, daos):
    """Two masks x three targets; scores and tags vary."""
    ndao, mdao = daos.neuron_metadata_dao, daos.cd_matches_dao
    masks = [ndao.save(_em(pkg, f"em{i}", f"{i}00", tags={f"mt{i}"}))
             for i in range(2)]
    targets = [ndao.save(_lm(pkg, f"lm{j}", f"line{j % 2}",
                             lib=("MCFO", "Gen1", "MCFO")[j]))
               for j in range(3)]
    ms = [_match(pkg, em, lm, matching_pixels=10 * (i + 1) + j,
                 matching_pixels_ratio=0.01 * (j + 1),
                 normalized_score=float(7 - 3 * i - j),
                 gradient_area_gap=None if j == 2 else 100 * j,
                 high_expression_area=5 * j, tags={f"run{j % 2}"})
          for i, em in enumerate(masks) for j, lm in enumerate(targets)]
    mdao.create_or_update_all(ms)
    return masks, targets, ms


def _rows(matches):
    return [(m.mask_image.mip_id, m.matched_image.mip_id, m.matching_pixels)
            for m in matches]


def op_find_matches_scope(pkg, daos):
    """find_matches_by_mask: mask and target selectors, a scores filter,
    match tags, sort and page."""
    req = pkg.req
    mdao = daos.cd_matches_dao
    _match_set(pkg, daos)
    by_score = req.PagedRequest(sort=[req.SortCriteria("normalizedScore",
                                                       ascending=False)])
    return {
        "all": sorted(_rows(mdao.find_matches_by_mask(req.NeuronSelector()))),
        "mask_tag": sorted(_rows(mdao.find_matches_by_mask(
            req.NeuronSelector(tags=["mt1"])))),
        "target_lib": sorted(_rows(mdao.find_matches_by_mask(
            req.NeuronSelector(),
            target_selector=req.NeuronSelector(libraries=["Gen1"])))),
        "target_name": sorted(_rows(mdao.find_matches_by_mask(
            req.NeuronSelector(mip_ids=["em0"]),
            target_selector=req.NeuronSelector(names=["line0"])))),
        "min_ratio_and_gap": sorted(_rows(mdao.find_matches_by_mask(
            req.NeuronSelector(),
            scores_filter=req.ScoresFilter()
            .add("matchingPixelsRatio", 0.015)
            .add("gradientAreaGap", 0)))),
        "match_tags": sorted(_rows(mdao.find_matches_by_mask(
            req.NeuronSelector(), match_tags=["run1"]))),
        "sorted": _rows(mdao.find_matches_by_mask(req.NeuronSelector(),
                                                  page=by_score)),
        "page": _rows(mdao.find_matches_by_mask(
            req.NeuronSelector(),
            page=req.PagedRequest(offset=1, size=3,
                                  sort=by_score.sort))),
        "mask_mip_ids": sorted(mdao.mask_mip_ids(
            req.NeuronSelector(libraries=["FlyEM_Hemibrain"]))),
    }


def op_update_scores(pkg, daos):
    """update_scores stores normalizedScore through _round_f32, as the FS
    writer does."""
    mdao = daos.cd_matches_dao
    em, lm = _pair(pkg, daos)
    m = _match(pkg, em, lm, matching_pixels=90)
    mdao.create_or_update_all([m])
    m.gradient_area_gap, m.high_expression_area = 1234, 10
    m.normalized_score = 1 / 3
    unsaved = _match(pkg, em, lm, normalized_score=2.0)
    n = mdao.update_scores([m, unsaved])
    got = mdao.find_matches_by_mask(pkg.req.NeuronSelector())[0]
    return {"n": n, "gap": got.gradient_area_gap,
            "he": got.high_expression_area,
            "score": got.normalized_score,
            "is_f32": got.normalized_score == pkg.entities._round_f32(1 / 3)}


def op_id_canonicalization(pkg, daos):
    col = daos.store.collection("publishedURL")
    col.insert_many([{"_id": 123, "uploaded": {"cdm": "u"}},
                     {"_id": "456", "uploaded": {"cdm": "v"}}])
    return {"int_in": len(col.find({"_id": {"$in": [123, 456]}})),
            "str_in": len(col.find({"_id": {"$in": ["123", "456"]}})),
            "int_one": col.find_one({"_id": 123})["uploaded"]["cdm"],
            "str_one": col.find_one({"_id": "456"})["uploaded"]["cdm"]}


def op_collection_surface(pkg, daos):
    """count, distinct, update_fields and delete_many on a collection."""
    col = daos.store.collection("neuronMetadata")
    _neuron_set(pkg, daos)
    first = col.find({"mipId": "e1"})[0]
    updated = col.update_fields(first["_id"], {"publishedName": "renamed"})
    missing = col.update_fields("1", {"publishedName": "x"})
    out = {"count": col.count(), "count_lm": col.count(
        {"libraryName": "MCFO"}),
        "distinct": sorted(col.distinct("libraryName")),
        "updated": (updated, missing),
        "renamed": col.find_one({"mipId": "e1"})["publishedName"],
        "exists": sorted(d["mipId"] for d in col.find(
            {"mipId": {"$in": ["e1", "e2", "l1"]},
             "neuronTerms": {"$exists": True}}))}
    out["deleted"] = col.delete_many({"libraryName": "MCFO"})
    out["left"] = col.count()
    return out


def op_db_io(pkg, daos):
    """The readers and writers of dataio/db_io.py."""
    req, db_io = pkg.req, pkg.db_io
    masks, targets, ms = _match_set(pkg, daos)
    n = db_io.DBCDMIPsWriter(daos).write(
        [_em(pkg, "em9", "900"), _em(pkg, "em0", "000")])
    mips = db_io.DBCDMIPsReader(daos)
    reader = db_io.DBNeuronMatchesReader(daos)
    sources = [req.DataSourceParam(
        selector=req.NeuronSelector(libraries=["FlyEM_Hemibrain"]),
        offset=1, size=1), "MCFO"]
    for m in ms:
        m.normalized_score = float(m.matching_pixels)
    db_io.DBNeuronMatchesWriter(daos).write_updates(ms)
    return {
        "written": n,
        "read": _mips(mips.read_mips(["FlyEM_Hemibrain"], offset=1,
                                     size=2)),
        "read_named": _mips(mips.read_mips(["FlyEM_Hemibrain"],
                                           names=["100"])),
        "window": req.DataSourceParam(offset=1, size=2).window(
            list("abcd")),
        "locations": reader.list_matches_locations(sources),
        "by_mask": _rows(reader.read_matches_by_mask("em1")),
        "by_mask_scoped": _rows(reader.read_matches_by_mask(
            "em0", min_ratio=0.015, min_grad_score=0,
            target_selector=req.NeuronSelector(libraries=["MCFO"]))),
        "by_mask_tags": _rows(reader.read_matches_by_mask(
            "em0", match_tags=["run0"], alignment_space="AS")),
    }


OPS = {
    **{f"selector_{f}": op_selector(f) for f in SELECTORS},
    "paging": op_paging,
    "create_or_update": op_create_or_update,
    "create_or_update_keeps_bookkeeping":
        op_create_or_update_keeps_bookkeeping,
    "zip_entry_idempotent": op_zip_entry_idempotent,
    "match_upsert_and_join": op_match_upsert_and_join,
    "match_update_fields": op_match_update_fields,
    "find_matches_scope": op_find_matches_scope,
    "update_scores": op_update_scores,
    "id_canonicalization": op_id_canonicalization,
    "collection_surface": op_collection_surface,
    "db_io": op_db_io,
}


def _sqlite_daos(pkg, path: Path):
    """DAOs on a sqlite file, and a function giving the store's
    documents (as testing.canonical_store reads them)."""
    cfg = pkg.persist.Config(overrides={"Store.Path": str(path)})
    return pkg.persist.DaosProvider(cfg), lambda: path


def _mongo_daos(pkg, _path: Path):
    cfg = pkg.persist.Config()
    client = _Client()
    store = pkg.mongo.MongoStore(cfg, client=client)
    db = client["neuronbridge"]
    return pkg.persist.DaosProvider(cfg, store=store), \
        lambda: {name: col.docs.values() for name, col in db.items()}


def _results(val):
    """Entities as comparable values (their classes differ by package)."""
    if isinstance(val, dict):
        return {k: _results(v) for k, v in val.items()}
    if isinstance(val, (list, tuple)):
        return [_results(v) for v in val]
    if hasattr(val, "to_json"):
        return val.to_json()
    return val


@pytest.mark.parametrize("backend", ["sqlite", "mongo"])
@pytest.mark.parametrize("name", sorted(OPS))
def test_store_operation_equals_jax(name, backend, tmp_path, fake_pymongo):
    results, stores = {}, {}
    for key, pkg in PKGS.items():
        make = _sqlite_daos if backend == "sqlite" else _mongo_daos
        daos, source = make(pkg, tmp_path / f"{key}.sqlite")
        results[key] = _results(OPS[name](pkg, daos))
        stores[key] = testing.canonical_store(source())
        daos.store.close()
    assert results["port"] == results["jax"]
    assert stores["port"] == stores["jax"]
    assert any(stores["port"].values()) or name == "id_canonicalization"


def test_store_persists_across_open_and_counts_its_time(tmp_path):
    GLOBAL.reset()
    cfg = t_persist.Config(overrides={"Store.Path":
                                      str(tmp_path / "p.sqlite")})
    first = t_persist.DaosProvider(cfg)
    first.neuron_metadata_dao.save(_em(PKGS["port"], "m1", "100"))
    first.store.close()
    again = t_persist.DaosProvider(cfg)
    assert again.neuron_metadata_dao.distinct_mip_ids(
        t_requests.NeuronSelector()) == ["m1"]
    again.store.close()
    assert GLOBAL.get("db.commits") == 1
    assert GLOBAL.get("db.write.seconds") > 0
    assert GLOBAL.get("db.read.seconds") > 0


@pytest.mark.parametrize("case", ["defaults", "environment", "file",
                                  "first_separator", "overrides"])
def test_config_layers_equal_jax(case, tmp_path, monkeypatch):
    """Defaults, then the environment (dots become underscores), then
    the --config properties file, then overrides; a line splits at its
    first '=' or ':'."""
    path = None
    if case == "environment":
        monkeypatch.setenv("MongoDB_Database", "from_env")
        monkeypatch.setenv("TimebasedId_Context", "3")
    if case in ("file", "first_separator", "overrides"):
        path = tmp_path / "my.properties"
        path.write_text(
            "MongoDB.Database=custom\n# comment\n! also a comment\n"
            "Store.Type = sqlite\nno separator\n"
            "MongoDB.ConnectionURL:mongodb://h/db?replicaSet=rs0\n"
            "Store.Path=/a/b:c\n")
        monkeypatch.setenv("MongoDB_Database", "from_env")
    overrides = {"Store.Path": "x.sqlite"} if case == "overrides" else None
    got = {}
    for key, pkg in PKGS.items():
        cfg = pkg.persist.Config(str(path) if path else None,
                                 overrides=overrides)
        got[key] = (cfg.as_dict(), cfg.get_int("TimebasedId.Context"),
                    cfg.get_int("MongoDB.Database", 7), cfg.get("nope", "d"))
    assert got["port"] == got["jax"]
    values = got["port"][0]
    if case == "environment":
        assert values["MongoDB.Database"] == "from_env"
        assert got["port"][1] == 3
    if case == "first_separator":
        assert values["MongoDB.ConnectionURL"] == \
            "mongodb://h/db?replicaSet=rs0"
        assert values["Store.Path"] == "/a/b:c"
        assert values["MongoDB.Database"] == "custom"


@pytest.mark.parametrize("pymongo", ["absent", "present"])
def test_mongo_store_type_dispatch(pymongo, monkeypatch):
    """Store.Type=mongo without pymongo raises the JAX package's
    RuntimeError; with it, open_store returns the shim, which passes the
    config's URL, auth database and replica set to the client and
    indexes the match collections."""
    if pymongo == "absent":
        monkeypatch.setitem(sys.modules, "pymongo", None)
    else:
        mod = types.ModuleType("pymongo")
        mod.MongoClient = _Client
        monkeypatch.setitem(sys.modules, "pymongo", mod)
    out = {}
    for key, pkg in PKGS.items():
        cfg = pkg.persist.Config(overrides={
            "Store.Type": "mongo", "MongoDB.ConnectionURL": "mongodb://h:1",
            "MongoDB.AuthDatabase": "admin", "MongoDB.ReplicaSet": "rs0",
            "MongoDB.Database": "nb"})
        if pymongo == "absent":
            with pytest.raises(RuntimeError, match="requires the pymongo"):
                pkg.persist.open_store(cfg)
            continue
        store = pkg.persist.open_store(cfg)
        assert isinstance(store, pkg.mongo.MongoStore)
        store.collection("cdMatches")
        client = store._client
        out[key] = (client.url, client.kwargs,
                    client["nb"]["cdMatches"].indexes)
        store.close()
        assert client.closed
    assert out.get("port") == out.get("jax")


def test_mongo_filter_translation_equals_jax():
    filters = [
        None, {}, {"_id": 5}, {"_id": {"$in": [1, "2"]}},
        {"_id": {"$ne": None}},
        {"tags": {"$contains": "x"}},
        {"mipId": {"$exists": True}, "x": {"$exists": False}},
        {"$or": [{"processedTags.GradientScore": {"$contains": "t"}},
                 {"libraryName": {"$in": ["a"]}}]},
        {"tags": {"$in": ["a"], "$nin": ["b"]}, "normalizedScore":
         {"$gte": 1.5}, "computeFiles.InputColorDepthImage":
         {"zipFile": "z", "entry": "e"}},
    ]
    for f in filters:
        assert t_mongo._translate_filter(f) == j_mongo._translate_filter(f)
    assert t_store._INDEXED_FIELDS == j_store._INDEXED_FIELDS
    assert t_store._SCALAR_FIELDS == j_store._SCALAR_FIELDS


def test_sql_pushdown_and_filters_equal_jax():
    """The SQL pushdown (an over-approximation the Python filter checks
    again), the _id normalization and the sort key, on the same
    filters."""
    filters = [
        None, {"_id": 3}, {"_id": {"$in": []}}, {"_id": {"$in": [1, "2"]}},
        {"mipId": "m", "libraryName": {"$in": ["a", "b"]}},
        {"mipId": {"$in": []}}, {"mipId": True},
        {"maskImageRefId": {"$in": ["1", 2.5]}, "tags": {"$in": ["t"]}},
        {"publishedName": {"$in": ["x", None]}},
    ]
    for f in filters:
        assert t_store._sql_pushdown(t_store._normalize_filter(f)) == \
            j_store._sql_pushdown(j_store._normalize_filter(f))
    values = [None, 3, 2.5, "b", "a", 0]
    assert sorted(values, key=t_store._sort_key) == \
        sorted(values, key=j_store._sort_key)


def test_two_writers_ids_collide_unless_their_contexts_differ(monkeypatch):
    """The time-based id (millis << 22 | block index << 12 | context << 8
    | ip octet) of both packages: two writers on one host that draw in
    the same millisecond with the same TimebasedId.Context get the same
    ids, so one's upsert (INSERT OR REPLACE by _id) replaces the other's
    document; a context each keeps them apart."""
    import colormipsearch_tpu.model.ids as j_ids
    import colormipsearch_tpu_torch.model.ids as t_ids

    for mod in (j_ids, t_ids):
        monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_000.123)
    draws = {}
    for name, mod in (("jax", j_ids), ("port", t_ids)):
        writers = [mod.TimebasedIdGenerator(ctx, ip_component=7)
                   for ctx in (0, 0, 1)]
        draws[name] = [w.generate_id_list(3) for w in writers]
    assert draws["port"] == draws["jax"]
    same, other = draws["port"][:2], draws["port"][2]
    assert same[0] == same[1] and not set(same[0]) & set(other)
