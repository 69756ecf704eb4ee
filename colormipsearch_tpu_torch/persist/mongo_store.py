"""MongoDB document-store backend.

Maps the Collection surface of persist/store.py onto pymongo, giving the
same storage semantics as the reference's Mongo DAO layer
(dao/mongo/AbstractMongoDao.java): one database, named collections,
string `_id` documents, plus the indexes the reference declares on its
match collections (AbstractNeuronMatchesMongoDao.java:56-62).

Config keys (persist/config.py layered properties, same names as the
reference's nbdb.properties):

    MongoDB.ConnectionURL   e.g. mongodb://host:27017
    MongoDB.Database        database name (default neuronbridge)
    MongoDB.AuthDatabase    optional authSource
    MongoDB.ReplicaSet      optional replica set name

Activated by `Store.Type=mongo`; requires the `pymongo` package and a
reachable server (the reference gates its Mongo tests behind the itest
profile for the same reason).
"""

from __future__ import annotations

from typing import Iterable, Optional

from colormipsearch_tpu_torch.persist.store import _INDEXED_FIELDS


def _translate_filter(filt: dict | None) -> dict:
    """Translate the store filter language to a pymongo filter.

    The dialect is already Mongo-shaped; only two operators differ:
      $contains  -> direct equality (Mongo matches array membership)
      $exists    -> our semantics are on VALUES ("is not None"), so
                    True -> {$ne: None}, False -> None equality
                    (Mongo treats missing fields as null).
    """
    if not filt:
        return {}
    out: dict = {}
    for key, cond in filt.items():
        if key == "$or":
            out["$or"] = [_translate_filter(sub) for sub in cond]
            continue
        if isinstance(cond, dict) and cond and \
                all(k.startswith("$") for k in cond):
            sub: dict = {}
            for op, arg in cond.items():
                if op == "$contains":
                    # plain equality matches array members; Mongo cannot
                    # express it combined with other ops on the same key,
                    # and no store caller does
                    sub["$eq"] = arg
                elif op == "$exists":
                    # our semantics are on VALUES ("is not None")
                    sub["$ne" if arg else "$eq"] = None
                else:
                    sub[op] = arg
            if key == "_id":
                sub = {op: ([str(v) for v in a]
                            if isinstance(a, (list, tuple, set)) else
                            (str(a) if a is not None else a))
                       for op, a in sub.items()}
            out[key] = sub
        else:
            out[key] = str(cond) if key == "_id" and cond is not None \
                else cond
    return out


class MongoCollection:
    """pymongo-backed Collection with the SqliteStore semantics."""

    def __init__(self, col):
        self._col = col
        self.name = col.name

    # -- write --

    def insert_many(self, docs: Iterable[dict]) -> int:
        from pymongo import ReplaceOne

        ops = [ReplaceOne({"_id": str(d["_id"])},
                          {**d, "_id": str(d["_id"])}, upsert=True)
               for d in docs]
        if not ops:
            return 0
        res = self._col.bulk_write(ops, ordered=False)
        return res.upserted_count + res.matched_count

    def replace_one(self, doc: dict) -> None:
        self._col.replace_one({"_id": str(doc["_id"])},
                              {**doc, "_id": str(doc["_id"])}, upsert=True)

    def update_fields(self, doc_id, fields: dict) -> bool:
        res = self._col.update_one({"_id": str(doc_id)}, {"$set": fields})
        return res.matched_count > 0

    def delete_many(self, filt: dict | None = None) -> int:
        return self._col.delete_many(_translate_filter(filt)).deleted_count

    # -- read --

    def find(self, filt: dict | None = None, *, limit: int = 0,
             offset: int = 0, sort=None) -> list[dict]:
        cur = self._col.find(_translate_filter(filt))
        if sort:
            cur = cur.sort([(k, 1 if d >= 0 else -1) for k, d in sort])
        if offset:
            cur = cur.skip(offset)
        if limit:
            cur = cur.limit(limit)
        return list(cur)

    def find_one(self, filt: dict) -> Optional[dict]:
        return self._col.find_one(_translate_filter(filt))

    def count(self, filt: dict | None = None) -> int:
        return self._col.count_documents(_translate_filter(filt))

    def distinct(self, field: str, filt: dict | None = None) -> list:
        return [v for v in self._col.distinct(field, _translate_filter(filt))
                if v is not None]


class MongoStore:
    """Store facade over one MongoDB database."""

    def __init__(self, config, client=None):
        if client is None:
            import pymongo

            url = config.get("MongoDB.ConnectionURL",
                             "mongodb://localhost:27017")
            kwargs = {}
            auth_db = config.get("MongoDB.AuthDatabase")
            if auth_db:
                kwargs["authSource"] = auth_db
            replica_set = config.get("MongoDB.ReplicaSet")
            if replica_set:
                kwargs["replicaSet"] = replica_set
            client = pymongo.MongoClient(url, **kwargs)
        self._client = client
        self._db = client[config.get("MongoDB.Database", "neuronbridge")]
        self._collections: dict[str, MongoCollection] = {}

    def collection(self, name: str) -> MongoCollection:
        if name not in self._collections:
            col = self._db[name]
            for field in _INDEXED_FIELDS.get(name, ()):
                col.create_index(field)
            self._collections[name] = MongoCollection(col)
        return self._collections[name]

    def close(self) -> None:
        self._client.close()
