"""Document store abstraction: embedded SQLite (default) or MongoDB.

The reference persists everything in MongoDB collections
(dao/mongo/AbstractMongoDao.java). Without a Mongo server the same
document/collection semantics come from an embedded SQLite JSON1
backend: documents are JSON rows queried with the small filter language
the DAOs need (equality, $in, $exists, $gte, tag membership). A Mongo
backend with identical semantics activates when `pymongo` is importable
and `Store.Type=mongo`.

The same store as the JAX package's persist/store.py, with its writes
(one commit each, as there) and reads timed: ``db.write.seconds``,
``db.read.seconds`` and ``db.commits`` in utils/metrics GLOBAL.
"""

from __future__ import annotations

import contextlib
import json
import os
import sqlite3
import threading
import time
from typing import Any, Iterable, Optional

from colormipsearch_tpu_torch.utils.metrics import GLOBAL


@contextlib.contextmanager
def _timed(kind: str):
    """Add the block's wall seconds to ``db.<kind>.seconds``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        GLOBAL.add(f"db.{kind}.seconds", time.perf_counter() - t0)


# Document fields that are always scalar (never arrays), safe to push
# down to SQL equality / IN on json_extract.  The hot ones are indexed
# per collection (_INDEXED_FIELDS) the way the reference indexes its
# match collections (AbstractNeuronMatchesMongoDao.java:56-62).
_SCALAR_FIELDS = {
    "maskImageRefId", "matchedImageRefId", "mipId", "libraryName",
    "alignmentSpace", "class", "publishedName", "sessionRefId",
    "sourceEmName", "sourceLmName", "sourceEmLibrary", "sourceLmLibrary",
}

_INDEXED_FIELDS = {
    "cdMatches": ("maskImageRefId", "matchedImageRefId"),
    "pppMatches": ("maskImageRefId", "matchedImageRefId", "sourceEmName"),
    "neuronMetadata": ("mipId", "libraryName", "publishedName"),
}


def _normalize_filter(filt: dict | None) -> dict | None:
    """Canonicalize `_id` conditions to STRINGS: documents always store a
    string _id (insert_many coerces), so int-typed filters from callers
    holding numeric entity ids must compare equal instead of silently
    matching nothing."""
    if not filt or "_id" not in filt:
        return filt
    out = dict(filt)
    cond = out["_id"]
    if isinstance(cond, dict):
        out["_id"] = {op: ([str(v) for v in arg]
                           if isinstance(arg, (list, tuple, set))
                           else str(arg))
                      for op, arg in cond.items()}
    else:
        out["_id"] = str(cond)
    return out


def _sql_pushdown(filt: dict | None):
    """Translate the top-level scalar equality / $in terms of a filter
    into SQL WHERE fragments (the full filter is still re-checked in
    Python, so the pushdown only needs to be an over-approximation)."""
    where: list[str] = []
    params: list = []
    for key, cond in (filt or {}).items():
        if key == "_id":
            if isinstance(cond, (str, int)):
                where.append("id = ?")
                params.append(str(cond))
            elif isinstance(cond, dict) and set(cond) == {"$in"}:
                vals = [str(v) for v in cond["$in"]]
                if not vals:
                    where.append("1 = 0")
                else:
                    where.append(f"id IN ({','.join('?' * len(vals))})")
                    params.extend(vals)
        elif key in _SCALAR_FIELDS:
            expr = f"json_extract(doc, '$.{key}')"
            if isinstance(cond, (str, int, float)) \
                    and not isinstance(cond, bool):
                where.append(f"{expr} = ?")
                params.append(cond)
            elif isinstance(cond, dict) and set(cond) == {"$in"} and all(
                    isinstance(v, (str, int, float))
                    and not isinstance(v, bool) for v in cond["$in"]):
                vals = list(cond["$in"])
                if not vals:
                    where.append("1 = 0")
                else:
                    where.append(f"{expr} IN ({','.join('?' * len(vals))})")
                    params.extend(vals)
    return where, params


class Collection:
    """Minimal document collection (insert/upsert/find/update)."""

    def __init__(self, store: "SqliteStore", name: str):
        self._store = store
        self.name = name

    # -- write --

    def insert_many(self, docs: Iterable[dict]) -> int:
        with self._store.lock, _timed("write"):
            cur = self._store.conn.cursor()
            n = 0
            for d in docs:
                did = str(d["_id"])
                if d.get("_id") != did:
                    d = {**d, "_id": did}
                cur.execute(
                    f"INSERT OR REPLACE INTO {self.name} (id, doc) "
                    "VALUES (?, ?)",
                    (did, json.dumps(d)))
                n += 1
            self._store.conn.commit()
            GLOBAL.add("db.commits")
            return n

    def replace_one(self, doc: dict) -> None:
        self.insert_many([doc])

    def update_fields(self, doc_id, fields: dict) -> bool:
        with self._store.lock, _timed("write"):
            cur = self._store.conn.execute(
                f"SELECT doc FROM {self.name} WHERE id = ?", (str(doc_id),))
            row = cur.fetchone()
            if row is None:
                return False
            d = json.loads(row[0])
            d.update(fields)
            self._store.conn.execute(
                f"UPDATE {self.name} SET doc = ? WHERE id = ?",
                (json.dumps(d), str(doc_id)))
            self._store.conn.commit()
            GLOBAL.add("db.commits")
            return True

    def delete_many(self, filt: dict | None = None) -> int:
        docs = self.find(filt or {})
        with self._store.lock, _timed("write"):
            n = 0
            for d in docs:
                self._store.conn.execute(
                    f"DELETE FROM {self.name} WHERE id = ?",
                    (str(d["_id"]),))
                n += 1
            self._store.conn.commit()
            GLOBAL.add("db.commits")
            return n

    # -- read --

    def find(self, filt: dict | None = None, *, limit: int = 0,
             offset: int = 0, sort=None) -> list[dict]:
        with _timed("read"):
            return self._find(filt, limit=limit, offset=offset, sort=sort)

    def _find(self, filt, *, limit, offset, sort) -> list[dict]:
        # scalar equality / $in terms run as indexed SQL; the full filter
        # is then re-applied in Python for the residual operators
        filt = _normalize_filter(filt)
        where, params = _sql_pushdown(filt)
        sql = f"SELECT doc FROM {self.name}"
        if where:
            sql += " WHERE " + " AND ".join(where)
        if not filt and not sort and limit and not offset:
            sql += f" LIMIT {int(limit)}"
        with self._store.lock:
            cur = self._store.conn.execute(sql, params)
            docs = [json.loads(r[0]) for r in cur.fetchall()]
        if filt:
            docs = [d for d in docs if _matches(d, filt)]
        if sort:
            for key, direction in reversed(sort):
                docs.sort(key=lambda d: _sort_key(d.get(key)),
                          reverse=direction < 0)
        if offset:
            docs = docs[offset:]
        if limit:
            docs = docs[:limit]
        return docs

    def find_one(self, filt: dict) -> Optional[dict]:
        r = self.find(filt, limit=1)
        return r[0] if r else None

    def count(self, filt: dict | None = None) -> int:
        if not filt:
            with self._store.lock, _timed("read"):
                cur = self._store.conn.execute(
                    f"SELECT COUNT(*) FROM {self.name}")
                return int(cur.fetchone()[0])
        return len(self.find(filt))

    def distinct(self, field: str, filt: dict | None = None) -> list:
        out = []
        seen = set()
        for d in self.find(filt):
            v = d.get(field)
            if v is not None and v not in seen:
                seen.add(v)
                out.append(v)
        return out


def _sort_key(v):
    # None sorts first; mixed types compare by (type-class, value)
    if v is None:
        return (0, 0)
    if isinstance(v, (int, float)):
        return (1, v)
    return (2, str(v))


def _matches(doc: dict, filt: dict) -> bool:
    for key, cond in filt.items():
        if key == "$or":
            if not any(_matches(doc, sub) for sub in cond):
                return False
            continue
        val = _get_path(doc, key)
        if isinstance(cond, dict) and cond and \
                all(k.startswith("$") for k in cond):
            for op, arg in cond.items():
                if op == "$in":
                    if isinstance(val, list):
                        if not any(v in arg for v in val):
                            return False
                    elif val not in arg:
                        return False
                elif op == "$nin":
                    if isinstance(val, list):
                        if any(v in arg for v in val):
                            return False
                    elif val in arg:
                        return False
                elif op == "$exists":
                    if bool(val is not None) != bool(arg):
                        return False
                elif op == "$gte":
                    if val is None or not val >= arg:
                        return False
                elif op == "$gt":
                    if val is None or not val > arg:
                        return False
                elif op == "$lte":
                    if val is None or not val <= arg:
                        return False
                elif op == "$ne":
                    if val == arg:
                        return False
                elif op == "$contains":  # array membership
                    if not isinstance(val, list) or arg not in val:
                        return False
                else:
                    raise ValueError(f"unsupported operator {op}")
        else:
            if isinstance(val, list):
                if cond not in val:
                    return False
            elif val != cond:
                return False
    return True


def _get_path(doc: dict, path: str):
    cur: Any = doc
    for part in path.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return cur


class SqliteStore:
    """Embedded store; one table per collection: (id PRIMARY KEY, doc)."""

    def __init__(self, path: str):
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.lock = threading.RLock()
        self._collections: dict[str, Collection] = {}

    def collection(self, name: str) -> Collection:
        if name not in self._collections:
            with self.lock:
                self.conn.execute(
                    f"CREATE TABLE IF NOT EXISTS {name} "
                    "(id TEXT PRIMARY KEY, doc TEXT NOT NULL)")
                for field in _INDEXED_FIELDS.get(name, ()):
                    self.conn.execute(
                        f"CREATE INDEX IF NOT EXISTS ix_{name}_{field} "
                        f"ON {name} (json_extract(doc, '$.{field}'))")
                self.conn.commit()
            self._collections[name] = Collection(self, name)
        return self._collections[name]

    def close(self) -> None:
        self.conn.close()


def open_store(config) -> SqliteStore:
    """Open the configured document store."""
    stype = config.get("Store.Type", "sqlite")
    if stype == "mongo":
        from colormipsearch_tpu_torch.persist.mongo_store import MongoStore

        try:
            import pymongo  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "Store.Type=mongo requires the pymongo package, which is "
                "not installed; use the default sqlite backend") from e
        return MongoStore(config)
    path = config.get("Store.Path") or "nbdb.sqlite"
    return SqliteStore(path)
