"""Layered properties configuration.

Same resolution order as the reference (config/ConfigProvider.java:33-67):
built-in defaults -> environment overrides -> explicit --config properties
file.  Keys use the reference's dotted names (`MongoDB.ConnectionURL`,
`MongoDB.Database`, `TimebasedId.Context`, plus `Store.Type` and
`Store.Path` for the embedded backend).
"""

from __future__ import annotations

import os


_DEFAULTS = {
    "Store.Type": "sqlite",       # sqlite | mongo
    "Store.Path": "",             # sqlite file path ('' -> ./nbdb.sqlite)
    "MongoDB.ConnectionURL": "mongodb://localhost:27017",
    "MongoDB.Database": "neuronbridge",
    "MongoDB.ReplicaSet": "",
    "MongoDB.AuthDatabase": "",
    "MongoDB.Username": "",
    "MongoDB.Password": "",
    "TimebasedId.Context": "0",
}


def _parse_properties(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("#", "!")):
                continue
            # Java Properties splits at the FIRST '=' or ':' —
            # whichever comes first — so values containing the other
            # separator (e.g. mongodb://host/db?replicaSet=rs) survive
            ie = line.find("=")
            ic = line.find(":")
            if ie < 0 and ic < 0:
                continue
            sep = min(i for i in (ie, ic) if i >= 0)
            k, v = line[:sep], line[sep + 1:]
            out[k.strip()] = v.strip()
    return out


class Config:
    def __init__(self, config_file: str | None = None,
                 overrides: dict | None = None):
        self._values = dict(_DEFAULTS)
        # environment: dots map to underscores, e.g. MongoDB_Database
        for k in _DEFAULTS:
            env = os.environ.get(k.replace(".", "_"))
            if env is not None:
                self._values[k] = env
        if config_file:
            self._values.update(_parse_properties(config_file))
        if overrides:
            self._values.update(overrides)

    def get(self, key: str, default: str = "") -> str:
        return self._values.get(key, default)

    def get_int(self, key: str, default: int = 0) -> int:
        try:
            return int(self.get(key, str(default)))
        except ValueError:
            return default

    def as_dict(self) -> dict:
        return dict(self._values)
