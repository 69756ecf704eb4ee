"""The DB storage backend (the JAX package's persist/): layered
properties config, the sqlite (or Mongo) document store and the DAOs."""

from colormipsearch_tpu_torch.persist.config import Config
from colormipsearch_tpu_torch.persist.daos import (
    CDMatchesDao,
    DaosProvider,
    NeuronMetadataDao,
    PPPMatchesDao,
)
from colormipsearch_tpu_torch.persist.store import open_store

__all__ = [
    "CDMatchesDao",
    "Config",
    "DaosProvider",
    "NeuronMetadataDao",
    "PPPMatchesDao",
    "open_store",
]
