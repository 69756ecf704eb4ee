"""Size-bounded image cache keyed by (neuron entity, compute file type).

Analogue of the reference's Guava LoadingCache (cmd/CachedMIPsUtils.java:
58-103): targets and their variants are decoded once and shared across
masks; a zero/negative size disables caching.  Thread-safe.
"""

from __future__ import annotations

import collections
import threading
from colormipsearch_tpu_torch.io import mips as mips_io
from colormipsearch_tpu_torch.model import ComputeFileType, Neuron

_lock = threading.Lock()
_cache: "collections.OrderedDict[tuple, mips_io.NeuronMIP]" = \
    collections.OrderedDict()
_loading: dict = {}  # key -> threading.Event for in-flight loads
_max_size = 0
_hits = 0
_misses = 0


def initialize_cache(size: int) -> None:
    """Set the cache capacity (number of images); clears current content."""
    global _max_size, _hits, _misses
    with _lock:
        _max_size = max(0, int(size))
        _cache.clear()
        _loading.clear()
        _hits = _misses = 0


def cache_stats() -> dict:
    with _lock:
        return {"size": len(_cache), "capacity": _max_size,
                "hits": _hits, "misses": _misses}


def load_mip(neuron: Neuron, ftype: ComputeFileType) -> mips_io.NeuronMIP:
    """Cached equivalent of mips_io.load_compute_file."""
    global _hits, _misses
    if _max_size <= 0:
        return mips_io.load_compute_file(neuron, ftype)
    fd = neuron.compute_file(ftype)
    if fd is None:
        return mips_io.NeuronMIP(neuron, None, None)
    key = (fd.file_name, fd.entry_name, ftype)
    while True:
        with _lock:
            hit = _cache.get(key)
            if hit is not None:
                _cache.move_to_end(key)
                _hits += 1
                return mips_io.NeuronMIP(neuron, hit.file_data, hit.image)
            pending = _loading.get(key)
            if pending is None:
                # claim the load; other threads wait instead of decoding
                # the same image concurrently (Guava LoadingCache blocks
                # on the in-flight load, CachedMIPsUtils.java:58-72)
                _loading[key] = threading.Event()
                break
        pending.wait()
    try:
        mip = mips_io.load_compute_file(neuron, ftype)
        with _lock:
            _misses += 1
            _cache[key] = mip
            while len(_cache) > _max_size:
                _cache.popitem(last=False)
        return mip
    finally:
        with _lock:
            _loading.pop(key).set()
