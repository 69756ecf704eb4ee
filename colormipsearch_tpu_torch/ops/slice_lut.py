"""Full-RGB z-slice lookup table.

The slice number of a pixel is a pure function of its 24-bit RGB value
(GradientAreaGapUtils.findSliceNumber:108-198), so the entire mapping fits
in a 2^24-entry uint16 table (32 MiB).  The table is built ONCE from the
float64 oracle — which replicates the reference's operation order
bit-for-bit, including f64 rounding at exact nearest-ratio ties — and
cached on disk; afterwards slice numbers are a gather on host or device.

This removes the reference's per-pixel-per-comparison 256-entry LUT scan
AND sidesteps the f64-tie subtlety that a from-scratch device argmin
cannot reproduce exactly.
"""

from __future__ import annotations

import os

import numpy as np

from colormipsearch_tpu_torch.oracle import shape as shape_oracle

_CACHE_ENV = "COLORMIPSEARCH_TPU_CACHE"
_LUT_FILE = "rgb_slice_lut_v1.npy"
_lut_mem: np.ndarray | None = None


def _cache_dir() -> str:
    d = os.environ.get(_CACHE_ENV)
    if not d:
        d = os.path.join(os.path.expanduser("~"), ".cache",
                         "colormipsearch_tpu")
    os.makedirs(d, exist_ok=True)
    return d


def build_slice_lut(chunk: int = 1 << 20) -> np.ndarray:
    """uint16 [2^24] slice numbers indexed by (r<<16)|(g<<8)|b."""
    out = np.empty(1 << 24, np.uint16)
    for start in range(0, 1 << 24, chunk):
        n = min(chunk, (1 << 24) - start)
        i = np.arange(n, dtype=np.int64) + start
        rgb = np.stack([(i >> 16) & 0xFF, (i >> 8) & 0xFF, i & 0xFF],
                       axis=-1).astype(np.uint8)
        out[start:start + n] = shape_oracle.slice_numbers(
            rgb.reshape(-1, 1, 3)).reshape(-1)
    return out


def get_slice_lut() -> np.ndarray:
    """Load (or build+cache) the full RGB->slice table."""
    global _lut_mem
    if _lut_mem is not None:
        return _lut_mem
    path = os.path.join(_cache_dir(), _LUT_FILE)
    if os.path.exists(path):
        try:
            lut = np.load(path)
        except (OSError, ValueError):
            lut = None  # corrupt cache: rebuild below
        if lut is not None and lut.shape == (1 << 24,) \
                and lut.dtype == np.uint16:
            _lut_mem = lut
            return lut
    lut = build_slice_lut()
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.save(f, lut)
    os.replace(tmp, path)
    _lut_mem = lut
    return lut


def slice_numbers_lut(rgb: np.ndarray) -> np.ndarray:
    """Exact slice numbers via the table (host gather)."""
    lut = get_slice_lut()
    r = rgb[..., 0].astype(np.int64)
    g = rgb[..., 1].astype(np.int64)
    b = rgb[..., 2].astype(np.int64)
    return lut[(r << 16) | (g << 8) | b].astype(np.int32)
