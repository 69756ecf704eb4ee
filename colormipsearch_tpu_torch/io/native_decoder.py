"""ctypes binding for the repository's native image decoder
(native/cdm_decoder.cpp).

The library is compiled on demand with g++ from the source in place into
the checkout's ``build/colormipsearch_tpu_torch/`` directory; when the
toolchain, zlib or the build is unavailable every entry point reports
unavailable and callers fall back to PIL or the pure-numpy PNG reader
(io/image.py) and to numpy foreground selection.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

LOG = logging.getLogger(__name__)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "cdm_decoder.cpp")
_BUILD_DIR = os.path.join(_REPO, "build", "colormipsearch_tpu_torch")

# Bump whenever the C ABI gains/changes symbols (baked into the .so name).
_ABI_VERSION = 3

_lock = threading.Lock()
_lib = None
_lib_failed = False


def _build_lib() -> str | None:
    so = os.path.join(_BUILD_DIR, f"libcdmdecoder.v{_ABI_VERSION}.so")
    if not os.path.exists(_SRC):
        return so if os.path.exists(so) else None
    if os.path.exists(so) and os.path.getmtime(so) >= \
            os.path.getmtime(_SRC):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = so + f".tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
           "-o", tmp, _SRC, "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except (subprocess.SubprocessError, OSError) as e:
        LOG.warning("native decoder build failed: %s", e)
        return None


def get_lib():
    """The loaded library, or None if unavailable."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        so = _build_lib()
        if so is None:
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(so)
            _bind_symbols(lib)
        except (OSError, AttributeError) as e:
            LOG.warning("cannot load native decoder %s: %s", so, e)
            _lib_failed = True
            return None
        _lib = lib
        return _lib


def _bind_symbols(lib) -> None:
    lib.cdm_tiff_info.restype = ctypes.c_int
    lib.cdm_tiff_info.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32)]
    lib.cdm_tiff_decode.restype = ctypes.c_int
    lib.cdm_tiff_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_size_t, ctypes.c_uint32, ctypes.c_uint32]
    lib.cdm_packbits_uncompress.restype = ctypes.c_longlong
    lib.cdm_packbits_uncompress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_size_t, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong]
    lib.cdm_tiff_decode_batch.restype = None
    lib.cdm_tiff_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.cdm_img_info.restype = ctypes.c_int
    lib.cdm_img_info.argtypes = lib.cdm_tiff_info.argtypes
    lib.cdm_img_decode.restype = ctypes.c_int
    lib.cdm_img_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_size_t]
    lib.cdm_img_decode_batch.restype = None
    lib.cdm_img_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.cdm_coo_count.restype = None
    lib.cdm_coo_count.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    lib.cdm_coo_fill.restype = None
    lib.cdm_coo_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.cdm_build_shape_row.restype = None
    lib.cdm_build_shape_row.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.cdm_shape_tile_from_store.restype = None
    lib.cdm_shape_tile_from_store.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]


def available() -> bool:
    return get_lib() is not None


def _info(fn, data: bytes):
    w = ctypes.c_uint32()
    h = ctypes.c_uint32()
    c = ctypes.c_uint32()
    b = ctypes.c_uint32()
    if fn(data, len(data), ctypes.byref(w), ctypes.byref(h),
          ctypes.byref(c), ctypes.byref(b)) != 0:
        return None
    return w.value, h.value, c.value, b.value


def tiff_info(data: bytes):
    """(width, height, channels, bits) of a TIFF, or None."""
    lib = get_lib()
    if lib is None:
        return None
    return _info(lib.cdm_tiff_info, data)


def decode_tiff(data: bytes, y0: int = 0, y1: int = 0):
    """Decode a TIFF held in memory -> numpy array, or None on failure.

    y0/y1 select a row range (y1=0 means the full height) — the native
    twin of the reference's partial PackBits range read
    (ImageArrayUtils.readImageArrayRange:130).
    """
    lib = get_lib()
    if lib is None:
        return None
    info = tiff_info(data)
    if info is None:
        return None
    w, h, c, bits = info
    if y1 == 0:
        y1 = h
    if not (0 <= y0 < y1 <= h):
        return None
    rows = y1 - y0
    dtype = np.uint16 if bits == 16 else np.uint8
    out = np.empty(rows * w * c, dtype)
    rc = lib.cdm_tiff_decode(data, len(data),
                             out.ctypes.data_as(ctypes.c_void_p),
                             out.nbytes, y0, y1)
    if rc != 0:
        return None
    if c == 1:
        return out.reshape(rows, w)
    return out.reshape(rows, w, c)


def packbits_uncompress(data: bytes, out: np.ndarray, offset=0, start=0,
                        end=0) -> int:
    """PackBits-decode `data` into `out`; the library's return value."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    return int(lib.cdm_packbits_uncompress(
        data, len(data), out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
        offset, start, end))


def _decode_batch(fn, blobs, width, height, channels, n_threads, *dims):
    n = len(blobs)
    stride = height * width * channels
    arena = np.empty((n, height, width, channels), np.uint8)
    bufs = (ctypes.c_char_p * n)(*blobs)
    lens = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
    results = (ctypes.c_int * n)()
    if n_threads <= 0:
        n_threads = min(32, os.cpu_count() or 1)
    fn(bufs, lens, n, arena.ctypes.data_as(ctypes.c_void_p), stride,
       *dims, n_threads, results)
    ok = np.array([results[i] == 0 for i in range(n)], bool)
    return arena, ok


def decode_tiff_batch(blobs: list[bytes], *, width: int, height: int,
                      channels: int, n_threads: int = 0):
    """Decode equal-shaped TIFF blobs into one uint8 arena in parallel.

    Returns (arena [N, H, W, C] uint8, ok mask [N] bool); per-image
    failures are flagged, not raised.
    """
    lib = get_lib()
    if lib is None:
        return None
    return _decode_batch(lib.cdm_tiff_decode_batch, blobs, width, height,
                         channels, n_threads, 0, 0)


def img_info(data: bytes):
    """(width, height, channels, bits) for TIFF or PNG, or None.

    PNG alpha channels are dropped in decode (like PIL convert("RGB")),
    so `channels` reports the output count."""
    lib = get_lib()
    if lib is None:
        return None
    return _info(lib.cdm_img_info, data)


def decode_img(data: bytes):
    """Decode a TIFF or PNG held in memory -> numpy array, or None."""
    lib = get_lib()
    if lib is None:
        return None
    info = img_info(data)
    if info is None:
        return None
    w, h, c, bits = info
    dtype = np.uint16 if bits == 16 else np.uint8
    out = np.empty(h * w * c, dtype)
    rc = lib.cdm_img_decode(data, len(data),
                            out.ctypes.data_as(ctypes.c_void_p),
                            out.nbytes)
    if rc != 0:
        return None
    if c == 1:
        return out.reshape(h, w)
    return out.reshape(h, w, c)


def decode_img_batch(blobs: list[bytes], *, width: int, height: int,
                     channels: int, n_threads: int = 0):
    """Decode equal-shaped TIFF/PNG blobs into one uint8 arena in
    parallel.  Returns (arena [N, H, W, C] uint8, ok mask [N])."""
    lib = get_lib()
    if lib is None:
        return None
    return _decode_batch(lib.cdm_img_decode_batch, blobs, width, height,
                         channels, n_threads, width, height, channels)


def build_shape_row(t_rgb: np.ndarray, grad: np.ndarray,
                    zgap_rgb: np.ndarray, slice_lut: np.ndarray, *,
                    mask_threshold: int, gap_threshold: int):
    """One-pass store-row fields (native twin of
    io/shape_pack.build_row_fields): (zsl uint16 [n_px], grad_thr uint16
    [n_px], tfg_bits uint8 [ceil(n_px/8)]).  Returns None when the
    native library is unavailable.  Runs single-threaded and drops the
    GIL — callers parallelize via their decode pool."""
    lib = get_lib()
    if lib is None:
        return None
    t_rgb = np.ascontiguousarray(t_rgb, np.uint8)
    grad = np.ascontiguousarray(grad, np.uint16)
    zgap_rgb = np.ascontiguousarray(zgap_rgb, np.uint8)
    assert slice_lut.dtype == np.uint16 and slice_lut.flags.c_contiguous
    n_px = grad.size
    assert t_rgb.size == n_px * 3 and zgap_rgb.size == n_px * 3
    zsl = np.empty(n_px, np.uint16)
    grad_thr = np.empty(n_px, np.uint16)
    tfg_bits = np.empty(-(-n_px // 8), np.uint8)
    ptr = ctypes.c_void_p
    lib.cdm_build_shape_row(
        ptr(t_rgb.ctypes.data), ptr(grad.ctypes.data),
        ptr(zgap_rgb.ctypes.data), n_px, ptr(slice_lut.ctypes.data),
        int(mask_threshold), int(gap_threshold), ptr(zsl.ctypes.data),
        ptr(grad_thr.ctypes.data), ptr(tfg_bits.ctypes.data))
    return zsl, grad_thr, tfg_bits


def shape_tile_from_store(zsl_mm: np.ndarray, grad_mm: np.ndarray,
                          tfg_mm: np.ndarray, rows: np.ndarray,
                          pos_gap: np.ndarray, g_pos: np.ndarray,
                          h_pos: np.ndarray, keep_he: np.ndarray | None,
                          n_or: int, n_gap_pad: int, n_he_words: int,
                          sl_shift: int, n_threads: int = 0):
    """Threaded store-row tile pack (native twin of
    ops/shape_score.select_target_tile_from_store): gathers the support
    columns of T store rows straight from the mmaps and assembles the
    final (t_gap uint32 [n_or, n_gap_pad, T], t_he uint32
    [n_or, n_he_words, T]) planes.  Returns None when the native
    library is unavailable (the caller takes the numpy path)."""
    lib = get_lib()
    if lib is None:
        return None
    assert zsl_mm.dtype == np.uint16 and grad_mm.dtype == np.uint16 \
        and tfg_mm.dtype == np.uint8
    rows = np.ascontiguousarray(rows, np.int64)
    pos_gap = np.ascontiguousarray(pos_gap, np.int32)
    g_pos = np.ascontiguousarray(g_pos, np.int32)
    h_pos = np.ascontiguousarray(h_pos, np.int32)
    # the C++ side does no bounds checks: refuse what would make it read
    # past the mmaps or write past the output planes
    n_he = h_pos.size // n_or
    if n_gap_pad < pos_gap.size or n_he_words < -(-n_he // 32):
        raise ValueError(f"planes too small: n_gap_pad {n_gap_pad} for "
                         f"{pos_gap.size} gap rows, n_he_words "
                         f"{n_he_words} for {n_he} ring rows")
    if rows.size:
        max_rows = min(zsl_mm.shape[0], grad_mm.shape[0], tfg_mm.shape[0])
        if int(rows.max()) >= max_rows or int(rows.min()) < 0:
            raise ValueError(f"store rows [{rows.min()}, {rows.max()}] "
                             f"outside the mapped range [0, {max_rows})")
    keep = (np.ascontiguousarray(keep_he, np.uint8)
            if keep_he is not None else None)
    t = len(rows)
    t_gap = np.empty((n_or, n_gap_pad, t), np.uint32)
    t_he = np.empty((n_or, n_he_words, t), np.uint32)
    if n_threads <= 0:
        n_threads = min(32, os.cpu_count() or 1)
    ptr = ctypes.c_void_p
    lib.cdm_shape_tile_from_store(
        ptr(zsl_mm.ctypes.data), ptr(grad_mm.ctypes.data),
        ptr(tfg_mm.ctypes.data), zsl_mm.shape[1], grad_mm.shape[1],
        tfg_mm.shape[1], ptr(rows.ctypes.data), t,
        ptr(pos_gap.ctypes.data), pos_gap.size, ptr(g_pos.ctypes.data),
        ptr(h_pos.ctypes.data), n_he,
        ptr(keep.ctypes.data) if keep is not None else None,
        n_or, n_gap_pad, n_he_words, sl_shift,
        ptr(t_gap.ctypes.data), ptr(t_he.ctypes.data), n_threads)
    return t_gap, t_he


def coo_select(arena: np.ndarray, threshold: int, n_threads: int = 0):
    """Threaded sparse foreground select over a uint8 [T, H, W, 3]
    arena: (pos int32 [N], tidx int32 [N], rgb uint8 [N, 3]) of every
    pixel with any channel > threshold, ordered by (image, pixel).
    Returns None when the native library is unavailable (callers fall
    back to the numpy nonzero path)."""
    lib = get_lib()
    if lib is None:
        return None
    assert arena.dtype == np.uint8 and arena.ndim == 4 \
        and arena.shape[-1] == 3 and arena.flags.c_contiguous
    n_img = arena.shape[0]
    n_px = arena.shape[1] * arena.shape[2]
    if n_threads <= 0:
        n_threads = min(32, os.cpu_count() or 1)
    counts = np.empty(n_img, np.int64)
    ptr = ctypes.c_void_p
    lib.cdm_coo_count(ptr(arena.ctypes.data), n_img, n_px,
                      int(threshold), ptr(counts.ctypes.data), n_threads)
    offsets = np.zeros(n_img, np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    total = int(counts.sum())
    pos = np.empty(total, np.int32)
    tidx = np.empty(total, np.int32)
    rgb = np.empty((total, 3), np.uint8)
    lib.cdm_coo_fill(ptr(arena.ctypes.data), n_img, n_px,
                     int(threshold), ptr(offsets.ctypes.data),
                     ptr(pos.ctypes.data), ptr(tidx.ctypes.data),
                     ptr(rgb.ctypes.data), n_threads)
    return pos, tidx, rgb
