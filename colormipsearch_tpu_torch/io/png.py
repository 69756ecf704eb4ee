"""PNG writers (numpy and zlib, no PIL): 8-bit RGB and 16-bit gray.

The two forms ``precomputeVariants`` writes (an RGB ZGapImage, a 16-bit
gray GradientImage) and the synthetic libraries of ``testing.py`` use.
Every row is stored under filter type 0, non-interlaced; the port's
``io/image`` reader (``decode_png_rgb8`` / ``decode_png_gray16``) and
PIL both read them back to the written array.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _png(rows: np.ndarray, w: int, h: int, depth: int,
         color: int) -> bytes:
    """PNG bytes of uint8 [H, row bytes] rows, each stored under filter
    type 0, non-interlaced."""
    raw = np.zeros((h, 1 + rows.shape[1]), np.uint8)
    raw[:, 1:] = rows

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (PNG_MAGIC
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                         0, 0, 0))
            # level 1: mostly-black images compress well even so, and
            # writing a 2,048-image library stays a few seconds
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + chunk(b"IEND", b""))


def encode_png(rgb: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> 8-bit RGB PNG bytes (what
    io/image.decode_png_rgb8 reads)."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected uint8 [H, W, 3], got {rgb.dtype} "
                         f"{rgb.shape}")
    h, w, _ = rgb.shape
    return _png(rgb.reshape(h, 3 * w), w, h, 8, 2)


def encode_png_gray16(gray: np.ndarray) -> bytes:
    """uint16 [H, W] -> 16-bit gray PNG bytes, big-endian samples (what
    io/image.decode_png_gray16 reads)."""
    if gray.dtype != np.uint16 or gray.ndim != 2:
        raise ValueError(f"expected uint16 [H, W], got {gray.dtype} "
                         f"{gray.shape}")
    h, w = gray.shape
    rows = np.ascontiguousarray(gray.astype(">u2")).view(np.uint8)
    return _png(rows.reshape(h, 2 * w), w, h, 16, 0)


def write_png(path, img: np.ndarray) -> None:
    """uint8 [H, W, 3] as 8-bit RGB, uint16 [H, W] as 16-bit gray."""
    data = encode_png_gray16(img) if img.dtype == np.uint16 \
        else encode_png(img)
    with open(path, "wb") as f:
        f.write(data)
