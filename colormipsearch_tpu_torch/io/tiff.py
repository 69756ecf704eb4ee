"""TIFF decoding without PIL or the native decoder: strip TIFFs as PIL's
TiffImagePlugin (and libtiff, for compressed files) read them.

Read: one image (the first IFD) in strips, either byte order; 8 bits a
sample (gray, RGB, palette) or 16 (gray, RGB); chunky or planar
(PlanarConfiguration 2; 16-bit planes only compressed) samples;
uncompressed, LZW (5), PackBits (32773) or Deflate (8 and 32946)
strips, with or without the horizontal predictor (2; PIL ignores it in
uncompressed strips). What
PIL makes of them, pinned by tests/test_torch_image_forms.py:
  * 8-bit gray: GRAY8 (photometric 1), inverted for WhiteIsZero (0);
  * 16-bit gray: GRAY16, its values as they are (both photometrics; PIL
    refuses a big-endian WhiteIsZero one);
  * 8-bit RGB: RGB; 16-bit RGB: RGB of the high byte of each sample;
  * palette (photometric 3, 8 bits): mode "P" whose colours are the
    16-bit ColorMap cut to its high byte (b // 256), converted to RGB.
Everything else (tiles, other bit depths, float samples, extra samples,
JPEG and other compressions) raises ValueError naming the form.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_TYPES = {1: "B", 3: "H", 4: "I"}   # BYTE, SHORT, LONG
# none, LZW, Deflate (Adobe's code and the old one), PackBits
_COMPRESSIONS = (1, 5, 8, 32946, 32773)


def _ifd(data: bytes) -> tuple[str, dict]:
    """The byte order and the first IFD's tags {tag: tuple of values}."""
    e = {b"II": "<", b"MM": ">"}.get(data[:2])
    if e is None or len(data) < 8:
        raise ValueError("not a TIFF")
    (magic, off) = struct.unpack(e + "HI", data[2:8])
    if magic != 42:
        raise ValueError(f"TIFF with magic {magic} (BigTIFF is not read)")
    (n,) = struct.unpack(e + "H", data[off:off + 2])
    tags = {}
    for k in range(n):
        at = off + 2 + 12 * k
        tag, typ, count = struct.unpack(e + "HHI", data[at:at + 8])
        if typ not in _TYPES:
            continue
        fmt = _TYPES[typ]
        size = struct.calcsize(fmt) * count
        at += 8
        if size > 4:
            (at,) = struct.unpack(e + "I", data[at:at + 4])
        raw = data[at:at + size]
        if len(raw) != size:
            raise ValueError(f"TIFF tag {tag} points past the file")
        tags[tag] = struct.unpack(f"{e}{count}{fmt}", raw)
    return e, tags


def _lzw(strip: bytes) -> bytes:
    """TIFF LZW: MSB-first codes of 9-12 bits, clear 256, end 257, the
    width growing one code early (libtiff's new-style decoder)."""
    b = np.frombuffer(strip + b"\0" * 4, np.uint8).astype(np.uint32)
    # w32[i]: bytes i .. i + 3 as one big-endian integer
    w32 = (b[:-3] << 24 | b[1:-2] << 16 | b[2:-1] << 8 | b[3:]).tolist()
    n_bits = 8 * len(strip)
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    size, prev, pos = 9, None, 0
    out = []
    while pos + size <= n_bits:
        code = (w32[pos >> 3] >> (32 - size - (pos & 7))) & ((1 << size) - 1)
        pos += size
        if code == 256:
            del table[258:]
            size, prev = 9, None
            continue
        if code == 257:
            break
        if prev is None:
            if code > 255:
                raise ValueError(f"TIFF LZW code {code} after a clear")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
            elif code == len(table):
                entry = prev + prev[:1]
            else:
                raise ValueError(f"TIFF LZW code {code} past the table")
            if len(table) < 4096:
                table.append(prev + entry[:1])
        if len(table) + 1 >= (1 << size) and size < 12:
            size += 1
        out.append(entry)
        prev = entry
    return b"".join(out)


def _packbits(strip: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(strip):
        n = strip[i]
        i += 1
        if n < 128:
            out += strip[i:i + n + 1]
            i += n + 1
        elif n > 128:
            if i < len(strip):
                out += strip[i:i + 1] * (257 - n)
            i += 1
    return bytes(out)


def _one(tags: dict, tag: int, default=None):
    v = tags.get(tag)
    if v is None:
        if default is None:
            raise ValueError(f"TIFF without tag {tag}")
        return default
    return v[0]


def decode_tiff(data: bytes) -> np.ndarray:
    """A strip TIFF's pixels as PIL gives them: uint8 [H, W] (GRAY8),
    uint16 [H, W] (GRAY16) or uint8 [H, W, 3] (RGB). Raises ValueError,
    its message naming TIFF and the form, on what it cannot decode."""
    try:
        return _decode(data)
    except ValueError as e:
        if "TIFF" in str(e):
            raise
        raise ValueError(f"TIFF: {e}") from e
    except (IndexError, KeyError, struct.error, zlib.error) as e:
        raise ValueError(f"corrupt TIFF: {e!r}") from e


def _decode(data: bytes) -> np.ndarray:
    e, tags = _ifd(data)
    w, h = _one(tags, 256), _one(tags, 257)
    bps = tags.get(258, (1,))
    spp = _one(tags, 277, 1)
    comp = _one(tags, 259, 1)
    photo = _one(tags, 262)
    planar = _one(tags, 284, 1)
    predictor = _one(tags, 317, 1)
    if 322 in tags or 324 in tags:
        raise ValueError("tiled TIFF is not decodable without PIL")
    if comp not in _COMPRESSIONS:
        raise ValueError(f"TIFF compression {comp} is not decodable without "
                         "PIL")
    if _one(tags, 339, 1) != 1:
        raise ValueError("TIFF with float or signed samples is not "
                         "decodable without PIL")
    bits = bps[0]
    form = {(0, 1, 8): "gray", (1, 1, 8): "gray", (0, 1, 16): "gray",
            (1, 1, 16): "gray", (2, 3, 8): "rgb", (2, 3, 16): "rgb",
            (3, 1, 8): "palette"}.get((photo, spp, bits))
    if form is None or len(set(bps)) != 1 or 338 in tags:
        raise ValueError(f"TIFF with photometric {photo}, {spp} samples of "
                         f"{bps} bits is not decodable without PIL")
    if planar not in (1, 2) or predictor not in (1, 2) or w == 0 or h == 0:
        raise ValueError(f"TIFF with planar configuration {planar}, "
                         f"predictor {predictor} is not decodable")
    if planar == 2 and bits != 8 and comp == 1:
        # PIL's raw reader takes such planes for 8-bit ones
        raise ValueError("uncompressed planar TIFF of 16-bit samples is "
                         "not decodable without PIL")
    if photo == 0 and bits == 16 and e == ">":
        raise ValueError("big-endian 16-bit WhiteIsZero TIFF is not "
                         "decodable without PIL")
    if comp == 1:
        predictor = 1      # PIL's raw reader ignores it without compression
    rps = min(_one(tags, 278, h), h)
    offsets, counts = tags[273], tags[279]
    planes = spp if planar == 2 else 1
    per_plane = -(-h // rps)
    if len(offsets) < planes * per_plane or len(counts) < len(offsets):
        raise ValueError("TIFF has too few strips")
    nbytes = bits // 8
    row_samples = w * (1 if planar == 2 else spp)
    dtype = np.dtype(e + ("u2" if bits == 16 else "u1"))
    out = np.empty((planes, h, row_samples), dtype)
    for p in range(planes):
        for s in range(per_plane):
            k = p * per_plane + s
            raw = data[offsets[k]:offsets[k] + counts[k]]
            if comp == 5:
                raw = _lzw(raw)
            elif comp in (8, 32946):
                raw = zlib.decompressobj().decompress(raw)
            elif comp == 32773:
                raw = _packbits(raw)
            rows = min(rps, h - s * rps)
            need = rows * row_samples * nbytes
            if len(raw) < need:
                raise ValueError("TIFF strip is too short")
            out[p, s * rps:s * rps + rows] = np.frombuffer(
                raw, dtype, rows * row_samples).reshape(rows, row_samples)
    x = out.astype(np.uint16 if bits == 16 else np.uint8)
    if predictor == 2:
        # horizontal differencing: each sample adds the one a pixel back
        step = 1 if planar == 2 else spp
        x = x.reshape(planes, h, w, step)
        x = np.cumsum(x, axis=2, dtype=x.dtype).reshape(planes, h, -1)
    if planar == 2:
        x = np.moveaxis(x, 0, -1)                 # [h, w, spp]
    else:
        x = x[0].reshape(h, w, spp)
    if form == "gray":
        g = x[..., 0]
        if bits == 8 and photo == 0:
            g = 255 - g
        return np.ascontiguousarray(g)
    if form == "rgb":
        return np.ascontiguousarray(x >> 8 if bits == 16 else x) \
            .astype(np.uint8)
    cmap = tags.get(320)
    if cmap is None or len(cmap) != 3 * 256:
        raise ValueError("palette TIFF without a 256-entry ColorMap")
    lut = (np.asarray(cmap, np.uint32).reshape(3, 256).T // 256) \
        .astype(np.uint8)
    return lut[x[..., 0]]
