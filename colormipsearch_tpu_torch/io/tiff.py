"""TIFF decoding without PIL or the native decoder: strip and tiled TIFFs
as PIL's TiffImagePlugin reads them (its own raw reader for
uncompressed data, libtiff for everything else).

Read: one image (the first IFD), in strips or tiles (edge tiles that
overhang the image are cut), either byte order, chunky or planar
(PlanarConfiguration 2) samples, FillOrder 1 or 2 (the bits of every
byte of a chunk reversed before it is decompressed, as libtiff and PIL's
";R" raw modes do); uncompressed, LZW (5), PackBits (32773), Deflate (8,
32946), CCITT Group 3 and 4 (3, 4; io/fax.py) and JPEG (7; io/jpeg.py on
the shared JPEGTables and each chunk's stream), with or without the
horizontal predictor (2; PIL ignores it in uncompressed data). What PIL
makes of them (its mode, then _from_pil), pinned by
tests/test_torch_image_forms.py:
  * gray: 1-bit (mode "1": RGB of 0 and 255), 8-bit (GRAY8, inverted
    for WhiteIsZero), 16-bit (GRAY16, its values as they are; PIL refuses
    a big-endian WhiteIsZero one), float32 (mode "F": RGB of each value
    clipped to [0, 255] and truncated, NaN 0); gray + alpha (mode "LA":
    RGB of the gray);
  * RGB 8-bit (RGB) and 16-bit (the high byte of each sample), with an
    extra sample: unassociated or unspecified (dropped), associated
    (PIL's "RGBa" raw mode divides it out: 255 * v // a, clipped; 0 where
    a = 0);
  * palette (photometric 3) at 1, 2, 4 and 8 bits: the 16-bit ColorMap
    cut to its high byte (b // 256), converted to RGB;
  * CMYK (photometric 5, 8-bit): PIL's CMYK -> RGB, (255 - c) * (255 - k)
    / 255 rounded;
  * JPEG-compressed RGB (photometric 2: the components as they are) and
    YCbCr (6: libjpeg's conversion to RGB, libtiff's JPEGCOLORMODE RGB);
  * uncompressed planar data: PIL's raw reader takes each plane for an
    8-bit one, so 16-bit planes give the bytes of each strip's first
    half, row by row.
Everything else (other bit depths or sample formats, YCbCr without
JPEG, LAB, old-style JPEG, SGILog, LZMA, ZSTD, WebP, ...) raises
ValueError naming the form.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from colormipsearch_tpu_torch.io import fax, jpeg

# BYTE, SHORT, LONG, UNDEFINED (bytes)
_TYPES = {1: "B", 3: "H", 4: "I", 7: "B"}
# none, CCITT G3 and G4, LZW, JPEG, Deflate (Adobe's code and the old
# one), PackBits
_COMPRESSIONS = (1, 3, 4, 5, 7, 8, 32946, 32773)
# bits -> reversed bits, for FillOrder 2
_REVERSE = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


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
    """A TIFF's pixels as PIL gives them through _from_pil: uint8 [H, W]
    (GRAY8), uint16 [H, W] (GRAY16) or uint8 [H, W, 3] (RGB). Raises
    ValueError, its message naming TIFF and the form, on what it cannot
    decode."""
    try:
        return _decode(data)
    except ValueError as e:
        if "TIFF" in str(e):
            raise
        raise ValueError(f"TIFF: {e}") from e
    except (IndexError, KeyError, struct.error, zlib.error) as e:
        raise ValueError(f"corrupt TIFF: {e!r}") from e


# (photometric, bits per sample, extra samples) -> the form; sample
# format 1 (unsigned) unless named
_FORMS = {
    (0, (1,), ()): "bilevel", (1, (1,), ()): "bilevel",
    (0, (8,), ()): "gray", (1, (8,), ()): "gray",
    (0, (16,), ()): "gray", (1, (16,), ()): "gray",
    (1, (8, 8), (2,)): "gray_alpha",
    (2, (8, 8, 8), ()): "rgb", (2, (16, 16, 16), ()): "rgb",
    (2, (8, 8, 8, 8), ()): "rgb", (2, (8, 8, 8, 8), (0,)): "rgb",
    (2, (8, 8, 8, 8), (2,)): "rgb", (2, (8, 8, 8, 8), (999,)): "rgb",
    (2, (8, 8, 8, 8), (1,)): "rgb_associated",
    (3, (1,), ()): "palette", (3, (2,), ()): "palette",
    (3, (4,), ()): "palette", (3, (8,), ()): "palette",
    (5, (8, 8, 8, 8), ()): "cmyk",
    (6, (8, 8, 8), ()): "ycbcr",
}


class _Layout:
    """A TIFF's geometry and coding, read from its tags with PIL's
    defaults."""

    def __init__(self, data: bytes):
        e, tags = _ifd(data)
        self.e, self.tags = e, tags
        self.w, self.h = _one(tags, 256), _one(tags, 257)
        self.comp = _one(tags, 259, 1)
        self.photo = _one(tags, 262)
        spp_default = 3 if self.comp == 7 and self.photo in (2, 6) else 1
        self.spp = _one(tags, 277, spp_default)
        bps = tags.get(258, (1,))
        if len(bps) == 1 and self.spp > 1:
            bps = bps * self.spp          # one value for every sample
        self.bps = tuple(bps[:self.spp])
        self.extra = tags.get(338, ())
        self.fmt = _one(tags, 339, 1)
        self.planar = _one(tags, 284, 1)
        self.predictor = _one(tags, 317, 1)
        self.fill = _one(tags, 266, 1)
        if self.comp not in _COMPRESSIONS:
            raise ValueError(f"TIFF compression {self.comp} is not "
                             "decodable without PIL")
        key = (self.photo, self.bps, tuple(self.extra))
        self.form = _FORMS.get(key)
        if self.fmt == 3 and key in ((0, (32,), ()), (1, (32,), ())):
            self.form = "float"
        elif self.fmt != 1:
            self.form = None
        if self.form is None or (self.form == "ycbcr" and self.comp != 7):
            raise ValueError(
                f"TIFF with photometric {self.photo}, {self.spp} samples "
                f"of {self.bps} bits (extra samples {self.extra}, sample "
                f"format {self.fmt}, compression {self.comp}) is not "
                "decodable without PIL")
        if self.planar not in (1, 2) or self.predictor not in (1, 2) \
                or self.fill not in (1, 2) or self.w == 0 or self.h == 0:
            raise ValueError(f"TIFF with planar configuration "
                             f"{self.planar}, predictor {self.predictor}, "
                             f"fill order {self.fill} is not decodable")
        if self.form == "gray" and self.photo == 0 and self.bps == (16,) \
                and e == ">":
            raise ValueError("big-endian 16-bit WhiteIsZero TIFF is not "
                             "decodable without PIL (PIL refuses it too)")
        if self.comp == 7 and (self.form not in ("rgb", "ycbcr", "gray")
                               or self.bps[0] != 8):
            raise ValueError(f"TIFF JPEG compression of photometric "
                             f"{self.photo} is not decodable without PIL")
        if self.comp in (3, 4) and self.bps != (1,):
            raise ValueError("TIFF CCITT compression of more than one bit "
                             "a sample")
        if self.predictor == 2 and self.comp != 1 \
                and self.bps[0] not in (8, 16):
            raise ValueError(f"TIFF predictor 2 with {self.bps[0]}-bit "
                             "samples is not decodable")
        if self.comp == 1:
            self.predictor = 1  # PIL's raw reader ignores it
        # PIL's raw reader takes strips whenever StripOffsets is there;
        # libtiff (every compression) takes tiles whenever TileWidth is
        self.tiled = (324 in tags and 273 not in tags) if self.comp == 1 \
            else 322 in tags
        if self.tiled:
            self.cw, self.ch = _one(tags, 322), _one(tags, 323)
            self.offsets, self.counts = tags[324], tags[325]
        else:
            self.cw, self.ch = self.w, min(_one(tags, 278, self.h), self.h)
            self.offsets, self.counts = tags[273], tags[279]
        if self.cw < 1 or self.ch < 1:
            raise ValueError("TIFF with an empty tile or strip")
        self.across = -(-self.w // self.cw)
        self.down = -(-self.h // self.ch)
        self.planes = self.spp if self.planar == 2 else 1
        n = self.planes * self.across * self.down
        if len(self.offsets) < n or len(self.counts) < n:
            raise ValueError("TIFF has too few strips or tiles")


def _chunk_samples(lay: _Layout, raw: bytes, rows: int) -> np.ndarray:
    """A decompressed chunk -> its samples [rows, chunk width, samples a
    pixel in the chunk]: sub-byte samples unpacked MSB first (each row
    starts on a byte), 16-bit and float32 ones in the file's byte
    order."""
    per = 1 if lay.planar == 2 else lay.spp
    bits = lay.bps[0]
    cw = lay.cw
    if bits < 8:
        row_bytes = -(-cw * per * bits // 8)
        need = rows * row_bytes
        if len(raw) < need:
            raise ValueError("TIFF strip or tile is too short")
        b = np.frombuffer(raw, np.uint8, need).reshape(rows, row_bytes)
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        x = ((b[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(rows, -1)
        return x[:, :cw * per].reshape(rows, cw, per)
    dtype = {8: np.dtype(np.uint8), 16: np.dtype(lay.e + "u2"),
             32: np.dtype(lay.e + "f4")}[bits]
    need = rows * cw * per * dtype.itemsize
    if len(raw) < need:
        raise ValueError("TIFF strip or tile is too short")
    x = np.frombuffer(raw, dtype, rows * cw * per).reshape(rows, cw, per)
    if lay.predictor == 2:
        # horizontal differencing: each sample adds the one a pixel back
        x = np.cumsum(x, axis=1, dtype=x.dtype)
    return x


def _jpeg_chunk(lay: _Layout, raw: bytes) -> np.ndarray:
    """A JPEG-compressed chunk, decoded as libtiff has libjpeg decode it:
    the shared JPEGTables stream read first, then the chunk's own; YCbCr
    to RGB for photometric 6 (JPEGCOLORMODE RGB), the components as they
    are otherwise. -> uint8 [rows, cols, samples]."""
    tables = bytes(lay.tags.get(347, ()))
    if tables:
        if not tables.startswith(b"\xff\xd8") or not raw.startswith(
                b"\xff\xd8"):
            raise ValueError("TIFF JPEG tables or chunk without an SOI")
        # the tables' stream without its EOI, then the chunk without its
        # SOI: one stream, as libjpeg reads the two
        end = tables.rfind(b"\xff\xd9")
        raw = tables[:end if end > 0 else len(tables)] + raw[2:]
    px = jpeg.decode_jpeg(raw, color="ycbcr" if lay.photo == 6 else "none")
    return px.reshape(px.shape[0], px.shape[1], -1)


def _chunks(data: bytes, lay: _Layout) -> np.ndarray:
    """Every strip or tile decoded and placed: samples [planes, H, W,
    samples a plane]."""
    per = 1 if lay.planar == 2 else lay.spp
    bits = lay.bps[0]
    dtype = {1: np.uint8, 2: np.uint8, 4: np.uint8, 8: np.uint8,
             16: np.dtype(lay.e + "u2"), 32: np.dtype(lay.e + "f4")}[bits]
    out = np.zeros((lay.planes, lay.h, lay.w, per), dtype)
    options = _one(lay.tags, 292 if lay.comp == 3 else 293, 0)
    k = 0
    for p in range(lay.planes):
        for ty in range(lay.down):
            for tx in range(lay.across):
                y0, x0 = ty * lay.ch, tx * lay.cw
                # a strip's rows end at the image; a tile is whole
                rows = lay.ch if lay.tiled else min(lay.ch, lay.h - y0)
                raw = data[lay.offsets[k]:lay.offsets[k] + lay.counts[k]]
                k += 1
                if lay.fill == 2:
                    raw = raw.translate(_REVERSE)
                if lay.comp == 7:
                    x = _jpeg_chunk(lay, raw)
                else:
                    if lay.comp == 5:
                        raw = _lzw(raw)
                    elif lay.comp in (8, 32946):
                        raw = zlib.decompressobj().decompress(raw)
                    elif lay.comp == 32773:
                        raw = _packbits(raw)
                    elif lay.comp in (3, 4):
                        raw = np.packbits(fax.decode(
                            raw, lay.cw, rows, lay.comp, options),
                            axis=1).tobytes()
                    x = _chunk_samples(lay, raw, rows)
                hh = min(rows, lay.h - y0, x.shape[0])
                ww = min(lay.cw, lay.w - x0, x.shape[1])
                out[p, y0:y0 + hh, x0:x0 + ww] = x[:hh, :ww, :per]
    return out


def _planar_raw_16(data: bytes, lay: _Layout) -> np.ndarray:
    """Uncompressed planar 16-bit strips as PIL's raw reader reads them:
    each plane with an 8-bit raw mode ("R", "G", "B"), so row r of a
    strip is bytes r*w .. (r+1)*w of the strip. -> uint8 [H, W, 3]."""
    out = np.zeros((lay.h, lay.w, lay.spp), np.uint8)
    k = 0
    for p in range(lay.spp):
        for s in range(lay.down):
            rows = min(lay.ch, lay.h - s * lay.ch)
            need = rows * lay.w
            raw = data[lay.offsets[k]:lay.offsets[k] + need]
            k += 1
            if len(raw) < need:
                raise ValueError("TIFF strip is too short")
            out[s * lay.ch:s * lay.ch + rows, :, p] = np.frombuffer(
                raw, np.uint8).reshape(rows, lay.w)
    return out


def _float_to_l(x: np.ndarray) -> np.ndarray:
    """PIL's "F" -> "L": clipped to [0, 255], truncated; NaN gives 0."""
    x = np.where(np.isnan(x), 0, x)
    return np.trunc(np.clip(x, 0, 255)).astype(np.uint8)


def _rgb(gray: np.ndarray) -> np.ndarray:
    return np.repeat(gray[..., None], 3, axis=-1)


def _decode(data: bytes) -> np.ndarray:
    lay = _Layout(data)
    if lay.planar == 2 and lay.comp == 1 and lay.bps[0] == 16:
        return _planar_raw_16(data, lay)
    x = _chunks(data, lay)
    # [planes, H, W, per] -> [H, W, spp]
    x = np.moveaxis(x, 0, -1)[..., 0, :] if lay.planar == 2 else x[0]
    form, bits = lay.form, lay.bps[0]
    if form == "bilevel":
        on = x[..., 0] != (lay.photo == 0)
        return _rgb(on.astype(np.uint8) * 255)
    if form == "gray":
        g = x[..., 0]
        if bits == 8 and lay.photo == 0:
            g = 255 - g
        return np.ascontiguousarray(g.astype(np.uint16 if bits == 16
                                             else np.uint8))
    if form == "float":
        return _rgb(_float_to_l(x[..., 0].astype(np.float32)))
    if form == "gray_alpha":
        return _rgb(x[..., 0])
    if form in ("rgb", "ycbcr"):
        rgb = x[..., :3]
        return np.ascontiguousarray(rgb >> 8 if bits == 16 else rgb) \
            .astype(np.uint8)
    if form == "rgb_associated":
        rgb = x[..., :3].astype(np.int32)
        a = x[..., 3:4].astype(np.int32)
        un = np.minimum(255, 255 * rgb // np.maximum(a, 1))
        return np.where(a == 255, rgb, np.where(a == 0, 0, un)) \
            .astype(np.uint8)
    if form == "cmyk":
        c = x.astype(np.int32)
        t = (255 - c[..., :3]) * (255 - c[..., 3:4]) + 128
        return ((t + (t >> 8)) >> 8).astype(np.uint8)
    cmap = lay.tags.get(320)
    n = 1 << bits
    if cmap is None or len(cmap) != 3 * n:
        raise ValueError(f"palette TIFF without a {n}-entry ColorMap")
    lut = (np.asarray(cmap, np.uint32).reshape(3, n).T // 256) \
        .astype(np.uint8)
    return lut[x[..., 0]]
