"""TIFF decoding without PIL or the native decoder: strip and tiled TIFFs
as PIL's TiffImagePlugin reads them (its own raw reader for
uncompressed data, libtiff for everything else).

Read: one image (the first IFD), in strips or tiles (edge tiles that
overhang the image are cut), either byte order, chunky or planar
(PlanarConfiguration 2) samples, FillOrder 1 or 2 (the bits of every
byte of a chunk reversed before it is decompressed, as libtiff and PIL's
";R" raw modes do); uncompressed, LZW (5), PackBits (32773), Deflate (8,
32946), CCITT RLE, Group 3 and Group 4 (2, 3, 4; io/fax.py), JPEG (7;
io/jpeg.py on the shared JPEGTables and each chunk's stream), LZMA
(34925: an .xz stream, the standard library's lzma) and Zstandard
(50000; io/zstd.py), with or without the horizontal predictor (2; PIL
ignores it in uncompressed data; libtiff adds 32-bit samples as uint32
words, float32 too). What PIL makes of them (its mode, then
_from_pil), pinned by tests/test_torch_image_forms.py:
  * gray: 1-bit (mode "1": RGB of 0 and 255), 2- and 4-bit (mode "L":
    each sample times 85 or 17, inverted for WhiteIsZero), 8-bit (GRAY8,
    inverted for WhiteIsZero), 16-bit (GRAY16, its values as they are;
    PIL refuses a big-endian WhiteIsZero one), float32 (mode "F": RGB of
    each value clipped to [0, 255] and truncated, NaN 0; compressed
    big-endian ones byte-swapped, as mode "I" below); gray + alpha
    (mode "LA": RGB of the gray);
  * BlackIsZero signed 16-bit, signed 32-bit and (little-endian only, as
    PIL maps it) unsigned 32-bit integers: PIL's mode "I" (int32; an
    unsigned value of 2^31 or more wraps negative), then _from_pil's
    range rule: GRAY8 when every value is at most 255, GRAY16 when all
    lie in [0, 65535], else ValueError. Compressed big-endian files are
    read as PIL reads them on a little-endian host: libtiff hands PIL its
    samples in host order and PIL unpacks them as big-endian, so each
    value comes out byte-swapped;
  * CIELab (photometric 8, 8-bit): PIL's LAB -> RGB (io/lab.py);
  * RGB 8-bit (RGB) and 16-bit (the high byte of each sample), with an
    extra sample: unassociated or unspecified (dropped), associated
    (PIL's "RGBa" raw mode divides it out: 255 * v // a, clipped; 0 where
    a = 0);
  * palette (photometric 3) at 1, 2, 4 and 8 bits, and 8-bit with an
    alpha or unspecified extra sample (modes "PA", "P"): the 16-bit
    ColorMap cut to its high byte (b // 256), converted to RGB; indices
    past a short ColorMap are black, the extra sample is dropped;
  * CMYK (photometric 5, 8-bit): PIL's CMYK -> RGB, (255 - c) * (255 - k)
    / 255 rounded;
  * JPEG-compressed RGB (photometric 2: the components as they are) and
    YCbCr (6: libjpeg's conversion to RGB, libtiff's JPEGCOLORMODE RGB);
  * uncompressed planar data: PIL's raw reader takes each plane for an
    8-bit one, so 16-bit planes give the bytes of each strip's first
    half, row by row.
Everything else (other bit depths or sample formats, YCbCr without
JPEG, old-style JPEG, SGILog, ThunderScan, WebP, ...) raises ValueError
naming the form.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from colormipsearch_tpu_torch.io import fax, jpeg, lab, zstd

# BYTE, SHORT, LONG, UNDEFINED (bytes)
_TYPES = {1: "B", 3: "H", 4: "I", 7: "B"}
# none, CCITT RLE, G3 and G4, LZW, JPEG, Deflate (Adobe's code and the
# old one), PackBits, LZMA, Zstandard
_COMPRESSIONS = (1, 2, 3, 4, 5, 7, 8, 32946, 32773, 34925, 50000)
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


# (photometric, bits per sample, extra samples) -> the form, for sample
# format 1 (unsigned)
_FORMS = {
    (0, (1,), ()): "bilevel", (1, (1,), ()): "bilevel",
    (0, (2,), ()): "gray_low", (1, (2,), ()): "gray_low",
    (0, (4,), ()): "gray_low", (1, (4,), ()): "gray_low",
    (0, (8,), ()): "gray", (1, (8,), ()): "gray",
    (0, (16,), ()): "gray", (1, (16,), ()): "gray",
    (1, (8, 8), (2,)): "gray_alpha",
    (2, (8, 8, 8), ()): "rgb", (2, (16, 16, 16), ()): "rgb",
    (2, (8, 8, 8, 8), ()): "rgb", (2, (8, 8, 8, 8), (0,)): "rgb",
    (2, (8, 8, 8, 8), (2,)): "rgb", (2, (8, 8, 8, 8), (999,)): "rgb",
    (2, (8, 8, 8, 8), (1,)): "rgb_associated",
    (3, (1,), ()): "palette", (3, (2,), ()): "palette",
    (3, (4,), ()): "palette", (3, (8,), ()): "palette",
    (3, (8, 8), (0,)): "palette", (3, (8, 8), (2,)): "palette",
    (5, (8, 8, 8, 8), ()): "cmyk",
    (6, (8, 8, 8), ()): "ycbcr",
    (8, (8, 8, 8), ()): "lab",
    (1, (32,), ()): "int",      # unsigned, little-endian only (below)
}
# (sample format, photometric, bits per sample) -> the form, for the
# other sample formats (2: signed, 3: IEEE float)
_FORMS_BY_FORMAT = {
    (2, 1, (16,)): "int", (2, 1, (32,)): "int",
    (3, 0, (32,)): "float", (3, 1, (32,)): "float",
}
# the forms PIL maps for FillOrder 1 only
_FILL_ORDER_1 = ("int", "lab")


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
        self.form = (_FORMS.get(key) if self.fmt == 1 else None
                     if self.extra else _FORMS_BY_FORMAT.get(
                         (self.fmt, self.photo, self.bps)))
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
        if self.form == "int" and self.fmt == 1 and e == ">":
            raise ValueError("big-endian unsigned 32-bit gray TIFF is not "
                             "decodable without PIL (PIL refuses it too)")
        if (self.form in _FILL_ORDER_1 or len(self.extra)
                and self.form == "palette") and self.fill != 1:
            raise ValueError(f"TIFF {self.form} with fill order "
                             f"{self.fill} is not decodable without PIL "
                             "(PIL refuses it too)")
        if self.planar == 2 and self.spp == 1 and self.form in (
                "int", "gray_low"):
            raise ValueError(f"planar TIFF of {self.bps[0]}-bit gray is "
                             "not decodable without PIL")
        if self.comp == 7 and (self.form not in ("rgb", "ycbcr", "gray")
                               or self.bps[0] != 8):
            raise ValueError(f"TIFF JPEG compression of photometric "
                             f"{self.photo} is not decodable without PIL")
        if self.comp in (2, 3, 4) and self.bps != (1,):
            raise ValueError("TIFF CCITT compression of more than one bit "
                             "a sample")
        if self.predictor == 2 and self.comp != 1 \
                and self.bps[0] not in (8, 16, 32):
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
    dtype = _sample_dtype(lay)
    need = rows * cw * per * dtype.itemsize
    if len(raw) < need:
        raise ValueError("TIFF strip or tile is too short")
    x = np.frombuffer(raw, dtype, rows * cw * per).reshape(rows, cw, per)
    if lay.predictor == 2:
        # horizontal differencing: each sample adds the one a pixel back,
        # as an unsigned integer of its width whatever its sample format
        # (libtiff's horAcc32 adds float32 words as uint32)
        acc = np.dtype(f"{lay.e}u{dtype.itemsize}")
        native = acc.newbyteorder("=")
        x = np.cumsum(x.view(acc).astype(native), axis=1, dtype=native) \
            .astype(acc).view(dtype)
    return x


def _sample_dtype(lay: _Layout) -> np.dtype:
    """The dtype of one decompressed sample of 8 bits or more."""
    return {8: np.dtype(np.uint8), 16: np.dtype(lay.e + "u2"),
            32: np.dtype(lay.e + ("f4" if lay.form == "float" else "u4"))
            }[lay.bps[0]]


def _lzma(raw: bytes) -> bytes:
    """TIFF LZMA (34925): libtiff writes one .xz stream a chunk."""
    try:
        import lzma
    except ImportError as e:
        raise ValueError("TIFF LZMA compression: this Python has no lzma "
                         "module") from e
    try:
        return lzma.LZMADecompressor().decompress(raw)
    except lzma.LZMAError as e:
        raise ValueError(f"corrupt TIFF LZMA data: {e}") from e


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
    dtype = np.uint8 if lay.bps[0] < 8 else _sample_dtype(lay)
    out = np.zeros((lay.planes, lay.h, lay.w, per), dtype)
    options = _one(lay.tags, 292 if lay.comp == 3 else 293, 0) \
        if lay.comp in (3, 4) else 0
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
                    elif lay.comp == 34925:
                        raw = _lzma(raw)
                    elif lay.comp == 50000:
                        raw = zstd.decompress(raw)
                    elif lay.comp in (2, 3, 4):
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


def _mode_i(lay: _Layout, x: np.ndarray) -> np.ndarray:
    """Integer gray samples as PIL's mode "I" holds them, through
    _from_pil's range rule -> uint8 or uint16 [H, W]."""
    if lay.e == ">" and lay.comp != 1:
        x = x.byteswap()   # host-order samples unpacked as big-endian
    wide = lay.bps[0] == 32
    v = x.astype(np.uint32 if wide else np.uint16) \
        .view(np.int32 if wide else np.int16).astype(np.int32)
    mx, mn = int(v.max(initial=0)), int(v.min(initial=0))
    if mx > 0xFFFF or mn < 0:
        raise ValueError(
            f"32-bit gray image with values outside uint16 (min {mn}, max "
            f"{mx}) is not supported")
    return v.astype(np.uint16 if mx > 255 else np.uint8)


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
    if form == "gray_low":
        g = x[..., 0] * {2: 85, 4: 17}[bits]
        return (255 - g if lay.photo == 0 else g).astype(np.uint8)
    if form == "int":
        return _mode_i(lay, x[..., 0])
    if form == "lab":
        return lab.lab_to_rgb(np.ascontiguousarray(x[..., :3]))
    if form == "gray":
        g = x[..., 0]
        if bits == 8 and lay.photo == 0:
            g = 255 - g
        return np.ascontiguousarray(g.astype(np.uint16 if bits == 16
                                             else np.uint8))
    if form == "float":
        f = x[..., 0]
        if lay.e == ">" and lay.comp != 1:
            f = f.byteswap()   # host-order samples unpacked as big-endian
        return _rgb(_float_to_l(f.astype(np.float32)))
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
    if cmap is None or len(cmap) % 3 or len(cmap) > 3 * 256:
        raise ValueError("palette TIFF without a ColorMap of 3 x n "
                         "entries, n <= 256")
    # PIL's "RGB;L" palette: indices past a short ColorMap are black
    lut = np.zeros((256, 3), np.uint8)
    lut[:len(cmap) // 3] = np.asarray(cmap, np.uint32).reshape(3, -1).T \
        // 256
    return lut[x[..., 0]]
