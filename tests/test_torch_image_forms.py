"""The port's image decoding without PIL against the JAX package's with PIL.

Every form is written here with numpy, zlib and struct (or with PIL
where PIL can write it): PNGs in every color type and bit depth, every
filter type forced per row, Adam7 interlacing, palettes; BMPs; TIFFs
(16-bit RGB, palette, Deflate with and without the predictor, planar);
JPEGs (PIL's: gray and RGB, every subsampling it writes, two qualities,
baseline and progressive, optimised tables, restart intervals, odd
sizes; testing.encode_jpeg's: the sampling factors PIL cannot write);
GIFs (global and local tables, interlaced, transparency, a grey ramp,
indices past a short table, a frame inside its screen). The port's
read_image, with PIL hidden and the native decoder disabled, must give
what the JAX package's read_image gives through PIL: the same ImageType,
dtype and values. A 16-bit RGB TIFF is read by the native decoder in both
packages; its cut to 8 bits is the port's own and is held to PIL's.

What the port still refuses raises ValueError naming the form. The
engine names a target it skips (a truncated JPEG, which PIL refuses too)
and scores the rest as without it; JPEG, GIF and palette TIFF targets
decoded without PIL give the matches of the run with PIL. The files of
tests/torch_forms/ and their pinned pixels and matches, which
chip_smoke.py holds the card to, still agree with PIL and the engine.
"""

import importlib
import io
import logging
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from colormipsearch_tpu.io import image as jimage
from colormipsearch_tpu.io import native_decoder as jnative
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.io import image as timage
from colormipsearch_tpu_torch.io import native_decoder as tnative


_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """samples [h, w, c] -> the row bytes uint8 [h, row bytes]."""
    h = samples.shape[0]
    if depth == 16:
        return np.ascontiguousarray(samples.astype(">u2")).view(np.uint8) \
            .reshape(h, -1)
    flat = samples.reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat
    per = 8 // depth
    n = -(-flat.shape[1] // per)
    padded = np.zeros((h, n * per), np.uint8)
    padded[:, :flat.shape[1]] = flat
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return (padded.reshape(h, n, per) << shifts).sum(2).astype(np.uint8)


def _filter_rows(rows: np.ndarray, types, bpp: int) -> np.ndarray:
    """Apply PNG filter types[r] to row r (the encoder side) -> uint8
    [h, 1 + row bytes]."""
    x = rows.astype(np.int32)
    up = np.vstack([np.zeros((1, x.shape[1]), np.int32), x[:-1]])
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    ul = np.zeros_like(x)
    ul[:, bpp:] = up[:, :-bpp]
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    preds = [np.zeros_like(x), left, up, (left + up) >> 1, paeth]
    out = np.zeros((x.shape[0], 1 + x.shape[1]), np.uint8)
    for r, t in enumerate(types):
        out[r, 0] = t
        out[r, 1:] = (x[r] - preds[t][r]) & 0xFF
    return out


def _png(samples: np.ndarray, depth: int, color: int, *, filters=None,
         interlace: bool = False, palette=None, rng=None) -> bytes:
    """A PNG of samples [h, w, channels]; filters: one type for every
    row, or None for a random type per row."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    stream = []
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack_rows(sub, depth)
        types = (rng.integers(0, 5, rows.shape[0]) if filters is None
                 else [filters] * rows.shape[0])
        stream.append(_filter_rows(rows, types, bpp).tobytes())
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    idat = zlib.compress(b"".join(stream), 6)
    # two IDAT chunks: the decoder must join them
    return (out + _chunk(b"IDAT", idat[:len(idat) // 2])
            + _chunk(b"IDAT", idat[len(idat) // 2:]) + _chunk(b"IEND", b""))


def _bmp(rgb_or_idx: np.ndarray, bits: int, *, top_down=False,
         palette=None, colors_field=None) -> bytes:
    h, w = rgb_or_idx.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    px = np.zeros((h, stride), np.uint8)
    if bits == 8:
        px[:, :w] = rgb_or_idx
    else:
        n = bits // 8
        bgr = np.zeros((h, w, n), np.uint8)
        bgr[..., :3] = rgb_or_idx[..., ::-1]
        if n == 4:
            bgr[..., 3] = 77       # the fourth byte is not alpha
        px[:, :w * n] = bgr.reshape(h, -1)
    if not top_down:
        px = px[::-1]
    pal = b""
    if palette is not None:
        bgrx = np.zeros((len(palette), 4), np.uint8)
        bgrx[:, :3] = palette[:, ::-1]
        pal = bgrx.tobytes()
    off = 14 + 40 + len(pal)
    colors = len(palette) if colors_field is None and palette is not None \
        else (colors_field or 0)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1,
                       bits, 0, stride * h, 2835, 2835, colors, 0)
    head = struct.pack("<2sIHHI", b"BM", off + stride * h, 0, 0, off)
    return head + info + pal + px.tobytes()


def _pil(save, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    save(Image).save(buf, **kw)
    return buf.getvalue()


def _form(name: str) -> bytes:
    """The bytes of one form, made from a seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    h, w = 13, 11
    kind, _, rest = name.partition("-")
    if kind == "png":
        if rest.startswith("filter"):
            rgb = rng.integers(0, 256, (h, w, 3))
            return _png(rgb, 8, 2, filters=int(rest[-1]))
        if rest == "palette_short":
            # indices past a 5-entry PLTE
            return _png(rng.integers(0, 256, (h, w, 1)), 8, 3, rng=rng,
                        palette=rng.integers(0, 256, (5, 3)))
        if rest.startswith("adam7"):
            depth, color, h, w = (int(x) for x in rest.split("_")[1:])
            c = _CHANNELS[color]
            samples = rng.integers(0, 1 << depth, (h, w, c))
            pal = (rng.integers(0, 256, (1 << depth, 3)) if color == 3
                   else None)
            return _png(samples, depth, color, interlace=True, palette=pal,
                        rng=rng)
        color, depth = (int(x) for x in rest.split("_"))
        c = _CHANNELS[color]
        if color == 3:
            n = min(1 << depth, 200)
            samples = rng.integers(0, n, (h, w, c))
            return _png(samples, depth, color, rng=rng,
                        palette=rng.integers(0, 256, (n, 3)))
        samples = rng.integers(0, 1 << depth, (h, w, c))
        return _png(samples, depth, color, rng=rng)
    if kind == "pil":
        rgb = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        rgb[:, :4] = 0          # runs that favour other filter choices
        if rest == "rgb":
            return _pil(lambda im: im.fromarray(rgb), format="PNG",
                        optimize=True)
        if rest == "palette":
            return _pil(lambda im: im.fromarray(rgb).quantize(7),
                        format="PNG")
        return _pil(lambda im: im.fromarray(rgb), format="PNG",
                    compress_level=9)
    if kind == "bmp":
        rgb = rng.integers(0, 256, (h, w, 3))
        if rest == "24":
            return _bmp(rgb, 24)
        if rest == "24_top_down":
            return _bmp(rgb, 24, top_down=True)
        if rest == "32":
            return _bmp(rgb, 32)
        if rest == "32_top_down":
            return _bmp(rgb, 32, top_down=True)
        idx = rng.integers(0, 256, (h, w))
        if rest == "8_palette":
            return _bmp(idx, 8, palette=rng.integers(0, 256, (256, 3)))
        if rest == "8_short_palette":
            return _bmp(idx % 16, 8, palette=rng.integers(0, 256, (16, 3)))
        if rest == "8_past_palette":
            return _bmp(idx, 8, palette=rng.integers(0, 256, (16, 3)))
        if rest == "8_gray":
            return _bmp(idx, 8, palette=np.repeat(np.arange(256)[:, None],
                                                  3, 1))
        if rest == "8_gray_top_down":
            return _bmp(idx, 8, top_down=True,
                        palette=np.repeat(np.arange(256)[:, None], 3, 1))
    if kind == "tiff" and rest.startswith("rgb16"):
        rgb16 = rng.integers(0, 1 << 16, (h, w, 3))
        rgb16[0, :4] = [[0] * 3, [255] * 3, [256] * 3, [65535] * 3]
        return testing.encode_tiff(rgb16.astype(np.uint16), photometric=2,
                                   big_endian=rest == "rgb16_be")
    if kind == "tiff" and rest.split("_")[0] in _OPEN_FAULT_KINDS:
        return _tiff_open_fault(rng, rest)
    if kind == "tiff":
        return _tiff_form(rng, rest, h, w)
    if kind == "jpeg":
        return _jpeg_form(rng, rest)
    if kind == "gif":
        return _gif_form(rng, rest)
    if kind == "edge":
        return _edge(rest)
    raise KeyError(name)


def _cdm_like(rng, h, w):
    """Strokes of colour on black, as a colour depth MIP, plus some
    noise: every block has detail, most of them sparse."""
    img = testing.synthetic_cdm(rng, h, w, fg_fraction=0.3)
    noise = rng.random((h, w)) < 0.05
    img[noise] = rng.integers(0, 256, (int(noise.sum()), 3))
    return img


def _jpeg_form(rng, rest: str) -> bytes:
    """jpeg-pil_<mode>_<subsampling>_<quality>[_prog][_opt][_rst][_HxW]:
    written by PIL; jpeg-enc_<sampling>[_rst][_HxW] by
    testing.encode_jpeg (sampling h1v1.h2v2... per component); jpeg-cmyk_*,
    jpeg-arith_*, jpeg-lossless_*, jpeg-cut_* and jpeg-corrupt_* as their
    helpers below say."""
    parts = rest.split("_")
    h, w = 13, 11
    if "x" in parts[-1]:
        h, w = (int(v) for v in parts.pop().split("x"))
    img = _cdm_like(rng, h, w)
    kind = parts[0]
    if kind == "cmyk":
        return _jpeg_cmyk(rng, parts, h, w)
    if kind == "arith":
        return _jpeg_arith(img, parts)
    if kind == "lossless":
        return _jpeg_lossless(img, parts)
    if kind == "cut":
        return _jpeg_cut(img, parts)
    if kind == "corrupt":
        return _jpeg_corrupt(rng, img, parts)
    if kind == "enc":
        sampling = tuple((int(f[1]), int(f[3])) for f in parts[1].split("."))
        ids = (82, 71, 66) if "rgbids" in parts else (1, 2, 3)
        return testing.encode_jpeg(
            img if len(sampling) == 3 else img[..., 1], quality=85,
            sampling=sampling, restart_interval=3 if "rst" in parts else 0,
            component_ids=ids, jfif="rgbids" not in parts)
    mode, sub, quality = parts[1], int(parts[2]), int(parts[3])
    kw = dict(quality=quality, progressive="prog" in parts,
              optimize="opt" in parts)
    if mode == "rgb":
        kw["subsampling"] = sub
    if "rst" in parts:
        kw["restart_marker_blocks"] = 2
    src = img if mode == "rgb" else img[..., 0]
    return _pil(lambda im: im.fromarray(src), format="JPEG", **kw)


def _jpeg_cmyk(rng, parts, h, w) -> bytes:
    """jpeg-cmyk_pil[_<quality>]: PIL's CMYK JPEG (Adobe transform 0);
    jpeg-cmyk_<transform|none>[_sub]: four planes under an Adobe marker
    of that transform (2: YCCK), or none, by testing.encode_jpeg, the
    first and last planes 2x2 with _sub."""
    planes = np.concatenate([_cdm_like(rng, h, w),
                             rng.integers(0, 256, (h, w, 1))], -1)
    planes = planes.astype(np.uint8)
    if parts[1] == "pil":
        q = int(parts[2]) if len(parts) > 2 else 75
        return _pil(lambda im: im.fromarray(planes, "CMYK"), format="JPEG",
                    quality=q)
    sampling = ((2, 2), (1, 1), (1, 1), (2, 2)) if "sub" in parts else None
    return testing.encode_jpeg(
        planes, quality=80, sampling=sampling, jfif=False,
        adobe_transform=None if parts[1] == "none" else int(parts[1]))


def _jpeg_arith(img, parts) -> bytes:
    """jpeg-arith_<seq|prog>_<gray|444|420|422>[_rst][_dac]: an
    arithmetic-coded JPEG by testing.encode_jpeg (DAC: L 1, U 3 and K 10
    on table 0, L 0, U 2, K 2 on table 1)."""
    sampling = {"gray": None, "444": None, "420": ((2, 2), (1, 1), (1, 1)),
                "422": ((2, 1), (1, 1), (1, 1))}[parts[2]]
    src = img[..., 0] if parts[2] == "gray" else img
    return testing.encode_jpeg(
        src, quality=85, sampling=sampling, arithmetic=True,
        progressive=parts[1] == "prog",
        restart_interval=2 if "rst" in parts else 0,
        dac={0: 0x31, 1: 0x20, 16: 10, 17: 2} if "dac" in parts else None)


def _jpeg_lossless(img, parts) -> bytes:
    """jpeg-lossless_p<predictor>_t<point transform>[_gray][_420]
    [_planar][_rst]: testing.encode_jpeg_lossless (restarts every MCU
    row)."""
    psv, pt = int(parts[1][1:]), int(parts[2][1:])
    gray = "gray" in parts
    src = img[..., 0] if gray else img
    if "cmyk" in parts:
        k = (img.sum(-1) // 3)[..., None].astype(np.uint8)
        return testing.encode_jpeg_lossless(
            np.concatenate([img, k], -1), predictor=psv,
            point_transform=pt, component_ids=(1, 2, 3, 4))
    sampling = ((2, 2), (1, 1), (1, 1)) if "420" in parts else None
    per_row = img.shape[1] if gray or "planar" in parts or not sampling \
        else -(-img.shape[1] // 2)
    return testing.encode_jpeg_lossless(
        src, predictor=psv, point_transform=pt, sampling=sampling,
        interleaved="planar" not in parts,
        restart_interval=per_row if "rst" in parts else 0)


def _scan_starts(data: bytes) -> list:
    """The offsets of a JPEG's SOS markers."""
    out, at = [], data.find(b"\xff\xda")
    while at >= 0:
        out.append(at)
        at = data.find(b"\xff\xda", at + 2)
    return out


def _jpeg_cut(img, parts) -> bytes:
    """jpeg-cut_<scans>_<pil sub|arith>: a progressive JPEG (PIL's at
    that subsampling, or testing.encode_jpeg's arithmetic-coded 4:2:0)
    cut after its first <scans> scans, EOI appended: libjpeg smooths the
    blocks whose AC coefficients the scans leave inexact."""
    n = int(parts[1])
    if parts[2] == "arith":
        data = testing.encode_jpeg(img, quality=85, arithmetic=True,
                                   progressive=True,
                                   sampling=((2, 2), (1, 1), (1, 1)))
    elif parts[2] == "gray":
        data = _pil(lambda im: im.fromarray(img[..., 0]), format="JPEG",
                    quality=85, progressive=True)
    else:
        data = _pil(lambda im: im.fromarray(img), format="JPEG", quality=85,
                    progressive=True, subsampling=int(parts[2]))
    starts = _scan_starts(data)
    return data[:starts[n]] + b"\xff\xd9" if n < len(starts) else data


def _entropy_ranges(data: bytes) -> list:
    """(start, end) of each scan's entropy-coded data."""
    out = []
    for at in _scan_starts(data):
        (length,) = struct.unpack(">H", data[at + 2:at + 4])
        start = end = at + 2 + length
        while True:
            end = data.index(b"\xff", end)
            if data[end + 1] == 0 or 0xD0 <= data[end + 1] <= 0xD7:
                end += 2
                continue
            break
        out.append((start, end))
    return out


def _jpeg_corrupt(rng, img, parts) -> bytes:
    """jpeg-corrupt_<bytes|renumber|drop|dup>_<base|rst|prog|prog_rst>:
    a PIL-written JPEG with 1-3 entropy-coded bytes replaced (never
    making or breaking a 0xFF), or one restart marker renumbered,
    dropped or doubled; libjpeg warns, and PIL returns an image."""
    what, base = parts[1], "_".join(parts[2:])
    kw = {"quality": 85, "progressive": base.startswith("prog")}
    if base.endswith("rst"):
        kw["restart_marker_blocks"] = 1 if kw["progressive"] else 2
    data = bytearray(_pil(lambda im: im.fromarray(img), format="JPEG", **kw))
    if what == "bytes":
        ranges = _entropy_ranges(bytes(data))
        for _ in range(int(rng.integers(1, 4))):
            start, end = ranges[int(rng.integers(len(ranges)))]
            for _ in range(100):
                k = int(rng.integers(start, end))
                v = int(rng.integers(0, 255))
                if data[k] != 0xFF and data[k - 1] != 0xFF and v != data[k]:
                    data[k] = v
                    break
        return bytes(data)
    rst = [k for k in range(len(data) - 1)
           if data[k] == 0xFF and 0xD0 <= data[k + 1] <= 0xD7]
    k = rst[int(rng.integers(len(rst)))]
    if what == "renumber":
        data[k + 1] = 0xD0 + (data[k + 1] - 0xD0 + int(rng.integers(1, 8))) % 8
    elif what == "drop":
        del data[k:k + 2]
    else:
        data[k:k] = data[k:k + 2]
    return bytes(data)


def _gif_form(rng, rest: str) -> bytes:
    """gif-<form>: testing.encode_gif, or gif-pil_* written by PIL."""
    h, w = 13, 11
    idx = rng.integers(0, 16, (h, w)).astype(np.uint8)
    pal = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    if rest == "pil_quantized":
        return _pil(lambda im: im.fromarray(_cdm_like(rng, 37, 29))
                    .quantize(200), format="GIF")
    if rest == "pil_interlaced":
        return _pil(lambda im: im.fromarray(_cdm_like(rng, 37, 29))
                    .quantize(64), format="GIF", interlace=True)
    if rest == "table_full":      # LZW codes reach 12 bits, clears
        big = rng.integers(0, 256, (90, 110)).astype(np.uint8)
        return testing.encode_gif(big, rng.integers(0, 256, (256, 3)))
    forms = {
        "global": {}, "local": {"local_table": True},
        "interlaced": {"interlace": True},
        "transparency": {"transparency": 5},
        "offset_transparency": {"transparency": 7, "offset": (3, 2)},
        "offset": {"offset": (3, 2)},
    }
    if rest in forms:
        return testing.encode_gif(idx, pal, **forms[rest])
    if rest == "grey_ramp":
        return testing.encode_gif(idx, np.repeat(np.arange(16)[:, None], 3,
                                                 1))
    if rest == "local_grey_ramp":   # a ramp overrides the global table
        out = testing.encode_gif(idx, np.repeat(np.arange(16)[:, None], 3,
                                                1), local_table=True)
        # the same frame behind a global table of colours
        head = out[:10] + bytes([out[10] | 0x80 | 3]) + out[11:13]
        return head + pal.tobytes() + out[13:]
    if rest == "short_table":       # indices 0..15 past a 5-colour table
        return testing.encode_gif(idx, pal[:5])
    if rest == "two_colours":
        return testing.encode_gif(idx % 2, pal[:2])
    raise KeyError(rest)


def _tiff_form(rng, rest: str, h: int, w: int) -> bytes:
    """tiff-<photometric>_<bits>[_deflate|_adobe][_pred][_planar][_be]
    by testing.encode_tiff; tiff-pil_* written by PIL; tiff-bits_*,
    tiff-assoc_*, tiff-float_* by testing.encode_tiff; tiff-tile_* and
    tiff-fill2_* assembled by testing.encode_tiff_chunks around chunks
    PIL coded."""
    if rest.startswith("pil_"):
        return _tiff_pil(rng, rest[4:], h, w)
    if rest.startswith(("tile_", "fill2_")):
        return _tiff_chunked(rng, rest)
    parts = rest.split("_")
    if parts[0] == "fax":
        # testing.encode_fax: tiff-fax_<g3|g4>_<1d|2d>_<photometric>
        # [_fill2]_<h>x<w>, runs past 64 and 2,560 at the widths used
        fh, fw = (int(v) for v in parts[-1].split("x"))
        on = (_cdm_like(rng, fh, fw).max(-1) > 60).astype(np.uint8)
        on[1 % fh] = 1
        group, two_d = int(parts[1][1]), parts[2] == "2d"
        options = int(two_d) if group == 3 else 0
        return testing.encode_tiff_chunks(
            [testing.encode_fax(on, group=group, two_d=two_d)], w=fw, h=fh,
            bits=[1], photometric=int(parts[3]), compression=group,
            extra_tags={} if group == 2 else {
                292 if group == 3 else 293: [options]},
            fill_order=2 if "fill2" in parts else 1)
    if parts[0] == "bilevel":
        # uncompressed 1-bit, WhiteIsZero (0) or BlackIsZero (1)
        on = rng.integers(0, 2, (h, w, 1)).astype(np.uint8)
        return testing.encode_tiff(on, photometric=int(parts[1]), bits=1,
                                   rows_per_strip=4,
                                   fill_order=2 if "fill2" in parts else 1)
    if parts[0] == "bits":
        # palette at 1, 2 or 4 bits, raw or Deflate
        bits = int(parts[1])
        idx = rng.integers(0, 1 << bits, (h, w, 1)).astype(np.uint8)
        cmap = rng.integers(0, 1 << 16, (3, 1 << bits)).astype(np.uint16)
        return testing.encode_tiff(
            idx, photometric=3, bits=bits, colormap=cmap,
            compression=8 if "deflate" in parts else 1, rows_per_strip=4,
            big_endian="be" in parts)
    if parts[0] == "assoc":
        # RGB + associated alpha: every alpha, 0 and 255 included
        rgba = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
        rgba[0, :3, 3] = (0, 255, 1)
        return testing.encode_tiff(
            rgba, photometric=2, extra_tags={338: [1]},
            compression=8 if "deflate" in parts else 1, rows_per_strip=5)
    if parts[0] == "float":
        x = rng.uniform(-40, 300, (h, w, 1)).astype(np.float32)
        x[0, :6, 0] = (np.nan, np.inf, -np.inf, 254.99, 0.5, 255.0)
        comp = 8 if "deflate" in parts else 1
        if "be" in parts and comp != 1:
            # PIL reads these byte-swapped: store the swapped values, so
            # that what it reads is x
            x = x.byteswap()
        return testing.encode_tiff(
            x, photometric=1, big_endian="be" in parts, compression=comp,
            predictor=2 if "pred" in parts else 1, rows_per_strip=5)
    photo = {"gray": 1, "wiz": 0, "rgb": 2, "palette": 3}[parts[0]]
    bits = int(parts[1])
    spp = 3 if photo == 2 else 1
    samples = rng.integers(0, 1 << bits, (h, w, spp)).astype(
        np.uint16 if bits == 16 else np.uint8)
    comp = 8 if "deflate" in parts else 32946 if "adobe" in parts else 1
    cmap = (rng.integers(0, 1 << 16, (3, 256)).astype(np.uint16)
            if photo == 3 else None)
    return testing.encode_tiff(
        samples, photometric=photo, compression=comp,
        predictor=2 if "pred" in parts else 1,
        planar=2 if "planar" in parts else 1, big_endian="be" in parts,
        rows_per_strip=5, colormap=cmap)


# PIL's names of the TIFF compressions the tests write with it
_PIL_COMPRESSION = {"raw": None, "lzw": "tiff_lzw", "packbits": "packbits",
                    "deflate": "tiff_adobe_deflate", "g3": "group3",
                    "g4": "group4", "jpeg": "jpeg", "ccitt": "tiff_ccitt",
                    "lzma": "lzma", "zstd": "zstd"}


def _bilevel(rng, h, w):
    """A 1-bit image with runs of every length: strokes, noise, a black
    row, a white row (runs longer than 64 and 1,728 at w >= 1,792)."""
    on = _cdm_like(rng, h, w).max(-1) > 60
    on[1] = True
    on[2] = False
    on[3, ::2] = True
    return Image.fromarray(on)


def _tiff_image(rng, mode: str, h: int, w: int):
    if mode == "1":
        return _bilevel(rng, h, w)
    if mode == "I":
        return Image.fromarray(_int_samples(rng, np.int32, "u16", h, w)
                               [..., 0], "I")
    if mode == "F":
        x = rng.uniform(-40, 300, (h, w)).astype(np.float32)
        x[0, :4] = (np.nan, np.inf, -np.inf, 255.5)
        return Image.fromarray(x, "F")
    rgb = _cdm_like(rng, h, w)
    if mode in ("RGBA", "LA"):
        alpha = rng.integers(0, 256, (h, w, 1)).astype(np.uint8)
        img = Image.fromarray(np.concatenate([rgb, alpha], -1), "RGBA")
        return img if mode == "RGBA" else img.convert("LA")
    if mode == "CMYK":
        k = rng.integers(0, 256, (h, w, 1)).astype(np.uint8)
        return Image.fromarray(np.concatenate([rgb, k], -1), "CMYK")
    if mode == "LAB":
        return Image.fromarray(rng.integers(0, 256, (h, w, 3))
                               .astype(np.uint8), "LAB")
    if mode == "PA":
        return Image.fromarray(rgb).quantize(40).convert("PA")
    return Image.fromarray(rgb).convert(mode)


def _tiff_pil(rng, rest: str, h: int, w: int) -> bytes:
    """tiff-pil_<mode>[_<compression>][_<option>]: an image PIL writes in
    that mode (1, F, LA, RGBA, CMYK, RGB, YCbCr, L, palette, LAB, PA) and
    compression; options: g3 2d and fill (Group3Options 1 and 5), strips
    (several strips: PIL's strip_size), big (40 x 1,900), fo2 (FillOrder
    2), pred (the horizontal predictor)."""
    parts = rest.split("_")
    mode = {"palette": "P", "ycbcr": "YCbCr", "rgb": "RGB", "l": "L",
            "f": "F", "la": "LA", "rgba": "RGBA", "cmyk": "CMYK",
            "1": "1", "lab": "LAB", "pa": "PA", "i": "I"}.get(parts[0],
                                                              parts[0])
    comp = _PIL_COMPRESSION[parts[1] if len(parts) > 1 else "raw"]
    kw = {} if comp is None else {"compression": comp}
    if "2d" in parts:
        kw["tiffinfo"] = {292: 1}
    if "fill" in parts:
        kw["tiffinfo"] = {292: 5}
    if "strips" in parts:
        kw["strip_size"] = 600
    if "fo2" in parts:
        kw["tiffinfo"] = {266: 2}
    if "pred" in parts:
        kw["tiffinfo"] = {317: 2}
    if comp == "jpeg":
        kw["quality"] = 85
    big = mode == "1" and "big" in parts
    if mode == "P":
        img = Image.fromarray(_cdm_like(rng, h, w)).quantize(40)
    else:
        img = _tiff_image(rng, mode, 40 if big else h, 1900 if big else w)
    return _pil(lambda im: img, format="TIFF", **kw)


def _pil_chunk(img, comp: str) -> tuple:
    """One strip or tile as PIL codes it: (its bytes, the tags of the
    one-strip TIFF PIL wrote)."""
    from colormipsearch_tpu_torch.io import tiff as ttiff

    kw = {} if comp == "raw" else {"compression": _PIL_COMPRESSION[comp]}
    if comp == "jpeg":
        kw["quality"] = 85
    data = _pil(lambda im: img, format="TIFF",
                strip_size=1 << 30, **kw)
    _, tags = ttiff._ifd(data)
    (off,), (count,) = tags[273], tags[279]
    return data[off:off + count], tags


def _tiff_chunked(rng, rest: str) -> bytes:
    """tiff-tile_<mode>_<compression>[_<tw>x<th>]: a 37 x 29 image in
    tiles (16 x 16 unless named: edge tiles overhang) or tiff-fill2_<mode>
    _<compression>: in strips of 5 rows with FillOrder 2, each chunk coded
    by PIL, the container by testing.encode_tiff_chunks."""
    parts = rest.split("_")
    kind, mode, comp = parts[0], parts[1], parts[2]
    h, w = 37, 29
    mode = {"rgb": "RGB", "ycbcr": "YCbCr", "l": "L", "1": "1",
            "rgba": "RGBA", "cmyk": "CMYK"}[mode]
    full = np.asarray(_tiff_image(rng, mode, h, w))
    if kind == "tile":
        tw, th = (int(v) for v in parts[3].split("x")) if len(parts) > 3 \
            else (16, 16)
        boxes = [(y, x) for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        tw, th = w, 5
        boxes = [(y, 0) for y in range(0, h, th)]
    chunks, tags = [], None
    for y, x in boxes:
        tile = np.zeros((th, tw) + full.shape[2:], full.dtype)
        part = full[y:y + th, x:x + tw]
        tile[:part.shape[0], :part.shape[1]] = part
        if kind == "fill2":
            tile = tile[:part.shape[0]]
        if comp == "jpeg22":
            # YCbCr 2x2, which PIL cannot write: testing.encode_jpeg's
            # whole streams, their tables inline
            data = testing.encode_jpeg(
                tile, quality=85, jfif=False,
                sampling=((2, 2), (1, 1), (1, 1)))
            tags = {258: (8, 8, 8), 259: (7,), 262: (6,), 277: (3,),
                    530: (2, 2)}
        else:
            data, tags = _pil_chunk(Image.fromarray(tile, mode), comp)
        chunks.append(data)
    keep = {t: list(v) for t, v in tags.items()
            if t in (277, 284, 292, 293, 338, 339, 530)}
    if 347 in tags:
        keep[347] = bytes(tags[347])
    return testing.encode_tiff_chunks(
        chunks, w=w, h=h, bits=list(tags.get(258, (1,))),
        photometric=tags[262][0],
        compression=tags[259][0], chunk=(tw, th), tiled=kind == "tile",
        extra_tags=keep, fill_order=2 if kind == "fill2" else 1)


# tiff-<kind>_...: the forms ROADMAP listed as open faults (PIL reads
# them, the port refused them before)
_OPEN_FAULT_KINDS = ("lab", "pa", "px", "int", "low", "lzma", "zstd")
# mode "I" samples: (dtype, big-endian, sample format)
_INT_KINDS = {"16s": (np.int16, False, 2), "16s_be": (np.int16, True, 2),
              "32u": (np.uint32, False, 1), "32s": (np.int32, False, 2),
              "32s_be": (np.int32, True, 2), "32u_be": (np.uint32, True, 1)}


def _int_samples(rng, dtype, what: str, h: int = 13, w: int = 11):
    """Integer gray samples: u8 (0..255), u16 (0..65535, some above 255;
    0..32767 for int16), out (some negative, or above 65535)."""
    top = {"u8": 256, "u16": min(65536, np.iinfo(dtype).max + 1)}.get(what)
    if top is not None:
        x = rng.integers(0, top, (h, w, 1))
        if what == "u16":
            x[0, 0, 0] = top - 1
        return x.astype(dtype)
    x = rng.integers(0, 256, (h, w, 1)).astype(np.int64)
    x[0, 0, 0] = 70000 if dtype == np.uint32 else -3
    return x.astype(dtype)


def _tiff_open_fault(rng, rest: str) -> bytes:
    """tiff-lab_all: every LAB triple once (4,096 x 4,096); tiff-pa_short:
    8-bit palette + alpha, a 16-entry ColorMap, indices up to 255;
    tiff-px: palette + an unspecified extra sample;
    tiff-int_<kind>_<u8|u16>_<raw|deflate>[_pred]: mode "I" samples
    (_INT_KINDS), with the horizontal predictor on request;
    tiff-low_<2|4>_<wiz|biz>_<compression>[_fill2]: 2- and 4-bit gray;
    tiff-lzma_<form> and tiff-zstd_<form>: see _tiff_lzma, _tiff_zstd."""
    parts = rest.split("_")
    kind = parts[0]
    if kind == "lab":
        v = np.arange(256, dtype=np.uint8)
        lab = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1)
        return testing.encode_tiff(lab.reshape(4096, 4096, 3), photometric=8,
                                   rows_per_strip=256)
    if kind in ("pa", "px"):
        idx = rng.integers(0, 256, (13, 11, 2)).astype(np.uint8)
        cmap = rng.integers(0, 1 << 16, (3, 16 if kind == "pa" else 256))
        return testing.encode_tiff(idx, photometric=3,
                                   colormap=cmap.astype(np.uint16),
                                   extra_tags={338: [2 if kind == "pa"
                                                     else 0]})
    if kind == "int":
        pred = parts[-1] == "pred"
        parts = parts[:-1] if pred else parts
        name = parts[1] + ("_be" if "be" in parts else "")
        dtype, big, fmt = _INT_KINDS[name]
        x = _int_samples(rng, dtype, parts[-2])
        comp = {"raw": 1, "deflate": 8, "zstd": 50000}[parts[-1]]
        if big and comp != 1:
            # PIL reads these byte-swapped: store the swapped values, so
            # that what it reads lies in the range named
            x = x.byteswap()
        return testing.encode_tiff(
            x.view({2: np.uint16, 4: np.uint32}[x.itemsize]),
            photometric=1, big_endian=big, compression=comp,
            predictor=2 if pred else 1, rows_per_strip=5,
            extra_tags={339: [fmt]})
    if kind == "low":
        bits = int(parts[1])
        x = rng.integers(0, 1 << bits, (37, 29, 1)).astype(np.uint8)
        comp = {"raw": 1, "packbits": 32773, "lzw": 5, "deflate": 8}[parts[3]]
        return testing.encode_tiff(
            x, photometric=0 if parts[2] == "wiz" else 1, bits=bits,
            compression=comp, rows_per_strip=8,
            fill_order=2 if "fill2" in parts else 1)
    if kind == "lzma":
        return _tiff_lzma(rng, parts[1:])
    return _tiff_zstd(rng, parts[1:])


def _tiff_lzma(rng, parts) -> bytes:
    """tiff-lzma_<rgb|gray16_pred>: LZMA strips of testing.encode_tiff
    (RGB; 16-bit gray with the predictor)."""
    if parts[0] == "rgb":
        return testing.encode_tiff(_cdm_like(rng, 37, 29), photometric=2,
                                   compression=34925, rows_per_strip=8)
    return testing.encode_tiff(
        rng.integers(0, 1 << 16, (37, 29, 1)).astype(np.uint16),
        photometric=1, compression=34925, predictor=2, rows_per_strip=8)


def _tiff_zstd(rng, parts) -> bytes:
    """tiff-zstd_<form>: Zstandard strips. pil_*: libzstd's frames through
    PIL (libtiff writes no content size and no checksum): cdm (566 x 1210
    CDM-like RGB, 4-stream Huffman literals, FSE and repeated sequence
    tables), onestrip (the same in one 2 MB strip: many blocks, treeless
    literals), pred (the predictor), noise (incompressible: raw literals
    and raw blocks), flat (zero strips: RLE blocks and literals), levels
    (3 byte values: few Huffman symbols), gray16 (16-bit), small (13 x 11:
    predefined tables), tiny4 (10 x 12 of 4 values: one Huffman stream,
    weights written directly), four (600 x 1000 of 4 values in one strip:
    treeless literals). enc_*: testing's encoders, for what libtiff never
    writes: enc_check (content size and checksum, raw and RLE blocks of
    1,000 bytes), enc_single (one segment), enc_skip (a skippable frame
    first, no content size: libtiff stops after it, as the port does),
    enc_sequences (testing.encode_zstd_sequences: RLE literals, RLE
    sequence tables, the repeat offset "first minus one")."""
    what = parts[0]
    if what == "pil":
        form = parts[1]
        h, w = {"small": (13, 11), "noise": (120, 200), "flat": (300, 400),
                "levels": (200, 300), "gray16": (200, 300),
                "tiny4": (10, 12), "four": (600, 1000)}.get(form, (566, 1210))
        kw = {"compression": "zstd"}
        if form in ("tiny4", "four"):
            img = Image.fromarray(rng.integers(0, 4, (h, w)).astype(np.uint8))
        elif form == "noise":
            img = Image.fromarray(rng.integers(0, 256, (h, w, 3))
                                  .astype(np.uint8))
        elif form == "flat":
            x = np.zeros((h, w, 3), np.uint8)
            x[h // 2:h // 2 + 3, :5] = 200
            img = Image.fromarray(x)
        elif form == "levels":
            img = Image.fromarray(rng.choice([0, 40, 255], (h, w))
                                  .astype(np.uint8))
        elif form == "gray16":
            img = Image.fromarray(rng.integers(0, 1 << 12, (h, w))
                                  .astype(np.uint16))
        else:
            img = Image.fromarray(_cdm_like(rng, h, w))
        if form == "pred":
            kw["tiffinfo"] = {317: 2}
        if form in ("onestrip", "four"):
            kw["strip_size"] = 1 << 22
        return _pil(lambda im: img, format="TIFF", **kw)
    if parts[1] == "sequences":
        frame, content = testing.encode_zstd_sequences()
        return testing.encode_tiff_chunks(
            [frame], w=13, h=2, bits=[8], photometric=1, compression=50000)
    x = _cdm_like(rng, 37, 29)
    x[10:30] = 0
    raw = x.tobytes()
    frame = {"check": lambda: testing.encode_zstd(
                 raw, block_size=1000, checksum=True),
             "single": lambda: testing.encode_zstd(
                 raw, block_size=870, single_segment=True),
             "skip": lambda: testing.encode_zstd(
                 raw, content_size=False, skippable=b"ignored")}[parts[1]]()
    return testing.encode_tiff_chunks(
        [frame], w=29, h=37, bits=[8, 8, 8], photometric=2,
        compression=50000, extra_tags={277: [3]})


FORMS = (
    # every color type at every bit depth it allows, random filters
    [f"png-0_{d}" for d in (1, 2, 4, 8, 16)]
    + [f"png-2_{d}" for d in (8, 16)]
    + [f"png-3_{d}" for d in (1, 2, 4, 8)]
    + [f"png-4_{d}" for d in (8, 16)]
    + [f"png-6_{d}" for d in (8, 16)]
    + ["png-palette_short"]
    # one filter type forced on every row
    + [f"png-filter{t}" for t in range(5)]
    # Adam7: depth_color_h_w, passes left empty at the small sizes
    + ["png-adam7_8_2_13_11", "png-adam7_16_6_9_10", "png-adam7_2_0_7_5",
       "png-adam7_4_3_17_3", "png-adam7_1_0_1_1", "png-adam7_8_4_2_3"]
    # written by PIL: adaptive filters, a quantized palette
    + ["pil-rgb", "pil-palette", "pil-level9"]
    + ["bmp-24", "bmp-24_top_down", "bmp-32", "bmp-32_top_down",
       "bmp-8_palette", "bmp-8_short_palette", "bmp-8_past_palette",
       "bmp-8_gray", "bmp-8_gray_top_down"]
    + ["tiff-rgb16_le", "tiff-rgb16_be"]
    # TIFFs the native decoder refuses: palette, Deflate (8 and 32946)
    # with and without the predictor at 8 and 16 bits, planar RGB
    + ["tiff-palette_8", "tiff-palette_8_deflate_pred",
       "tiff-pil_palette", "tiff-pil_palette_lzw", "tiff-pil_palette_deflate",
       "tiff-gray_8_deflate", "tiff-gray_8_deflate_pred",
       "tiff-gray_16_adobe", "tiff-gray_16_adobe_pred",
       "tiff-gray_16_deflate_pred_be", "tiff-rgb_8_adobe_pred",
       "tiff-rgb_16_deflate_pred", "tiff-rgb_8_planar",
       "tiff-rgb_8_deflate_pred_planar_be", "tiff-wiz_8"]
    # TIFFs PIL writes: bilevel raw, PackBits, LZW, Deflate, CCITT Group 3
    # (1-D, 2-D, 2-D with fill bits) and Group 4, also at 1,900 columns
    # (the extended make-up codes); float, gray + alpha, RGBA, CMYK, raw
    # and LZW; JPEG-compressed RGB, gray and YCbCr (1x1 and 2x2), in one
    # strip and in several
    + [f"tiff-pil_1_{c}" for c in ("raw", "packbits", "lzw", "deflate",
                                   "g3", "g4")]
    + ["tiff-pil_1_g3_2d", "tiff-pil_1_g3_fill", "tiff-pil_1_g4_big",
       "tiff-pil_1_g3_2d_big", "tiff-pil_f", "tiff-pil_f_lzw",
       "tiff-pil_la", "tiff-pil_la_lzw", "tiff-pil_rgba",
       "tiff-pil_rgba_deflate", "tiff-pil_cmyk", "tiff-pil_cmyk_lzw",
       "tiff-pil_rgb_jpeg", "tiff-pil_rgb_jpeg_strips", "tiff-pil_l_jpeg",
       "tiff-pil_ycbcr_jpeg", "tiff-pil_ycbcr_jpeg_strips"]
    # TIFFs of testing.encode_tiff: palettes at 1, 2 and 4 bits, RGB with
    # associated alpha, float32 (NaN, infinities, out of range), the
    # uncompressed planar 16-bit RGB PIL reads as 8-bit planes
    + ["tiff-bits_1", "tiff-bits_2_deflate", "tiff-bits_4_be",
       "tiff-assoc", "tiff-assoc_deflate", "tiff-float", "tiff-float_be",
       "tiff-float_deflate", "tiff-rgb_16_planar", "tiff-rgb_16_planar_be"]
    # tiled TIFFs (16 x 16 tiles over 37 x 29: edge tiles overhang) in
    # every compression, and FillOrder 2 strips, the chunks coded by PIL
    + [f"tiff-tile_{m}_{c}" for m, c in (
        ("rgb", "raw"), ("rgb", "lzw"), ("rgb", "packbits"),
        ("rgb", "deflate"), ("1", "raw"), ("1", "g3"), ("1", "g4"),
        ("rgb", "jpeg"), ("ycbcr", "jpeg"), ("l", "jpeg"), ("rgba", "lzw"),
        ("cmyk", "raw"))]
    + ["tiff-tile_rgb_jpeg_32x16", "tiff-tile_1_g4_32x48",
       "tiff-tile_rgb_jpeg22", "tiff-tile_rgb_jpeg22_32x32"]
    + [f"tiff-fill2_1_{c}" for c in ("raw", "lzw", "packbits", "g3", "g4")]
    # CCITT strips of testing.encode_fax: Group 4, Group 3 1-D and 2-D,
    # both photometrics, FillOrder 2, widths of long runs
    + ["tiff-fax_g4_2d_0_40x150", "tiff-fax_g4_2d_1_30x1900",
       "tiff-fax_g3_1d_0_30x1900", "tiff-fax_g3_2d_1_40x150",
       "tiff-fax_g3_1d_1_fill2_40x150", "tiff-fax_g4_2d_0_fill2_13x11",
       "tiff-bilevel_0", "tiff-bilevel_1_fill2"]
    + ["tiff-fill2_rgb_deflate"]
    # JPEGs written by PIL: gray and RGB, subsampling 4:4:4, 4:2:2 and
    # 4:2:0, quality 50 and 95, baseline and progressive, optimised
    # tables, restart markers, sizes off the 8 and 16 grids
    + [f"jpeg-pil_rgb_{sub}_{q}{prog}" for sub in (0, 1, 2) for q in (50, 95)
       for prog in ("", "_prog")]
    + ["jpeg-pil_gray_0_50", "jpeg-pil_gray_0_95_prog",
       "jpeg-pil_gray_0_75_opt_rst", "jpeg-pil_rgb_2_75_opt",
       "jpeg-pil_rgb_2_75_rst_37x29", "jpeg-pil_rgb_1_90_prog_rst_37x29",
       "jpeg-pil_rgb_2_90_prog_opt_1x1", "jpeg-pil_rgb_2_90_2x3",
       "jpeg-pil_rgb_0_90_prog_17x33"]
    # JPEGs PIL cannot write: 4:4:0, chroma 1x2 under luma 2x2, 4:1:1 and
    # 3:1 (replicated), the fancy filters' narrow-plane fallback, RGB
    # without a colour transform
    + ["jpeg-enc_h1v2.h1v1.h1v1_37x29", "jpeg-enc_h2v2.h1v2.h1v2_37x29",
       "jpeg-enc_h4v1.h1v1.h1v1_37x29", "jpeg-enc_h3v1.h1v1.h1v1_37x29",
       "jpeg-enc_h2v2.h1v1.h1v1_rst_37x29", "jpeg-enc_h2v2.h1v1.h1v1_3x4",
       "jpeg-enc_h2v1.h1v1.h1v1_4x3", "jpeg-enc_h1v1.h1v1.h1v1_rgbids",
       "jpeg-enc_h2v2_37x29"]
    # four components: PIL's CMYK; testing.encode_jpeg's CMYK, YCCK
    # (Adobe transform 2, also with 2x2 planes) and no Adobe marker
    + ["jpeg-cmyk_pil", "jpeg-cmyk_pil_95_37x29", "jpeg-cmyk_0_37x29",
       "jpeg-cmyk_2_37x29", "jpeg-cmyk_2_sub_37x29", "jpeg-cmyk_none_37x29"]
    # arithmetic coding, sequential and progressive: gray, 4:4:4, 4:2:0
    # with restarts, 4:2:2 with a DAC segment
    + [f"jpeg-arith_{m}_{form}_37x29" for m in ("seq", "prog")
       for form in ("gray", "444", "420_rst", "422_dac")]
    # lossless: every predictor, point transforms 0-3, gray, 4:2:0, one
    # scan a component, a restart every MCU row
    + [f"jpeg-lossless_p{p}_t{t}_37x29" for p, t in (
        (1, 0), (2, 1), (3, 0), (4, 2), (5, 0), (6, 3), (7, 1))]
    + ["jpeg-lossless_p1_t0_gray_37x29", "jpeg-lossless_p4_t0_420_37x29",
       "jpeg-lossless_p7_t0_planar_37x29", "jpeg-lossless_p5_t1_rst_37x29",
       "jpeg-lossless_p2_t0_cmyk_37x29"]
    # progressive JPEGs cut after a scan (libjpeg's block smoothing),
    # Huffman at every subsampling and gray, and arithmetic
    + [f"jpeg-cut_{n}_{b}_{size}" for n, b, size in (
        (1, "2", "37x29"), (2, "2", "64x48"), (3, "0", "37x29"),
        (4, "1", "40x56"), (5, "2", "64x48"), (9, "2", "37x29"),
        (1, "gray", "24x20"), (3, "gray", "64x48"), (2, "arith", "37x29"),
        (6, "arith", "64x48"))]
    # corrupt entropy-coded data: bytes replaced in baseline and
    # progressive files with and without restarts, restart markers
    # renumbered, dropped and doubled
    + [f"jpeg-corrupt_bytes_{b}_{size}" for b in ("base", "rst", "prog",
                                                  "prog_rst")
       for size in ("37x29", "64x48")]
    + [f"jpeg-corrupt_{what}_{b}_64x48" for what in ("renumber", "drop", "dup")
       for b in ("rst", "prog_rst")]
    # the forms the port refused before this slice, now decoded
    + [f"edge-{what}" for what in ("cmyk", "dc_only", "sof9", "tiled",
                                   "bits1", "float", "jpeg_in_tiff")]
    # the open faults of ROADMAP section 3, now decoded: LAB (every triple,
    # and PIL's in every compression), palette + alpha (PIL's; a short
    # ColorMap), palette + an unspecified sample, mode "I" (five sample
    # forms at values <= 255 and <= 65,535, raw and Deflate: big-endian
    # Deflate is read byte-swapped, as PIL does), 2- and 4-bit gray in
    # both photometrics and four compressions, LZMA, Zstandard, CCITT RLE
    + ["tiff-lab_all"]
    + [f"tiff-pil_lab{c}" for c in ("", "_lzw", "_deflate", "_lzma", "_zstd")]
    + ["tiff-pil_pa", "tiff-pil_pa_deflate", "tiff-pil_pa_zstd",
       "tiff-pa_short", "tiff-px"]
    + [f"tiff-int_{k}_{r}_{c}" for k in ("16s", "16s_be", "32u", "32s",
                                         "32s_be")
       for r in ("u8", "u16") for c in ("raw", "deflate")]
    + [f"tiff-low_{b}_{p}_{c}" for b in (2, 4) for p in ("wiz", "biz")
       for c in ("raw", "packbits", "lzw", "deflate")]
    + ["tiff-low_2_wiz_lzw_fill2", "tiff-low_4_biz_raw_fill2"]
    + ["tiff-lzma_rgb", "tiff-lzma_gray16_pred", "tiff-pil_rgb_lzma",
       "tiff-pil_l_lzma", "tiff-pil_1_lzma"]
    + [f"tiff-zstd_pil_{f}" for f in ("cdm", "onestrip", "pred", "noise",
                                      "flat", "levels", "gray16", "small",
                                      "tiny4", "four")]
    + [f"tiff-zstd_enc_{f}" for f in ("check", "single", "sequences")]
    + ["tiff-pil_rgb_zstd", "tiff-pil_1_zstd", "tiff-int_32s_u16_zstd"]
    # 32-bit samples under the horizontal predictor, summed as uint32
    # words whatever the sample format (libtiff's horAcc32): PIL's mode
    # "I" and "F" (little-endian), and both byte orders of int32, uint32
    # and float32 (compressed big-endian floats PIL reads byte-swapped)
    + ["tiff-pil_i_deflate_pred", "tiff-pil_f_deflate_pred",
       "tiff-int_32s_u16_deflate_pred", "tiff-int_32s_be_u16_deflate_pred",
       "tiff-int_32u_u16_deflate_pred", "tiff-float_deflate_pred",
       "tiff-float_deflate_pred_be", "tiff-float_deflate_be"]
    + ["tiff-pil_1_ccitt", "tiff-pil_1_ccitt_big", "tiff-pil_1_ccitt_fo2",
       "tiff-fax_g2_1d_0_40x150", "tiff-fax_g2_1d_1_fill2_30x1900",
       "tiff-fax_g2_1d_0_13x11"]
    # GIFs: the first frame through its table, as PIL converts it
    + [f"gif-{f}" for f in (
        "global", "local", "interlaced", "transparency", "grey_ramp",
        "local_grey_ramp", "short_table", "two_colours", "offset",
        "offset_transparency", "table_full", "pil_quantized",
        "pil_interlaced")])


class _NoPIL:
    """Stands in for the port's importlib: any PIL lookup fails."""

    def __init__(self):
        self.asked = []

    def import_module(self, name, *a, **kw):
        if name.split(".")[0] == "PIL":
            self.asked.append(name)
            raise ImportError(f"{name} hidden by the test")
        return importlib.import_module(name, *a, **kw)


@pytest.fixture
def no_pil(monkeypatch):
    stub = _NoPIL()
    monkeypatch.setattr(timage, "importlib", stub)
    return stub


@pytest.mark.parametrize("form", FORMS)
def test_read_image_without_pil_equals_jax_with_pil(form, no_pil,
                                                    monkeypatch):
    data = _form(form)
    # the JAX side decodes through PIL alone
    monkeypatch.setattr(jnative, "decode_img", lambda d: None)
    want = jimage.read_image(data)
    native = form.startswith("tiff-rgb16")
    if native:
        if not tnative.available():
            pytest.skip("the native decoder did not build here")
        arr = tnative.decode_img(data)
        assert arr is not None and arr.dtype == np.uint16
    else:
        monkeypatch.setattr(tnative, "decode_img", lambda d: None)
    got = timage.read_image(data)
    assert no_pil.asked == ([] if native else ["PIL.Image"])
    assert got.type.value == want.type.value
    assert got.pixels.dtype == want.pixels.dtype
    assert got.pixels.shape == want.pixels.shape
    np.testing.assert_array_equal(got.pixels, want.pixels)


def _corrupt_png(what: str) -> bytes:
    """A valid PNG with its IHDR's CRC broken, or its IHDR cut to 12
    bytes (under a right CRC); PIL refuses both."""
    data = _form("png-2_8")
    if what == "crc":
        return data[:29] + bytes([data[29] ^ 1]) + data[30:]
    return data[:8] + _chunk(b"IHDR", data[16:28]) + data[33:]


def _edge(what: str) -> bytes:
    """Forms the port refused without PIL before, each now decoded (a
    FORMS entry "edge-<what>") or refused with PIL: PIL's CMYK JPEG; a
    progressive JPEG cut after its first (DC) scan, which libjpeg
    smooths; a baseline JPEG re-labelled as arithmetic-coded (libjpeg
    decodes its Huffman data as arithmetic-coded data), lossless, 12-bit,
    hierarchical (SOF5-7) or of another process PIL refuses (SOF11, 13);
    PIL's 1-bit, float and JPEG-compressed TIFFs and a tiled one; a
    2-component and a YCbCr lossless JPEG; a big-endian 16-bit
    WhiteIsZero TIFF."""
    rgb = _cdm_like(np.random.default_rng(3), 24, 20)
    sof = {"sof9": 0xC9, "sof3": 0xC3, "sof5": 0xC5, "sof6": 0xC6,
           "sof7": 0xC7, "sof11": 0xCB, "sof13": 0xCD}
    if what in sof or what == "precision12":
        data = bytearray(_pil(lambda im: im.fromarray(rgb), format="JPEG"))
        at = data.index(b"\xff\xc0")
        if what == "precision12":
            data[at + 4] = 12
        else:
            data[at + 1] = sof[what]
        return bytes(data)
    if what == "cmyk":
        cmyk = np.concatenate([rgb, rgb[..., :1]], -1)
        return _pil(lambda im: im.fromarray(cmyk, "CMYK"), format="JPEG")
    if what == "dc_only":
        data = _pil(lambda im: im.fromarray(rgb), format="JPEG",
                    progressive=True)
        first = data.index(b"\xff\xda")
        return data[:data.index(b"\xff\xda", first + 2)] + b"\xff\xd9"
    if what == "two_components":
        return testing.encode_jpeg_lossless(rgb[..., :2],
                                            component_ids=(1, 2))
    if what == "lossless_ycbcr":
        return testing.encode_jpeg_lossless(rgb, jfif=True)
    if what == "lossless_ycck":
        data = testing.encode_jpeg_lossless(
            np.concatenate([rgb, rgb[..., :1]], -1),
            component_ids=(1, 2, 3, 4))
        return data[:2] + testing._jpeg_segment(
            0xEE, b"Adobe\0\x64\0\0\0\0\x02") + data[2:]
    if what == "tiled":
        return testing.encode_tiff(rgb, photometric=2,
                                   extra_tags={322: [16], 323: [16]})
    if what == "wiz16_be":
        return testing.encode_tiff(
            (rgb[..., :1].astype(np.uint16) * 257), photometric=0,
            big_endian=True)
    mode, kw = {"bits1": ("1", {}), "float": ("F", {}),
                "jpeg_in_tiff": ("RGB", {"compression": "jpeg"})}[what]
    src = rgb if mode == "RGB" else rgb[..., 0]
    return _pil(lambda im: im.fromarray(src).convert(mode), format="TIFF",
                **kw)


def _broken_tiff(what: str) -> bytes:
    """TIFFs PIL refuses: a Zstandard strip whose first block is of the
    reserved type, a frame whose checksum is off, one naming a
    dictionary, one after a skippable frame (libtiff stops there); an
    LZMA strip with a byte changed mid-stream; LAB with FillOrder 2."""
    from colormipsearch_tpu_torch.io import tiff as ttiff

    rng = np.random.default_rng(5)
    if what in ("zstd", "lzma"):
        data = bytearray(
            _pil(lambda im: im.fromarray(_cdm_like(rng, 50, 60)),
                 format="TIFF", compression="zstd")
            if what == "zstd" else _tiff_lzma(rng, ["rgb"]))
        _, tags = ttiff._ifd(bytes(data))
        # libtiff's frames: magic, descriptor, window, then a block
        at = tags[273][0] + (6 if what == "zstd" else tags[279][0] // 2)
        if what == "zstd":
            data[at] |= 6          # block type 3
        else:
            data[at] ^= 0x5A
        return bytes(data)
    if what == "zstd_skip":
        return _tiff_zstd(rng, ["enc", "skip"])
    if what == "lab_fill2":
        return _pil(lambda im: im.fromarray(
            rng.integers(0, 256, (5, 20, 3)).astype(np.uint8), "LAB"),
            format="TIFF", tiffinfo={266: 2})
    frame = bytearray(testing.encode_zstd_sequences()[0])
    if what == "zstd_checksum":
        frame[-1] ^= 0x10
    else:                      # a dictionary ID byte in the header
        frame[4] |= 1
        frame[5:5] = b"\x07"
    return testing.encode_tiff_chunks([bytes(frame)], w=13, h=2, bits=[8],
                                      photometric=1, compression=50000)


# what the port still refuses, with the words its ValueError names;
# PIL refuses every one of these bytes too
_REFUSED = [
    ("JPEG", b"\xff\xd8\xff\xe0" + b"\0" * 32),
    ("GIF", b"GIF89a" + b"\0" * 32),
    ("unrecognised", b"\0" * 40),
    ("bad CRC", _corrupt_png("crc")),
    ("IHDR of 12 bytes", _corrupt_png("ihdr")),
    ("lossless", _edge("sof3")),
    ("12-bit JPEG", _edge("precision12")),
    ("hierarchical JPEG", _edge("sof5")),
    ("hierarchical JPEG", _edge("sof6")),
    ("hierarchical JPEG", _edge("sof7")),
    ("lossless arithmetic-coded JPEG", _edge("sof11")),
    ("hierarchical arithmetic-coded JPEG", _edge("sof13")),
    ("JPEG with 2 components", _edge("two_components")),
    ("lossless JPEG with a colour transform", _edge("lossless_ycbcr")),
    ("lossless JPEG with a colour transform", _edge("lossless_ycck")),
    ("truncated", _form("jpeg-pil_rgb_2_95")[:300]),
    ("big-endian 16-bit WhiteIsZero", _edge("wiz16_be")),
    ("big-endian unsigned 32-bit", _form("tiff-int_32u_be_u8_raw")),
    ("fill order 2", _broken_tiff("lab_fill2")),
    ("corrupt Zstandard data", _broken_tiff("zstd")),
    ("Zstandard content checksum mismatch", _broken_tiff("zstd_checksum")),
    ("dictionaries are not supported", _broken_tiff("zstd_dictionary")),
    ("too short", _broken_tiff("zstd_skip")),
    ("corrupt TIFF LZMA data", _broken_tiff("lzma")),
]
_REFUSED_IDS = ["jpeg_junk", "gif_junk", "unrecognised", "png_crc",
                "png_ihdr", "sof3_fake", "precision12", "sof5", "sof6",
                "sof7", "sof11", "sof13", "two_components", "lossless_ycbcr",
                "lossless_ycck", "truncated_jpeg", "wiz16_be", "u32_be",
                "lab_fill2", "zstd_corrupt", "zstd_checksum",
                "zstd_dictionary", "zstd_skippable_first", "lzma_corrupt"]


@pytest.mark.parametrize("what,data", _REFUSED, ids=_REFUSED_IDS)
def test_read_image_without_pil_names_what_it_cannot_decode(what, data,
                                                            no_pil,
                                                            monkeypatch):
    monkeypatch.setattr(tnative, "decode_img", lambda d: None)
    with pytest.raises(ValueError, match=what):
        timage.read_image(data)
    # PIL refuses the same bytes
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).load()


@pytest.mark.parametrize("form", [
    f"tiff-int_{k}_out_{c}" for k in ("16s", "16s_be", "32u", "32s", "32s_be")
    for c in ("raw", "deflate")])
def test_mode_i_outside_uint16_raises_on_both_sides(form, no_pil,
                                                    monkeypatch):
    """Mode "I" values outside [0, 65535] (a negative one, or 70,000):
    JAX's read_image refuses them after PIL, and the port, without PIL,
    with the same words."""
    data = _form(form)
    monkeypatch.setattr(jnative, "decode_img", lambda d: None)
    monkeypatch.setattr(tnative, "decode_img", lambda d: None)
    with pytest.raises(ValueError) as want:
        jimage.read_image(data)
    with pytest.raises(ValueError) as got:
        timage.read_image(data)
    assert "outside uint16" in str(want.value)
    assert str(got.value).endswith(str(want.value))


def test_engines_skip_a_mode_i_target_outside_uint16(tmp_path, no_pil,
                                                     monkeypatch, caplog):
    """A signed 32-bit TIFF target with a negative value: both engines
    skip it (the port names it) and score the other targets as without
    it."""
    from colormipsearch_tpu.engine import cds as jcds
    from colormipsearch_tpu.model import neuron_from_json as jax_neuron
    from colormipsearch_tpu_torch.engine import cds as tcds
    from colormipsearch_tpu_torch.model import ComputeFileType, LMNeuron

    rng = np.random.default_rng(61)
    lib = testing.synthetic_library(rng, 6, 2, 48, 64, target_fg=0.1,
                                    mask_fg=0.04)
    masks = testing.write_neuron_images(tmp_path / "m", lib.masks, "m")
    targets = testing.write_neuron_images(tmp_path / "t", lib.targets, "t")
    bad = tmp_path / "t" / "int32.tif"
    x = lib.targets[0][..., :1].astype(np.int32)
    x[0, 0] = -1
    bad.write_bytes(testing.encode_tiff(x.view(np.uint32), photometric=1,
                                        extra_tags={339: [2]}))
    extra = LMNeuron(mip_id="x-00000", library_name="synthetic",
                     published_name="x00000")
    extra.set_compute_file(ComputeFileType.InputColorDepthImage, str(bad))
    kw = dict(mask_threshold=20, data_threshold=20, pix_color_fluctuation=1.0,
              xy_shift=2, mirror_mask=True, pct_positive_pixels=0.0)

    def run(engine, tgts):
        return sorted((m.mask_image.mip_id, m.matched_image.mip_id,
                       m.matching_pixels, m.mirrored)
                      for m in engine.find_all_matches(masks, tgts))

    port = tcds.CDSearchEngine(tcds.CDSParams(**kw), device="cpu",
                               decode_concurrency=1)
    want = run(port, targets)
    caplog.set_level(logging.WARNING, logger=tcds.LOG.name)
    assert run(port, targets + [extra]) == want and want
    named = [r.getMessage() for r in caplog.records
             if str(bad) in r.getMessage()]
    assert len(named) == 1 and "outside uint16" in named[0], caplog.text
    jax_engine = jcds.CDSearchEngine(jcds.CDSParams(**kw), use_mesh=False,
                                     decode_concurrency=1)

    def run_jax(tgts):
        return sorted(
            (m.mask_image.mip_id, m.matched_image.mip_id, m.matching_pixels,
             m.mirrored)
            for m in jax_engine.find_all_matches(
                [jax_neuron(n.to_json()) for n in masks],
                [jax_neuron(n.to_json()) for n in tgts]))

    assert run_jax(targets + [extra]) == run_jax(targets) == want


def test_engine_names_every_skipped_target(tmp_path, no_pil, monkeypatch,
                                           caplog):
    """A truncated JPEG target, which PIL refuses too, is named in its own
    warning; the other targets score as in the run without it."""
    from colormipsearch_tpu_torch.engine import cds as tcds
    from colormipsearch_tpu_torch.model import ComputeFileType, LMNeuron

    rng = np.random.default_rng(61)
    lib = testing.synthetic_library(rng, 6, 2, 48, 64, target_fg=0.1,
                                    mask_fg=0.04)
    masks = testing.write_neuron_images(tmp_path / "m", lib.masks, "m")
    targets = testing.write_neuron_images(tmp_path / "t", lib.targets, "t")
    jpg = tmp_path / "t" / "as_jpeg.jpg"
    buf = io.BytesIO()
    Image.fromarray(lib.targets[0]).save(buf, format="JPEG")
    jpg.write_bytes(buf.getvalue()[:len(buf.getvalue()) // 2])
    with pytest.raises(OSError):
        Image.open(jpg).load()
    extra = LMNeuron(mip_id="x-00000", library_name="synthetic",
                     published_name="x00000")
    extra.set_compute_file(ComputeFileType.InputColorDepthImage, str(jpg))
    params = tcds.CDSParams(mask_threshold=20, data_threshold=20,
                            pix_color_fluctuation=1.0, xy_shift=2,
                            mirror_mask=True, pct_positive_pixels=0.0)

    def run(tgts):
        engine = tcds.CDSearchEngine(params, device="cpu",
                                     decode_concurrency=1)
        return sorted((m.mask_image.mip_id, m.matched_image.mip_id,
                       m.matching_pixels, m.mirrored)
                      for m in engine.find_all_matches(masks, tgts))

    want = run(targets)
    caplog.set_level(logging.WARNING, logger=tcds.LOG.name)
    got = run(targets + [extra])
    assert got == want and got
    named = [r.getMessage() for r in caplog.records
             if str(jpg) in r.getMessage()]
    assert len(named) == 1 and "JPEG" in named[0], caplog.text
    assert any("skipped 1 target" in r.getMessage()
               for r in caplog.records), caplog.text


@pytest.mark.parametrize("data,want", [
    (b"", 0xEF46DB3751D8E999), (b"a", 0xD24EC4F1A98C6E5B),
    (b"abc", 0x44BC2CF5AD770999), (bytes(range(31)), 0xC346D2B59B4D8EE1),
    (bytes(range(32)), 0xCBF59C5116FF32B4),
    (bytes(range(100)), 0x6AC1E58032166597),
    (bytes(range(256)) * 9, 0xB6BC56AC49FE30E6)],
    ids=["0", "1", "3", "31", "32", "100", "2304"])
def test_zstd_checksum_hash_is_xxh64(data, want):
    """The content checksum's XXH64 at the lengths its stripes and tails
    meet (the values of the reference implementation)."""
    from colormipsearch_tpu_torch.io import zstd

    assert zstd.xxh64(data) == want


def _pil_decoded(path) -> np.ndarray:
    return jimage.read_image(str(path)).as_rgb()


def test_engine_reads_jpeg_gif_and_palette_tiff_without_pil(
        tmp_path, monkeypatch, caplog):
    """Targets stored as JPEG (baseline and progressive), GIF and palette
    TIFF give the same matches without PIL as with it, and none is
    skipped."""
    from colormipsearch_tpu_torch.engine import cds as tcds

    rng = np.random.default_rng(62)
    h, w = 48, 64
    forms = {"b.jpg": dict(format="JPEG", quality=90),
             "p.jpg": dict(format="JPEG", quality=80, progressive=True),
             "q.gif": dict(format="GIF"),
             "q.tif": dict(format="TIFF", compression="tiff_adobe_deflate")}
    pixels = {}
    for name, kw in forms.items():
        img = Image.fromarray(testing.synthetic_cdm(rng, h, w,
                                                    fg_fraction=0.1))
        if name.startswith("q"):
            img = img.quantize(64)
        img.save(tmp_path / name, **kw)
        pixels[name] = _pil_decoded(tmp_path / name)

    def run(work):
        return testing.forms_search(pixels, tmp_path / work, "cpu",
                                    forms_dir=str(tmp_path),
                                    file_names=list(forms))

    with_pil = run("with_pil")
    monkeypatch.setattr(timage, "importlib", _NoPIL())
    monkeypatch.setattr(tnative, "decode_img", lambda d: None)
    caplog.set_level(logging.WARNING, logger=tcds.LOG.name)
    without = run("without_pil")
    assert not [r for r in caplog.records if "skipped" in r.getMessage()]
    np.testing.assert_array_equal(without, with_pil)
    # every form file is a target its own cut mask matches
    n_synthetic = testing.FORMS_SYNTHETIC_TARGETS
    assert set(range(n_synthetic, n_synthetic + 4)) <= set(without[:, 1])


def test_pinned_forms_agree_with_pil_and_the_engine(tmp_path, monkeypatch):
    """tests/torch_forms/: each file decodes without PIL to the pixels
    pinned in its .npz, which are PIL's, and the engine's search over
    them (chip_smoke.py repeats it on the card) gives the pinned
    matches."""
    pinned = np.load(f"{testing.FORMS_DIR}/{testing.FORMS_NPZ}")
    monkeypatch.setattr(timage, "importlib", _NoPIL())
    monkeypatch.setattr(tnative, "decode_img", lambda d: None)
    pixels = {}
    for name in testing.FORM_FILES:
        path = f"{testing.FORMS_DIR}/{name}"
        want = jimage.read_image(path)
        np.testing.assert_array_equal(pinned[name], want.pixels)
        got = timage.read_image(path)
        assert got.type.value == want.type.value
        np.testing.assert_array_equal(got.pixels, pinned[name])
        pixels[name] = got.as_rgb()
    matches = testing.forms_search(pixels, tmp_path, "cpu")
    np.testing.assert_array_equal(matches, pinned["matches"])


def test_zstd_timing_file_agrees_with_pil(no_pil, monkeypatch):
    """tests/torch_forms' production-size Zstandard TIFF, which
    chip_smoke.py times the reader on, decodes without PIL to PIL's
    pixels."""
    monkeypatch.setattr(tnative, "decode_img", lambda d: None)
    path = f"{testing.FORMS_DIR}/{testing.FORMS_ZSTD_TIMING}"
    want = jimage.read_image(path)
    got = timage.read_image(path)
    assert got.type.value == want.type.value == "rgb"
    assert got.pixels.shape == (566, 1210, 3)
    np.testing.assert_array_equal(got.pixels, want.pixels)


def _pinned_form(name: str, rng) -> bytes:
    """The bytes of one tests/torch_forms file: PIL's for the forms PIL
    writes, testing's encoders' for the others; each from rng."""
    h, w = testing.FORMS_SIZE
    cdm = testing.synthetic_cdm(rng, h, w, fg_fraction=0.12)
    img = Image.fromarray(cdm)
    if name in ("baseline.jpg", "progressive.jpg", "palette.gif",
                "palette.tif"):
        kw = {"baseline.jpg": dict(format="JPEG", quality=90),
              "progressive.jpg": dict(format="JPEG", quality=85,
                                      progressive=True),
              "palette.gif": dict(format="GIF"),
              "palette.tif": dict(format="TIFF",
                                  compression="tiff_adobe_deflate")}[name]
        if kw["format"] in ("GIF", "TIFF"):
            img = img.quantize(48)
        return _pil(lambda im: img, **kw)
    alpha = rng.integers(0, 256, (h, w, 1)).astype(np.uint8)
    if name == "ccitt_g4.tif":
        return _pil(lambda im: Image.fromarray(cdm.max(-1) > 40),
                    format="TIFF", compression="group4")
    if name == "tiled_jpeg.tif":
        tiles = [testing.encode_jpeg(cdm[y:y + 16, x:x + 16], quality=85,
                                     jfif=False,
                                     sampling=((2, 2), (1, 1), (1, 1)))
                 for y in range(0, h, 16) for x in range(0, w, 16)]
        return testing.encode_tiff_chunks(
            tiles, w=w, h=h, bits=[8, 8, 8], photometric=6, compression=7,
            chunk=(16, 16), tiled=True, extra_tags={530: [2, 2]})
    if name == "rgba_lzw.tif":
        return _pil(lambda im: Image.fromarray(
            np.concatenate([cdm, alpha], -1), "RGBA"), format="TIFF",
            compression="tiff_lzw")
    if name == "cmyk.tif":
        return _pil(lambda im: Image.fromarray(
            np.concatenate([255 - cdm, alpha], -1), "CMYK"), format="TIFF")
    if name == "float.tif":
        return _pil(lambda im: Image.fromarray(
            cdm[..., 1].astype(np.float32) * 1.5 - 20, "F"), format="TIFF")
    if name == "cmyk.jpg":
        return _pil(lambda im: Image.fromarray(
            np.concatenate([255 - cdm, alpha], -1), "CMYK"), format="JPEG",
            quality=90)
    if name == "smoothed.jpg":
        data = _pil(lambda im: img, format="JPEG", quality=90,
                    progressive=True)
        return data[:_scan_starts(data)[4]] + b"\xff\xd9"
    if name == "arith.jpg":
        return testing.encode_jpeg(cdm, quality=90, arithmetic=True,
                                   progressive=True,
                                   sampling=((2, 2), (1, 1), (1, 1)))
    if name == "lossless.jpg":
        return testing.encode_jpeg_lossless(cdm, predictor=4)
    if name == "lab.tif":
        # the CDM's bytes read as L, a*, b*
        return _pil(lambda im: Image.fromarray(cdm, "LAB"), format="TIFF",
                    compression="tiff_adobe_deflate")
    if name == "palette_alpha.tif":
        return _pil(lambda im: img.quantize(48).convert("PA"), format="TIFF")
    if name == "int32.tif":
        return testing.encode_tiff(
            cdm[..., 1:2].astype(np.int32).view(np.uint32), photometric=1,
            big_endian=True, extra_tags={339: [2]})
    if name == "gray4.tif":
        return testing.encode_tiff((cdm[..., :1] >> 4).astype(np.uint8),
                                   photometric=0, bits=4, compression=5)
    if name == "lzma.tif":
        return _pil(lambda im: img, format="TIFF", compression="lzma")
    if name == "zstd.tif":
        return _pil(lambda im: img, format="TIFF", compression="zstd",
                    tiffinfo={317: 2})
    if name == "ccitt_rle.tif":
        return _pil(lambda im: Image.fromarray(cdm.max(-1) > 40),
                    format="TIFF", compression="tiff_ccitt")
    if name == "corrupt.jpg":
        data = bytearray(_pil(lambda im: img, format="JPEG", quality=90,
                              restart_marker_blocks=4))
        start, end = _entropy_ranges(bytes(data))[0]
        for k in (start + (end - start) // 3, start + 2 * (end - start) // 3):
            if data[k] != 0xFF and data[k - 1] != 0xFF:
                data[k] ^= 0x5A if data[k] ^ 0x5A != 0xFF else 0x33
        return bytes(data)
    raise KeyError(name)


def write_pinned_forms() -> None:
    """Write tests/torch_forms/: each of testing.FORM_FILES from seed 7
    (see _pinned_form), the .npz of their pixels as PIL decodes them and
    of the engine's matches over them, and testing.FORMS_ZSTD_TIMING from
    seed 8."""
    rng = np.random.default_rng(7)
    pinned = {}
    for name in testing.FORM_FILES:
        path = f"{testing.FORMS_DIR}/{name}"
        with open(path, "wb") as f:
            f.write(_pinned_form(name, rng))
        pinned[name] = jimage.read_image(path).pixels
    import tempfile

    with tempfile.TemporaryDirectory() as work:
        pinned["matches"] = testing.forms_search(
            {n: jimage.read_image(f"{testing.FORMS_DIR}/{n}").as_rgb()
             for n in testing.FORM_FILES}, work, "cpu")
    np.savez_compressed(f"{testing.FORMS_DIR}/{testing.FORMS_NPZ}",
                        **pinned)
    cdm = testing.synthetic_cdm(np.random.default_rng(8), 566, 1210)
    with open(f"{testing.FORMS_DIR}/{testing.FORMS_ZSTD_TIMING}", "wb") as f:
        f.write(_pil(lambda im: im.fromarray(cdm), format="TIFF",
                     compression="zstd"))


if __name__ == "__main__":
    # regenerates the pinned forms: python tests/test_torch_image_forms.py
    write_pinned_forms()
