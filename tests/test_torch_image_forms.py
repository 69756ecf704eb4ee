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
    if kind == "tiff":
        return _tiff_form(rng, rest, h, w)
    if kind == "jpeg":
        return _jpeg_form(rng, rest)
    if kind == "gif":
        return _gif_form(rng, rest)
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
    testing.encode_jpeg (sampling h1v1.h2v2... per component)."""
    parts = rest.split("_")
    h, w = 13, 11
    if "x" in parts[-1]:
        h, w = (int(v) for v in parts.pop().split("x"))
    img = _cdm_like(rng, h, w)
    if parts[0] == "enc":
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
    by testing.encode_tiff, or tiff-pil_* written by PIL."""
    if rest.startswith("pil_"):
        comp = {"pil_palette": None, "pil_palette_lzw": "tiff_lzw",
                "pil_palette_deflate": "tiff_adobe_deflate"}[rest]
        kw = {} if comp is None else {"compression": comp}
        return _pil(lambda im: im.fromarray(_cdm_like(rng, h, w))
                    .quantize(40), format="TIFF", **kw)
    parts = rest.split("_")
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


def _refused(what: str) -> bytes:
    """A form the port refuses without PIL: JPEGs re-labelled as
    arithmetic-coded, lossless or 12-bit, PIL's CMYK JPEG, a progressive
    JPEG cut after its first (DC) scan, which libjpeg would smooth; PIL's
    1-bit, float and JPEG-compressed TIFFs and a tiled one."""
    rgb = _cdm_like(np.random.default_rng(3), 24, 20)
    if what in ("sof9", "sof3", "precision12"):
        data = bytearray(_pil(lambda im: im.fromarray(rgb), format="JPEG"))
        at = data.index(b"\xff\xc0")
        if what == "precision12":
            data[at + 4] = 12
        else:
            data[at + 1] = 0xC9 if what == "sof9" else 0xC3
        return bytes(data)
    if what == "cmyk":
        cmyk = np.concatenate([rgb, rgb[..., :1]], -1)
        return _pil(lambda im: im.fromarray(cmyk, "CMYK"), format="JPEG")
    if what == "dc_only":
        data = _pil(lambda im: im.fromarray(rgb), format="JPEG",
                    progressive=True)
        first = data.index(b"\xff\xda")
        return data[:data.index(b"\xff\xda", first + 2)] + b"\xff\xd9"
    if what == "tiled":
        return testing.encode_tiff(rgb, photometric=2,
                                   extra_tags={322: [16], 323: [16]})
    mode, kw = {"bits1": ("1", {}), "float": ("F", {}),
                "jpeg_in_tiff": ("RGB", {"compression": "jpeg"})}[what]
    src = rgb if mode == "RGB" else rgb[..., 0]
    return _pil(lambda im: im.fromarray(src).convert(mode), format="TIFF",
                **kw)


@pytest.mark.parametrize("what,data", [
    ("JPEG", b"\xff\xd8\xff\xe0" + b"\0" * 32),
    ("GIF", b"GIF89a" + b"\0" * 32),
    ("unrecognised", b"\0" * 40),
    ("bad CRC", _corrupt_png("crc")),
    ("IHDR of 12 bytes", _corrupt_png("ihdr")),
    ("arithmetic-coded JPEG", _refused("sof9")),
    ("lossless JPEG", _refused("sof3")),
    ("12-bit JPEG", _refused("precision12")),
    ("CMYK", _refused("cmyk")),
    ("block smoothing", _refused("dc_only")),
    ("truncated", _form("jpeg-pil_rgb_2_95")[:300]),
    ("tiled TIFF", _refused("tiled")),
    ("TIFF with photometric", _refused("bits1")),
    ("float", _refused("float")),
    ("TIFF compression 7", _refused("jpeg_in_tiff")),
])
def test_read_image_without_pil_names_what_it_cannot_decode(what, data,
                                                            no_pil,
                                                            monkeypatch):
    monkeypatch.setattr(tnative, "decode_img", lambda d: None)
    with pytest.raises(ValueError, match=what):
        timage.read_image(data)
    if data.startswith(b"\x89PNG"):
        # PIL refuses the corrupt PNGs too
        from PIL import Image

        with pytest.raises(Exception):
            Image.open(io.BytesIO(data)).load()


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
        return testing.forms_search(
            {f: pixels[n] for f, n in zip(testing.FORM_FILES, forms)},
            tmp_path / work, "cpu", forms_dir=str(tmp_path),
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


def write_pinned_forms() -> None:
    """Write tests/torch_forms/ with PIL: the four files from seed 7 and
    the .npz of their pixels and of the engine's matches over them."""
    rng = np.random.default_rng(7)
    h, w = testing.FORMS_SIZE
    kws = (dict(format="JPEG", quality=90),
           dict(format="JPEG", quality=85, progressive=True),
           dict(format="GIF"),
           dict(format="TIFF", compression="tiff_adobe_deflate"))
    pinned = {}
    for name, kw in zip(testing.FORM_FILES, kws):
        img = Image.fromarray(testing.synthetic_cdm(rng, h, w,
                                                    fg_fraction=0.12))
        if kw["format"] in ("GIF", "TIFF"):
            img = img.quantize(48)
        path = f"{testing.FORMS_DIR}/{name}"
        img.save(path, **kw)
        pinned[name] = jimage.read_image(path).pixels
    import tempfile

    with tempfile.TemporaryDirectory() as work:
        pinned["matches"] = testing.forms_search(
            {n: jimage.read_image(f"{testing.FORMS_DIR}/{n}").as_rgb()
             for n in testing.FORM_FILES}, work, "cpu")
    np.savez_compressed(f"{testing.FORMS_DIR}/{testing.FORMS_NPZ}",
                        **pinned)


if __name__ == "__main__":
    # regenerates the pinned forms: python tests/test_torch_image_forms.py
    write_pinned_forms()
