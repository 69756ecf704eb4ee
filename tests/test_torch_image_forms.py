"""The port's image decoding without PIL against the JAX package's with PIL.

Every form is written here with numpy, zlib and struct (or with PIL
where PIL can write it): PNGs in every color type and bit depth, every
filter type forced per row, Adam7 interlacing, palettes; BMPs; 16-bit RGB
TIFFs. The port's read_image, with PIL hidden and the native decoder
disabled, must give what the JAX package's read_image gives through PIL:
the same ImageType, dtype and values. A 16-bit RGB TIFF is read by the
native decoder in both packages (the port has no other TIFF reader); its
cut to 8 bits is the port's own and is held to PIL's.

The engine test: a JPEG target cannot be decoded without PIL; the engine
names it in a warning of its own and scores the other targets as it
would without it.
"""

import importlib
import io
import logging
import struct
import zlib

import numpy as np
import pytest

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


def _tiff_rgb16(rgb16: np.ndarray, big_endian: bool) -> bytes:
    """A baseline uncompressed 16-bit RGB TIFF, one strip."""
    e = ">" if big_endian else "<"
    h, w, _ = rgb16.shape
    pix = np.ascontiguousarray(rgb16.astype(e + "u2")).tobytes()
    n_tags = 10
    ifd_off = 8
    bps_off = ifd_off + 2 + 12 * n_tags + 4
    data_off = bps_off + 6
    tags = [(256, 3, 1, w), (257, 3, 1, h), (258, 3, 3, bps_off),
            (259, 3, 1, 1), (262, 3, 1, 2), (273, 4, 1, data_off),
            (277, 3, 1, 3), (278, 3, 1, h), (279, 4, 1, len(pix)),
            (284, 3, 1, 1)]
    out = (b"MM" if big_endian else b"II") + struct.pack(e + "HI", 42,
                                                          ifd_off)
    out += struct.pack(e + "H", n_tags)
    for tag, typ, count, value in tags:
        if typ == 3 and count == 1:
            out += struct.pack(e + "HHIHH", tag, typ, count, value, 0)
        else:
            out += struct.pack(e + "HHII", tag, typ, count, value)
    out += struct.pack(e + "I", 0)
    out += struct.pack(e + "HHH", 16, 16, 16)
    return out + pix


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
    if kind == "tiff":
        rgb16 = rng.integers(0, 1 << 16, (h, w, 3))
        rgb16[0, :4] = [[0] * 3, [255] * 3, [256] * 3, [65535] * 3]
        return _tiff_rgb16(rgb16, big_endian=rest == "rgb16_be")
    raise KeyError(name)


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
    + ["tiff-rgb16_le", "tiff-rgb16_be"])


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
    if form.startswith("tiff"):
        if not tnative.available():
            pytest.skip("the native decoder did not build here")
        arr = tnative.decode_img(data)
        assert arr is not None and arr.dtype == np.uint16
    else:
        monkeypatch.setattr(tnative, "decode_img", lambda d: None)
    got = timage.read_image(data)
    assert no_pil.asked == ([] if form.startswith("tiff") else ["PIL.Image"])
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


@pytest.mark.parametrize("what,data", [
    ("JPEG", b"\xff\xd8\xff\xe0" + b"\0" * 32),
    ("GIF", b"GIF89a" + b"\0" * 32),
    ("unrecognised", b"\0" * 40),
    ("bad CRC", _corrupt_png("crc")),
    ("IHDR of 12 bytes", _corrupt_png("ihdr")),
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
    """A JPEG target, undecodable without PIL, is named in its own
    warning; the other targets score as in the run without it."""
    from PIL import Image

    from colormipsearch_tpu_torch.engine import cds as tcds
    from colormipsearch_tpu_torch.model import ComputeFileType, LMNeuron

    rng = np.random.default_rng(61)
    lib = testing.synthetic_library(rng, 6, 2, 48, 64, target_fg=0.1,
                                    mask_fg=0.04)
    masks = testing.write_neuron_images(tmp_path / "m", lib.masks, "m")
    targets = testing.write_neuron_images(tmp_path / "t", lib.targets, "t")
    jpg = tmp_path / "t" / "as_jpeg.jpg"
    Image.fromarray(lib.targets[0]).save(jpg, format="JPEG")
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
