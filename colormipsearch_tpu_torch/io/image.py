"""Image decoding to packed numpy arrays.

Replaces the reference's ImageJ/ImageIO decode layer
(imageprocessing/ImageArrayUtils.java, LocalTiffDecoder.java):

  * RGB images  -> uint8 [H, W, 3]
  * 8-bit gray  -> uint8 [H, W]
  * 16-bit gray -> uint16 [H, W]

Decoders, in order: the native C++ decoder (io/native_decoder.py; TIFF
and PNG; a 16-bit RGB result is cut to its high bytes, as PIL does), PIL
when it is importable, and last numpy + zlib decoders, which give what
PIL gives through _from_pil: every PNG form (decode_png), uncompressed
BMPs (decode_bmp), JPEGs (io/jpeg.py, libjpeg-turbo's integer
decompression: Huffman and arithmetic coding, sequential, progressive
with block smoothing and lossless, CMYK / YCCK, corrupt data), the first
frame of GIFs (io/gif.py) and TIFFs (io/tiff.py: strips and tiles;
bilevel, gray, float, gray + alpha, RGB(A), palette, CMYK and
JPEG-compressed YCbCr forms; uncompressed, LZW, PackBits, Deflate, CCITT
(io/fax.py) and JPEG compression). The last exist because the GPU hosts
may have neither zlib's headers nor PIL; what none of them reads raises
ValueError naming the form.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
import io as _io
import os
import struct
import zlib

import numpy as np

from colormipsearch_tpu_torch.io import gif, jpeg, tiff


class ImageType(enum.Enum):
    GRAY8 = "gray8"
    GRAY16 = "gray16"
    RGB = "rgb"


@dataclasses.dataclass
class ImageData:
    """Decoded image + pixel type (analogue of the reference ImageArray)."""
    type: ImageType
    pixels: np.ndarray  # [H, W] or [H, W, 3]

    @property
    def height(self) -> int:
        return self.pixels.shape[0]

    @property
    def width(self) -> int:
        return self.pixels.shape[1]

    def as_rgb(self) -> np.ndarray:
        """uint8 [H, W, 3] view (grays replicated across channels)."""
        if self.type is ImageType.RGB:
            return self.pixels
        if self.type is ImageType.GRAY8:
            return np.repeat(self.pixels[..., None], 3, axis=-1)
        raise ValueError(f"cannot view {self.type} as RGB")


SUPPORTED_SUFFIXES = (".png", ".tif", ".tiff", ".jpg", ".jpeg", ".gif", ".bmp")


def is_image_file(name: str) -> bool:
    return name.lower().endswith(SUPPORTED_SUFFIXES)


def _from_pil(img) -> ImageData:
    if img.mode in ("RGB", "RGBA", "P"):
        arr = np.asarray(img.convert("RGB"), dtype=np.uint8)
        return ImageData(ImageType.RGB, arr)
    if img.mode == "L":
        return ImageData(ImageType.GRAY8, np.asarray(img, dtype=np.uint8))
    if img.mode in ("I;16", "I;16B", "I;16L"):
        return ImageData(ImageType.GRAY16, np.asarray(img, dtype=np.uint16))
    if img.mode == "I":
        # PIL promotes 16-bit grayscale PNGs to 32-bit mode "I"; values
        # must fit the 16-bit pipeline — reject instead of silently
        # wrapping through astype (the bit-exactness contract)
        arr = np.asarray(img, dtype=np.int32)
        mx = int(arr.max(initial=0))
        if mx > 0xFFFF or int(arr.min(initial=0)) < 0:
            raise ValueError(
                f"32-bit gray image with values outside uint16 "
                f"(min {arr.min(initial=0)}, max {mx}) is not supported")
        if mx > 255:
            return ImageData(ImageType.GRAY16, arr.astype(np.uint16))
        return ImageData(ImageType.GRAY8, arr.astype(np.uint8))
    # fall back to RGB conversion for exotic modes
    return ImageData(ImageType.RGB, np.asarray(img.convert("RGB"), dtype=np.uint8))


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _try_native(data: bytes) -> ImageData | None:
    """Decode a TIFF or PNG with the native C++ decoder when possible."""
    if len(data) < 8 or (data[:2] not in (b"II", b"MM")
                         and not data.startswith(_PNG_MAGIC)):
        return None
    from colormipsearch_tpu_torch.io import native_decoder

    arr = native_decoder.decode_img(data)
    if arr is None:
        return None
    if arr.ndim == 3 and arr.shape[-1] == 3:
        if arr.dtype == np.uint16:
            # 16-bit RGB: PIL unpacks RGB;16B and RGB;16L to the high
            # byte of every sample
            arr = (arr >> 8).astype(np.uint8)
        elif arr.dtype != np.uint8:
            return None
        return ImageData(ImageType.RGB, np.ascontiguousarray(arr))
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        if arr.dtype == np.uint16:
            return ImageData(ImageType.GRAY16, arr)
        return ImageData(ImageType.GRAY8, arr)
    return None


# --- PNG without PIL: every bit depth, color type, filter and Adam7 ---

# samples a pixel, by color type: gray, RGB, palette, gray+alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_chunks(data: bytes):
    """(IHDR fields, PLTE uint8 [n, 3] or None, the joined IDAT bytes).
    As PIL, checks the CRC of every chunk before the first IDAT and of
    none after it."""
    if not data.startswith(_PNG_MAGIC):
        raise ValueError("not a PNG")
    off = len(_PNG_MAGIC)
    header = palette = None
    idat = []
    while off + 8 <= len(data):
        (length,) = struct.unpack(">I", data[off:off + 4])
        tag = data[off + 4:off + 8]
        body = data[off + 8:off + 8 + length]
        if len(body) != length:
            raise ValueError(f"truncated PNG chunk {tag!r}")
        if not idat:
            crc = data[off + 8 + length:off + 12 + length]
            if len(crc) != 4 or struct.unpack(">I", crc)[0] \
                    != zlib.crc32(tag + body):
                raise ValueError(f"PNG chunk {tag!r}: bad CRC")
        off += 12 + length
        if tag == b"IHDR":
            if length != 13:
                raise ValueError(f"PNG IHDR of {length} bytes, not 13")
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            if length % 3:
                raise ValueError("PNG palette length is not a multiple of 3")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    return header, palette, b"".join(idat)


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Reverse the PNG filters of one pass: uint8 [h, 1 + n] (each row's
    filter byte, then its bytes) -> uint8 [h, n].

    Without Average (3) or Paeth (4) rows, each row is one vector
    operation: None copies, Sub is a per-channel cumulative sum mod 256,
    Up adds the row above. Average and Paeth need the reconstructed byte
    to the left, so then the image is swept by anti-diagonals of (row,
    pixel): step d decodes pixel d - r of every row r at once, each with
    its own row's filter, and every neighbour it reads (left, above,
    above-left) lies on an earlier diagonal."""
    h, n = rows.shape[0], rows.shape[1] - 1
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"PNG filter type {int(ftype.max())} is not 0-4")
    filt = rows[:, 1:]
    out = np.zeros((h + 1, n), np.uint8)     # out[0]: the zero row above
    if h == 0 or n == 0:
        return out[1:]
    if (ftype <= 2).all():
        for r in range(h):
            t = ftype[r]
            if t == 0:
                out[r + 1] = filt[r]
            elif t == 1:
                out[r + 1] = np.cumsum(filt[r].reshape(-1, bpp), axis=0,
                                       dtype=np.uint8).reshape(-1)
            else:
                out[r + 1] = filt[r] + out[r]
        return out[1:]
    nk = n // bpp
    x3 = filt.reshape(h, nk, bpp).astype(np.int32)
    o3 = out.reshape(h + 1, nk, bpp)
    t_all = ftype.astype(np.int32)[:, None]
    for d in range(h + nk - 1):
        r = np.arange(max(0, d - nk + 1), min(h, d + 1))
        k = d - r
        has_left = (k > 0)[:, None]
        up = o3[r, k].astype(np.int32)
        left = np.where(has_left, o3[r + 1, k - 1], 0).astype(np.int32)
        ul = np.where(has_left, o3[r, k - 1], 0).astype(np.int32)
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        t = t_all[r]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [left, up, (left + up) >> 1, paeth], 0)
        o3[r + 1, k] = (x3[r, k] + pred) & 0xFF
    return out[1:]


def _png_samples(rows: np.ndarray, w: int, channels: int,
                 depth: int) -> np.ndarray:
    """Reconstructed bytes uint8 [h, row bytes] -> samples [h, w,
    channels] (uint16 at depth 16, else uint8; below 8 bits the samples
    are unpacked MSB first, their raw values)."""
    h = rows.shape[0]
    if depth == 16:
        return np.ascontiguousarray(rows).view(">u2").astype(np.uint16) \
            .reshape(h, w, channels)
    if depth == 8:
        return rows.reshape(h, w, channels)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    samples = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return samples.reshape(h, -1)[:, :w * channels].reshape(h, w, channels)


def _png_pixels(raw: np.ndarray, w: int, h: int, channels: int, depth: int,
                interlace: int) -> np.ndarray:
    """The decompressed IDAT stream -> samples [h, w, channels]."""
    bpp = max(1, channels * depth // 8)
    passes = ((0, 0, 1, 1),) if interlace == 0 else _ADAM7
    dtype = np.uint16 if depth == 16 else np.uint8
    img = np.zeros((h, w, channels), dtype)
    off = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue                   # an empty pass stores no rows
        row_bytes = -(-pw * channels * depth // 8)
        size = ph * (1 + row_bytes)
        if off + size > raw.size:
            raise ValueError("PNG image data is too short")
        rows = _unfilter(raw[off:off + size].reshape(ph, 1 + row_bytes), bpp)
        off += size
        img[y0::dy, x0::dx] = _png_samples(rows, pw, channels, depth)
    if off != raw.size:
        raise ValueError("PNG image data has the wrong size")
    return img


def decode_png(data: bytes) -> ImageData:
    """numpy + zlib PNG decoder: every bit depth (1, 2, 4, 8, 16), color
    type (gray, RGB, palette, gray+alpha, RGBA), filter type and Adam7
    interlacing. The result is what PIL gives through _from_pil: 8-bit
    gray and 2- and 4-bit gray (scaled by 85 and 17) GRAY8, 16-bit
    gray GRAY16, 1-bit gray RGB (0 or 255, PIL's mode "1" converted);
    every other form RGB, with alpha dropped, not blended (convert("RGB")),
    16-bit samples cut to their high byte (PIL's ";16B" raw modes) and
    palette indices past the PLTE black. Raises ValueError on anything
    that is not a valid PNG."""
    header, palette, idat = _png_chunks(data)
    w, h, depth, color, comp, filt, interlace = header
    if color not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[color]:
        raise ValueError(f"invalid PNG: bit depth {depth}, color type "
                         f"{color}")
    if comp != 0 or filt != 0 or interlace not in (0, 1):
        raise ValueError(f"invalid PNG: compression {comp}, filter method "
                         f"{filt}, interlace {interlace}")
    if color == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    try:
        raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    except zlib.error as e:
        raise ValueError(f"PNG image data: {e}") from e
    px = _png_pixels(raw, w, h, _PNG_CHANNELS[color], depth, interlace)
    if color == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:min(len(palette), 256)] = palette[:256]
        return ImageData(ImageType.RGB, lut[px[..., 0]])
    if color == 0:
        gray = px[..., 0]
        if depth == 16:
            return ImageData(ImageType.GRAY16, gray)
        if depth == 1:
            return ImageData(ImageType.RGB, np.repeat(
                (gray * 255)[..., None], 3, axis=-1))
        # PIL's L;2 and L;4 stretch the samples over 0..255
        return ImageData(ImageType.GRAY8, gray * {2: 85, 4: 17, 8: 1}[depth])
    if depth == 16:
        px = (px >> 8).astype(np.uint8)
    if color == 4:
        return ImageData(ImageType.RGB, np.repeat(px[..., :1], 3, axis=-1))
    return ImageData(ImageType.RGB, np.ascontiguousarray(px[..., :3]))


def decode_png_rgb8(data: bytes) -> np.ndarray:
    """decode_png for a PNG that decodes to RGB -> uint8 [H, W, 3].
    Raises ValueError on any other PNG."""
    img = decode_png(data)
    if img.type is not ImageType.RGB:
        raise ValueError(f"PNG decodes to {img.type.value}, not RGB")
    return img.pixels


def decode_png_gray16(data: bytes) -> np.ndarray:
    """decode_png for a 16-bit gray PNG -> uint16 [H, W]. Raises
    ValueError on any other PNG."""
    img = decode_png(data)
    if img.type is not ImageType.GRAY16:
        raise ValueError(f"PNG decodes to {img.type.value}, not 16-bit "
                         "gray")
    return img.pixels


def decode_bmp(data: bytes) -> ImageData:
    """numpy reader of uncompressed BMPs (BITMAPINFOHEADER and later):
    24- and 32-bit (BGR, BGRX: the fourth byte ignored) and 8-bit palette,
    bottom-up or top-down. As PIL: an 8-bit palette that is the identity
    gray ramp is dropped (GRAY8 of the indices); any other palette gives
    RGB, indices past it black. Raises ValueError on anything else."""
    if len(data) < 54 or data[:2] != b"BM":
        raise ValueError("not a BMP")
    (off_bits,) = struct.unpack_from("<I", data, 10)
    (hsize,) = struct.unpack_from("<I", data, 14)
    if hsize not in (40, 52, 56, 64, 108, 124):
        raise ValueError(f"unsupported BMP header size {hsize}")
    w, h, _, bits, comp = struct.unpack_from("<iiHHI", data, 18)
    (colors,) = struct.unpack_from("<I", data, 46)
    if comp != 0 or bits not in (8, 24, 32) or w <= 0:
        raise ValueError(f"unsupported BMP: {bits} bits, compression "
                         f"{comp} (uncompressed 8-, 24- and 32-bit only)")
    top_down = h < 0
    h = abs(h)
    stride = ((w * bits + 31) >> 3) & ~3
    pal = None
    if bits == 8:
        colors = colors or 256
        if colors > 256 or 14 + hsize + 4 * colors > len(data):
            raise ValueError(f"BMP palette of {colors} colors")
        pal = np.frombuffer(data, np.uint8, 4 * colors, 14 + hsize) \
            .reshape(colors, 4)[:, 2::-1]
        if off_bits == 14 + hsize:
            off_bits += 4 * colors
        if colors == 2 and (pal == [[0] * 3, [255] * 3]).all():
            raise ValueError("8-bit BMP with a black-and-white palette")
    if off_bits + stride * h > len(data):
        raise ValueError("BMP pixel data is too short")
    px = np.frombuffer(data, np.uint8, stride * h, off_bits).reshape(h, stride)
    if not top_down:
        px = px[::-1]
    if bits == 8:
        idx = px[:, :w]
        if (pal == np.arange(colors, dtype=np.uint8)[:, None]).all():
            return ImageData(ImageType.GRAY8, np.ascontiguousarray(idx))
        lut = np.zeros((256, 3), np.uint8)
        lut[:colors] = pal
        return ImageData(ImageType.RGB, lut[idx])
    n = bits // 8
    return ImageData(ImageType.RGB, np.ascontiguousarray(
        px[:, :w * n].reshape(h, w, n)[..., 2::-1]))


def _image_data(arr: np.ndarray) -> ImageData:
    """A reader's array as ImageData: uint8 [H, W] GRAY8, uint16 [H, W]
    GRAY16, uint8 [H, W, 3] RGB."""
    if arr.ndim == 3:
        return ImageData(ImageType.RGB, arr)
    return ImageData(ImageType.GRAY16 if arr.dtype == np.uint16
                     else ImageType.GRAY8, arr)


def _decode_numpy(data: bytes) -> ImageData:
    """The decoders that need neither PIL nor the native library; a form
    none of them reads raises ValueError naming it."""
    if data.startswith(_PNG_MAGIC):
        return decode_png(data)
    if data[:2] == b"BM":
        return decode_bmp(data)
    if data[:3] == b"\xff\xd8\xff":
        return _image_data(jpeg.decode_jpeg(data))
    if data[:4] == b"GIF8":
        return _image_data(gif.decode_gif(data))
    if data[:2] in (b"II", b"MM"):
        return _image_data(tiff.decode_tiff(data))
    raise ValueError("unrecognised image format: not decodable without PIL")


def read_image(path_or_bytes) -> ImageData:
    """Decode an image from a path, byte string, or file-like object.

    TIFFs and PNGs go through the native C++ decoder when it is
    available; everything else (and any native failure) goes to PIL when
    it is importable, else to the numpy decoders (_decode_numpy), which
    raise ValueError on what they cannot read.
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    elif isinstance(path_or_bytes, (str, os.PathLike)):
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    else:
        data = path_or_bytes.read()
    native = _try_native(data)
    if native is not None:
        return native
    try:
        # optional dependency, looked up only here (the GPU hosts lack it)
        pil_image = importlib.import_module("PIL.Image")
    except ImportError:
        return _decode_numpy(data)
    with pil_image.open(_io.BytesIO(data)) as img:
        img.load()
        return _from_pil(img)
