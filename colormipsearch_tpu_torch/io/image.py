"""Image decoding to packed numpy arrays.

Replaces the reference's ImageJ/ImageIO decode layer
(imageprocessing/ImageArrayUtils.java, LocalTiffDecoder.java):

  * RGB images  -> uint8 [H, W, 3]
  * 8-bit gray  -> uint8 [H, W]
  * 16-bit gray -> uint16 [H, W]

Decoders, in order: the native C++ decoder (io/native_decoder.py; TIFF
and PNG), PIL when it is importable, and last a small numpy + zlib
reader that accepts only non-interlaced 8-bit RGB and 16-bit gray PNGs
whose rows all use filter type 0 (what ``colormipsearch_tpu_torch.
testing`` writes: CDMs, z-gap variants and gradient variants). The last
one exists because the GPU hosts may have neither zlib's headers nor
PIL.
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
        if arr.dtype != np.uint8:
            # 16-bit RGB TIFFs: let PIL convert; the RGB contract is
            # uint8 [H, W, 3]
            return None
        return ImageData(ImageType.RGB, np.ascontiguousarray(arr))
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        if arr.dtype == np.uint16:
            return ImageData(ImageType.GRAY16, arr)
        return ImageData(ImageType.GRAY8, arr)
    return None


def _png_filter0_rows(data: bytes, depth: int, color: int,
                      what: str) -> tuple[int, int, np.ndarray]:
    """(width, height, uint8 [H, row bytes]) of a non-interlaced PNG of
    the given bit depth and color type whose rows all use filter type
    0; raises ValueError on any other PNG."""
    if not data.startswith(_PNG_MAGIC):
        raise ValueError("not a PNG")
    off = len(_PNG_MAGIC)
    header = None
    idat = []
    while off + 8 <= len(data):
        (length,) = struct.unpack(">I", data[off:off + 4])
        ctype = data[off + 4:off + 8]
        body = data[off + 8:off + 8 + length]
        off += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, got_depth, got_color, comp, filt, interlace = header
    if (got_depth, got_color, comp, filt, interlace) != \
            (depth, color, 0, 0, 0):
        raise ValueError(
            f"unsupported PNG (bit depth {got_depth}, color type "
            f"{got_color}, interlace {interlace}): expected {what}, "
            "non-interlaced")
    channels = 3 if color == 2 else 1
    row_bytes = w * channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + row_bytes):
        raise ValueError("PNG image data has the wrong size")
    rows = raw.reshape(h, 1 + row_bytes)
    if rows[:, 0].any():
        raise ValueError("PNG rows use a filter other than type 0")
    return w, h, rows[:, 1:]


def decode_png_rgb8(data: bytes) -> np.ndarray:
    """numpy + zlib PNG reader for 8-bit RGB, non-interlaced images whose
    rows all use filter type 0 -> uint8 [H, W, 3].  Raises ValueError on
    any other PNG."""
    w, h, rows = _png_filter0_rows(data, 8, 2, "8-bit RGB")
    return np.ascontiguousarray(rows.reshape(h, w, 3))


def decode_png_gray16(data: bytes) -> np.ndarray:
    """numpy + zlib PNG reader for 16-bit gray, non-interlaced images
    whose rows all use filter type 0 (big-endian samples) -> uint16
    [H, W].  Raises ValueError on any other PNG."""
    w, h, rows = _png_filter0_rows(data, 16, 0, "16-bit gray")
    return np.ascontiguousarray(rows).view(">u2").astype(np.uint16) \
        .reshape(h, w)


def _decode_png_numpy(data: bytes) -> ImageData:
    """The numpy PNG readers, chosen by the IHDR's bit depth and color
    type (16-bit gray, else 8-bit RGB)."""
    if data[12:16] == b"IHDR" and data[24:26] == b"\x10\x00":
        return ImageData(ImageType.GRAY16, decode_png_gray16(data))
    return ImageData(ImageType.RGB, decode_png_rgb8(data))


def read_image(path_or_bytes) -> ImageData:
    """Decode an image from a path, byte string, or file-like object.

    TIFFs and PNGs go through the native C++ decoder when it is
    available; everything else (and any native failure) goes to PIL when
    it is importable, else to the numpy PNG readers (decode_png_rgb8,
    decode_png_gray16).
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
        return _decode_png_numpy(data)
    with pil_image.open(_io.BytesIO(data)) as img:
        img.load()
        return _from_pil(img)
