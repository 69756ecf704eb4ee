"""GIF decoding without PIL: the first frame, as PIL's GifImagePlugin
loads it and `convert("RGB")` then gives it.

PIL's rules, each pinned by tests/test_torch_image_forms.py:
  * the canvas is the logical screen, grown to the first frame's extent;
    outside the frame it holds the transparency index when the frame has
    one, else index 0;
  * the frame's colour table is its local table, else the global one; a
    table that is the identity grey ramp (entry i = (i, i, i)) counts as
    none, and a frame without a table opens as mode "L", its indices
    taken as grey values (GRAY8);
  * otherwise the frame is mode "P" and converts to RGB through its
    table; an index past the table is black, and the transparency index
    simply has its table colour (convert("RGB") drops transparency);
  * the LZW stream fills the frame row by row (or in the four interlaced
    passes) and may stop early at its end code; rows it does not reach
    keep the canvas.
"""

from __future__ import annotations

import struct

import numpy as np


def _blocks(data: bytes, pos: int) -> tuple[bytes, int]:
    """The concatenated data sub-blocks starting at pos, and the position
    after their terminator."""
    out = []
    while True:
        if pos >= len(data):
            raise ValueError("GIF data blocks are truncated")
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(out), pos
        if pos + n > len(data):
            raise ValueError("GIF data blocks are truncated")
        out.append(data[pos:pos + n])
        pos += n


def _lzw(stream: bytes, min_bits: int, n_out: int) -> np.ndarray:
    """GIF LZW (LSB-first codes, 12 bits at most; the width grows once
    the table's next entry needs it, as PIL's GifDecode.c): at most n_out
    indices; stops at the end code or where the stream ends."""
    clear, eoi = 1 << min_bits, (1 << min_bits) + 1
    table = [bytes([i]) for i in range(clear)] + [b"", b""]
    size = min_bits + 1
    nxt = eoi + 1
    prev = None
    out = []
    n = 0
    b = np.frombuffer(stream + b"\0" * 4, np.uint8).astype(np.uint32)
    # w32[i]: bytes i .. i + 3 as one little-endian integer
    w32 = (b[:-3] | b[1:-2] << 8 | b[2:-1] << 16 | b[3:] << 24).tolist()
    n_bits = 8 * len(stream)
    pos = 0
    while pos + size <= n_bits and n < n_out:
        code = (w32[pos >> 3] >> (pos & 7)) & ((1 << size) - 1)
        pos += size
        if code == clear:
            del table[eoi + 1:]
            size = min_bits + 1
            nxt = eoi + 1
            prev = None
            continue
        if code == eoi:
            break
        if prev is None:
            if code >= clear:
                raise ValueError(f"GIF LZW code {code} after a clear")
            entry = table[code]
        else:
            if code < nxt:
                entry = table[code]
            elif code == nxt and nxt < 4096:
                entry = prev + prev[:1]
            else:
                raise ValueError(f"GIF LZW code {code} past the table "
                                 f"({nxt})")
            if nxt < 4096:
                table.append(prev + entry[:1])
                nxt += 1
                if nxt == (1 << size) and size < 12:
                    size += 1
        out.append(entry)
        n += len(entry)
        prev = entry
    return np.frombuffer(b"".join(out), np.uint8)[:n_out]


def _is_grey_ramp(table: np.ndarray) -> bool:
    return bool((table == np.arange(len(table))[:, None]).all())


def decode_gif(data: bytes) -> np.ndarray:
    """The first frame of a GIF as PIL gives it: uint8 [H, W] when the
    frame has no colour table (or an identity grey ramp; PIL's "L"),
    else uint8 [H, W, 3]. Raises ValueError, its message naming GIF, on
    what it cannot decode."""
    if len(data) < 13 or data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF")
    try:
        return _decode(data)
    except (IndexError, struct.error) as e:
        raise ValueError(f"corrupt GIF: {e!r}") from e


def _table(data: bytes, pos: int, flags: int):
    n = 3 << ((flags & 7) + 1)
    if pos + n > len(data):
        raise ValueError("GIF colour table is truncated")
    table = np.frombuffer(data, np.uint8, n, pos).reshape(-1, 3)
    return (None if _is_grey_ramp(table) else table), pos + n


def _decode(data: bytes) -> np.ndarray:
    w, h, flags = struct.unpack("<HHB", data[6:11])
    pos = 13
    palette = None
    if flags & 0x80:
        palette, pos = _table(data, pos, flags)
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError("GIF without an image")
        kind = data[pos]
        pos += 1
        if kind == 0x21:
            label = data[pos]
            body, pos = _blocks(data, pos + 1)
            if label == 0xF9 and len(body) >= 4 and body[0] & 1:
                transparency = body[3]
            continue
        if kind != 0x2C:
            raise ValueError(f"GIF block 0x{kind:02x} is not an image or an "
                             "extension")
        x0, y0, fw, fh, iflags = struct.unpack("<HHHHB", data[pos:pos + 9])
        pos += 9
        if iflags & 0x80:
            palette, pos = _table(data, pos, iflags)
        min_bits = data[pos]
        if not 1 <= min_bits <= 11:
            raise ValueError(f"GIF LZW minimum code size {min_bits}")
        stream, _ = _blocks(data, pos + 1)
        break
    w, h = max(w, x0 + fw), max(h, y0 + fh)
    idx = np.full((h, w), transparency or 0, np.uint8)
    px = _lzw(stream, min_bits, fw * fh)
    rows = np.arange(fh)
    if iflags & 0x40:
        rows = np.concatenate([rows[0::8], rows[4::8], rows[2::4],
                               rows[1::2]])
    frame = idx[y0:y0 + fh, x0:x0 + fw]
    full, part = divmod(px.size, fw) if fw else (0, 0)
    frame[rows[:full]] = px[:full * fw].reshape(full, fw)
    if part:
        frame[rows[full], :part] = px[full * fw:]
    if palette is None:
        return idx
    lut = np.zeros((256, 3), np.uint8)
    lut[:len(palette)] = palette
    return lut[idx]
