"""Synthetic color depth MIPs, shared by the tests and ``chip_smoke.py``
(with the PNG writers of ``io/png.py``).

A CDM codes depth as hue: every foreground pixel takes the color of the
rainbow LUT (constants.RAINBOW_LUT) at its z-slice, scaled by an
intensity. The generator draws neuron-like strokes — smooth random walks
a few pixels wide whose depth drifts slowly along their length — until
the requested foreground fraction is covered (about 6% for a target,
like the production libraries). Masks are either independent, sparser
images or cut from a target (a box of it, shifted by a few pixels and
optionally mirrored), so that strong matches exist.

For the shape pass every target can carry the two variants that
``precomputeVariants`` writes beside a CDM: a 16-bit gray GradientImage
(random 0..399, 0 on the foreground) and an RGB ZGapImage (the masked
CDM dilated by a per-channel max; the shape oracle takes the z-gap image
as given, so a square window of the reference's radius stands in for
its disk).

Everything is made from an explicitly seeded ``np.random.Generator``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import sqlite3
import struct
import zlib

import numpy as np

from colormipsearch_tpu_torch.constants import RAINBOW_LUT
from colormipsearch_tpu_torch.io import fax, zstd
from colormipsearch_tpu_torch.io.jpeg import _QE
from colormipsearch_tpu_torch.io.png import (  # noqa: F401 (re-exported)
    encode_png,
    encode_png_gray16,
    write_png,
)
from colormipsearch_tpu_torch.io.ppp import SCREENSHOT_TYPES
from colormipsearch_tpu_torch.model import (
    ComputeFileType,
    EMNeuron,
    LMNeuron,
    Neuron,
)

# --- JPEG, GIF and TIFF writers (numpy + zlib): inputs for the port's
# PIL-free readers (io/jpeg.py, io/gif.py, io/tiff.py) on hosts without PIL


def _jpeg_qtable(base: np.ndarray, quality: int) -> np.ndarray:
    """IJG's quality scaling (jcparam.c) of a base table, clamped to 1..255."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4
                     + [24, 26, 56] + [99] * 5 + [47, 66] + [99] * 38)
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])
# fixed-length Huffman codes: 12 DC categories of 4 bits, the 162 AC
# symbols (EOB, ZRL, run/size 0-15 x 1-10) of 8 bits; no code is all ones
_DC_SYMBOLS = list(range(12))
_AC_SYMBOLS = [0x00, 0xF0] + [r << 4 | s for r in range(16)
                              for s in range(1, 11)]


def _jpeg_segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    c[0] /= np.sqrt(2)
    return c


def encode_jpeg(pixels: np.ndarray, *, quality: int = 90,
                sampling=None, restart_interval: int = 0,
                component_ids=(1, 2, 3), jfif: bool = True,
                arithmetic: bool = False, progressive: bool = False,
                dac: dict | None = None,
                adobe_transform: int | None = None) -> bytes:
    """A JPEG of uint8 [H, W] (gray), [H, W, 3] (RGB, stored as YCbCr
    unless component_ids spell 'RGB' without JFIF) or [H, W, 4] (four
    planes stored as they are, for CMYK or YCCK under an Adobe marker of
    adobe_transform 0 or 2), with any sampling
    factors ((h, v) per component; default 1x1), IJG's quality tables and
    an optional restart interval (in MCUs). Huffman-coded baseline with
    fixed-length codes, or with arithmetic=True arithmetic-coded (T.81
    Annex D's QM coder, as libjpeg's jcarith.c codes): sequential (SOF9)
    or progressive (SOF10, progressive=True, jpeg_simple_progression's
    scans), and a DAC segment of {table index: value} on request."""
    img = np.asarray(pixels, np.float64)
    if img.ndim == 2:
        planes = [img]
        sampling = sampling or ((1, 1),)
        component_ids = component_ids[:1]
    elif img.shape[2] == 4:
        planes = [img[..., k] for k in range(4)]
        sampling = sampling or ((1, 1),) * 4
        component_ids = tuple(component_ids) + (4,) * (4 - len(
            component_ids))
    else:
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        if bytes(component_ids) == b"RGB":
            planes = [r, g, b]
        else:
            planes = [0.299 * r + 0.587 * g + 0.114 * b,
                      -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                      0.5 * r - 0.418688 * g - 0.081312 * b + 128]
        sampling = sampling or ((1, 1),) * 3
    h, w = img.shape[:2]
    hmax = max(f[0] for f in sampling)
    vmax = max(f[1] for f in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    q_tables = [_jpeg_qtable(_Q_LUMA, quality),
                _jpeg_qtable(_Q_CHROMA, quality)]
    cmat = _dct_matrix()
    comps = []
    for ci, (plane, (fh, fv)) in enumerate(zip(planes, sampling)):
        # the padded plane, then the mean over each fh' x fv' cell
        ph, pw = mcuy * 8 * vmax, mcux * 8 * hmax
        full = np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")
        sy, sx = vmax // fv, hmax // fh
        sub = full.reshape(ph // sy, sy, pw // sx, sx).mean(axis=(1, 3))
        blocks = (sub - 128).reshape(ph // sy // 8, 8, pw // sx // 8, 8) \
            .transpose(0, 2, 1, 3)
        coef = cmat @ blocks @ cmat.T
        qt = q_tables[min(ci, 1)].reshape(8, 8)
        quant = np.round(coef / qt).astype(np.int64)
        comps.append(quant.reshape(quant.shape[0], quant.shape[1], 64)
                     [..., _ZIGZAG])
    out = [b"\xff\xd8"]
    if jfif:
        out.append(_jpeg_segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0"))
    if adobe_transform is not None:
        out.append(_jpeg_segment(0xEE, b"Adobe\0\x64\0\0\0\0"
                                 + bytes([adobe_transform])))
    for t, table in enumerate(q_tables[:min(len(planes), 2)]):
        out.append(_jpeg_segment(0xDB, bytes([t]) + bytes(
            table[_ZIGZAG].astype(np.uint8))))
    sof = (0xCA if progressive else 0xC9) if arithmetic else 0xC0
    out.append(_jpeg_segment(sof, struct.pack(">BHHB", 8, h, w,
                                              len(planes)) + b"".join(
        bytes([component_ids[ci], fh << 4 | fv, min(ci, 1)])
        for ci, (fh, fv) in enumerate(sampling))))
    if arithmetic:
        if dac:
            out.append(_jpeg_segment(0xCC, b"".join(
                bytes([k, v]) for k, v in dac.items())))
        if restart_interval:
            out.append(_jpeg_segment(0xDD, struct.pack(">H",
                                                       restart_interval)))
        cond = _ArithConditioning(dac or {})
        for scan in _arith_scans(len(planes), progressive):
            ids = bytes(b for ci in scan[0]
                        for b in (component_ids[ci], min(ci, 1) * 0x11))
            out.append(_jpeg_segment(0xDA, bytes([len(scan[0])]) + ids
                                     + bytes(scan[1:3])
                                     + bytes([scan[3] << 4 | scan[4]])))
            out.append(_arith_scan(comps, sampling, mcux, mcuy,
                                   restart_interval, (h, w), scan, cond))
        out.append(b"\xff\xd9")
        return b"".join(out)
    for tc, length, symbols in ((0, 4, _DC_SYMBOLS), (1, 8, _AC_SYMBOLS)):
        counts = [0] * 16
        counts[length - 1] = len(symbols)
        for th in range(min(len(planes), 2)):
            out.append(_jpeg_segment(0xC4, bytes([tc << 4 | th] + counts
                                                 + symbols)))
    if restart_interval:
        out.append(_jpeg_segment(0xDD, struct.pack(">H", restart_interval)))
    out.append(_jpeg_segment(0xDA, bytes([len(planes)]) + b"".join(
        bytes([component_ids[ci], min(ci, 1) * 0x11])
        for ci in range(len(planes))) + b"\0\x3f\0"))
    out.append(_jpeg_scan(comps, sampling, mcux, mcuy, restart_interval,
                          (h, w)))
    out.append(b"\xff\xd9")
    return b"".join(out)


def _jpeg_scan(comps, sampling, mcux, mcuy, restart_interval,
               size) -> bytes:
    """The entropy-coded data of one interleaved (or single-component)
    baseline scan, byte-stuffed, with its restart markers."""
    ac_code = {sym: i for i, sym in enumerate(_AC_SYMBOLS)}
    if len(comps) == 1:
        # a one-component scan codes the component's own blocks only
        by_n, bx_n = -(-size[0] // 8), -(-size[1] // 8)
        mcus = [[(0, by, bx)] for by in range(by_n) for bx in range(bx_n)]
    else:
        mcus = [[(ci, my * fv + v, mx * fh + u)
                 for ci, (fh, fv) in enumerate(sampling)
                 for v in range(fv) for u in range(fh)]
                for my in range(mcuy) for mx in range(mcux)]
    out = bytearray()
    acc, n_acc = 0, 0
    pred = [0] * len(comps)

    def put(value, n):
        nonlocal acc, n_acc
        acc = acc << n | value
        n_acc += n
        while n_acc >= 8:
            n_acc -= 8
            byte = acc >> n_acc & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
        acc &= (1 << n_acc) - 1

    def magnitude(v):
        n = int(abs(v)).bit_length()
        return n, (v if v >= 0 else v + (1 << n) - 1)

    for k, mcu in enumerate(mcus):
        if restart_interval and k and k % restart_interval == 0:
            if n_acc:
                put((1 << (8 - n_acc)) - 1, 8 - n_acc)
            out += bytes([0xFF, 0xD0 + (k // restart_interval - 1) % 8])
            pred = [0] * len(comps)
        for ci, by, bx in mcu:
            blk = comps[ci][by, bx]
            diff = int(blk[0]) - pred[ci]
            pred[ci] = int(blk[0])
            n, bits = magnitude(diff)
            put(n, 4)
            if n:
                put(bits, n)
            nz = np.flatnonzero(blk[1:]) + 1
            last = 0
            for pos in nz.tolist():
                run = pos - last - 1
                while run > 15:
                    put(ac_code[0xF0], 8)
                    run -= 16
                n, bits = magnitude(int(blk[pos]))
                put(ac_code[run << 4 | n], 8)
                put(bits, n)
                last = pos
            if last != 63:
                put(ac_code[0x00], 8)
    if n_acc:
        put((1 << (8 - n_acc)) - 1, 8 - n_acc)
    return bytes(out)


def encode_jpeg_lossless(pixels: np.ndarray, *, predictor: int = 1,
                         point_transform: int = 0, sampling=None,
                         restart_interval: int = 0,
                         component_ids=(1, 2, 3), jfif: bool = False,
                         interleaved: bool = True) -> bytes:
    """A lossless JPEG (SOF3, T.81 Annex H) of uint8 [H, W] or [H, W, 3]
    samples, stored as they are (no colour transform): predictor 1-7,
    point transform Pt, sampling factors ((h, v) per component; a
    subsampled component takes the mean of each cell, rounded down), one
    interleaved scan or one scan per component, an optional restart
    interval (in MCUs; libjpeg needs whole MCU rows) and fixed-length
    5-bit codes for the 17 difference categories."""
    img = np.asarray(pixels, np.int64)
    if img.ndim == 2:
        img = img[..., None]
    h, w, nc = img.shape
    sampling = sampling or ((1, 1),) * nc
    hmax = max(f[0] for f in sampling)
    vmax = max(f[1] for f in sampling)
    mcux, mcuy = -(-w // hmax), -(-h // vmax)
    planes = []
    for k, (fh, fv) in enumerate(sampling):
        sy, sx = vmax // fv, hmax // fh
        full = np.pad(img[..., k], ((0, mcuy * vmax - h), (0, mcux * hmax - w)),
                      mode="edge")
        sub = full.reshape(full.shape[0] // sy, sy, full.shape[1] // sx,
                           sx).sum(axis=(1, 3)) // (sy * sx)
        planes.append(sub >> point_transform)
    dims = [(-(-h * fv // vmax), -(-w * fh // hmax)) for fh, fv in sampling]
    out = [b"\xff\xd8"]
    if jfif:
        out.append(_jpeg_segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0"))
    out.append(_jpeg_segment(0xC3, struct.pack(">BHHB", 8, h, w, nc)
                             + b"".join(bytes([component_ids[k], fh << 4 | fv,
                                               0])
                                        for k, (fh, fv) in
                                        enumerate(sampling))))
    counts = [0] * 16
    counts[4] = 17
    out.append(_jpeg_segment(0xC4, bytes([0] + counts + list(range(17)))))
    if restart_interval:
        out.append(_jpeg_segment(0xDD, struct.pack(">H", restart_interval)))
    scans = [tuple(range(nc))] if interleaved else [(k,) for k in range(nc)]
    for members in scans:
        out.append(_jpeg_segment(0xDA, bytes([len(members)]) + b"".join(
            bytes([component_ids[k], 0]) for k in members)
            + bytes([predictor, 0, point_transform])))
        out.append(_lossless_data(planes, dims, sampling, members, mcux,
                                  mcuy, predictor, point_transform,
                                  restart_interval))
    out.append(b"\xff\xd9")
    return b"".join(out)


def _lossless_data(planes, dims, sampling, members, mcux, mcuy, predictor,
                   pt, restart_interval) -> bytes:
    """One lossless scan's entropy-coded data."""
    # each component's predictions: the first row of the scan (and of
    # each restart interval) along the row from 2^(7 - Pt), the others
    # by the predictor, their first sample from above
    if len(members) == 1:
        dh, dw = dims[members[0]]
        per_row, rows_per_mcu = dw, [1]
        mcus = [[(members[0], y, x)] for y in range(dh) for x in range(dw)]
    else:
        per_row = mcux
        mcus = [[(k, my * sampling[k][1] + v, mx * sampling[k][0] + u)
                 for k in members for v in range(sampling[k][1])
                 for u in range(sampling[k][0])]
                for my in range(mcuy) for mx in range(mcux)]
    rows_per_interval = restart_interval // per_row if restart_interval \
        else 0
    diffs = {}
    for k in members:
        x = planes[k]
        fv = 1 if len(members) == 1 else sampling[k][1]
        pred = np.zeros_like(x)
        for y in range(x.shape[0]):
            fresh = y == 0 or (rows_per_interval
                               and y % (fv * rows_per_interval) == 0)
            if fresh:
                pred[y, 0] = 1 << (8 - pt - 1)
                pred[y, 1:] = x[y, :-1]
                continue
            ra = np.concatenate([[0], x[y, :-1]])
            rb = x[y - 1]
            rc = np.concatenate([[0], x[y - 1, :-1]])
            p = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                 5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                 7: (ra + rb) >> 1}[predictor]
            p = p.copy()
            p[0] = rb[0]
            pred[y] = p
        d = (x - pred) & 0xFFFF
        diffs[k] = np.where(d >= 0x8000, d - 0x10000, d)
    data = bytearray()
    acc, n_acc = 0, 0

    def put(value, n):
        nonlocal acc, n_acc
        acc = acc << n | value
        n_acc += n
        while n_acc >= 8:
            n_acc -= 8
            byte = acc >> n_acc & 0xFF
            data.append(byte)
            if byte == 0xFF:
                data.append(0)
        acc &= (1 << n_acc) - 1

    for i, mcu in enumerate(mcus):
        if restart_interval and i and i % restart_interval == 0:
            if n_acc:
                put((1 << (8 - n_acc)) - 1, 8 - n_acc)
            data += bytes([0xFF, 0xD0 + (i // restart_interval - 1) % 8])
        for k, y, x in mcu:
            dy, dx = diffs[k].shape
            v = int(diffs[k][y, x]) if y < dy and x < dx else 0
            s = 16 if v == -32768 else abs(v).bit_length()
            put(s, 5)
            if 0 < s < 16:
                put(v if v > 0 else v + (1 << s) - 1, s)
    if n_acc:
        put((1 << (8 - n_acc)) - 1, 8 - n_acc)
    return bytes(data)


class _ArithConditioning:
    """DAC's conditioning (L, U per DC table, K per AC table), with
    SOI's defaults."""

    def __init__(self, dac: dict):
        self.lo, self.hi, self.kx = [0] * 16, [1] * 16, [5] * 16
        for index, val in dac.items():
            if index >= 16:
                self.kx[index - 16] = val
            else:
                self.lo[index], self.hi[index] = val & 15, val >> 4


def _arith_scans(n_comps: int, progressive: bool) -> list:
    """(component indices, Ss, Se, Ah, Al) of each scan: one sequential
    scan, or jpeg_simple_progression's script (jcparam.c)."""
    every = tuple(range(n_comps))
    if not progressive:
        return [(every, 0, 63, 0, 0)]
    if n_comps == 3:
        return [(every, 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2),
                ((0,), 1, 63, 2, 1), (every, 0, 0, 1, 0),
                ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                ((0,), 1, 63, 1, 0)]
    return [(every, 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
            ((0,), 1, 63, 2, 1), (every, 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]


class _ArithEncoder:
    """jcarith.c's arith_encode and finish_pass: the QM coder with its
    carry handling, 0xFF stuffing and trailing-zero trimming."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.ct = 0, 0x10000, 11
        self.sc, self.zc, self.buffer = 0, 0, -1

    def _emit(self, b: int) -> None:
        self.out.append(b)

    def _flush_zeros(self) -> None:
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, st, k: int, val: int) -> None:
        sv = st[k]
        qe, nm, nl = _QE[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[k] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[k] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._flush_zeros()
                        for _ in range(self.sc):
                            self.out += b"\xff\x00"
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._flush_zeros()
                for _ in range(self.sc):
                    self.out += b"\xff\x00"
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_zeros()
            b = (self.c >> 19) & 0xFF
            self._emit(b)
            if b == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self._emit(b)
                if b == 0xFF:
                    self._emit(0)
        return bytes(self.out)


def _arith_value(enc, stats, st: int, v: int, x1: int, fixed=None) -> None:
    """Figures F.6-F.9 for a nonzero v: its sign (in bin st + 1 for DC,
    the fixed bin for AC), magnitude category and bits. x1 < 0: DC (the
    categories in bins 20 on); else AC, categories past the second in
    bins x1 on."""
    if fixed is None:
        enc.encode(stats, st + 1, int(v < 0))
        st += 3 if v < 0 else 2
    else:
        enc.encode(fixed, 0, int(v < 0))
        st += 2
    v = abs(v) - 1
    m = 0
    if v:
        enc.encode(stats, st, 1)
        m = 1
        v2 = v >> 1
        if x1 < 0:
            st = 20
            while v2:
                enc.encode(stats, st, 1)
                m <<= 1
                st += 1
                v2 >>= 1
        elif v2:
            enc.encode(stats, st, 1)
            m <<= 1
            st = x1
            v2 >>= 1
            while v2:
                enc.encode(stats, st, 1)
                m <<= 1
                st += 1
                v2 >>= 1
    enc.encode(stats, st, 0)
    st += 14
    m >>= 1
    while m:
        enc.encode(stats, st, int(bool(m & v)))
        m >>= 1


def _arith_scan(comps, sampling, mcux, mcuy, restart_interval, size, scan,
                cond) -> bytes:
    """One arithmetic-coded scan of quantized blocks (zigzag order),
    byte-stuffed, with its restart markers."""
    members, ss, se, ah, al = scan
    if len(members) == 1:
        ci = members[0]
        fh, fv = sampling[ci]
        hmax = max(f[0] for f in sampling)
        vmax = max(f[1] for f in sampling)
        bh = -(-(-(-size[0] * fv // vmax)) // 8)
        bw = -(-(-(-size[1] * fh // hmax)) // 8)
        mcus = [[(0, ci, by, bx)] for by in range(bh) for bx in range(bw)]
    else:
        mcus = [[(k, ci, my * sampling[ci][1] + v, mx * sampling[ci][0] + u)
                 for k, ci in enumerate(members)
                 for v in range(sampling[ci][1])
                 for u in range(sampling[ci][0])]
                for my in range(mcuy) for mx in range(mcux)]
    out = bytearray()
    fixed = bytearray([113])

    def fresh():
        return ({min(ci, 1): bytearray(64) for ci in members},
                {min(ci, 1): bytearray(256) for ci in members},
                [0] * len(members), [0] * len(members))

    dc_stats, ac_stats, last, ctx = fresh()
    enc = _ArithEncoder()
    for n, mcu in enumerate(mcus):
        if restart_interval and n and n % restart_interval == 0:
            out += enc.finish() + bytes(
                [0xFF, 0xD0 + (n // restart_interval - 1) % 8])
            dc_stats, ac_stats, last, ctx = fresh()
            enc = _ArithEncoder()
        for k, ci, by, bx in mcu:
            blk = [int(x) for x in comps[ci][by, bx]]
            tbl = min(ci, 1)
            if ss == 0 and ah == 0:
                dc = blk[0] >> al
                v = dc - last[k]
                st = ctx[k]
                if v == 0:
                    enc.encode(dc_stats[tbl], st, 0)
                    ctx[k] = 0
                else:
                    last[k] = dc
                    enc.encode(dc_stats[tbl], st, 1)
                    _arith_value(enc, dc_stats[tbl], st, v, -1)
                    m = abs(v) - 1
                    m = 1 << (m.bit_length() - 1) if m else 0
                    if m < (1 << cond.lo[tbl]) >> 1:
                        ctx[k] = 0
                    elif m > (1 << cond.hi[tbl]) >> 1:
                        ctx[k] = 12 + 4 * int(v < 0)
                    else:
                        ctx[k] = 4 + 4 * int(v < 0)
                if ss == 0 and se == 0:
                    continue
                _arith_ac_block(enc, ac_stats[tbl], fixed, blk, 1, 63, 0,
                                cond.kx[tbl])
            elif ss == 0:
                enc.encode(fixed, 0, (blk[0] >> al) & 1)
            elif ah == 0:
                _arith_ac_block(enc, ac_stats[tbl], fixed, blk, ss, se, al,
                                cond.kx[tbl])
            else:
                _arith_ac_refine_block(enc, ac_stats[tbl], fixed, blk, ss,
                                       se, ah, al)
    return bytes(out + enc.finish())


def _shifted(v: int, al: int) -> int:
    """An AC coefficient's point transform: |v| >> al with v's sign."""
    return (abs(v) >> al) * (1 if v >= 0 else -1)


def _arith_ac_block(enc, stats, fixed, blk, ss, se, al, kx) -> None:
    """Figure F.5 over the band ss..se of a block (zigzag order) after
    its point transform by al."""
    ke = se
    while ke > 0 and not _shifted(blk[ke], al):
        ke -= 1
    k = ss
    while k <= ke:
        st = 3 * (k - 1)
        enc.encode(stats, st, 0)
        while not _shifted(blk[k], al):
            enc.encode(stats, st + 1, 0)
            st += 3
            k += 1
        enc.encode(stats, st + 1, 1)
        _arith_value(enc, stats, st, _shifted(blk[k], al),
                     189 if k <= kx else 217, fixed)
        k += 1
    if k <= se:
        enc.encode(stats, 3 * (k - 1), 1)


def _arith_ac_refine_block(enc, stats, fixed, blk, ss, se, ah, al) -> None:
    """Figure G.10: the refinement scan of a block's band."""
    ke = se
    while ke > 0 and not _shifted(blk[ke], al):
        ke -= 1
    kex = ke
    while kex > 0 and not _shifted(blk[kex], ah):
        kex -= 1
    k = ss
    while k <= ke:
        st = 3 * (k - 1)
        if k > kex:
            enc.encode(stats, st, 0)
        while True:
            v = abs(blk[k]) >> al
            if v:
                if v >> 1:
                    enc.encode(stats, st + 2, v & 1)
                else:
                    enc.encode(stats, st + 1, 1)
                    enc.encode(fixed, 0, int(blk[k] < 0))
                break
            enc.encode(stats, st + 1, 0)
            st += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(stats, 3 * (k - 1), 1)


def _lzw_codes(indices: bytes, min_bits: int) -> list:
    """GIF LZW compression: (code, width) pairs, a clear first and the
    end code last, the table cleared when it fills."""
    clear = 1 << min_bits
    codes = [(clear, min_bits + 1)]
    table = {bytes([i]): i for i in range(clear)}
    nxt, width = clear + 2, min_bits + 1
    cur = b""
    for i in range(len(indices)):
        ext = cur + indices[i:i + 1]
        if ext in table:
            cur = ext
            continue
        codes.append((table[cur], width))
        if nxt < 4096:
            table[ext] = nxt
            nxt += 1
            # the decoder adds each entry one code later, so the width
            # grows one code after the entry that fills it
            if nxt > 1 << width and width < 12:
                width += 1
        else:
            codes.append((clear, width))
            table = {bytes([i]): i for i in range(clear)}
            nxt, width = clear + 2, min_bits + 1
        cur = indices[i:i + 1]
    if cur:
        codes.append((table[cur], width))
    codes.append((clear + 1, width))
    return codes


def encode_gif(indices: np.ndarray, palette: np.ndarray, *,
               interlace: bool = False, transparency: int | None = None,
               local_table: bool = False, screen=None,
               offset=(0, 0)) -> bytes:
    """A one-frame GIF89a of uint8 indices [h, w] with a colour table
    uint8 [n, 3] (padded to 2^k black entries; global, or local to the
    frame), LZW-compressed;
    `screen` (w, h) may be smaller than the frame, `offset` places it."""
    h, w = indices.shape
    bits = max(1, int(len(palette) - 1).bit_length())
    table = np.zeros((1 << bits, 3), np.uint8)
    table[:len(palette)] = palette
    # indices may pass the table: the code size covers the largest
    min_bits = max(2, bits, int(indices.max(initial=0)).bit_length())
    sw, sh = screen or (w + offset[0], h + offset[1])
    out = bytearray(b"GIF89a" + struct.pack(
        "<HHBBB", sw, sh, 0 if local_table else 0x80 | (bits - 1), 0, 0))
    if not local_table:
        out += table.tobytes()
    if transparency is not None:
        out += struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 1, 0, transparency, 0)
    flags = (0x40 if interlace else 0) | (0x80 | (bits - 1)
                                          if local_table else 0)
    out += struct.pack("<BHHHHB", 0x2C, offset[0], offset[1], w, h, flags)
    if local_table:
        out += table.tobytes()
    rows = np.arange(h)
    if interlace:
        rows = np.concatenate([rows[0::8], rows[4::8], rows[2::4],
                               rows[1::2]])
    acc, n_acc, stream = 0, 0, bytearray()
    for code, width in _lzw_codes(indices[rows].astype(np.uint8).tobytes(),
                                  min_bits):
        acc |= code << n_acc
        n_acc += width
        while n_acc >= 8:
            stream.append(acc & 0xFF)
            acc >>= 8
            n_acc -= 8
    if n_acc:
        stream.append(acc & 0xFF)
    out.append(min_bits)
    for i in range(0, len(stream), 255):
        chunk = stream[i:i + 255]
        out += bytes([len(chunk)]) + chunk
    return bytes(out + b"\0;")


def encode_fax(bits: np.ndarray, *, group: int = 4,
               two_d: bool = True) -> bytes:
    """CCITT fax coding of uint8 [h, w] bits (1 = black) for one TIFF
    strip or tile: T.6 (group 4), T.4 (group 3, an EOL before every row,
    then with two_d a tag bit: every row but the first 2-D coded) or
    TIFF's CCITT RLE (group 2: Modified Huffman, every row 1-D and padded
    to a byte, no EOLs), MSB first, the last byte padded with zeros. The
    run codes are io/fax.py's tables."""
    white = {r: c for c, r in fax._run_codes(fax._WHITE).items()}
    black = {r: c for c, r in fax._run_codes(fax._BLACK).items()}
    modes = {m: c for c, m in fax._MODES.items()}
    out = []

    def run(length, colour):
        table = black if colour else white
        while length >= 2560:
            out.append(table[2560])
            length -= 2560
        if length >= 64:
            out.append(table[length // 64 * 64])
        out.append(table[length % 64])

    h, w = bits.shape
    ref = [w, w]
    for y in range(h):
        row = bits[y].astype(np.int8)
        changes = (np.flatnonzero(np.diff(np.concatenate([[0], row])))
                   .tolist())
        if group == 3:
            out.append("000000000001")
            if two_d:
                out.append("1" if y == 0 else "0")
        if group == 2 or group == 3 and (not two_d or y == 0):
            a0, colour = 0, 0
            for c in changes + [w]:
                run(c - a0, colour)
                a0, colour = c, colour ^ 1
                if c == w:
                    break
            if group == 2:
                out.append("0" * (-len("".join(out)) % 8))
        else:
            line = changes + [w, w]
            a0, colour = -1, 0
            while a0 < w:
                a1 = next(c for c in line if c > a0)
                i = colour
                while i < len(ref) and ref[i] <= a0:
                    i += 2
                b1 = ref[i] if i < len(ref) else w
                b2 = ref[i + 1] if i + 1 < len(ref) else w
                if b2 < a1:
                    out.append(modes["P"])
                    a0 = b2
                elif abs(a1 - b1) <= 3:
                    out.append(modes[a1 - b1])
                    a0, colour = a1, colour ^ 1
                else:
                    a2 = next((c for c in line if c > a1), w)
                    out.append(modes["H"])
                    run(a1 - max(a0, 0), colour)
                    run(a2 - a1, colour ^ 1)
                    a0 = a2
        ref = changes + [w, w]
    text = "".join(out)
    text += "0" * (-len(text) % 8)
    return int(text, 2).to_bytes(len(text) // 8, "big") if text else b""


def encode_tiff(samples: np.ndarray, *, photometric: int,
                compression: int = 1, predictor: int = 1, planar: int = 1,
                big_endian: bool = False, rows_per_strip: int | None = None,
                colormap: np.ndarray | None = None,
                extra_tags: dict | None = None, bits: int | None = None,
                fill_order: int = 1) -> bytes:
    """A strip TIFF of samples [h, w, spp] (uint8, uint16, uint32 or
    float32), uncompressed (1), LZW (5), Deflate (8, 32946), PackBits
    (32773), LZMA (34925) or Zstandard (50000, encode_zstd's raw and RLE
    blocks), with the horizontal predictor (2) and planar configuration 2
    on request; `bits` < 8 packs uint8 samples MSB first, each row on a
    byte; fill_order 2 reverses the bits of every byte; colormap uint16
    [3, n] for a palette (photometric 3); extra_tags {tag: [LONG
    values]}."""
    e = ">" if big_endian else "<"
    h, w, spp = samples.shape
    bits = bits or samples.dtype.itemsize * 8
    x = samples.astype(samples.dtype.newbyteorder(e))
    if predictor == 2:
        # differences of the samples' bit patterns, float32 too
        u = x.view(np.dtype(f"{e}u{x.dtype.itemsize}"))
        d = u.astype(np.int64)
        d[:, 1:] -= u[:, :-1].astype(np.int64)
        x = (d % (1 << bits)).astype(u.dtype).view(x.dtype)
    planes = ([x[..., p:p + 1] for p in range(spp)] if planar == 2 else [x])
    rps = rows_per_strip or h
    strips = []
    for plane in planes:
        for r0 in range(0, h, rps):
            rows = plane[r0:r0 + rps]
            raw = (_pack_bits(rows, bits) if bits < 8
                   else np.ascontiguousarray(rows).tobytes())
            strips.append(compress_tiff_chunk(raw, compression))
    tags = {277: [spp]}
    if colormap is not None:
        tags[320] = np.asarray(colormap).reshape(-1).tolist()
    if samples.dtype == np.float32:
        tags[339] = [3]
    if predictor != 1:
        tags[317] = [predictor]
    tags.update(extra_tags or {})
    return encode_tiff_chunks(
        strips, w=w, h=h, bits=[bits] * spp, photometric=photometric,
        compression=compression, planar=planar, big_endian=big_endian,
        chunk=(w, rps), extra_tags=tags, fill_order=fill_order)


def compress_tiff_chunk(raw: bytes, compression: int) -> bytes:
    """One strip or tile coded in a TIFF compression: 1, 5 (LZW), 8 and
    32946 (Deflate), 32773 (PackBits), 34925 (LZMA: an .xz stream) or
    50000 (encode_zstd)."""
    if compression == 1:
        return raw
    if compression == 5:
        return _lzw_encode(raw)
    if compression in (8, 32946):
        return zlib.compress(raw)
    if compression == 32773:
        return _packbits_encode(raw)
    if compression == 34925:
        import lzma

        return lzma.compress(raw, format=lzma.FORMAT_XZ)
    if compression == 50000:
        return encode_zstd(raw)
    raise ValueError(f"no encoder for TIFF compression {compression}")


def _lzw_encode(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it: MSB-first codes of 9-12 bits, a
    clear code first and whenever the table fills, the width growing when
    the next free code passes the current width's largest, end code
    last."""
    bits, n_bits = [], 0

    def emit(code, width):
        nonlocal n_bits
        bits.append((code, width))
        n_bits += width

    width, table, nxt = 9, {}, 258
    emit(256, width)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if not w or wc in table:
            w = wc
            continue
        emit(table[w] if len(w) > 1 else w[0], width)
        table[wc] = nxt
        nxt += 1
        if nxt == 4093:
            emit(256, width)
            width, table, nxt = 9, {}, 258
        elif nxt > (1 << width) - 1:
            width += 1
        w = bytes([c])
    if w:
        emit(table[w] if len(w) > 1 else w[0], width)
    emit(257, width)
    value = 0
    for code, wd in bits:
        value = (value << wd) | code
    pad = -n_bits % 8
    return (value << pad).to_bytes((n_bits + pad) // 8, "big")


def _packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 3 to 128 equal bytes as (257 - n, byte), the
    rest as literal runs of up to 128 bytes."""
    out, i, lit = bytearray(), 0, bytearray()

    def flush():
        for k in range(0, len(lit), 128):
            part = lit[k:k + 128]
            out.extend(bytes([len(part) - 1]) + part)
        lit.clear()

    while i < len(data):
        j = i
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            flush()
            out.extend(bytes([257 - (j - i), data[i]]))
            i = j
        else:
            lit.append(data[i])
            i += 1
    flush()
    return bytes(out)


def encode_zstd(data: bytes, *, block_size: int = 1 << 17,
                checksum: bool = False, content_size: bool = True,
                single_segment: bool = False,
                skippable: bytes | None = None) -> bytes:
    """A Zstandard frame of raw and RLE blocks only (a run of one byte
    value becomes an RLE block): blocks of at most `block_size` bytes,
    with or without the frame content size (4 bytes, or 8 past 2^32) and
    the XXH64 content checksum, in one segment (no window descriptor) on
    request; `skippable` puts a skippable frame of those bytes first."""
    desc = (4 if checksum else 0) | (32 if single_segment else 0)
    head = b""
    if not single_segment:
        log = max(10, (max(len(data), 1) - 1).bit_length())
        head += bytes([(log - 10) << 3])
    if content_size or single_segment:
        wide = len(data) >= 1 << 32
        desc |= (3 if wide else 2) << 6
        head += len(data).to_bytes(8 if wide else 4, "little")
    out = bytearray()
    if skippable is not None:
        out += struct.pack("<II", 0x184D2A50, len(skippable)) + skippable
    out += struct.pack("<I", 0xFD2FB528) + bytes([desc]) + head
    starts = list(range(0, len(data), block_size)) or [0]
    for k, at in enumerate(starts):
        part = data[at:at + block_size]
        last = int(k == len(starts) - 1)
        if len(part) > 1 and part.count(part[:1]) == len(part):
            out += (last | 2 | len(part) << 3).to_bytes(3, "little")
            out += part[:1]
        else:
            out += (last | len(part) << 3).to_bytes(3, "little") + part
    if checksum:
        out += struct.pack("<I", zstd.xxh64(data) & 0xFFFFFFFF)
    return bytes(out)


def encode_zstd_sequences() -> tuple:
    """A Zstandard frame of two compressed blocks whose sequences use RLE
    tables for all three codes (each block's sequences share their
    codes) -> (frame, its 26 bytes of content). Block 1: raw literals
    "0123456789", one sequence of 10 literals and a new offset 5 of 5
    bytes. Block 2: RLE literals "zzz" and two sequences without
    literals: Offset_Value 3 (the first repeat offset minus one: 4),
    then Offset_Value 2 (after no literals, the third repeat: 1), 4
    bytes each; the content checksum last."""
    def block(body: bytes, last: int) -> bytes:
        return (last | 2 << 1 | len(body) << 3).to_bytes(3, "little") + body

    # literals header, sequence count, modes (RLE, RLE, RLE), the LL, OF
    # and ML codes, then the bitstream (extra bits, end mark highest)
    first = bytes([10 << 3]) + b"0123456789" + bytes([1, 0x54, 10, 3, 2,
                                                      0b1000])
    second = bytes([3 << 3 | 1]) + b"z" + bytes([2, 0x54, 0, 1, 1, 0b110])
    content = b"0123456789" + b"56789" + b"6789" + b"9999" + b"zzz"
    frame = (struct.pack("<I", 0xFD2FB528) + bytes([2 << 6 | 32 | 4])
             + struct.pack("<I", len(content)) + block(first, 0)
             + block(second, 1)
             + struct.pack("<I", zstd.xxh64(content) & 0xFFFFFFFF))
    return frame, content


def _pack_bits(rows: np.ndarray, bits: int) -> bytes:
    """uint8 samples [h, w, c] of `bits` bits -> rows packed MSB first,
    each padded to a byte."""
    h = rows.shape[0]
    flat = rows.reshape(h, -1).astype(np.uint8)
    per = 8 // bits
    n = -(-flat.shape[1] // per)
    padded = np.zeros((h, n * per), np.uint8)
    padded[:, :flat.shape[1]] = flat
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    return (padded.reshape(h, n, per) << shifts).sum(2).astype(
        np.uint8).tobytes()


def encode_tiff_chunks(chunks: list, *, w: int, h: int, bits: list,
                       photometric: int, compression: int, planar: int = 1,
                       big_endian: bool = False, chunk: tuple | None = None,
                       tiled: bool = False, extra_tags: dict | None = None,
                       fill_order: int = 1) -> bytes:
    """A TIFF around already coded strips or tiles (chunk = (width,
    height) of a strip or tile, tiles with tiled=True; in the order a
    reader takes them: plane by plane, row of tiles by row). fill_order 2
    reverses the bits of every chunk's bytes. extra_tags {tag: values}
    are SHORT where every value fits, LONG otherwise; bytes values are
    UNDEFINED (JPEGTables)."""
    e = ">" if big_endian else "<"
    cw, ch = chunk or (w, h)
    if fill_order == 2:
        rev = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
        chunks = [c.translate(rev) for c in chunks]
    tags = {256: [w], 257: [h], 258: list(bits), 259: [compression],
            262: [photometric], 277: [len(bits)], 284: [planar]}
    if fill_order != 1:
        tags[266] = [fill_order]
    if tiled:
        tags.update({322: [cw], 323: [ch], 324: [0] * len(chunks),
                     325: [len(c) for c in chunks]})
    else:
        tags.update({273: [0] * len(chunks), 278: [ch],
                     279: [len(c) for c in chunks]})
    tags.update(extra_tags or {})
    ifd_off = 8
    extra_off = ifd_off + 2 + 12 * len(tags) + 4
    entries = []
    for tag in sorted(tags):
        vals = tags[tag]
        if isinstance(vals, (bytes, bytearray)):
            typ, body = 7, bytes(vals)
        else:
            typ = 3 if max(vals, default=0) < 1 << 16 \
                and tag not in (273, 279, 324, 325) else 4
            body = struct.pack(f"{e}{len(vals)}{'H' if typ == 3 else 'I'}",
                               *vals)
        entries.append((tag, typ, len(vals), body))
    data_off = extra_off + sum(len(b) for *_, b in entries if len(b) > 4)
    offsets, pos = [], data_off
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    out = bytearray((b"MM" if big_endian else b"II")
                    + struct.pack(e + "HI", 42, ifd_off)
                    + struct.pack(e + "H", len(entries)))
    extra = bytearray()
    for tag, typ, count, body in entries:
        if tag in (273, 324):
            body = struct.pack(f"{e}{count}I", *offsets)
        if len(body) > 4:
            out += struct.pack(e + "HHII", tag, typ, count,
                               extra_off + len(extra))
            extra += body
        else:
            out += struct.pack(e + "HHI", tag, typ, count) + body.ljust(4,
                                                                   b"\0")
    out += struct.pack(e + "I", 0) + extra
    return bytes(out + b"".join(chunks))


_STROKE_WIDTH = 3
_STROKE_LENGTH = 300


def synthetic_cdm(rng: np.random.Generator, height: int, width: int, *,
                  fg_fraction: float = 0.06) -> np.ndarray:
    """One synthetic CDM, uint8 [height, width, 3], with about
    `fg_fraction` of its pixels covered by hue-coded strokes."""
    img = np.zeros((height, width, 3), np.uint8)
    steps = max(1, int(fg_fraction * height * width / _STROKE_WIDTH))
    length = max(8, min(_STROKE_LENGTH, (height + width) // 2))
    n_strokes = max(1, -(-steps // length))
    # smooth random walks: the heading turns a little at each unit step
    heading = rng.uniform(0, 2 * np.pi, (n_strokes, 1)) + np.cumsum(
        rng.normal(0, 0.12, (n_strokes, length)), axis=1)
    y = rng.uniform(0, height, (n_strokes, 1)) + np.cumsum(
        np.sin(heading), axis=1)
    x = rng.uniform(0, width, (n_strokes, 1)) + np.cumsum(
        np.cos(heading), axis=1)
    # depth drifts slowly along a stroke; intensity is set per stroke
    z = np.clip(rng.uniform(0, 255, (n_strokes, 1)) + np.cumsum(
        rng.normal(0, 0.4, (n_strokes, length)), axis=1), 0, 255)
    gain = rng.uniform(0.55, 1.0, (n_strokes, 1)) * np.ones((1, length))
    color = (RAINBOW_LUT[z.astype(np.int64).ravel()]
             * gain.ravel()[:, None]).astype(np.uint8)
    yy = np.rint(y).astype(np.int64).ravel()
    xx = np.rint(x).astype(np.int64).ravel()
    half = _STROKE_WIDTH // 2
    for oy in range(-half, _STROKE_WIDTH - half):
        for ox in range(-half, _STROKE_WIDTH - half):
            py, px = yy + oy, xx + ox
            ok = (py >= 0) & (py < height) & (px >= 0) & (px < width)
            img[py[ok], px[ok]] = color[ok]
    return img


def scattered_pixels(rng: np.random.Generator, height: int, width: int,
                     n: int) -> np.ndarray:
    """uint8 [height, width, 3] with `n` pixels set to random colors at
    random places (every class, ties and near-threshold values occur)."""
    img = np.zeros((height, width, 3), np.uint8)
    ys = rng.integers(0, height, n)
    xs = rng.integers(0, width, n)
    img[ys, xs] = rng.integers(0, 256, (n, 3))
    return img


def cut_mask(rng: np.random.Generator, target: np.ndarray, *,
             shift: tuple[int, int], mirror: bool = False) -> np.ndarray:
    """A mask cut from `target`: the pixels inside a random box covering
    about 40% of the image, moved by `shift` = (dx, dy) and optionally
    mirrored left-right."""
    h, w = target.shape[:2]
    side = np.sqrt(0.4)
    bh, bw = max(1, int(h * side)), max(1, int(w * side))
    y0 = int(rng.integers(0, h - bh + 1))
    x0 = int(rng.integers(0, w - bw + 1))
    cut = np.zeros_like(target)
    cut[y0:y0 + bh, x0:x0 + bw] = target[y0:y0 + bh, x0:x0 + bw]
    dx, dy = shift
    out = np.zeros_like(target)
    out[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        cut[max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)]
    return np.ascontiguousarray(out[:, ::-1]) if mirror else out


def synthetic_gradient(rng: np.random.Generator, cdm: np.ndarray, *,
                       mask_threshold: int = 20) -> np.ndarray:
    """A GradientImage variant of `cdm`: uint16 [H, W], random 0..399,
    and 0 on the foreground (any channel above `mask_threshold`), as
    precomputeVariants writes it."""
    grad = rng.integers(0, 400, cdm.shape[:2], dtype=np.uint16)
    grad[(cdm > mask_threshold).any(axis=-1)] = 0
    return grad


def _window_max(a: np.ndarray, radius: int, axis: int,
                step: int = 1) -> np.ndarray:
    """max over the elements i + step * d, |d| <= radius, along `axis`
    (zeros outside): windows doubled by shifted np.maximum, then two
    overlapping ones."""
    def span(m, start, stop):
        idx = [slice(None)] * m.ndim
        idx[axis] = slice(start, stop)
        return m[tuple(idx)]

    n = a.shape[axis]
    size = 2 * radius + 1
    pad = [(0, 0)] * a.ndim
    pad[axis] = (radius * step, radius * step)
    m = np.pad(a, pad)
    k = 1  # m[i] = max of the padded a[i + step * j], 0 <= j < k
    while 2 * k <= size:
        m = np.maximum(span(m, 0, m.shape[axis] - k * step),
                       span(m, k * step, None))
        k *= 2
    return np.maximum(span(m, 0, n),
                      span(m, (size - k) * step, (size - k) * step + n))


def synthetic_zgap(cdm: np.ndarray, *, mask_threshold: int = 20,
                   radius: int = 20) -> np.ndarray:
    """A ZGapImage variant of `cdm`: the masked CDM (channels of pixels
    with none above `mask_threshold` cleared) dilated by a per-channel
    max over a (2 radius + 1)^2 square, uint8 [H, W, 3]: 24 shifted
    np.maximum passes at radius 20, which release the GIL."""
    keep = (cdm > mask_threshold).any(axis=-1)
    out = np.where(keep[..., None], cdm, 0).astype(np.uint8)
    h, w = out.shape[:2]
    # rows of interleaved RGB: a pixel's same channel is 3 bytes away
    rows = _window_max(out.reshape(h, 3 * w), radius, 0)
    return _window_max(rows, radius, 1, step=3).reshape(h, w, 3)


@dataclasses.dataclass
class SyntheticLibrary:
    targets: list[np.ndarray]
    masks: list[np.ndarray]


def synthetic_library(rng: np.random.Generator, n_targets: int,
                      n_masks: int, height: int, width: int, *,
                      target_fg: float = 0.06,
                      mask_fg: float = 0.015) -> SyntheticLibrary:
    """Targets at `target_fg` foreground; masks: every other one (at
    least a third of them) cut from a target with a small even or odd
    shift, one of those mirrored, the rest independent sparser images."""
    targets = [synthetic_cdm(rng, height, width, fg_fraction=target_fg)
               for _ in range(n_targets)]
    masks = []
    shifts = [(0, 0), (2, 0), (0, -2), (-2, 2), (1, 0), (0, 3)]
    for i in range(n_masks):
        if i % 2 == 0 and n_targets:
            src = int(rng.integers(0, n_targets))
            masks.append(cut_mask(rng, targets[src],
                                  shift=shifts[(i // 2) % len(shifts)],
                                  mirror=i == 2))
        else:
            masks.append(synthetic_cdm(rng, height, width,
                                       fg_fraction=mask_fg))
    return SyntheticLibrary(targets, masks)


def write_neuron_images(directory, images: list[np.ndarray], prefix: str, *,
                        gradients: list[np.ndarray] | None = None,
                        zgaps: list[np.ndarray] | None = None,
                        threads: int = 8) -> list[Neuron]:
    """Write `images` as PNGs under `directory` and return one neuron
    per image whose InputColorDepthImage is that file. With `gradients`
    / `zgaps`, each neuron's GradientImage / ZGapImage is the variant
    written under `directory`/grad and `directory`/zgap."""
    directory = str(directory)
    jobs = {ComputeFileType.InputColorDepthImage: (directory, "", images)}
    if gradients is not None:
        jobs[ComputeFileType.GradientImage] = (
            os.path.join(directory, "grad"), "_gradient", gradients)
    if zgaps is not None:
        jobs[ComputeFileType.ZGapImage] = (
            os.path.join(directory, "zgap"), "_20pxRGB", zgaps)
    paths = {}
    for ftype, (d, suffix, imgs) in jobs.items():
        if len(imgs) != len(images):
            raise ValueError(f"{len(imgs)} {ftype.value} variants for "
                             f"{len(images)} images")
        os.makedirs(d, exist_ok=True)
        paths[ftype] = [os.path.join(d, f"{prefix}{i:05d}{suffix}.png")
                        for i in range(len(images))]
    with concurrent.futures.ThreadPoolExecutor(max_workers=threads) as pool:
        for ftype, (_, _, imgs) in jobs.items():
            list(pool.map(write_png, paths[ftype], imgs))
    neurons = []
    for i in range(len(images)):
        n = LMNeuron(mip_id=f"{prefix}-{i:05d}", library_name="synthetic",
                     published_name=f"{prefix}{i:05d}")
        for ftype, ps in paths.items():
            n.set_compute_file(ftype, ps[i])
        neurons.append(n)
    return neurons


# The edge shapes of the union kernels (K3, K13, row 14), which split the
# union into chunks over the grid: (name, xy_shift, mirror, masks in the
# batch, union cut to this many elements or None, slot-2 prefix u2 or
# None for the batch's own, union elements a block (0: the kernel's
# choice)). 17 and 25 lanes take two and three lane groups of 9.
UNION_EDGE_CASES = (
    ("lanes_25", 6, True, 3, None, None, 0),
    ("lanes_17", 4, True, 2, None, None, 256),
    ("no_mirror", 2, False, 3, None, None, 0),
    ("batch_1", 2, True, 1, None, None, 128),
    ("ragged_union", 2, True, 2, 1700, None, 256),
    ("u2_on_chunk_edge", 2, True, 2, None, 512, 256),
    ("u2_past_chunk_edge", 2, True, 2, None, 513, 256),
    ("u2_before_chunk_edge", 2, True, 2, None, 511, 256),
    ("u2_inside_ragged_chunk", 2, True, 2, 1700, 300, 200),
)


def union_edge_batch(rng: np.random.Generator, case: tuple, h: int, w: int,
                     device) -> dict:
    """One UNION_EDGE_CASES batch on `device`, from random masks of h x
    w: {"union": (u_pos, mu_pos, lane_lo, lane_span, u2) for K3 and K13,
    "qkeys": (u_pos, mu_pos, qidx, key_list, tab_lo, tab_span, u2) for
    row 14, "chunk": chunk}. The lane tables are K2's expansion (its
    plain version); a cut union keeps the first elements of every
    array."""
    from colormipsearch_tpu_torch import convert
    from colormipsearch_tpu_torch.oracle.pixel import shift_offsets
    from colormipsearch_tpu_torch.ops import pixel_match as pm

    _, xy, mirror, n_masks, cut, u2, chunk = case
    plans = [pm.build_full_union_key_plan(
        scattered_pixels(rng, h, w, 250), 20, mirror=mirror, xy_shift=xy,
        pix_color_fluctuation=1.0, light=True) for _ in range(n_masks)]
    u_pos, mu_pos, q_pos, key_list, own_u2 = pm.stack_union_pos_args(
        plans, h * w)
    qidx = pm.stack_union_qkey_args(plans, h * w)[2]
    tabs = convert.interval_tables(pm.interval_table_arrays(0.01), device)
    u_t, kl_t = (convert.as_tensor(a, device) for a in (u_pos, key_list))
    lo, sp = pm.expand_union_tables_from_pos_plain(
        u_t, convert.as_tensor(q_pos, device), kl_t, *tabs,
        offsets=tuple(shift_offsets(xy)), w=w, h=h)
    qidx_t = convert.qidx(qidx, device)
    mu_t = convert.as_tensor(mu_pos, device)
    if cut is not None:
        u_t, mu_t, lo, sp, qidx_t = (x[..., :cut].contiguous() for x in (
            u_t, mu_t, lo, sp, qidx_t))
    u2 = own_u2 if u2 is None else u2
    if not 0 <= u2 < u_t.shape[2]:
        raise ValueError(f"{case[0]}: u2 {u2} outside the union of "
                         f"{u_t.shape[2]}")
    return {"union": (u_t, mu_t, lo, sp, u2),
            "qkeys": (u_t, mu_t, qidx_t, kl_t, *tabs, u2), "chunk": chunk}


# The edge shapes of the shape pass's two kernels. K6 (shape_tile_device):
# (name, gap rows, ring rows, mirror, ring order, store rows selected):
# no gap rows, no ring rows, a ring not a multiple of 32, one
# orientation, the ring rows shuffled out of raster order, the store rows
# unsorted with repeats. K5 (shape_score_pairs_split): (name, T,
# orientations, query): T not a multiple of the 4 columns a thread, all
# query words zero, one orientation.
# K1 at the shapes its tiles and cursors meet at their edges: (name,
# targets, t_pad, fill). t_pad 13 and 33 are not a multiple of the
# kernel's 32-column tile (one-by-one stores), 32 is one tile; "empty"
# leaves every third target black and pads t_pad past the last target
# (flat cum), "full" makes one target foreground at every pixel, "black"
# gives no element at all (n = 0). No image size of the callers has P + 1
# a multiple of the kernel's 256-row tile.
SCATTER_EDGE_CASES = (
    ("t_pad_13", 13, 13, "random"),
    ("t_pad_32", 32, 32, "random"),
    ("t_pad_33", 33, 33, "random"),
    ("empty_targets", 40, 64, "empty"),
    ("full_target", 5, 32, "full"),
    ("n_0", 4, 32, "black"),
)


def scatter_edge_inputs(rng: np.random.Generator, case: tuple, h: int,
                        w: int, device) -> tuple:
    """One SCATTER_EDGE_CASES input on `device` for scatter_key_planes:
    ((pos, rgb, cum, rank_lut), {"n_px", "t_pad"}), the COO elements of
    random targets of h x w in coo_foreground's order."""
    import torch

    from colormipsearch_tpu_torch.ops import common

    _, n_targets, t_pad, fill = case
    stack = np.stack([scattered_pixels(rng, h, w, max(1, h * w // 20))
                      for _ in range(n_targets)])
    if fill == "empty":
        stack[::3] = 0
    elif fill == "full":
        stack[2] = rng.integers(21, 256, (h, w, 3))
    elif fill == "black":
        stack[:] = 0
    pos, rgb, cum = common.coo_foreground(stack, 20, t_pad)
    args = tuple(torch.from_numpy(a).to(device) for a in (pos, rgb, cum))
    return args + (common.rank_lut_tensor(device),), \
        {"n_px": h * w, "t_pad": t_pad}


# K2 at its edges: (name, h, w, masks, n_q (= KL - 1), query pixels,
# union elements, lanes). lanes: an xy-shift (0: one lane, 4: 17), or
# "far", offsets that move every src out of the image. "segmented" lays
# u_pos out as the slot-2 plans do (two ascending runs, then sentinel
# pads); the rest draw it in no order. n_q 65,534 is the longest list
# the wire form allows, with no pad.
EXPAND_EDGE_CASES = (
    ("n_q_0", 30, 40, 2, 0, 0, 700, 2),
    ("n_q_65534", 566, 1210, 2, 65534, 65534, 20000, 2),
    ("batch_1_lane_1", 30, 40, 1, 511, 300, 700, 0),
    ("lanes_17", 60, 80, 3, 1023, 900, 3000, 4),
    ("segmented", 60, 80, 2, 511, 400, 2000, 2),
    ("w_1", 500, 1, 2, 127, 100, 400, 2),
    ("h_1", 1, 500, 2, 127, 100, 400, 2),
    ("far_offsets", 30, 40, 2, 511, 300, 700, "far"),
)


def expand_edge_inputs(rng: np.random.Generator, case: tuple,
                       device) -> tuple:
    """One EXPAND_EDGE_CASES input on `device` for
    expand_union_tables_from_pos: ((u_pos, q_pos, key_list, tab_lo,
    tab_span), {"offsets", "w", "h"}). q_pos rises with pads = P last,
    as stack_union_pos_args builds it; key_list holds random keys and
    the trailing 0 of the inactive slot; the tables are the 1.0% ones."""
    from colormipsearch_tpu_torch import convert
    from colormipsearch_tpu_torch.oracle.pixel import shift_offsets
    from colormipsearch_tpu_torch.ops import pixel_match as pm

    name, h, w, batch, n_q, n_real, n_u, lanes = case
    n_px = h * w
    tabs = pm.interval_table_arrays(0.01)
    n_keys = tabs[0].shape[1]
    q_pos = np.full((batch, n_q), n_px, np.int32)
    key_list = np.zeros((batch, n_q + 1), np.int32)
    u_pos = np.full((batch, 2, n_u), n_px, np.int32)
    for b in range(batch):
        q_pos[b, :n_real] = np.sort(rng.choice(n_px, n_real, replace=False))
        key_list[b, :n_real] = rng.integers(0, n_keys, n_real)
        live = n_u - n_u // 8          # the rest stay sentinel pads
        u = rng.integers(0, n_px, (2, live))
        if name == "segmented":
            cut = live // 3
            u[0, :cut].sort()
            u[0, cut:].sort()
        u_pos[b, :, :live] = u
    offsets = (((w + 3, 0), (0, h + 3), (-w - 1, -h - 1)) if lanes == "far"
               else tuple(shift_offsets(lanes)))
    args = tuple(convert.as_tensor(a, device)
                 for a in (u_pos, q_pos, key_list)) \
        + convert.interval_tables(tabs, device)
    return args, {"offsets": offsets, "w": w, "h": h}


TILE_EDGE_CASES = (
    ("sg_0", 0, 150, True, "raster", "arange"),
    ("sh_0", 90, 0, True, "raster", "arange"),
    ("sh_77", 90, 77, True, "raster", "arange"),
    ("no_mirror", 90, 77, False, "raster", "arange"),
    ("shuffled_ring", 90, 300, True, "shuffled", "arange"),
    ("rows_unsorted_repeats", 90, 300, True, "raster", "repeats"),
)
SPLIT_EDGE_CASES = (
    ("t_1", 1, 2, "random"),
    ("t_3", 3, 2, "random"),
    ("t_13", 13, 2, "random"),
    ("zero_query", 64, 2, "zero"),
    ("one_orientation", 37, 1, "random"),
)


def tile_edge_case(rng: np.random.Generator, case: tuple, h: int = 19,
                   w: int = 23, n_rows: int = 9) -> dict:
    """numpy inputs of K6 at one TILE_EDGE_CASES shape: pixel-major store
    fields of n_rows random rows ("zsl", "grad" uint16 [h*w, n_rows],
    "tfg" uint8 [ceil(h*w/8), n_rows]), "rows" int32 [T], the mask's
    support ("pos_gap", "g_pos", "h_pos", "keep" as split_gather_plan
    makes them, the ring optionally shuffled), "n_gap_pad",
    "n_he_words" and "mirror"."""
    from colormipsearch_tpu_torch.ops import shape_score as ss

    _, sg, sh, mirror, order, rows = case
    n_px = h * w
    px = rng.permutation(n_px)
    pos_gap = np.sort(px[:sg]).astype(np.int32)
    pos_he = np.sort(px[sg:sg + sh]).astype(np.int32)
    excluded = np.zeros((h, w), bool)
    excluded[:h // 4, :w // 3] = True
    g_pos, h_pos, keep = ss.split_gather_plan(pos_gap, pos_he, w,
                                              mirror=mirror,
                                              excluded=excluded)
    if order == "shuffled":
        n_or = 2 if mirror else 1
        perm = np.concatenate([o * sh + rng.permutation(sh)
                               for o in range(n_or)])
        h_pos, keep = h_pos[perm], keep[perm]
    sel = (np.arange(n_rows) if rows == "arange"
           else rng.integers(0, n_rows, 2 * n_rows + 3))
    return {"zsl": rng.integers(0, 1 << 16, (n_px, n_rows)).astype(np.uint16),
            "grad": rng.integers(0, 1 << 16, (n_px, n_rows))
            .astype(np.uint16),
            "tfg": rng.integers(0, 256, (-(-n_px // 8), n_rows))
            .astype(np.uint8),
            "rows": sel.astype(np.int32), "pos_gap": pos_gap,
            "g_pos": g_pos, "h_pos": h_pos, "keep": keep,
            "n_gap_pad": ss.support_bucket(max(sg, 1), minimum=64),
            "n_he_words": ss.he_words(max(sh, 1), minimum=4),
            "mirror": mirror}


def tile_edge_inputs(c: dict, device) -> tuple:
    """A tile_edge_case on `device` as shape_tile_device takes it:
    (fields, rows_sel, TilePositions, {"n_gap_pad", "n_he_words"}); the
    uint16 fields travel as int16 bits."""
    import torch

    from colormipsearch_tpu_torch.ops import shape_score as ss

    kw = dict(n_gap_pad=c["n_gap_pad"], n_he_words=c["n_he_words"])
    tp = ss.tile_positions(c["pos_gap"], c["g_pos"], c["h_pos"], c["keep"],
                           mirror=c["mirror"], device=device, **kw)
    fields = tuple(torch.from_numpy(c[k].view(np.int16)).to(device)
                   for k in ("zsl", "grad")) \
        + (torch.from_numpy(c["tfg"]).to(device),)
    return fields, torch.from_numpy(c["rows"]).to(device), tp, kw


def split_edge_case(rng: np.random.Generator, case: tuple, sg: int = 300,
                    n_words: int = 9) -> tuple:
    """numpy inputs of K5 at one SPLIT_EDGE_CASES shape: (t_gap uint32
    [n_or, sg, T], q_gap int32 [n_or, sg], t_he uint32 [n_or, n_words,
    T], q_he uint32 [n_or, n_words]), every bit pattern, the last three
    gap rows and the last ring word of the query zero (pad rows)."""
    _, t, n_or, query = case
    t_gap = rng.integers(0, 1 << 32, (n_or, sg, t), dtype=np.uint64) \
        .astype(np.uint32)
    t_he = rng.integers(0, 1 << 32, (n_or, n_words, t), dtype=np.uint64) \
        .astype(np.uint32)
    q_gap = rng.integers(-(1 << 31), 1 << 31, (n_or, sg), dtype=np.int64) \
        .astype(np.int32)
    q_he = rng.integers(0, 1 << 32, (n_or, n_words), dtype=np.uint64) \
        .astype(np.uint32)
    q_gap[:, -3:] = 0
    q_he[:, -1] = 0
    if query == "zero":
        q_gap[:] = 0
        q_he[:] = 0
    return t_gap, q_gap, t_he, q_he


# K4 at the shapes its select, its scans and its two ordering branches
# meet at their edges: (name, batch, T, k, scores, flags). scores:
# "random" over a wide range, "narrow" over 0..40 (many ties, as real
# counts), "equal" (every score of a row the same: the select falls to
# the column order), "extremes" (INT32_MIN, INT32_MAX, -1, 0, 1 among
# random ones). T 2,049 and 255 are no power of two, 16,384 is the cap;
# k = T orders the whole row (the bitonic branch past 512 winners).
TOPK_EDGE_CASES = (
    ("t1_k1", 8, 1, 1, "random", False),
    ("t255_k1", 8, 255, 1, "random", True),
    ("t255_kT", 1, 255, 255, "narrow", False),
    ("t2048_k1", 8, 2048, 1, "narrow", True),
    ("t2048_k256", 8, 2048, 256, "random", True),
    ("t2048_k256_narrow", 8, 2048, 256, "narrow", False),
    ("t2048_k600", 8, 2048, 600, "random", False),
    ("t2048_kT", 8, 2048, 2048, "narrow", True),
    ("t2049_k256", 8, 2049, 256, "narrow", True),
    ("t2049_kT", 1, 2049, 2049, "random", False),
    ("t16384_k256", 8, 16384, 256, "narrow", False),
    ("t16384_kT", 1, 16384, 16384, "random", True),
    ("equal_rows", 8, 2048, 256, "equal", False),
    ("equal_rows_kT", 2, 2049, 2049, "equal", True),
    ("equal_rows_16384_k1", 1, 16384, 1, "equal", False),
    ("int32_extremes", 8, 2048, 256, "extremes", True),
    ("int32_extremes_kT", 1, 255, 255, "extremes", False),
    ("batch_0", 0, 2048, 256, "random", False),
)


def topk_edge_inputs(rng: np.random.Generator, case: tuple, device) -> tuple:
    """One TOPK_EDGE_CASES input on `device` for union_keys_topk: (best
    int32 [B, T], mirrored bool [B, T], pair_flags int32 [B, T] or None,
    k)."""
    import torch

    _, batch, t, k, scores, flags = case
    if scores == "narrow":
        best = rng.integers(0, 41, (batch, t))
    elif scores == "equal":
        best = np.repeat(rng.integers(-5, 500, (batch, 1)), t, axis=1)
    else:
        best = rng.integers(-(1 << 31), 1 << 31, (batch, t), dtype=np.int64)
        if scores == "extremes":
            special = np.array([-(1 << 31), (1 << 31) - 1, -1, 0, 1])
            pick = rng.random((batch, t)) < 0.5
            best[pick] = rng.choice(special, int(pick.sum()))
    best = torch.from_numpy(best.astype(np.int32)).to(device)
    mirrored = torch.from_numpy(rng.random((batch, t)) < 0.5).to(device)
    pair_flags = (torch.from_numpy(rng.integers(0, 4, (batch, t))
                                   .astype(np.int32)).to(device)
                  if flags else None)
    return best, mirrored, pair_flags, k


def check_topk_edge(case: tuple, device) -> None:
    """K4 at one TOPK_EDGE_CASES input on a CUDA `device` against its
    plain version: the same outputs (flags included when the case has
    them), dtypes and values. Raises AssertionError naming the case."""
    import torch

    from colormipsearch_tpu_torch.ops import pixel_match as pm

    rng = np.random.default_rng(sum(map(ord, case[0])))
    best, mirrored, flags, k = topk_edge_inputs(rng, case, device)
    got = pm.union_keys_topk(best, mirrored, k, flags)
    want = pm.union_keys_topk_plain(best, mirrored, k, flags)
    if len(got) != len(want) or len(got) != (3 if flags is None else 4) \
            or not all(a.dtype == b.dtype and torch.equal(a, b)
                       for a, b in zip(got, want)):
        raise AssertionError(f"K4 at edge case {case[0]} differs from its "
                             "plain version")


# The mesh finish (ops/mesh_finish: K4's selection written into a
# shard's column slice of the merged outputs, with the row maxima and
# flagged counts) at its edges: (name, batch, w, k, scores, flags) as
# TOPK_EDGE_CASES. w 512 with k 256 is phase 7's shard (2,048 columns
# over 4), B 1 the one-mask search step, k 0 the dense steps (maxima
# only), w 300 and 2,049 no multiple of a block's 256 threads (2,049 a
# cluster of 4, ragged), "equal" rows the tie order, no flags the key,
# union and qkey steps (the flags written as zeros).
MESH_FINISH_EDGE_CASES = (
    ("w512_k256", 8, 512, 256, "narrow", True),
    ("w512_k1", 8, 512, 1, "random", True),
    ("w512_kw", 8, 512, 512, "narrow", False),
    ("w300_k37", 8, 300, 37, "random", True),
    ("w2049_k256", 4, 2049, 256, "narrow", False),
    ("equal_rows", 8, 512, 256, "equal", True),
    ("equal_rows_kw", 2, 300, 300, "equal", False),
    ("k0_max_only", 8, 512, 0, "random", True),
    ("b1_search", 1, 512, 256, "narrow", False),
    ("int32_extremes", 8, 512, 64, "extremes", True),
    ("batch_0", 0, 512, 256, "random", False),
)
# the shards of the merged outputs in check_mesh_finish_edge: the case
# writes shard 1's slice and leaves the others as they were
MESH_FINISH_EDGE_SHARDS = 3


def check_mesh_finish_edge(case: tuple, device) -> None:
    """mesh_finish at one MESH_FINISH_EDGE_CASES input on a CUDA `device`
    against its plain version: written into shard 1's column slice of
    merged [B, 3k] outputs (the other slices untouched), with the
    shard's column offset, and mesh_reduce over [3, B] slots holding the
    case's row maxima and flagged counts. Raises AssertionError naming
    the case."""
    import torch

    from colormipsearch_tpu_torch.ops import mesh_finish as mf

    rng = np.random.default_rng(sum(map(ord, case[0])))
    best, mirrored, flags, k = topk_edge_inputs(rng, case, device)
    batch, width = best.shape
    n = MESH_FINISH_EDGE_SHARDS
    want = mf.mesh_finish_plain(best, mirrored, k, flags, width)
    top = torch.full((3, batch, n * k), -7, dtype=torch.int32, device=device)
    top_m = torch.ones((batch, n * k), dtype=torch.bool, device=device)
    slots = torch.full((2, n, batch), -7, dtype=torch.int32, device=device)
    scores, idx, flags_k = (x[:, k:2 * k] for x in top)
    got = mf.mesh_finish(best, mirrored, k, flags, width,
                         out=(scores, idx, top_m[:, k:2 * k], flags_k,
                              slots[0, 1], slots[1, 1]))
    outside = (torch.cat([top[..., :k], top[..., 2 * k:]], -1),
               torch.cat([top_m[:, :k], top_m[:, 2 * k:]], -1))
    if not all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(got, want)) \
            or not bool((outside[0] == -7).all()) \
            or not bool(outside[1].all()):
        raise AssertionError(f"mesh_finish at edge case {case[0]} differs "
                             "from its plain version")
    slots[:, 0] = torch.from_numpy(rng.integers(-50, 50, (2, batch))
                                   .astype(np.int32)).to(device)
    slots[:, 2] = torch.from_numpy(rng.integers(-50, 50, (2, batch))
                                   .astype(np.int32)).to(device)
    got = mf.mesh_reduce(slots[0], slots[1])
    want = mf.mesh_reduce_plain(slots[0], slots[1])
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"mesh_reduce at edge case {case[0]} differs "
                             "from its plain version")


# K7 at its edges: (name, R, n, where, dtype) for every R in (1, 31, 33,
# 1,638, 2,048), n in (1, 7, 9, a full chunk of PIXEL_MAJOR_CHUNK_BYTES),
# the chunk written at pixel 0 or ending at the buffer's last pixel, int16
# and uint8. R 1,638 (the engine's sorted subset of the store rows) and
# the odd ones give dst pitches no multiple of 16 bytes (element stores);
# n 7 and 9 give src pitches of 7-18 bytes (narrow loads).
PIXEL_MAJOR_CHUNK_BYTES = 1 << 20
PIXEL_MAJOR_EDGE_CASES = tuple(
    (f"r{r}_n{n}_{where}_{dt}", r, n, where, dt)
    for dt in ("int16", "uint8") for r in (1, 31, 33, 1638, 2048)
    for n in (1, 7, 9, "chunk") for where in ("start", "end"))


def pixel_major_edge_case(rng: np.random.Generator, case: tuple) -> dict:
    """numpy inputs of K7 at one PIXEL_MAJOR_EDGE_CASES shape: the field
    [R, n_px] (uint16 or uint8; n_px = n + 5), the chunk's n and p0 and
    the chunk_bytes at which upload_pixel_major cuts the field into
    chunks of n."""
    _, n_r, n, where, dt = case
    dtype = np.dtype(np.uint16 if dt == "int16" else np.uint8)
    if n == "chunk":
        n = PIXEL_MAJOR_CHUNK_BYTES // (n_r * dtype.itemsize)
    n_px = n + 5
    field = rng.integers(0, np.iinfo(dtype).max + 1, (n_r, n_px),
                         dtype=np.int64).astype(dtype)
    return {"field": field, "n": n, "p0": 0 if where == "start"
            else n_px - n, "chunk_bytes": n_r * n * dtype.itemsize}


def check_pixel_major_edge(case: tuple, device) -> None:
    """K7 at one PIXEL_MAJOR_EDGE_CASES shape on a CUDA `device` against
    its plain version, into a buffer filled with 3, from the chunk as it
    is and from a copy one element past an aligned base (narrower loads).
    Raises AssertionError naming the case."""
    import torch

    from colormipsearch_tpu_torch.ops import shape_score as ss

    rng = np.random.default_rng(sum(map(ord, case[0])))
    c = pixel_major_edge_case(rng, case)
    field = c["field"].view(np.int16) if case[4] == "int16" else c["field"]
    n, p0 = c["n"], c["p0"]
    src = torch.from_numpy(np.ascontiguousarray(field[:, p0:p0 + n])) \
        .to(device)
    shifted = torch.zeros(src.numel() + 1, dtype=src.dtype,
                          device=device)[1:].view(src.shape)
    shifted.copy_(src)
    for chunk in (src, shifted):
        buf = torch.full((field.shape[1], field.shape[0]), 3,
                         dtype=src.dtype, device=device)
        ref = buf.clone()
        ss.upload_pixel_major_chunk(buf, chunk, p0)
        ss.upload_pixel_major_chunk_plain(ref, chunk, p0)
        if not torch.equal(buf, ref):
            raise AssertionError(f"K7 at edge shape {case[0]} differs "
                                 "from its plain version")


# Row 15 at its edges: (name, pixel shape without the channel axis,
# content, shift). content: "random" (uniform RGB), "black", "sparse"
# (runs of colour in black, as a CDM: whole warps of black pixels and
# warps that mix both), "class1".."class6" (only pixels of that >=-tie
# class), "dense" (uniform, no black pixel). shift k: the pixels start k
# pixels (3k bytes) into their buffer, so the kernel's 16-byte loads
# narrow to 1, 2, 4 or 8 bytes. n 0-17 cross one 16-pixel group and its
# tail.
SLICE_NUMBERS_EDGE_CASES = (
    ("n0", (0,), "random", 0),
    ("n1", (1,), "random", 0),
    ("n15", (15,), "random", 0),
    ("n16", (16,), "random", 0),
    ("n17", (17,), "random", 0),
    ("shift3_bytes", (4099,), "random", 1),
    ("shift6_bytes", (4099,), "random", 2),
    ("shift12_bytes", (4099,), "random", 4),
    ("shift24_bytes", (4099,), "random", 8),
    ("shift3_bytes_n17", (17,), "random", 1),
    ("leading_2x5x7", (2, 5, 7), "random", 0),
    ("all_black", (4105,), "black", 0),
    ("sparse", (40_003,), "sparse", 0),
    *((f"class{c}", (4099,), f"class{c}", 0) for c in range(1, 7)),
    ("dense", (24_581,), "dense", 0),
)


def slice_class(rgb: np.ndarray) -> np.ndarray:
    """The >=-tie class (1..6, R, G, B priority) of uint8 [..., 3] pixels,
    as slice_numbers_device classifies them."""
    r, g, b = (rgb[..., c].astype(np.int32) for c in range(3))
    r_dom = (r >= g) & (r >= b)
    g_dom = ~r_dom & (g >= r) & (g >= b)
    return np.where(r_dom, np.where(g >= b, 5, 6),
                    np.where(g_dom, np.where(r >= b, 4, 3),
                             np.where(r >= g, 1, 2)))


def slice_numbers_edge_pixels(rng: np.random.Generator,
                              case: tuple) -> np.ndarray:
    """numpy uint8 [*shape, 3] pixels of one SLICE_NUMBERS_EDGE_CASES
    case."""
    _, shape, content, _ = case
    n = int(np.prod(shape))
    if content == "black":
        rgb = np.zeros((n, 3), np.uint8)
    elif content.startswith("class"):
        pool = rng.integers(1, 256, (16 * n + 64, 3)).astype(np.uint8)
        rgb = pool[slice_class(pool) == int(content[5:])][:n]
    elif content == "sparse":
        rgb = np.zeros((n, 3), np.uint8)
        for _ in range(40):
            at, run = rng.integers(0, n), rng.integers(1, 700)
            rgb[at:at + run] = rng.integers(0, 256, (len(rgb[at:at + run]),
                                                     3))
    else:
        rgb = rng.integers(0, 256, (n, 3)).astype(np.uint8)
        if content == "dense":
            rgb[rgb.max(1) == 0, 0] = 1
    return rgb.reshape(*shape, 3)


def slice_numbers_edge_input(rng: np.random.Generator, case: tuple,
                             device):
    """(numpy pixels, the same pixels as a uint8 tensor on `device` that
    starts the case's shift of pixels into its buffer)."""
    import torch

    rgb = slice_numbers_edge_pixels(rng, case)
    shift = case[3]
    buf = torch.zeros((rgb[..., 0].size + shift, 3), dtype=torch.uint8,
                      device=device)
    buf[shift:] = torch.from_numpy(rgb.reshape(-1, 3)).to(device)
    return rgb, buf[shift:].view(rgb.shape)


def check_slice_numbers_edge(case: tuple, device) -> None:
    """Row 15 at one SLICE_NUMBERS_EDGE_CASES input on a CUDA `device`
    against its plain version: the same shape and values. Raises
    AssertionError naming the case."""
    import torch

    from colormipsearch_tpu_torch.ops import shape_score as ss

    rng = np.random.default_rng(sum(map(ord, case[0])))
    _, rgb = slice_numbers_edge_input(rng, case, device)
    got = ss.slice_numbers_device(rgb)
    want = ss.slice_numbers_device_plain(rgb)
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"row 15 at edge case {case[0]} differs from "
                             "its plain version")


def slice_class_triples() -> np.ndarray:
    """uint8 [N, 3]: one pixel of every (class, p, s) that the >=-tie
    classification produces (p 1-255, s 0-p; the third channel 0), every
    pixel with a two-way or a three-way channel tie, and every pixel of
    0, 1, 254 and 255."""
    out = []
    for p in range(1, 256):
        s = np.arange(p + 1)
        z = np.zeros_like(s)
        pp = np.full_like(s, p)
        out += [np.stack([pp, s, z], 1),             # class 5
                np.stack([pp, z, s], 1)[1:],         # class 6: s >= 1
                np.stack([s, pp, z], 1)[:-1],        # class 4: s < p
                np.stack([z, pp, s], 1)[1:],         # class 3: s >= 1
                np.stack([s, z, pp], 1)[:-1],        # class 1: s < p
                np.stack([z, s, pp], 1)[1:-1]]       # class 2: 1 <= s < p
    a, b = (x.ravel() for x in np.meshgrid(np.arange(256), np.arange(256)))
    out += [np.stack([a, a, b], 1), np.stack([a, b, a], 1),
            np.stack([b, a, a], 1)]
    ext = np.array([0, 1, 254, 255])
    out.append(np.stack(np.meshgrid(ext, ext, ext), -1).reshape(-1, 3))
    return np.concatenate(out).astype(np.uint8)


# K8's split mode at its edges: (name, T, t_pad, h, w, threshold, base).
# P = h * w, and 3P mod 16 (the step of a target row's base) is 4 (the
# production image's), 8, 12 or 0 (aligned loads); t_pad = T (odd), T +
# 1, 2T, or a multiple of 16 (vector stores) with padding columns; T
# past one 128-target tile; n_px 1 and ragged (not a multiple of the
# 16-pixel run); threshold 0 and 255 (every pixel dead). base "target":
# the stack is a view one target into a larger one; "byte": one byte
# into its buffer.
PACK_SPLIT_EDGE_CASES = (
    ("t1", 1, 1, 10, 14, 20, None),
    ("t1_pad2", 1, 2, 10, 14, 20, None),
    ("t33", 33, 33, 10, 14, 20, None),
    ("t33_pad34", 33, 34, 10, 14, 20, None),
    ("t33_pad66", 33, 66, 10, 14, 20, None),
    ("t33_pad48", 33, 48, 10, 14, 20, None),
    ("t130_pad144", 130, 144, 8, 16, 20, None),
    ("n_px1", 5, 16, 1, 1, 20, None),
    ("n_px_ragged", 7, 16, 7, 13, 20, None),
    ("thr0", 33, 48, 11, 12, 0, None),
    ("thr255", 33, 48, 11, 12, 255, None),
    ("view_one_target", 33, 48, 10, 14, 20, "target"),
    ("view_one_byte", 33, 48, 8, 16, 20, "byte"),
    ("p140_3p_4", 17, 32, 10, 14, 20, None),
    ("p136_3p_8", 17, 32, 8, 17, 20, None),
    ("p132_3p_12", 17, 32, 11, 12, 20, None),
    ("p128_3p_0", 17, 32, 8, 16, 20, None),
)


def pack_split_edge_stack(rng: np.random.Generator,
                          case: tuple) -> np.ndarray:
    """numpy uint8 [T, h, w, 3] stack of one PACK_SPLIT_EDGE_CASES case:
    random colours, ~40% black, ~15% with two equal channels (class 0
    when they are the largest)."""
    _, t, _, h, w, _, _ = case
    stack = rng.integers(0, 256, (t, h, w, 3)).astype(np.uint8)
    stack[rng.random((t, h, w)) < 0.4] = 0
    tie = rng.random((t, h, w)) < 0.15
    stack[tie, 1] = stack[tie, 0]
    return stack


def pack_split_edge_input(rng: np.random.Generator, case: tuple, device):
    """(numpy stack, the same stack as a uint8 tensor on `device` at the
    case's base, threshold, t_pad)."""
    import torch

    stack = pack_split_edge_stack(rng, case)
    base, shape = case[6], stack.shape
    if base == "target":
        buf = torch.zeros((shape[0] + 1, *shape[1:]), dtype=torch.uint8,
                          device=device)
        view = buf[1:]
    elif base == "byte":
        buf = torch.zeros(stack.size + 1, dtype=torch.uint8, device=device)
        view = buf[1:].view(shape)
    else:
        view = torch.empty(shape, dtype=torch.uint8, device=device)
    view.copy_(torch.from_numpy(stack))
    return stack, view, case[5], case[2]


def check_pack_split_edge(case: tuple, device) -> None:
    """K8's split mode at one PACK_SPLIT_EDGE_CASES input on a CUDA
    `device` against its plain version: both planes, dtypes and values.
    Raises AssertionError naming the case."""
    import torch

    from colormipsearch_tpu_torch.ops import common

    rng = np.random.default_rng(sum(map(ord, case[0])))
    _, rgb, thr, t_pad = pack_split_edge_input(rng, case, device)
    got = common.pack_target_planes_split(rgb, thr, t_pad=t_pad)
    want = common.pack_target_planes_split_plain(rgb, thr, t_pad=t_pad)
    if not all(a.dtype == b.dtype and a.shape == b.shape
               and torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"K8's split mode at edge case {case[0]} "
                             "differs from its plain version")


# The repository's image forms that only PIL wrote (tests/torch_forms/):
# each file, with its PIL-decoded pixels and the matches of forms_search
# pinned beside them in FORMS_NPZ.
FORMS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "torch_forms")
FORM_FILES = ("baseline.jpg", "progressive.jpg", "palette.gif",
              "palette.tif", "ccitt_g4.tif", "tiled_jpeg.tif",
              "rgba_lzw.tif", "cmyk.tif", "float.tif", "cmyk.jpg",
              "smoothed.jpg", "arith.jpg", "lossless.jpg", "corrupt.jpg",
              "lab.tif", "palette_alpha.tif", "int32.tif", "gray4.tif",
              "lzma.tif", "zstd.tif", "ccitt_rle.tif")
FORMS_NPZ = "pixels_and_matches.npz"
# a production-size (566 x 1210) Zstandard TIFF of a synthetic CDM,
# written by PIL (libzstd): the GPU hosts, which have no zstd encoder,
# time the port's reader on it
FORMS_ZSTD_TIMING = "zstd_566x1210.tif"
FORMS_SIZE = (48, 64)   # height, width of every file and library image
FORMS_SYNTHETIC_TARGETS = 6


def forms_search(pixels: dict, work_dir, device, *, forms_dir=FORMS_DIR,
                 file_names=FORM_FILES, seed: int = 0) -> np.ndarray:
    """One colorDepthSearch over image files: 6 synthetic PNG targets
    and `file_names` in `forms_dir` (read by the engine as they are) as
    targets; a mask cut from each file's pixels (`pixels`: file name ->
    uint8 [h, w, 3]) and 2 synthetic masks, written as PNGs to
    `work_dir`. Returns the matches int64 [n, 4] (mask index, target
    index, matching pixels, mirrored), sorted."""
    from colormipsearch_tpu_torch.engine import cds

    rng = np.random.default_rng(seed)
    h, w = FORMS_SIZE
    lib = synthetic_library(rng, FORMS_SYNTHETIC_TARGETS, 2, h, w,
                            target_fg=0.1, mask_fg=0.04)
    cut = [cut_mask(rng, pixels[name], shift=((0, 0), (0, 0), (2, 0),
                                              (0, -2))[k % 4],
                    mirror=k % 4 == 1) for k, name in enumerate(file_names)]
    masks = write_neuron_images(os.path.join(str(work_dir), "m"),
                                cut + lib.masks, "m")
    targets = write_neuron_images(os.path.join(str(work_dir), "t"),
                                  lib.targets, "t")
    for k, name in enumerate(file_names):
        n = LMNeuron(mip_id=f"f-{k:05d}", library_name="synthetic",
                     published_name=f"f{k:05d}")
        n.set_compute_file(ComputeFileType.InputColorDepthImage,
                           os.path.join(forms_dir, name))
        targets.append(n)
    params = cds.CDSParams(mask_threshold=20, data_threshold=20,
                           pix_color_fluctuation=1.0, xy_shift=2,
                           mirror_mask=True, pct_positive_pixels=0.0)
    engine = cds.CDSearchEngine(params, device=device, decode_concurrency=1)
    m_idx = {n.mip_id: i for i, n in enumerate(masks)}
    t_idx = {n.mip_id: i for i, n in enumerate(targets)}
    return np.array(sorted(
        (m_idx[m.mask_image.mip_id], t_idx[m.matched_image.mip_id],
         m.matching_pixels, int(m.mirrored))
        for m in engine.find_all_matches(masks, targets)),
        np.int64).reshape(-1, 4)


# The DB store in canonical form. Entity ids are time-based (model/ids.py),
# so two stores, or two runs, never share one: documents are compared
# without them, each match naming its neurons by a key of theirs.
_ID_FIELDS = ("_id", "entityId")
_REF_FIELDS = ("maskImageRefId", "matchedImageRefId")
# the neurons a document embeds (a PPP match's mask and LM images)
_EMBEDDED_NEURONS = ("maskImage", "image")


def store_collections(source) -> dict:
    """{collection: [document]} of a store: `source` is the path of a
    sqlite store file (read with the standard library alone), or such a
    mapping already (a Mongo database's documents)."""
    if not isinstance(source, (str, os.PathLike)):
        return {name: list(docs) for name, docs in source.items()}
    conn = sqlite3.connect(f"file:{os.fspath(source)}?mode=ro", uri=True)
    try:
        names = [r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type = 'table'")]
        return {name: [json.loads(r[0]) for r in conn.execute(
            f"SELECT doc FROM {name}")] for name in names}
    finally:
        conn.close()


def neuron_key(doc: dict, key: str = "mipId"):
    """A neuron document's key: (mipId, libraryName), or with key
    "image" the path of its InputColorDepthImage (a zip entry as its
    serialized object)."""
    if doc is None:
        return None
    if key == "image":
        fd = (doc.get("computeFiles") or {}).get("InputColorDepthImage")
        return json.dumps(fd, sort_keys=True) if isinstance(fd, dict) \
            else fd
    return doc.get("mipId"), doc.get("libraryName")


def canonical_store(source) -> dict:
    """A store's documents in a form two stores can be compared in:
    every collection that holds documents as a sorted list of them
    without ``_id`` and ``entityId`` (also in the neurons it embeds),
    each match's maskImageRefId and matchedImageRefId replaced by the
    (mipId, libraryName) of the neuron it references (None for a
    dangling reference)."""
    cols = store_collections(source)
    by_id = {str(d["_id"]): d for d in cols.get("neuronMetadata", ())}
    out = {}
    for name, docs in cols.items():
        if not docs:
            continue  # an empty collection is an absent one, as in Mongo
        canon = []
        for d in docs:
            c = {k: v for k, v in d.items() if k not in _ID_FIELDS}
            for ref in _REF_FIELDS:
                if ref in c:
                    c[ref] = neuron_key(by_id.get(str(c[ref])))
            for emb in _EMBEDDED_NEURONS:
                if isinstance(c.get(emb), dict):
                    c[emb] = {k: v for k, v in c[emb].items()
                              if k not in _ID_FIELDS}
            canon.append(c)
        out[name] = sorted(canon, key=lambda c: json.dumps(c,
                                                           sort_keys=True))
    return out


def store_match_rows(source, key: str = "mipId") -> dict:
    """{(mask key, target key): match fields} of a store's cdMatches (the
    fields without ids and references; keys by neuron_key)."""
    cols = store_collections(source)
    by_id = {str(d["_id"]): d for d in cols.get("neuronMetadata", ())}
    out = {}
    for d in cols.get("cdMatches", ()):
        pair = tuple(neuron_key(by_id.get(str(d.get(ref))), key)
                     for ref in _REF_FIELDS)
        if pair in out:
            raise AssertionError(f"the store holds the pair {pair} twice")
        out[pair] = {k: v for k, v in d.items()
                     if k not in _ID_FIELDS + _REF_FIELDS}
    return out


def fs_match_rows(per_mask_dir, key: str = "mipId") -> dict:
    """{(mask key, target key): match fields} of a directory of per-mask
    result files, in store_match_rows' form (the row without its
    embedded image, ids and references)."""
    out = {}
    for name in sorted(os.listdir(per_mask_dir)):
        with open(os.path.join(per_mask_dir, name)) as f:
            doc = json.load(f)
        mask = neuron_key(doc["inputImage"], key)
        for row in doc["results"]:
            pair = (mask, neuron_key(row["image"], key))
            out[pair] = {k: v for k, v in row.items()
                         if k not in _ID_FIELDS + _REF_FIELDS + ("image",)}
    return out


_MINTED_ID = re.compile(r'"(entityId|maskImageRefId|matchedImageRefId|'
                        r'sessionRefId)": ?"(\d+)"')


def canonical_ids(text: str, ordinals: dict) -> str:
    """`text` (a JSON file's contents) with every id a command mints
    replaced by its ordinal of first appearance in `ordinals`, which the
    caller shares across the files of one tree, so that two runs' files
    compare byte for byte and a reference still names what it named."""
    def sub(m):
        n = ordinals.setdefault(m.group(2), len(ordinals))
        return m.group(0).replace(m.group(2), f"id{n}")

    return _MINTED_ID.sub(sub, text)


# Synthetic PatchPerPix (PPP) results, as the PPP pipeline writes them for
# importPPPResults and convertPPPResults: per EM body a
# `cov_scores_<em name>.json` ({em name: {lm name: raw match}}) under
# `<em name>/<sub dir>/`, with a screenshots/ directory beside it.
PPP_SUB_DIR = "lm_cable_length_20_v4_adj_by_cov_numba_agglo_aT"
PPP_EM_LIBRARY = "flyem_hemibrain_1_2_1"
PPP_ALIGNMENT_SPACE = "JRC2018_Unisex_20x_HR"
PPP_EM_TYPES = ("PFNp_c", "SMP145", "", "LC10a")
# LM name suffixes: objectives, the default anatomical area, another area
# (neither an objective nor --anatomical-area's default) and no
# _REG_UNISEX_ marker at all
PPP_LM_SUFFIXES = ("40x", "63x", "Brain", "VNC", None)
PPP_LIST_FORMS = ("json", "numpy", "ellipsis")
PPP_POOL = 16  # skeleton-list groups per form (numpy prints slowly)
PPP_BEST, PPP_ALL = 3, 20  # skeletons in a match's best and all lists


@dataclasses.dataclass
class PPPResults:
    files: list[str]            # the cov_scores files, one per EM body
    em_neurons: list[EMNeuron]  # the bodies as the neuron store holds them
    n_matches: int              # LM matches in all the files


def _ppp_list(values, form: str) -> str:
    """A skeleton list as the PPP pipeline writes it: "json" a JSON list,
    "numpy" numpy's print wrapped over lines, "ellipsis" numpy's print
    cut to its first and last three entries around "..."."""
    arr = np.asarray(values)
    if form == "json":
        return json.dumps(arr.tolist())
    return np.array2string(arr, max_line_width=40, edgeitems=3,
                           threshold=6 if form == "ellipsis" else 1 << 30)


def _ppp_skeletons(rng, ids, form: str, colors_off: int) -> dict:
    """One prefix's four lists for the skeletons `ids`; the colors list is
    `colors_off` entries longer than the ids (then the reader drops it)."""
    n = len(ids)
    return {"skel_ids": _ppp_list(ids, form),
            "nblast_scores": _ppp_list(np.round(
                rng.uniform(-0.5, 1.0, n), 6), form),
            "coverages": _ppp_list(np.round(rng.uniform(0, 80, n), 4), form),
            "colors": _ppp_list(rng.integers(
                0, 256, size=(max(n + colors_off, 1), 3)), form)}


def write_ppp_results(root, rng: np.random.Generator, n_bodies: int,
                      n_matches: int, *, forms=PPP_LIST_FORMS,
                      rank_step: float = 1.0, shot_bodies: int = 0,
                      shots_every: int = 1,
                      strays: bool = False) -> PPPResults:
    """`n_bodies` EM bodies with `n_matches` LM matches each under `root`.

    Each raw match has a negative ``cov_score``, ``aggregate_coverage``,
    ``mirrored`` (a bool or an int) and a float ``rank`` (the j-th best
    `rank_step` * j, every seventh tied with the one before; written in
    shuffled order), and its best (PPP_BEST) and all (PPP_ALL, the best
    among them) skeleton lists in the forms of `forms` in turn, drawn from
    PPP_POOL groups per form. Every fifth match has no ``all_*`` lists,
    every third a colors list one entry longer than its ids. The first
    `shot_bodies` bodies get a screenshot of every PPP type for every
    `shots_every`-th match (ranks below 500 and at or above it), a
    thumbnail and an unrelated file. With `strays`, the first body also
    has an ``other_scores_`` file and a cov_scores file in another sub
    directory."""
    root = str(root)
    files, neurons = [], []
    pool: dict = {}

    def skeletons(form: str, colors_off: int, j: int) -> tuple:
        if (form, colors_off) not in pool:
            groups = pool[form, colors_off] = []
            for _ in range(PPP_POOL):
                ids = rng.choice(10 ** 6, size=PPP_ALL, replace=False) + 1
                # the best skeletons lead the all-lists
                groups.append((
                    _ppp_skeletons(rng, ids[:PPP_BEST], form, colors_off),
                    {f"all_{k}": v for k, v in _ppp_skeletons(
                        rng, ids, form, colors_off).items()}))
        return pool[form, colors_off][j % PPP_POOL]

    for b in range(n_bodies):
        body = int(rng.integers(10 ** 8, 10 ** 10))
        em_type = PPP_EM_TYPES[b % len(PPP_EM_TYPES)]
        em_name = f"{body}-{em_type}-RT_18U" if b % 7 != 6 \
            else f"hemibrain_body_{body}"
        ranks = [rank_step * j for j in range(n_matches)]
        for j in range(7, n_matches, 7):
            ranks[j] = ranks[j - 1]
        lm_map = {}
        for j in map(int, rng.permutation(n_matches)):
            suffix = PPP_LM_SUFFIXES[(b + j) % len(PPP_LM_SUFFIXES)]
            lm = f"BJD_{b:03d}{j:04d}_AE_01-20190507_{j % 90:02d}_F1"
            if suffix is not None:
                lm += f"_REG_UNISEX_{suffix}"
            form = forms[(b + j) % len(forms)]
            raw = {"cov_score": -float(np.round(rng.uniform(1, 300), 9)),
                   "aggregate_coverage": float(np.round(
                       rng.uniform(0, 100), 9)),
                   "mirrored": bool(j % 2) if j % 3 else j % 2,
                   "rank": float(ranks[j])}
            best, every = skeletons(form, int(j % 3 == 0), j)
            raw.update(best)
            if j % 5:
                raw.update(every)
            lm_map[lm] = raw
        d = os.path.join(root, em_name, PPP_SUB_DIR)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"cov_scores_{em_name}.json")
        with open(path, "w") as f:
            json.dump({em_name: lm_map}, f, indent=1)
        files.append(path)
        if b < shot_bodies:
            _write_screenshots(os.path.join(d, "screenshots"), em_name,
                               lm_map, shots_every)
        if strays and b == 0:
            with open(os.path.join(d, f"other_scores_{em_name}.json"),
                      "w") as f:
                json.dump({em_name: dict(list(lm_map.items())[:2])}, f)
            other = os.path.join(root, em_name, "other_run")
            os.makedirs(other, exist_ok=True)
            with open(os.path.join(other, f"cov_scores_{em_name}.json"),
                      "w") as f:
                json.dump({em_name: dict(list(lm_map.items())[:3])}, f)
        neurons.append(EMNeuron(
            mip_id=f"em-{body}", library_name=PPP_EM_LIBRARY,
            alignment_space=PPP_ALIGNMENT_SPACE,
            published_name=str(body) if b % 7 != 6 else em_name,
            neuron_type=em_type or None))
    return PPPResults(files, neurons, n_bodies * n_matches)


def _write_screenshots(d: str, em_name: str, lm_map: dict,
                       every: int) -> None:
    os.makedirs(d, exist_ok=True)
    lms = sorted(lm_map, key=lambda lm: lm_map[lm]["rank"])
    for lm in lms[::every]:
        for _, suffix in SCREENSHOT_TYPES:
            with open(os.path.join(d, f"{em_name}-{lm}{suffix}"), "wb") as f:
                f.write(b"png")
    with open(os.path.join(d, f"{em_name}-{lms[0]}_5_ch.jpg"), "wb") as f:
        f.write(b"jpg")
    with open(os.path.join(d, f"999-{lms[0]}_1_raw.png"), "wb") as f:
        f.write(b"png")


# The publish collections the export reads beside the matches, made from
# a store's own neurons and matches (their entity ids differ per store).
def published_url_docs(neurons) -> list[dict]:
    """publishedURL documents ({_id: entity id, uploaded: {...}}) for
    every neuron but each fourth, which then has no searchable URL."""
    out = []
    for i, n in enumerate(neurons):
        if i % 4 == 3:
            continue
        base = f"https://s3.amazonaws.com/janelia-flylight/v3/{n.mip_id}"
        up = {"cdm": f"{base}/cdm.png",
              "searchable_neurons": f"{base}/searchable.png"}
        if i % 2 == 0:
            up["cdm_thumbnail"] = f"{base}/cdm.jpg"
        if i % 3 == 0:
            up["skeletonswc"] = f"{base}/skel.swc"
            up["skeletonobj"] = f"{base}/skel.obj"
        out.append({"_id": n.entity_id, "uploaded": up})
    return out


def published_url_map(neurons) -> dict:
    """--published-urls' file: {mip id (published name for every third
    neuron): {FileType: url}} for every neuron but each fifth."""
    out = {}
    for i, n in enumerate(neurons):
        if i % 5 == 4:
            continue
        key = n.published_name if i % 3 == 2 else n.mip_id
        out[key] = {"CDM": f"https://s3.amazonaws.com/bucket/v3/cdm/"
                           f"{n.mip_id}.png",
                    "CDMThumbnail": f"/nrs/local/thumbs/{n.mip_id}.jpg"}
    return out


def published_lm_image_docs(lm_neurons, alias: str) -> list[dict]:
    """publishedLMImage rows (PublishedLMImage.to_json, no ids) for the LM
    neurons with a sample: each sample's image in the neuron's alignment
    space or, for every other one, in `alias`, with a 3D stack but for
    each fifth; a Gen1 GAL4 or LexA row with a ColorDepthMip1 for every
    third line and area, and one for another area for the next."""
    out = []
    for i, n in enumerate(lm_neurons):
        if not n.sample_ref:
            continue
        area = n.anatomical_area or "Brain"
        space = n.alignment_space if i % 2 == 0 else alias
        line = n.published_name
        out.append({
            "sampleRef": n.sample_ref, "line": line, "area": area,
            "originalLine": line, "slideCode": n.slide_code,
            "objective": n.objective or "40x", "alignmentSpace": space,
            "releaseName": "Split-GAL4 Omnibus",
            "files": {} if i % 5 == 4 else {
                "VisuallyLosslessStack":
                    f"https://s3.amazonaws.com/stacks/{line}/{i}.h5j"}})
        if i % 3 < 2:
            out.append({
                "sampleRef": f"Gen1#{line}#{i}", "line": line,
                "area": area if i % 3 == 0 else "VNC", "originalLine": line,
                "alignmentSpace": space,
                "releaseName": ("Gen1 GAL4", "Gen1 LexA")[i % 2],
                "files": {"ColorDepthMip1":
                          f"https://s3.amazonaws.com/gen1/{line}/{i}.png"}})
    return out


def pppm_url_docs(matches) -> list[dict]:
    """pppmURL documents for every other PPP match with screenshots: the
    uploaded CH and RAW files and the CH thumbnail."""
    out = []
    for i, m in enumerate(matches):
        if i % 2 or not m.source_image_files:
            continue
        base = (f"https://s3.amazonaws.com/ppp/{m.source_em_name}/"
                f"{m.source_lm_name}")
        out.append({"_id": m.entity_id,
                    "uploadedFiles": {"CH": f"{base}/ch.png",
                                      "RAW": f"{base}/raw.png"},
                    "uploadedThumbnails": {"CH": f"{base}/ch.jpg"}})
    return out


# --- JACS page dumps and v2 result files: inputs of the JACS client
# (io/jacs.py, its file:// transport) and of legacyImport

JACS_MIPS_ENDPOINT = "data_colorDepthMIPsWithSamples"
JACS_SAMPLES_ENDPOINT = "data_samples"


def jacs_mip_records(neurons, *, em: bool = False,
                     libraries=None) -> list[dict]:
    """JACS ColorDepthMIP records (cmd/jacsdata/ColorDepthMIP.java) of
    neurons with an InputColorDepthImage: the record's filepath is that
    file. LM records carry a sample (publishing name, slide code, gender,
    line, mounting protocol) and every third one a channel that is not a
    number; EM records a body id and an emBody (type, instance, skeleton
    files on every other one). `libraries` gives each record's libraries
    list (i -> list), else none."""
    out = []
    for i, n in enumerate(neurons):
        fd = n.compute_file(ComputeFileType.InputColorDepthImage)
        rec = {"id": n.mip_id, "filepath": fd.name,
               "alignmentSpace": n.alignment_space or "JRC2018_Unisex_20x_HR",
               "objective": ("40x", "63x", "20x")[i % 3],
               "anatomicalArea": ("Brain", "VNC")[i % 2]}
        if libraries is not None:
            rec["libraries"] = libraries(i)
        if em:
            rec["bodyId"] = int(1000 + i) if i % 5 != 4 else None
            rec["emBodyRef"] = f"EMBody#{i}" if i % 2 else None
            rec["emBody"] = {"_id": f"body-{i}", "name": f"name{i}",
                             "neuronType": f"T{i % 3}",
                             "neuronInstance": f"T{i % 3}_R"}
            if i % 2 == 0:
                rec["emBody"]["files"] = {"SkeletonSWC": f"/swc/{i}.swc",
                                          "SkeletonOBJ": f"/obj/{i}.obj"}
        else:
            rec["sampleRef"] = f"Sample#{i}"
            rec["channelNumber"] = str(1 + i % 2) if i % 3 else "ch?"
            rec["sample"] = {
                "name": f"sample{i}",
                "publishingName": n.published_name if i % 7 != 6 else None,
                "slideCode": f"2020{i:04d}_1_A1", "gender": "fm"[i % 2],
                "line": f"line{i}",
                "mountingProtocol": "DPX PBS Mounting" if i % 4 else None}
        out.append(rec)
    return out


def write_jacs_dump(directory, records: list, *,
                    endpoint: str = JACS_MIPS_ENDPOINT,
                    page_size: int = 10000) -> list[str]:
    """Write `records` as the page files the JACS client's file://
    transport reads (<endpoint>_<offset>.json, `page_size` records a
    page); returns their paths."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for off in range(0, max(len(records), 1), page_size):
        path = os.path.join(str(directory), f"{endpoint}_{off}.json")
        with open(path, "w") as f:
            json.dump(records[off:off + page_size], f)
        paths.append(path)
    return paths


def _v2_mip(prefix: str, i: int, library: str, image: str) -> dict:
    """A v2 MIP's fields: LM ones (slide code, objective, gender, area,
    channel, mounting protocol) unless the library is an EM one."""
    d = {"id": f"{prefix}{i}", "publishedName": f"{prefix.upper()}{i % 5}",
         "libraryName": library, "imageName": image,
         "alignmentSpace": "JRC2018_Unisex_20x_HR"}
    if "flyem" in library:
        d.update(neuronType=f"T{i % 3}", neuronInstance=f"T{i % 3}_L")
    else:
        d.update(slideCode=f"2019{i:04d}_62_F1", objective="40x",
                 gender="fm"[i % 2], anatomicalArea="Brain",
                 channel=("1", "2", "x")[i % 3],
                 mountingProtocol="DPX PBS Mounting")
    return d


def write_v2_results(root, rng: np.random.Generator, n_masks: int,
                     n_targets: int, *, legacy_every: int = 3,
                     missing_every: int = 4) -> list[str]:
    """v2 per-mask result files (CDSMatches) under `root`/results: EM
    masks against LM targets, every target a row of every mask, in the
    current shape (the target's fields, the mask's as source*) and, for
    every `legacy_every`-th mask, the legacy shape (the mask's own fields,
    matched* for the target, scores in an attrs map of strings). Rows
    carry shape scores, a normalized gap score or neither. Every image is
    a small PNG under `root`/images but every `missing_every`-th target,
    whose file is absent. Returns the result files."""
    root = str(root)
    images = os.path.join(root, "images")
    results = os.path.join(root, "results")
    os.makedirs(images, exist_ok=True)
    os.makedirs(results, exist_ok=True)
    blank = encode_png(np.zeros((4, 6, 3), np.uint8))

    def image(name, present=True):
        path = os.path.join(images, name)
        if present:
            with open(path, "wb") as f:
                f.write(blank)
        return path

    masks = [_v2_mip("em", i, "flyem_hemibrain_1_2_1",
                     image(f"em{i}.png")) for i in range(n_masks)]
    targets = [_v2_mip("lm", j, "FlyLight Gen1 MCFO",
                       image(f"lm{j}.png", j % missing_every != 1))
               for j in range(n_targets)]
    files = []
    for i, mask in enumerate(masks):
        legacy = legacy_every and i % legacy_every == legacy_every - 1
        rows = []
        for j, target in enumerate(targets):
            px = int(rng.integers(1, 5000))
            ratio = round(float(rng.uniform(0, 1)), 6)
            gap = int(rng.integers(0, 90000)) if j % 3 != 2 else None
            he = int(rng.integers(0, 900)) if gap is not None else None
            norm = round(float(rng.uniform(0, 9000)), 4) \
                if j % 2 == 0 else None
            if legacy:
                r = {**mask, "matchedId": target["id"],
                     "matchedPublishedName": target["publishedName"],
                     "matchedLibrary": target["libraryName"],
                     "matchedImageName": target["imageName"],
                     "image_path": f"/thumbs/{target['id']}.png",
                     "attrs": {"Matched pixels": str(px),
                               "Score": str(ratio),
                               "Slide Code": target.get("slideCode")}}
                if gap is not None:
                    r["attrs"]["GradientAreaGap"] = str(gap)
                    r["attrs"]["HighExpressionArea"] = str(he)
                if norm is not None:
                    r["attrs"]["NormalizedGapScore"] = str(norm)
                r["mirrored"] = bool(j % 2)
            else:
                r = {**target, **{"source" + k[0].upper() + k[1:]: v
                                  for k, v in mask.items()},
                     "matchingPixels": px, "matchingRatio": ratio,
                     "mirrored": bool(j % 2)}
                if gap is not None:
                    r.update(gradientAreaGap=gap, highExpressionArea=he)
                if norm is not None:
                    r["normalizedGapScore"] = norm
            rows.append(r)
        doc = {"results": rows} if legacy else \
            {"maskId": mask["id"], "maskPublishedName":
             mask["publishedName"], "maskLibraryName": mask["libraryName"],
             "results": rows}
        path = os.path.join(results, f"{mask['id']}.json")
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        files.append(path)
    return files


def snapshot(path):
    """A file's bytes, a directory's {relative path: bytes}, or None
    when the path does not exist."""
    path = str(path)
    if os.path.isfile(path):
        with open(path, "rb") as f:
            return f.read()
    if not os.path.isdir(path):
        return None
    out = {}
    for d, _, names in os.walk(path):
        for name in names:
            full = os.path.join(d, name)
            with open(full, "rb") as f:
                out[os.path.relpath(full, path)] = f.read()
    return dict(sorted(out.items()))


def run_clis(mains: dict, argv: list, *, outputs=(), inputs=()) -> dict:
    """Run one command line through each CLI of `mains` ({name: main})
    in turn, on the same paths: before each run the files and
    directories in `outputs` are removed, then the files in `inputs` (one
    may lie in an output directory) get back the bytes they had before
    the first run. Returns {name: (exit code, standard output, [snapshot
    of each output])}."""
    argv = [str(a) for a in argv]
    kept = {str(p): snapshot(p) for p in inputs}
    out = {}
    for name, main in mains.items():
        for path in map(str, outputs):
            if os.path.isdir(path):
                shutil.rmtree(path)
            elif os.path.exists(path):
                os.remove(path)
        for path, data in kept.items():
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "wb") as f:
                f.write(data)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(list(argv))
        out[name] = (rc, buf.getvalue(), [snapshot(p) for p in outputs])
    return out
