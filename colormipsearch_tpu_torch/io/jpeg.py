"""JPEG decoding without PIL: libjpeg-turbo's default decompression.

PIL decodes JPEGs through libjpeg-turbo with its defaults, which are
integer arithmetic throughout: the accurate integer IDCT as its SIMD
kernels compute it (jsimd_idct_islow: 16-bit words, saturated), "fancy"
upsampling of subsampled chroma (`h2v1_fancy_upsample`,
`h2v2_fancy_upsample`, `h1v2_fancy_upsample`, jdsample.c) and the
fixed-point YCbCr -> RGB tables of `build_ycc_rgb_table` (jdcolor.c).
This module carries the same rules, so it gives what PIL gives, value
for value: the entropy decoding loops in Python (this path only has to
be right), the IDCT, upsampling and colour conversion vectorised over all
blocks in numpy.

Decoded: baseline, extended sequential and progressive JPEGs (8-bit),
Huffman-coded or arithmetic-coded (SOF9/10, DAC; jdarith.c), and lossless
Huffman-coded ones (SOF3; jdlossls.c, its planes replicated, not
filtered, when subsampled); 1 component (gray: uint8 [H, W]), 3 (uint8
[H, W, 3]; YCbCr converted to RGB unless libjpeg's rule of JFIF / Adobe
transform / component ids names the file RGB) or 4 (CMYK, or YCCK under
an Adobe transform other than 0, through PIL's inverted CMYK raw mode
and its CMYK -> RGB: uint8 [H, W, 3]); any integer sampling ratios,
restart markers. Progressive files whose scans leave some of the first
nine AC coefficients inexact are block-smoothed (`decompress_smooth_data`
of libjpeg-turbo 2.1+, jdcoefct.c). Corrupt entropy data is read as
libjpeg-turbo reads it (a bad Huffman code decodes as 0; past a
premature marker zeros, and the rest of the restart interval untouched;
restart markers resynchronised by `jpeg_resync_to_restart`; arithmetic
decoding stops at a bad code until the next restart). Like PIL's
Image.open, no EXIF orientation and no ICC profile are applied. Raises
ValueError, naming the form, on what PIL refuses too: 12-bit,
hierarchical (SOF5-7, 13-15), lossless arithmetic-coded (SOF11) and
2-component JPEGs, lossless ones under a colour transform, DNL heights,
files without an EOI (truncated).
"""

from __future__ import annotations

import struct

import numpy as np

# jpeg_natural_order (jutils.c): zigzag index -> row-major position, with
# the 16 guard entries libjpeg appends for corrupt run lengths
_NATURAL = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19,
            26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49,
            56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52,
            45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63) + (63,) * 16
_SAVED_COEFS = 10        # jdcoefct.c: coef_bits[0..9] decide smoothing
_SOF_FORMS = {0xC5: "hierarchical", 0xC6: "hierarchical",
              0xC7: "hierarchical", 0xCB: "lossless arithmetic-coded",
              0xCD: "hierarchical arithmetic-coded",
              0xCE: "hierarchical arithmetic-coded",
              0xCF: "hierarchical arithmetic-coded"}
# SOF markers this module decodes: sequential and progressive, Huffman
# (0, 1, 2) and arithmetic (9, 10) coding; lossless Huffman (3)
_SOF_DECODED = (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA)


def _wrap16(v):
    """(JCOEF) v, or a 16-bit SIMD word: v wrapped to a 16-bit short."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


class _Huffman:
    """A decoding table: lut[16 peeked bits] = length << 8 | symbol, 0 for
    a prefix that is no code (jpeg_make_d_derived_tbl's checks)."""

    def __init__(self, counts, symbols):
        if sum(counts) > 256 or len(symbols) != sum(counts):
            raise ValueError("JPEG: bad Huffman table")
        # checked when a scan takes the table as a DC one (the limit is
        # 15 for DCT scans, 16 for lossless ones)
        self.max_symbol = max(symbols, default=0)
        lut = np.zeros(1 << 16, np.int32)
        code, k = 0, 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                span = 1 << (16 - length)
                lut[code * span:(code + 1) * span] = length << 8 | symbols[k]
                code += 1
                k += 1
            if code >= (1 << length):   # no code is all ones
                raise ValueError("JPEG: bad Huffman table")
            code <<= 1
        self.lut = lut.tolist()


class _Bits:
    """MSB-first bit reader over one entropy-coded segment (stuffing
    removed), zero-padded past its end as libjpeg pads."""

    def __init__(self, seg: bytes):
        b = np.frombuffer(seg + b"\0" * 8, np.uint8).astype(np.uint64)
        n = len(seg) + 4
        # w40[i]: bytes i .. i + 4 as one 40-bit integer
        w = np.zeros(n, np.uint64)
        for k in range(5):
            w = (w << np.uint64(8)) | b[k:k + n]
        self.w40 = w.tolist()
        self.n_bits = 8 * len(seg)
        self.pos = 0

    def window(self) -> int:
        """The next 32 bits (zeros past the segment)."""
        p = self.pos
        if p >= self.n_bits:
            return 0
        return (self.w40[p >> 3] >> (8 - (p & 7))) & 0xFFFFFFFF

    def symbol(self, lut) -> int:
        """One Huffman symbol. A prefix that is no code decodes as 0
        after 17 bits, as jpeg_huff_decode fakes it (JWRN_HUFF_BAD_CODE)."""
        win = self.window()
        e = lut[win >> 16]
        if not e:
            self.pos += 17
            return 0
        self.pos += e >> 8
        return e & 0xFF

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        v = self.window() >> (32 - n)
        self.pos += n
        return v

    @property
    def past_end(self) -> bool:
        """Whether a read went past the segment: libjpeg then fills the
        bit buffer with zeros and sets insufficient_data."""
        return self.pos > self.n_bits


def _extend(v: int, s: int) -> int:
    """HUFF_EXTEND: an s-bit magnitude category value -> signed."""
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None                  # latched at its first scan
        self.coef_bits = [-1] * 64      # progressive: bit position known


def _segments(data: bytes, pos: int):
    """The entropy-coded data of the scan that starts at pos, cut at its
    restart markers: ([(bytes, number of the RST marker that ends it or
    None)], position of the marker that ends the scan)."""
    segs = []
    cur = bytearray()
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= len(data):
            raise ValueError("JPEG scan data is truncated")
        cur += data[pos:i]
        nxt = data[i + 1]
        if nxt == 0:
            cur.append(0xFF)
            pos = i + 2
        elif nxt == 0xFF:
            pos = i + 1            # fill byte before a marker
        elif 0xD0 <= nxt <= 0xD7:
            segs.append((bytes(cur), nxt - 0xD0))
            cur = bytearray()
            pos = i + 2
        else:
            segs.append((bytes(cur), None))
            return segs, i


def _resync(segs, cur: int, desired: int) -> tuple[int, bool]:
    """process_restart's marker handling: the marker that ends segment
    cur is taken if it is RST<desired>; else jpeg_resync_to_restart
    (jdmarker.c): one of the next two restarts, or any other marker, is
    left unread (the interval reads as empty); one of the two before is
    skipped with the data after it, and the decision repeats; any other
    restart is discarded and decoding resumes after it. -> (segment to
    read next, whether the reader stays at a marker)."""
    while True:
        m = segs[cur][1]
        if m is None or m in ((desired + 1) & 7, (desired + 2) & 7):
            return cur, True
        if m in ((desired - 1) & 7, (desired - 2) & 7):
            cur += 1
            continue
        return cur + 1, False


class _Decoder:
    def __init__(self, data: bytes):
        self.data = data
        self.qt = {}
        self.dc, self.ac = {}, {}
        self.restart = 0
        self.frame = None
        self.progressive = False
        self.arith = False
        # DAC conditioning per arithmetic table: L, U (DC) and K (AC),
        # as SOI resets them
        self.arith_l, self.arith_u, self.arith_k = [0] * 16, [1] * 16, [5] * 16
        self.jfif = False
        self.adobe = None
        self.comps = []

    # --- markers ---

    def parse(self) -> None:
        data = self.data
        if not data.startswith(b"\xff\xd8"):
            raise ValueError("not a JPEG")
        pos = 2
        while True:
            i = data.find(b"\xff", pos)
            while 0 <= i < len(data) - 1 and data[i + 1] == 0xFF:
                i += 1
            if i < 0 or i + 1 >= len(data):
                raise ValueError("JPEG ends before its EOI marker "
                                 "(truncated)")
            m = data[i + 1]
            pos = i + 2
            if m == 0xD9:
                break
            if m in (0x01,) or 0xD0 <= m <= 0xD7:
                continue
            if pos + 2 > len(data):
                raise ValueError("JPEG marker segment is truncated")
            (length,) = struct.unpack(">H", data[pos:pos + 2])
            body = data[pos + 2:pos + length]
            if length < 2 or len(body) != length - 2:
                raise ValueError("JPEG marker segment is truncated")
            pos += length
            if m == 0xDB:
                self._dqt(body)
            elif m == 0xC4:
                self._dht(body)
            elif m == 0xDD:
                (self.restart,) = struct.unpack(">H", body[:2])
            elif m in _SOF_DECODED:
                self._sof(m, body)
            elif m in _SOF_FORMS:
                raise ValueError(f"{_SOF_FORMS[m]} JPEG (SOF{m - 0xC0}) is "
                                 "not decodable without PIL")
            elif m == 0xCC:
                self._dac(body)
            elif m == 0xDC:
                raise ValueError("JPEG with a DNL marker is not decodable "
                                 "without PIL")
            elif m == 0xDA:
                pos = self._sos(body, pos)
            elif m == 0xE0 and body.startswith(b"JFIF\0"):
                self.jfif = True
            elif m == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
                self.adobe = body[11]
        if self.frame is None:
            raise ValueError("JPEG without a frame header")

    def _dqt(self, body: bytes) -> None:
        off = 0
        while off < len(body):
            pq, tq = body[off] >> 4, body[off] & 15
            n = 128 if pq else 64
            if pq > 1 or tq > 3 or off + 1 + n > len(body):
                raise ValueError("JPEG: bad quantization table")
            vals = np.frombuffer(body, ">u2" if pq else np.uint8, 64, off + 1)
            table = np.zeros(64, np.int64)
            table[np.asarray(_NATURAL[:64])] = vals
            self.qt[tq] = table
            off += 1 + n

    def _dht(self, body: bytes) -> None:
        off = 0
        while off < len(body):
            if off + 17 > len(body):
                raise ValueError("JPEG: bad Huffman table")
            tc, th = body[off] >> 4, body[off] & 15
            counts = list(body[off + 1:off + 17])
            n = sum(counts)
            symbols = list(body[off + 17:off + 17 + n])
            if tc > 1 or th > 3:
                raise ValueError("JPEG: bad Huffman table")
            (self.ac if tc else self.dc)[th] = _Huffman(counts, symbols)
            off += 17 + n

    def _dac(self, body: bytes) -> None:
        """get_dac (jdmarker.c): index < 16 sets a DC table's L and U,
        16-31 an AC table's K."""
        if len(body) % 2:
            raise ValueError("JPEG: bad DAC marker")
        for k in range(0, len(body), 2):
            index, val = body[k], body[k + 1]
            if index >= 32:
                raise ValueError(f"JPEG: DAC index {index}")
            if index >= 16:
                self.arith_k[index - 16] = val
            else:
                self.arith_l[index], self.arith_u[index] = val & 15, val >> 4
                if val & 15 > val >> 4:
                    raise ValueError(f"JPEG: DAC value {val}")

    def _sof(self, m: int, body: bytes) -> None:
        if self.frame is not None:
            raise ValueError("JPEG with two frame headers")
        if len(body) < 6:
            raise ValueError("JPEG: bad frame header")
        prec, h, w, nc = struct.unpack(">BHHB", body[:6])
        if prec != 8:
            raise ValueError(f"{prec}-bit JPEG is not decodable without PIL")
        if h == 0 or w == 0:
            raise ValueError("JPEG without a height (DNL) or width is not "
                             "decodable without PIL")
        if nc not in (1, 3, 4) or len(body) < 6 + 3 * nc:
            raise ValueError(f"JPEG with {nc} components is not decodable "
                             "without PIL")
        for k in range(nc):
            cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
            hs, vs = hv >> 4, hv & 15
            if not (1 <= hs <= 4 and 1 <= vs <= 4) or tq > 3:
                raise ValueError("JPEG: bad sampling factors or table")
            self.comps.append(_Component(cid, hs, vs, tq))
        self.frame = (w, h)
        self.progressive = m in (0xC2, 0xCA)
        self.arith = m in (0xC9, 0xCA)
        self.lossless = m == 0xC3
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        unit = 1 if self.lossless else 8     # samples a data unit spans
        self.mcux = -(-w // (unit * self.hmax))
        self.mcuy = -(-h // (unit * self.vmax))
        for c in self.comps:
            # the component's own size and blocks (jdinput.c initial_setup)
            c.dw = -(-w * c.h // self.hmax)
            c.dh = -(-h * c.v // self.vmax)
            c.bw, c.bh = -(-c.dw // 8), -(-c.dh // 8)
            c.aw, c.ah = self.mcux * c.h, self.mcuy * c.v    # allocated
            c.coef = [0] * (c.aw * c.ah * (1 if self.lossless else 64))
            c.plane = None                   # lossless: decoded samples

    # --- scans ---

    def _sos(self, body: bytes, pos: int) -> int:
        if self.frame is None:
            raise ValueError("JPEG scan before its frame header")
        ns = body[0] if body else 0
        if not 1 <= ns <= 4 or len(body) != 4 + 2 * ns:
            raise ValueError("JPEG: bad scan header")
        by_id = {c.id: c for c in self.comps}
        comps, tables = [], []
        for k in range(ns):
            cid, t = body[1 + 2 * k], body[2 + 2 * k]
            if cid not in by_id:
                raise ValueError("JPEG scan names an unknown component")
            comps.append(by_id[cid])
            tables.append((t >> 4, t & 15))
        ss, se, ah, al = (body[1 + 2 * ns], body[2 + 2 * ns],
                          body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 15)
        for c in comps:
            if c.qt is None and not self.lossless:
                if c.tq not in self.qt:
                    raise ValueError("JPEG: missing quantization table")
                c.qt = self.qt[c.tq].copy()   # latch_quant_tables
        if ns > 1 and sum(c.h * c.v for c in comps) > 10:
            raise ValueError("JPEG: MCU of more than 10 blocks")
        segs, end = _segments(self.data, pos)
        if self.lossless:
            _lossless_scan(self, comps, tables, segs, ss, se, ah, al)
            return end
        if self.progressive:
            dc_band = ss == 0
            bad = (se != 0 if dc_band else (ss > se or se > 63 or ns != 1))
            if ah and al != ah - 1:
                bad = True
            if bad or al > 13:
                raise ValueError(f"JPEG: bad progression (Ss {ss}, Se {se}, "
                                 f"Ah {ah}, Al {al})")
            for c in comps:
                for k in range(ss, se + 1):
                    c.coef_bits[k] = al
        else:
            ss, se, ah, al = 0, 63, 0, 0
        # the tables the scan decodes with: DC for a sequential scan and a
        # first DC scan, AC for a sequential scan and every AC scan
        if self.arith:
            _arith_scan(self, comps, tables, segs, ss, se, ah, al)
            return end
        use_dc = not self.progressive or (ss == 0 and ah == 0)
        use_ac = not self.progressive or ss > 0
        for td, ta in tables:
            if (use_dc and td not in self.dc) \
                    or (use_ac and ta not in self.ac):
                raise ValueError("JPEG: scan without its Huffman table")
            if use_dc and self.dc[td].max_symbol > 15:
                raise ValueError("JPEG: bad DC Huffman table")
        self._decode_scan(comps, tables, segs, ss, se, ah, al)
        return end

    def _blocks(self, comps):
        """The scan's blocks in coding order: (component index in the
        scan, coef offset) per block, in MCUs."""
        if len(comps) == 1:
            c = comps[0]
            return [[(0, (by * c.aw + bx) * 64)]
                    for by in range(c.bh) for bx in range(c.bw)]
        mcus = []
        for my in range(self.mcuy):
            for mx in range(self.mcux):
                mcu = []
                for ci, c in enumerate(comps):
                    for v in range(c.v):
                        for h in range(c.h):
                            by, bx = my * c.v + v, mx * c.h + h
                            mcu.append((ci, (by * c.aw + bx) * 64))
                mcus.append(mcu)
        return mcus

    def _decode_scan(self, comps, tables, segs, ss, se, ah, al) -> None:
        """Decode one scan's MCUs from its entropy-coded segments as
        libjpeg-turbo does, corrupt data included: once a read runs past a
        segment (a premature marker: zero bits, insufficient_data) the
        rest of the restart interval is left as it is; at each restart
        the marker that ends the current segment is taken if it is the
        expected RSTn, else jpeg_resync_to_restart decides (_resync);
        segments and restart markers after the last MCU are skipped."""
        mcus = self._blocks(comps)
        ri = self.restart
        dcs = [self.dc.get(td) for td, _ in tables]
        acs = [self.ac.get(ta) for _, ta in tables]
        coefs = [c.coef for c in comps]
        state = {"pred": [0] * len(comps), "eobrun": 0}
        cur, at_marker, insufficient = 0, False, False
        next_rst, to_go = 0, ri
        bits = _Bits(segs[0][0])
        for mcu in mcus:
            if ri and to_go == 0:
                cur, at_marker = _resync(segs, cur, next_rst)
                next_rst = (next_rst + 1) & 7
                state = {"pred": [0] * len(comps), "eobrun": 0}
                to_go = ri
                if not at_marker:
                    insufficient = False
                bits = _Bits(b"" if at_marker else segs[cur][0])
            if ri:
                to_go -= 1
            if insufficient:
                continue
            for ci, off in mcu:
                coef = coefs[ci]
                if not self.progressive:
                    _sequential(bits, coef, off, dcs[ci].lut, acs[ci].lut,
                                state, ci)
                elif ss == 0:
                    _dc_progressive(bits, coef, off, dcs[ci], ah, al, state,
                                    ci)
                elif ah == 0:
                    _ac_first(bits, coef, off, acs[ci].lut, ss, se, al,
                              state)
                else:
                    _ac_refine(bits, coef, off, acs[ci].lut, ss, se, al,
                               state)
            insufficient = bits.past_end

    # --- output ---

    def pixels(self, color: str | None = None) -> np.ndarray:
        w, h = self.frame
        if self.lossless:
            return self._lossless_pixels()
        if any(c.qt is None for c in self.comps):
            raise ValueError("JPEG component without any scan")
        smooth = self.progressive and self._smoothing_ok()
        planes = []
        for c in self.comps:
            coef = np.asarray(c.coef, np.int64).reshape(c.ah, c.aw, 64)
            coef = ((coef + 0x8000) & 0xFFFF) - 0x8000
            if smooth:
                block = _smooth(coef, c, self.mcuy)
            else:
                block = coef[:c.bh, :c.bw]
            px = _idct_islow(block.reshape(-1, 64), c.qt)
            plane = px.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3) \
                .reshape(c.bh * 8, c.bw * 8)[:c.dh, :c.dw]
            planes.append(_upsample(plane, self.hmax // c.h,
                                    self.vmax // c.v, c, self)[:h, :w])
        if len(planes) == 1:
            return planes[0].astype(np.uint8)
        if len(planes) == 4:
            return _cmyk_to_rgb(planes, self.adobe not in (None, 0))
        if color == "none" or (color is None and self._is_rgb()):
            return np.stack(planes, -1).astype(np.uint8)
        return _ycc_to_rgb(*planes)

    def _lossless_pixels(self) -> np.ndarray:
        """The lossless planes, upsampled by replication; libjpeg-turbo
        keeps a lossless image's colours as they are (RGB, or CMYK as the
        DCT path converts it) and refuses a colour transform (JFIF on 3
        components, an Adobe transform other than 0)."""
        w, h = self.frame
        if any(c.plane is None for c in self.comps):
            raise ValueError("JPEG component without any scan")
        if (len(self.comps) == 3 and self.jfif) or (
                len(self.comps) > 2 and self.adobe not in (None, 0)):
            raise ValueError("lossless JPEG with a colour transform is not "
                             "decodable (libjpeg refuses it too)")
        # jinit_upsampler's fancy filters need a DCT_scaled_size above 1,
        # which lossless data units never have: replication
        planes = [np.repeat(np.repeat(c.plane, self.vmax // c.v, axis=0),
                            self.hmax // c.h, axis=1)[:h, :w]
                  for c in self.comps]
        if len(planes) == 1:
            return planes[0].astype(np.uint8)
        if len(planes) == 4:
            return _cmyk_to_rgb(planes, False)
        return np.stack(planes, -1).astype(np.uint8)

    def _is_rgb(self) -> bool:
        """default_decompress_parms (jdapimin.c) for 3 components."""
        if self.jfif:
            return False
        if self.adobe is not None:
            return self.adobe == 0
        return [c.id for c in self.comps] == [82, 71, 66]   # 'R', 'G', 'B'

    def _smoothing_ok(self) -> bool:
        """smoothing_ok (jdcoefct.c): libjpeg smooths the blocks when the
        scans leave any of the first nine AC coefficients of any
        component inexact, every component has some DC bits and none of
        its first ten quantizers is 0."""
        pos = _NATURAL[:_SAVED_COEFS]
        if any(not all(c.qt[p] for p in pos) or c.coef_bits[0] < 0
               for c in self.comps):
            return False
        return any(b != 0 for c in self.comps
                   for b in c.coef_bits[1:_SAVED_COEFS])


# decompress_smooth_data (libjpeg-turbo 2.1+, jdcoefct.c): each estimate
# is a 5x5 kernel over the quantized DC values of the block's neighbours
# (rows above to below, columns left to right); with DC interpolation
# (no AC bits known at all) the Gaussian-like kernels, else those of
# T.81 K.8 widened to 5x5.
def _kernel(rows) -> np.ndarray:
    return np.array(rows, np.int64).reshape(5, 5)


_Z = [0] * 5
# zigzag index k -> (natural position, kernel with DC interpolation,
# kernel without, or None: that coefficient is estimated only with it)
_SMOOTH = {
    1: (1, _kernel([-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3,
                    -3, 13, 0, -13, 3, -1, -1, 0, 1, 1]),
        _kernel(_Z * 2 + [-7, 50, 0, -50, 7] + _Z * 2)),
    2: (8, _kernel([-1, -3, -3, -3, -1, -1, 13, 38, 13, -1] + _Z
                   + [1, -13, -38, -13, 1, 1, 3, 3, 3, 1]),
        _kernel([0, 0, -7, 0, 0, 0, 0, 50, 0, 0] + _Z
                + [0, 0, -50, 0, 0, 0, 0, 7, 0, 0])),
    3: (16, _kernel([0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0,
                     0, 2, 7, 2, 0, 0, 0, 1, 0, 0]),
        _kernel([0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0,
                 0, 0, 13, 0, 0, 0, 0, -1, 0, 0])),
    4: (9, _kernel([-1, 0, 0, 0, 1, 0, 9, 0, -9, 0] + _Z
                   + [0, -9, 0, 9, 0, 1, 0, 0, 0, -1]),
        _kernel([0, -1, 0, 1, 0, -1, 10, 0, -10, 1] + _Z
                + [1, -10, 0, 10, -1, 0, 1, 0, -1, 0])),
    5: (2, _kernel(_Z + [0, 2, -5, 2, 0, 1, 7, -14, 7, 1, 0, 2, -5, 2, 0]
                   + _Z),
        _kernel(_Z * 2 + [-1, 13, -24, 13, -1] + _Z * 2)),
    6: (3, _kernel(_Z + [0, 1, 0, -1, 0, 0, 2, 0, -2, 0, 0, 1, 0, -1, 0]
                   + _Z), None),
    7: (10, _kernel(_Z + [0, 1, -3, 1, 0] + _Z + [0, -1, 3, -1, 0] + _Z),
        None),
    8: (17, _kernel(_Z + [0, 1, 0, -1, 0, 0, -3, 0, 3, 0, 0, 1, 0, -1, 0]
                    + _Z), None),
    9: (24, _kernel(_Z + [0, 1, 2, 1, 0] + _Z + [0, -1, -2, -1, 0] + _Z),
        None),
}
_SMOOTH_DC = _kernel([-2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152,
                      42, -8, -6, 6, 42, 6, -6, -2, -6, -8, -6, -2])


def _estimate(num: np.ndarray, q: int, al: int) -> np.ndarray:
    """pred = ((q << 7) + |num|) / (q << 8) with num's sign, clamped to
    (1 << Al) - 1 when Al > 0 bits are still unknown."""
    pred = ((q << 7) + np.abs(num)) // (q << 8)
    if al > 0:
        pred = np.minimum(pred, (1 << al) - 1)
    return np.where(num >= 0, pred, -pred)


def _smooth(coef: np.ndarray, c, mcuy: int) -> np.ndarray:
    """decompress_smooth_data for one component: its quantized blocks
    int64 [ah, aw, 64] (natural order, the allocated ones) -> the real
    blocks [bh, bw, 64] with each estimate applied where its coefficient
    is 0 and not known exactly. Neighbours past the image repeat the
    edge block, as libjpeg's row pointers and DC registers do; near the
    bottom libjpeg counts rows as block_rows * total_iMCU_rows, which
    reaches the dummy rows of an interleaved scan, and so does this."""
    bh, bw, v = c.bh, c.bw, c.v
    rows = np.empty((bh, 5), np.int64)
    for r in range(bh):
        m, block_row = divmod(r, v)
        block_rows = v if m < mcuy - 1 else (bh % v or v)
        ibr = m * block_rows + block_row
        ibrs = block_rows * mcuy
        prev = r - 1 if ibr > 0 else r
        nxt = r + 1 if ibr < ibrs - 1 else r
        rows[r] = (r - 2 if ibr > 1 else prev, prev, r, nxt,
                   r + 2 if ibr < ibrs - 2 else nxt)
    k = np.arange(bw)
    cols = np.stack([np.maximum(k - 2, 0), np.maximum(k - 1, 0), k,
                     np.minimum(k + 1, bw - 1), np.minimum(k + 2, bw - 1)],
                    1)
    dc = coef[:, :, 0]
    nb = dc[rows[:, None, :, None], cols[None, :, None, :]]  # [bh, bw, 5, 5]
    bits = c.coef_bits
    change_dc = all(b == -1 for b in bits[1:_SAVED_COEFS])
    out = coef[:bh, :bw].copy()
    q00 = int(c.qt[0])
    for zz, (pos, with_dc, without) in _SMOOTH.items():
        kern = with_dc if change_dc else without
        al = bits[zz]
        if kern is None or al == 0:
            continue
        num = q00 * np.einsum("ijkl,kl->ij", nb, kern)
        pred = _estimate(num, int(c.qt[pos]), al)
        blk = out[:, :, pos]
        out[:, :, pos] = np.where(blk == 0, pred, blk)
    if change_dc:
        num = q00 * np.einsum("ijkl,kl->ij", nb, _SMOOTH_DC)
        out[:, :, 0] = _estimate(num, q00, 0)
    return out


def _sequential(bits, coef, off, dc, ac, state, ci) -> None:
    s = bits.symbol(dc)
    if s:
        s = _extend(bits.bits(s), s)
    pred = state["pred"]
    pred[ci] += s
    coef[off] = _wrap16(pred[ci])
    k = 1
    while k < 64:
        rs = bits.symbol(ac)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            coef[off + _NATURAL[k]] = _extend(bits.bits(s), s)
        elif r != 15:
            break
        else:
            k += 15
        k += 1


def _dc_progressive(bits, coef, off, dc, ah, al, state, ci) -> None:
    if ah == 0:
        s = bits.symbol(dc.lut)
        if s:
            s = _extend(bits.bits(s), s)
        pred = state["pred"]
        pred[ci] += s
        coef[off] = _wrap16(pred[ci] << al)
    elif bits.bits(1):
        coef[off] = _wrap16(coef[off] | (1 << al))


def _ac_first(bits, coef, off, ac, ss, se, al, state) -> None:
    if state["eobrun"]:
        state["eobrun"] -= 1
        return
    k = ss
    while k <= se:
        rs = bits.symbol(ac)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            coef[off + _NATURAL[k]] = _wrap16(_extend(bits.bits(s), s) << al)
        elif r == 15:
            k += 15
        else:
            eobrun = 1 << r
            if r:
                eobrun += bits.bits(r)
            state["eobrun"] = eobrun - 1
            break
        k += 1


def _refine(bits, coef, i, p1) -> None:
    """One correction bit for the nonzero coefficient at coef[i]."""
    if bits.bits(1) and not coef[i] & p1:
        coef[i] = _wrap16(coef[i] + (p1 if coef[i] >= 0 else -p1))


def _ac_refine(bits, coef, off, ac, ss, se, al, state) -> None:
    """decode_mcu_AC_refine (jdphuff.c)."""
    p1 = 1 << al
    k = ss
    if not state["eobrun"]:
        while k <= se:
            rs = bits.symbol(ac)
            r, s = rs >> 4, rs & 15
            if s:
                # a size other than 1 is corrupt: libjpeg warns and reads
                # the sign bit all the same
                s = p1 if bits.bits(1) else -p1
            elif r != 15:
                eobrun = 1 << r
                if r:
                    eobrun += bits.bits(r)
                state["eobrun"] = eobrun
                break
            while True:
                i = off + _NATURAL[k]
                if coef[i]:
                    _refine(bits, coef, i, p1)
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
                if k > se:
                    break
            if s:
                coef[off + _NATURAL[k]] = s
            k += 1
    if state["eobrun"]:
        while k <= se:
            i = off + _NATURAL[k]
            if coef[i]:
                _refine(bits, coef, i, p1)
            k += 1
        state["eobrun"] -= 1


# --- jdlhuff.c, jddiffct.c, jdlossls.c: lossless (process 14) ---


def _lossless_scan(jd, comps, tables, segs, psv, se, ah, pt) -> None:
    """One lossless scan: the sample differences, Huffman-coded with the
    DC tables (category 16 is 32768 with no bits), in MCUs of h x v
    samples per component, with libjpeg-turbo's rules for corrupt data
    and restarts (whole MCU rows, as it requires); then each component's
    rows undifferenced (jdlossls.c: the first row of the scan and of each
    restart interval from 2^(P - Pt - 1) along the row, the others with
    predictor psv, their first sample from the one above) and scaled by
    2^Pt into 8-bit samples."""
    if not 1 <= psv <= 7 or se != 0 or ah != 0 or pt >= 8:
        raise ValueError(f"JPEG: bad lossless scan (Ss {psv}, Se {se}, Ah "
                         f"{ah}, Al {pt})")
    for td, _ in tables:
        if td not in jd.dc:
            raise ValueError("JPEG: scan without its Huffman table")
        if jd.dc[td].max_symbol > 16:
            raise ValueError("JPEG: bad lossless Huffman table")
    if len(comps) == 1:
        c = comps[0]
        per_row = c.dw
        mcus = [[(0, y * c.aw + x)] for y in range(c.dh) for x in range(c.dw)]
    else:
        per_row = jd.mcux
        mcus = [[(ci, (my * c.v + v) * c.aw + mx * c.h + u)
                 for ci, c in enumerate(comps)
                 for v in range(c.v) for u in range(c.h)]
                for my in range(jd.mcuy) for mx in range(jd.mcux)]
    ri = jd.restart
    if ri % per_row:
        raise ValueError("JPEG: a lossless restart interval that is not "
                         "whole MCU rows")
    luts = [jd.dc[td].lut for td, _ in tables]
    diffs = [[0] * (c.aw * c.ah) for c in comps]
    cur, at_marker, insufficient = 0, False, False
    next_rst, to_go = 0, ri
    bits = _Bits(segs[0][0])
    for mcu in mcus:
        if ri and to_go == 0:
            cur, at_marker = _resync(segs, cur, next_rst)
            next_rst = (next_rst + 1) & 7
            to_go = ri
            if not at_marker:
                insufficient = False
            bits = _Bits(b"" if at_marker else segs[cur][0])
        if ri:
            to_go -= 1
        if insufficient:
            continue
        for ci, at in mcu:
            s = bits.symbol(luts[ci])
            if s == 16:
                s = 32768
            elif s:
                s = _extend(bits.bits(s), s)
            diffs[ci][at] = s
        insufficient = bits.past_end
    rows_per_interval = ri // per_row if ri else 0
    for ci, c in enumerate(comps):
        d = np.asarray(diffs[ci], np.int64).reshape(c.ah, c.aw)
        fresh = set(range(0, c.dh, c.v * rows_per_interval)) \
            if rows_per_interval else {0}
        c.plane = _undifference(d[:c.dh, :c.dw], psv, pt, fresh)


def _undifference(d: np.ndarray, psv: int, pt: int, fresh) -> np.ndarray:
    """Sample differences [h, w] -> 8-bit samples: rows in `fresh` from
    the initial predictor along the row (UNDIFFERENCE_1D), the others by
    predictor psv (UNDIFFERENCE_2D), all mod 2^16, then << Pt cut to a
    JSAMPLE."""
    h, w = d.shape
    out = np.zeros((h, w), np.int64)
    for y in range(h):
        if y in fresh:
            row = d[y].copy()
            row[0] += 1 << (8 - pt - 1)
            out[y] = np.cumsum(row) & 0xFFFF
            continue
        up = out[y - 1]
        if psv == 1:
            row = d[y].copy()
            row[0] += up[0]
            out[y] = np.cumsum(row) & 0xFFFF
            continue
        if psv in (2, 3):
            pred = up.copy() if psv == 2 else np.concatenate([up[:1],
                                                              up[:-1]])
            out[y] = (d[y] + pred) & 0xFFFF
            continue
        dy, upl = d[y].tolist(), up.tolist()
        ra = (dy[0] + upl[0]) & 0xFFFF
        vals = [ra]
        for x in range(1, w):
            rb, rc = upl[x], upl[x - 1]
            if psv == 4:
                p = ra + rb - rc
            elif psv == 5:
                p = ra + ((rb - rc) >> 1)
            elif psv == 6:
                p = rb + ((ra - rc) >> 1)
            else:
                p = (ra + rb) >> 1
            ra = (dy[x] + p) & 0xFFFF
            vals.append(ra)
        out[y] = vals
    return (out << pt) & 0xFF


# --- jdarith.c: arithmetic decoding (T.81 Annex D and F.1.4.4, G.1.3) ---

# jpeg_aritab (jaricom.c), T.81 Table D.2: (Qe, Next_Index_LPS,
# Next_Index_MPS, Switch_MPS) per state, and a last state (113) of fixed
# probability 0.5
_ARITAB = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))
# (Qe, Next_Index_MPS, Next_Index_LPS | Switch_MPS << 7), as jaricom.c
# packs them
_QE = tuple((qe, nm, nl | sw << 7) for qe, nl, nm, sw in _ARITAB)
_FIXED = 113        # the state of fixed probability 0.5


class _ArithError(Exception):
    """JWRN_ARITH_BAD_CODE: the decoder stops until the next restart."""


class _Arith:
    """arith_decode (jdarith.c) over one entropy-coded segment; past its
    end (a marker) the data is zeros."""

    def __init__(self, seg: bytes):
        self.seg, self.i = seg, 0
        self.c, self.a, self.ct = 0, 0, -16

    def decode(self, st, k: int) -> int:
        """One binary decision with the statistics bin st[k]."""
        a, ct = self.a, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                data = 0
                if self.i < len(self.seg):
                    data = self.seg[self.i]
                    self.i += 1
                self.c = (self.c << 8) | data
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000        # two first bytes read
            a <<= 1
        sv = st[k]
        qe, nm, nl = _QE[sv & 0x7F]
        temp = a - qe
        a = temp
        temp <<= ct
        if self.c >= temp:
            self.c -= temp
            if a < qe:
                a = qe
                st[k] = (sv & 0x80) ^ nm
            else:
                a = qe
                st[k] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif a < 0x8000:
            if a < qe:
                st[k] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[k] = (sv & 0x80) ^ nm
        self.a, self.ct = a, ct
        return sv >> 7


def _arith_dc(dec: _Arith, stats, ctx: list, ci: int, lo: int,
              hi: int) -> int:
    """Figure F.19 with F.21-F.24: one DC difference, the component's
    conditioning category ctx[ci] updated (DAC's L = lo, U = hi)."""
    st = ctx[ci]
    if dec.decode(stats, st) == 0:
        ctx[ci] = 0
        return 0
    sign = dec.decode(stats, st + 1)
    st += 2 + sign
    m = dec.decode(stats, st)
    if m:
        st = 20                          # X1
        while dec.decode(stats, st):
            m <<= 1
            if m == 0x8000:
                raise _ArithError
            st += 1
    if m < (1 << lo) >> 1:
        ctx[ci] = 0
    elif m > (1 << hi) >> 1:
        ctx[ci] = 12 + 4 * sign
    else:
        ctx[ci] = 4 + 4 * sign
    v = m
    st += 14
    m >>= 1
    while m:
        if dec.decode(stats, st):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def _arith_ac(dec: _Arith, stats, fixed, st: int, k: int, kx: int) -> int:
    """Figures F.21-F.24 for the AC coefficient k whose bins start at st
    (S0 + 1 decided it is nonzero): its sign (fixed bin), magnitude
    category and bits; categories past the second from bin 189 up to
    k = K (kx), 217 after."""
    sign = dec.decode(fixed, 0)
    st += 2
    m = dec.decode(stats, st)
    if m and dec.decode(stats, st):
        m <<= 1
        st = 189 if k <= kx else 217
        while dec.decode(stats, st):
            m <<= 1
            if m == 0x8000:
                raise _ArithError
            st += 1
    v = m
    st += 14
    m >>= 1
    while m:
        if dec.decode(stats, st):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def _arith_scan(jd, comps, tables, segs, ss, se, ah, al) -> None:
    """One arithmetic-coded scan (decode_mcu, decode_mcu_DC_first,
    _AC_first, _DC_refine, _AC_refine of jdarith.c): statistics bins per
    table, reset with the DC predictions at each restart; a bad code
    (JWRN_ARITH_BAD_CODE) stops decoding until the next restart; past a
    segment's end (a marker) the data reads as zeros."""
    prog = jd.progressive
    use_dc = not prog or (ss == 0 and ah == 0)
    use_ac = not prog or ss > 0
    mcus = jd._blocks(comps)
    coefs = [c.coef for c in comps]
    fixed = bytearray([_FIXED])

    def fresh():
        dcs = {td: bytearray(64) for td, _ in tables} if use_dc else {}
        acs = {ta: bytearray(256) for _, ta in tables} if use_ac else {}
        return dcs, acs, [0] * len(comps), [0] * len(comps)

    dc_stats, ac_stats, last, ctx = fresh()
    ri = jd.restart
    cur, at_marker, failed = 0, False, False
    next_rst, to_go = 0, ri
    dec = _Arith(segs[0][0])
    p1, m1 = 1 << al, -(1 << al)
    for mcu in mcus:
        if ri and to_go == 0:
            cur, at_marker = _resync(segs, cur, next_rst)
            next_rst = (next_rst + 1) & 7
            dc_stats, ac_stats, last, ctx = fresh()
            dec = _Arith(b"" if at_marker else segs[cur][0])
            failed = False
            to_go = ri
        if ri:
            to_go -= 1
        if failed:
            continue
        try:
            for ci, off in mcu:
                coef = coefs[ci]
                td, ta = tables[ci]
                if not prog or (ss == 0 and ah == 0):
                    v = _arith_dc(dec, dc_stats[td], ctx, ci,
                                  jd.arith_l[td], jd.arith_u[td])
                    if v:
                        last[ci] = (last[ci] + v) & 0xFFFF
                    coef[off] = _wrap16(last[ci] << al)
                    if prog:
                        continue
                    _arith_ac_seq(dec, ac_stats[ta], fixed, coef, off,
                                  jd.arith_k[ta])
                elif ss == 0:
                    if dec.decode(fixed, 0):
                        coef[off] = _wrap16(coef[off] | p1)
                elif ah == 0:
                    _arith_ac_first(dec, ac_stats[ta], fixed, coef, off, ss,
                                    se, al, jd.arith_k[ta])
                else:
                    _arith_ac_refine(dec, ac_stats[ta], fixed, coef, off, ss,
                                     se, p1, m1)
        except _ArithError:
            failed = True


def _arith_ac_seq(dec, stats, fixed, coef, off, kx) -> None:
    """Figure F.20 for a sequential block."""
    k = 0
    while k < 63:
        st = 3 * k
        if dec.decode(stats, st):
            break                        # EOB
        while True:
            k += 1
            if dec.decode(stats, st + 1):
                break
            st += 3
            if k >= 63:
                raise _ArithError
        coef[off + _NATURAL[k]] = _wrap16(_arith_ac(dec, stats, fixed, st,
                                                    k, kx))


def _arith_ac_first(dec, stats, fixed, coef, off, ss, se, al, kx) -> None:
    """decode_mcu_AC_first: one band of a block, scaled by 2^Al."""
    k = ss
    while k <= se:
        st = 3 * (k - 1)
        if dec.decode(stats, st):
            break                        # EOB
        while dec.decode(stats, st + 1) == 0:
            st += 3
            k += 1
            if k > se:
                raise _ArithError
        coef[off + _NATURAL[k]] = _wrap16(
            _arith_ac(dec, stats, fixed, st, k, kx) << al)
        k += 1


def _arith_ac_refine(dec, stats, fixed, coef, off, ss, se, p1, m1) -> None:
    """decode_mcu_AC_refine (Figure G.10): correction bits of the
    coefficients already nonzero, new ones of magnitude 1."""
    kex = se
    while kex > 0 and not coef[off + _NATURAL[kex]]:
        kex -= 1
    k = ss
    while k <= se:
        st = 3 * (k - 1)
        if k > kex and dec.decode(stats, st):
            break                        # EOB
        while True:
            i = off + _NATURAL[k]
            if coef[i]:
                if dec.decode(stats, st + 2):
                    coef[i] = _wrap16(coef[i] + (m1 if coef[i] < 0 else p1))
                break
            if dec.decode(stats, st + 1):
                coef[i] = m1 if dec.decode(fixed, 0) else p1
                break
            st += 3
            k += 1
            if k > se:
                raise _ArithError
        k += 1


# --- jpeg_idct_islow as libjpeg-turbo's SIMD code computes it (the
# jsimd_idct_islow kernels PIL's build runs), over all blocks at once ---

_CONST_BITS, _PASS1_BITS = 13, 2


def _sat16(v):
    """A value packed into a 16-bit word with signed saturation."""
    return np.clip(v, -0x8000, 0x7FFF)


def _idct_1d(d, shift: int):
    """One pass over 8 arrays d[0..7] of 16-bit words (the inputs along
    the transformed axis): the SIMD kernels' arithmetic, which is
    jidctint.c's folded into 16 x 16 -> 32-bit multiply-adds, with the
    sums d0 + d4, d0 - d4, d7 + d3 and d5 + d1 taken in 16-bit words;
    DESCALEd by `shift`, then saturated to 16 bits."""
    z2, z3 = d[2], d[6]
    tmp3 = z2 * 10703 + z3 * 4433        # F_0_541 + F_0_765, F_0_541
    tmp2 = z2 * 4433 + z3 * -10704       # F_0_541, F_0_541 - F_1_847
    tmp0 = _wrap16(d[0] + d[4]) << _CONST_BITS
    tmp1 = _wrap16(d[0] - d[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z3 = _wrap16(t0 + t2)
    z4 = _wrap16(t1 + t3)
    z3, z4 = (z3 * -6436 + z4 * 9633,    # F_1_175 - F_1_961, F_1_175
              z3 * 9633 + z4 * 6437)     # F_1_175, F_1_175 - F_0_390
    o0 = t0 * -4927 + t3 * -7373 + z3    # F_0_298 - F_0_899, -F_0_899
    o3 = t0 * -7373 + t3 * 4926 + z4     # -F_0_899, F_1_501 - F_0_899
    o1 = t1 * -4176 + t2 * -20995 + z4   # F_2_053 - F_2_562, -F_2_562
    o2 = t1 * -20995 + t2 * 4177 + z3    # -F_2_562, F_3_072 - F_2_562
    rnd = 1 << (shift - 1)
    return [_sat16((x + rnd) >> shift) for x in
            (tmp10 + o3, tmp11 + o2, tmp12 + o1, tmp13 + o0,
             tmp13 - o0, tmp12 - o1, tmp11 - o2, tmp10 - o3)]


def _idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """Quantized coefficients int64 [N, 64] (row-major 8x8) and their
    table -> samples uint8 [N, 64]. The SIMD kernels dequantize in 16-bit
    words (wrapped); a block whose rows 1-7 are all zero takes their
    shortcut, the dequantized first row shifted left by PASS1_BITS in
    16-bit words (wrapped) for every row; pass 1 goes down the columns,
    pass 2 along the rows, and the result is saturated to [-128, 127]
    and centred on 128. For coefficients of a valid JPEG this is
    jidctint.c's jpeg_idct_islow exactly."""
    x = _wrap16(coef * qt).reshape(-1, 8, 8)
    cols = np.stack(_idct_1d([x[:, k, :] for k in range(8)],
                             _CONST_BITS - _PASS1_BITS), axis=1)
    dc_only = ~coef.reshape(-1, 8, 8)[:, 1:, :].any(axis=(1, 2))
    if dc_only.any():
        cols[dc_only] = _wrap16(x[dc_only, :1, :] << _PASS1_BITS)
    out = np.stack(_idct_1d([cols[:, :, k] for k in range(8)],
                            _CONST_BITS + _PASS1_BITS + 3), axis=2)
    return (np.clip(out, -128, 127) + 128).reshape(-1, 64)


# --- jdsample.c ---


def _upsample(plane: np.ndarray, fh: int, fv: int, comp, dec) -> np.ndarray:
    """jinit_upsampler's choice for one component at ratios fh x fv:
    fancy h2v1 / h1v2 / h2v2 (the first two with the downsampled width
    over 2), else replication by integer factors."""
    if (dec.hmax % comp.h) or (dec.vmax % comp.v):
        raise ValueError("JPEG with fractional sampling ratios is not "
                         "decodable")
    x = plane.astype(np.int32)
    if fh == 1 and fv == 1:
        return x
    dw = plane.shape[1]
    if fh == 2 and fv == 1 and dw > 2:
        return _fancy_h2(x, 1, 2)
    if fh == 1 and fv == 2:
        return _fancy_v2(x)
    if fh == 2 and fv == 2 and dw > 2:
        up = _colsums(x)                 # [2 dh, dw]: 3 near + 1 far row
        return _fancy_h2(up, 8, 7) >> 4
    return np.repeat(np.repeat(x, fv, axis=0), fh, axis=1)


def _fancy_h2(x: np.ndarray, b_left: int, b_right: int) -> np.ndarray:
    """Horizontal 2x: out[2i] = 3 x[i] + x[i-1] + b_left, out[2i+1] = 3 x[i]
    + x[i+1] + b_right (edge columns replicated); h2v1 shifts by 2
    (biases 1, 2), h2v2's column sums by 4 (biases 8, 7) after."""
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = 3 * x + left + b_left
    out[:, 1::2] = 3 * x + right + b_right
    return out >> 2 if b_left == 1 else out


def _colsums(x: np.ndarray) -> np.ndarray:
    """Vertical 2x without the shift: row 2y is 3 x[y] + x[y-1], row 2y+1
    is 3 x[y] + x[y+1] (edge rows replicated, as jdmainct.c's context)."""
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
    out[0::2] = 3 * x + up
    out[1::2] = 3 * x + down
    return out


def _fancy_v2(x: np.ndarray) -> np.ndarray:
    """h1v2_fancy_upsample: biases 1 above, 2 below, shifted by 2."""
    cs = _colsums(x)
    cs[0::2] += 1
    cs[1::2] += 2
    return cs >> 2


# --- jdcolor.c ---

_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(v: float) -> int:
    return int(v * (1 << _SCALEBITS) + 0.5)


_X = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _X + _ONE_HALF) >> _SCALEBITS
_CB_B = (_fix(1.77200) * _X + _ONE_HALF) >> _SCALEBITS
_CR_G = -_fix(0.71414) * _X
_CB_G = -_fix(0.34414) * _X + _ONE_HALF


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """ycc_rgb_convert with the tables of build_ycc_rgb_table."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> _SCALEBITS)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _cmyk_to_rgb(planes, ycck: bool) -> np.ndarray:
    """A 4-component JPEG as PIL gives it: libjpeg's CMYK output (YCCK
    first through ycck_cmyk_convert: C, M, Y = 255 - the YCbCr -> RGB of
    the first three, K as it is), read with PIL's inverted "CMYK;I" raw
    mode, then PIL's CMYK -> RGB, (255 - c) * (255 - k) / 255 rounded.
    The two inversions cancel: R = C * K / 255 of libjpeg's C and K."""
    if ycck:
        cmy = 255 - _ycc_to_rgb(*planes[:3]).astype(np.int32)
    else:
        cmy = np.stack(planes[:3], -1).astype(np.int32)
    t = cmy * planes[3].astype(np.int32)[..., None] + 128
    return ((t + (t >> 8)) >> 8).astype(np.uint8)


def decode_jpeg(data: bytes, color: str | None = None) -> np.ndarray:
    """A JPEG's pixels as PIL gives them: uint8 [H, W] for one component
    (PIL's mode "L"), uint8 [H, W, 3] for three ("RGB") and four (CMYK
    or YCCK, converted as PIL converts "CMYK" to "RGB"). color: None for
    libjpeg's own rule of whether 3 components are YCbCr, "ycbcr" or
    "none" (no colour conversion) to force it, as libtiff does for
    JPEG-compressed TIFFs. Raises ValueError, its message naming the
    form, on what it cannot decode."""
    dec = _Decoder(data)
    try:
        dec.parse()
        return dec.pixels(color)
    except ValueError as e:
        if "JPEG" in str(e):
            raise
        raise ValueError(f"JPEG: {e}") from e
    except (IndexError, KeyError, struct.error) as e:
        raise ValueError(f"corrupt JPEG: {e!r}") from e
