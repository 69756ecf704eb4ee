"""JPEG decoding without PIL: libjpeg-turbo's default decompression.

PIL decodes JPEGs through libjpeg-turbo with its defaults, which are
integer arithmetic throughout: the accurate integer IDCT
(`jpeg_idct_islow`, jidctint.c), "fancy" upsampling of subsampled chroma
(`h2v1_fancy_upsample`, `h2v2_fancy_upsample`, `h1v2_fancy_upsample`,
jdsample.c) and the fixed-point YCbCr -> RGB tables of
`build_ycc_rgb_table` (jdcolor.c). This module carries the same rules,
so it gives what PIL gives, value for value: the Huffman decoding loops
in Python (this path only has to be right), the IDCT, upsampling and
colour conversion are vectorised over all blocks in numpy.

Decoded: baseline, extended sequential (8-bit) and progressive
Huffman-coded JPEGs with 1 (gray: uint8 [H, W]) or 3 components
(uint8 [H, W, 3]; YCbCr converted to RGB unless libjpeg's rule of
JFIF / Adobe transform / component ids names the file RGB), any integer
sampling ratios, restart markers. Like PIL's Image.open, no EXIF
orientation and no ICC profile are applied. Raises ValueError, naming
the form, on arithmetic coding, 12-bit, lossless and hierarchical JPEGs,
2- and 4-component (CMYK / YCCK) files, DNL heights, corrupt or
truncated entropy data (where libjpeg would warn and substitute zeros)
and on progressive files whose scans leave some of the first nine AC
coefficients incomplete (libjpeg then smooths the blocks,
`decompress_smooth_data`, which is not ported).
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
_SOF_FORMS = {0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical",
              0xC7: "hierarchical", 0xC9: "arithmetic-coded",
              0xCA: "arithmetic-coded", 0xCB: "arithmetic-coded",
              0xCD: "arithmetic-coded", 0xCE: "arithmetic-coded",
              0xCF: "arithmetic-coded"}


def _wrap16(v: int) -> int:
    """(JCOEF) v: a coefficient is stored as a 16-bit short."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


class _Huffman:
    """A decoding table: lut[16 peeked bits] = length << 8 | symbol, 0 for
    a prefix that is no code (jpeg_make_d_derived_tbl's checks)."""

    def __init__(self, counts, symbols, is_dc: bool):
        if sum(counts) > 256 or len(symbols) != sum(counts):
            raise ValueError("JPEG: bad Huffman table")
        if is_dc and any(s > 15 for s in symbols):
            raise ValueError("JPEG: bad DC Huffman table")
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
        """The next 32 bits."""
        p = self.pos
        return (self.w40[p >> 3] >> (8 - (p & 7))) & 0xFFFFFFFF

    def symbol(self, lut) -> int:
        win = self.window()
        e = lut[win >> 16]
        if not e:
            raise ValueError("corrupt JPEG data: bad Huffman code")
        self.pos += e >> 8
        return e & 0xFF

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        v = self.window() >> (32 - n)
        self.pos += n
        return v

    def check_end(self) -> None:
        if self.pos > self.n_bits:
            raise ValueError("corrupt JPEG data: premature end of data "
                             "segment")


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


class _Decoder:
    def __init__(self, data: bytes):
        self.data = data
        self.qt = {}
        self.dc, self.ac = {}, {}
        self.restart = 0
        self.frame = None
        self.progressive = False
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
            elif m in (0xC0, 0xC1, 0xC2):
                self._sof(m, body)
            elif m in _SOF_FORMS:
                raise ValueError(f"{_SOF_FORMS[m]} JPEG (SOF{m - 0xC0}) is "
                                 "not decodable without PIL")
            elif m == 0xCC:
                raise ValueError("arithmetic-coded JPEG (DAC) is not "
                                 "decodable without PIL")
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
            (self.ac if tc else self.dc)[th] = _Huffman(counts, symbols,
                                                        tc == 0)
            off += 17 + n

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
        if nc == 4:
            raise ValueError("CMYK / YCCK JPEG (4 components) is not "
                             "decodable without PIL")
        if nc not in (1, 3) or len(body) < 6 + 3 * nc:
            raise ValueError(f"JPEG with {nc} components is not decodable "
                             "without PIL")
        for k in range(nc):
            cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
            hs, vs = hv >> 4, hv & 15
            if not (1 <= hs <= 4 and 1 <= vs <= 4) or tq > 3:
                raise ValueError("JPEG: bad sampling factors or table")
            self.comps.append(_Component(cid, hs, vs, tq))
        self.frame = (w, h)
        self.progressive = m == 0xC2
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcux = -(-w // (8 * self.hmax))
        self.mcuy = -(-h // (8 * self.vmax))
        for c in self.comps:
            # the component's own size and blocks (jdinput.c initial_setup)
            c.dw = -(-w * c.h // self.hmax)
            c.dh = -(-h * c.v // self.vmax)
            c.bw, c.bh = -(-c.dw // 8), -(-c.dh // 8)
            c.aw, c.ah = self.mcux * c.h, self.mcuy * c.v    # allocated
            c.coef = [0] * (c.aw * c.ah * 64)

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
            if c.qt is None:
                if c.tq not in self.qt:
                    raise ValueError("JPEG: missing quantization table")
                c.qt = self.qt[c.tq].copy()   # latch_quant_tables
        if ns > 1 and sum(c.h * c.v for c in comps) > 10:
            raise ValueError("JPEG: MCU of more than 10 blocks")
        segs, end = _segments(self.data, pos)
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
        use_dc = not self.progressive or (ss == 0 and ah == 0)
        use_ac = not self.progressive or ss > 0
        for td, ta in tables:
            if (use_dc and td not in self.dc) \
                    or (use_ac and ta not in self.ac):
                raise ValueError("JPEG: scan without its Huffman table")
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
        mcus = self._blocks(comps)
        ri = self.restart or len(mcus)
        n_seg = -(-len(mcus) // ri) if mcus else 0
        if segs and segs[-1][0] == b"" and len(segs) == n_seg + 1:
            segs = segs[:-1]     # a restart marker after the last interval
        if len(segs) != n_seg:
            raise ValueError(f"JPEG: {len(segs)} restart intervals where "
                             f"{n_seg} are due")
        for k, (_, rst) in enumerate(segs[:-1]):
            if rst != k % 8:
                raise ValueError("JPEG: restart markers out of order")
        dcs = [self.dc.get(td) for td, _ in tables]
        acs = [self.ac.get(ta) for _, ta in tables]
        coefs = [c.coef for c in comps]
        for k, (seg, _) in enumerate(segs):
            bits = _Bits(seg)
            state = {"pred": [0] * len(comps), "eobrun": 0}
            for mcu in mcus[k * ri:(k + 1) * ri]:
                for ci, off in mcu:
                    coef = coefs[ci]
                    if not self.progressive:
                        _sequential(bits, coef, off, dcs[ci].lut,
                                    acs[ci].lut, state, ci)
                    elif ss == 0:
                        _dc_progressive(bits, coef, off, dcs[ci], ah, al,
                                        state, ci)
                    elif ah == 0:
                        _ac_first(bits, coef, off, acs[ci].lut, ss, se, al,
                                  state)
                    else:
                        _ac_refine(bits, coef, off, acs[ci].lut, ss, se, al,
                                   state)
            bits.check_end()

    # --- output ---

    def pixels(self) -> np.ndarray:
        w, h = self.frame
        if self.progressive:
            self._check_smoothing()
        planes = []
        for c in self.comps:
            if c.qt is None:
                raise ValueError("JPEG component without any scan")
            coef = np.asarray(c.coef, np.int64).reshape(c.ah, c.aw, 64)
            coef = ((coef[:c.bh, :c.bw] + 0x8000) & 0xFFFF) - 0x8000
            px = _idct_islow(coef.reshape(-1, 64) * c.qt)
            plane = px.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3) \
                .reshape(c.bh * 8, c.bw * 8)[:c.dh, :c.dw]
            planes.append(_upsample(plane, self.hmax // c.h,
                                    self.vmax // c.v, c, self)[:h, :w])
        if len(planes) == 1:
            return planes[0].astype(np.uint8)
        if self._is_rgb():
            return np.stack(planes, -1).astype(np.uint8)
        return _ycc_to_rgb(*planes)

    def _is_rgb(self) -> bool:
        """default_decompress_parms (jdapimin.c) for 3 components."""
        if self.jfif:
            return False
        if self.adobe is not None:
            return self.adobe == 0
        return [c.id for c in self.comps] == [82, 71, 66]   # 'R', 'G', 'B'

    def _check_smoothing(self) -> None:
        """smoothing_ok (jdcoefct.c): libjpeg smooths the blocks when the
        scans leave any of the first nine AC coefficients incomplete."""
        pos = _NATURAL[:_SAVED_COEFS]
        if any(c.qt is None or not all(c.qt[p] for p in pos)
               or c.coef_bits[0] < 0 for c in self.comps):
            return
        if any(b != 0 for c in self.comps
               for b in c.coef_bits[1:_SAVED_COEFS]):
            raise ValueError("progressive JPEG whose scans leave AC "
                             "coefficients incomplete (libjpeg's block "
                             "smoothing) is not decodable without PIL")


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
                if s != 1:
                    raise ValueError("corrupt JPEG data: bad refinement "
                                     "code")
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


# --- jidctint.c, jpeg_idct_islow, over all blocks at once ---

_CONST_BITS, _PASS1_BITS = 13, 2


def _idct_1d(d, shift: int):
    """One pass of jpeg_idct_islow over 8 arrays d[0..7] (the inputs along
    the transformed axis), DESCALEd by `shift`."""
    z1 = (d[2] + d[6]) * 4433                     # FIX_0_541196100
    tmp2 = z1 + d[6] * -15137                     # FIX_1_847759065
    tmp3 = z1 + d[2] * 6270                       # FIX_0_765366865
    tmp0 = (d[0] + d[4]) << _CONST_BITS
    tmp1 = (d[0] - d[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633                         # FIX_1_175875602
    t0 = t0 * 2446                                # FIX_0_298631336
    t1 = t1 * 16819                               # FIX_2_053119869
    t2 = t2 * 25172                               # FIX_3_072711026
    t3 = t3 * 12299                               # FIX_1_501321110
    z1 = z1 * -7373                               # FIX_0_899976223
    z2 = z2 * -20995                              # FIX_2_562915447
    z3 = z3 * -16069 + z5                         # FIX_1_961570560
    z4 = z4 * -3196 + z5                          # FIX_0_390180644
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    rnd = 1 << (shift - 1)
    return [(x + rnd) >> shift for x in
            (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
             tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _idct_islow(deq: np.ndarray) -> np.ndarray:
    """Dequantized coefficients int64 [N, 64] (row-major 8x8) -> samples
    uint8 [N, 64]: pass 1 down the columns into the int workspace, pass 2
    along its rows, then the range-limit table (jdmaster.c
    prepare_range_limit_table) on the low 10 bits."""
    x = deq.reshape(-1, 8, 8)
    ws = np.stack(_idct_1d([x[:, k, :] for k in range(8)],
                           _CONST_BITS - _PASS1_BITS), axis=1)
    ws = ws.astype(np.int32).astype(np.int64)
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)],
                            _CONST_BITS + _PASS1_BITS + 3), axis=2)
    out = ((out + 512) & 1023) - 512 + 128
    return np.clip(out, 0, 255).reshape(-1, 64)


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


def decode_jpeg(data: bytes) -> np.ndarray:
    """A JPEG's pixels as PIL gives them: uint8 [H, W] for one component
    (PIL's mode "L"), uint8 [H, W, 3] for three ("RGB"). Raises
    ValueError, its message naming the form, on what it cannot decode."""
    dec = _Decoder(data)
    try:
        dec.parse()
        return dec.pixels()
    except ValueError as e:
        if "JPEG" in str(e):
            raise
        raise ValueError(f"JPEG: {e}") from e
    except (IndexError, KeyError, struct.error) as e:
        raise ValueError(f"corrupt JPEG: {e!r}") from e
