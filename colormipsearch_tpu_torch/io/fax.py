"""CCITT fax decoding (TIFF compressions 2, 3 and 4) without PIL: ITU-T
T.4 one- and two-dimensional coding and T.6, as libtiff's tif_fax3.c
reads them for a strip or a tile (compression 2, CCITT RLE, is T.4's
one-dimensional Modified Huffman coding with each row on a byte).

A decoded row is a list of run lengths that alternate white, black,
white, ..., starting white; libtiff turns white runs into 0 bits and
black runs into 1 bits, whatever the photometric interpretation, and so
does rows_to_bits. Group 3 rows each follow an EOL (twelve bits
000000000001, any number of zero fill bits before it); with
Group3Options bit 0 a tag bit after the EOL says whether the row is one-
(1) or two-dimensional (0). Group 4 rows are all two-dimensional, with
no EOLs. The reference line of a chunk's first row is all white. The
decoding loops are Python: this path only has to be right.
"""

from __future__ import annotations

import numpy as np

# (code, run length) of T.4 Tables 2 and 3: the terminating codes 0-63
# in order, then the make-up codes 64, 128, ..., 1728
_WHITE = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100 "
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 "
    "011011011 010011000 010011001 010011010 011000 010011011")
_BLACK = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 "
    "0000101 0000111 00000100 00000111 000011000 0000010111 0000011000 "
    "0000001000 00001100111 00001101000 00001101100 00000110111 "
    "00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 "
    "000001101011 000011010010 000011010011 000011010100 000011010101 "
    "000011010110 000011010111 000001101100 000001101101 000011011010 "
    "000011011011 000001010100 000001010101 000001010110 000001010111 "
    "000001100100 000001100101 000001010010 000001010011 000000100100 "
    "000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 "
    "000001100111 0000001111 000011001000 000011001001 000001011011 "
    "000000110011 000000110100 000000110101 0000001101100 0000001101101 "
    "0000001001010 0000001001011 0000001001100 0000001001101 "
    "0000001110010 0000001110011 0000001110100 0000001110101 "
    "0000001110110 0000001110111 0000001010010 0000001010011 "
    "0000001010100 0000001010101 0000001011010 0000001011011 "
    "0000001100100 0000001100101")
# the make-up codes 1792-2560 both colours share (T.4 Table 3a)
_EXTENDED = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 "
    "000000010100 000000010101 000000010110 000000010111 000000011100 "
    "000000011101 000000011110 000000011111")
# two-dimensional modes (T.4 Table 4): pass, horizontal, vertical -3..3
_MODES = {"0001": "P", "001": "H", "1": 0, "011": 1, "000011": 2,
          "0000011": 3, "010": -1, "000010": -2, "0000010": -3}
_EOL_ZEROS = 11


def _lut(codes: dict, width: int) -> list:
    """{code string: value} -> a list over every `width`-bit prefix of
    (code length, value), or None where no code starts."""
    lut = [None] * (1 << width)
    for code, value in codes.items():
        k = len(code)
        base = int(code, 2) << (width - k)
        for i in range(base, base + (1 << (width - k))):
            if lut[i] is not None:
                raise AssertionError(f"fax code {code} is not prefix-free")
            lut[i] = (k, value)
    return lut


def _run_codes(terms: str) -> dict:
    """{code: run} of one colour: its terminating codes, its make-up
    codes, the shared extended make-up codes."""
    runs = list(range(64)) + [64 * k for k in range(1, 28)]
    codes = dict(zip(terms.split(), runs))
    for k, c in enumerate(_EXTENDED.split()):
        codes[c] = 1792 + 64 * k
    return codes


_RUN_BITS, _MODE_BITS = 13, 7
_RUNS = (_lut(_run_codes(_WHITE), _RUN_BITS),
         _lut(_run_codes(_BLACK), _RUN_BITS))
_MODE_LUT = _lut(_MODES, _MODE_BITS)


class _Bits:
    """MSB-first reader over a chunk; past its end it reads zeros."""

    def __init__(self, data: bytes):
        b = np.frombuffer(data + b"\0" * 4, np.uint8).astype(np.uint32)
        # w32[i]: bytes i .. i + 3 as one big-endian integer
        self.w32 = (b[:-3] << 24 | b[1:-2] << 16 | b[2:-1] << 8
                    | b[3:]).tolist() + [0]
        self.n = 8 * len(data)
        self.pos = 0

    def peek(self, k: int) -> int:
        """The next k <= 25 bits."""
        p = self.pos
        if p >= self.n:
            return 0
        return (self.w32[p >> 3] >> (32 - k - (p & 7))) & ((1 << k) - 1)

    def code(self, lut: list, width: int, what: str):
        hit = lut[self.peek(width)]
        if hit is None:
            raise ValueError(f"TIFF CCITT data: bad {what} code at bit "
                             f"{self.pos}")
        self.pos += hit[0]
        return hit[1]

    def run(self, colour: int) -> int:
        """One run length: make-up codes, then a terminating code."""
        total = 0
        while True:
            r = self.code(_RUNS[colour], _RUN_BITS, "run")
            total += r
            if r < 64:
                return total

    def eol(self) -> bool:
        """Skips fill zeros and one EOL; False at the end of the data."""
        zeros = 0
        while self.pos < self.n:
            if self.peek(1):
                self.pos += 1
                if zeros >= _EOL_ZEROS:
                    return True
                raise ValueError("TIFF CCITT data: a 1 bit where an EOL is "
                                 "due")
            zeros += 1
            self.pos += 1
        return False


def _row_1d(bits: _Bits, width: int) -> list:
    """The changing elements of a one-dimensional (MH) row."""
    changes, a0, colour = [], 0, 0
    while a0 < width:
        a0 += bits.run(colour)
        changes.append(min(a0, width))
        colour ^= 1
    return changes


def _row_2d(bits: _Bits, ref: list, width: int) -> list:
    """The changing elements of a two-dimensional (READ) row against the
    reference row's changing elements `ref` (ending with width, width)."""
    changes = []
    a0, colour = -1, 0
    while a0 < width:
        # b1: the first change on the reference line right of a0 whose
        # colour is the opposite of a0's (the change to colour ^ 1 sits at
        # an even index for colour 0, an odd one for colour 1)
        i = colour
        while i < len(ref) and ref[i] <= a0:
            i += 2
        b1 = ref[i] if i < len(ref) else width
        b2 = ref[i + 1] if i + 1 < len(ref) else width
        mode = bits.code(_MODE_LUT, _MODE_BITS, "mode")
        if mode == "P":
            a0 = b2
        elif mode == "H":
            start = max(a0, 0)
            a1 = start + bits.run(colour)
            a2 = a1 + bits.run(colour ^ 1)
            changes += [min(a1, width), min(a2, width)]
            a0 = a2
        else:
            a1 = b1 + mode
            if a1 < max(a0, 0) or a1 > width:
                raise ValueError("TIFF CCITT data: a vertical code leaves "
                                 "the row")
            changes.append(a1)
            a0 = a1
            colour ^= 1
    return changes


def rows_to_bits(rows: list, width: int) -> np.ndarray:
    """Changing elements per row -> uint8 [rows, width] of 0 (white) and 1
    (black)."""
    out = np.zeros((len(rows), width), np.uint8)
    for y, changes in enumerate(rows):
        for k in range(0, len(changes), 2):
            end = changes[k + 1] if k + 1 < len(changes) else width
            out[y, changes[k]:end] = 1
    return out


def decode(data: bytes, width: int, height: int, group: int,
           options: int = 0) -> np.ndarray:
    """One CCITT-coded strip or tile -> uint8 [height, width] bits (1 =
    black). group 2 (TIFF compression 2, CCITT RLE: Modified Huffman,
    every row one-dimensional and starting on a byte, no EOLs), 3 (T.4,
    options = Group3Options: bit 0 two-dimensional) or 4 (T.6, options =
    Group4Options)."""
    if options & 2:
        raise ValueError("TIFF CCITT data in uncompressed mode is not "
                         "decodable without PIL")
    bits = _Bits(data)
    ref = [width, width]
    rows = []
    for _ in range(height):
        if group == 2:
            changes = _row_1d(bits, width)
            bits.pos = (bits.pos + 7) & ~7
        elif group == 3:
            if not bits.eol():
                break
            two_d = options & 1 and not (bits.peek(1))
            if options & 1:
                bits.pos += 1
            changes = (_row_2d(bits, ref, width) if two_d
                       else _row_1d(bits, width))
        else:
            changes = _row_2d(bits, ref, width)
        rows.append(changes)
        ref = changes + [width, width]
    if len(rows) < height:
        raise ValueError("TIFF CCITT data ends before its last row")
    return rows_to_bits(rows, width)
