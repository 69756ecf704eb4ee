"""Zstandard decoding (RFC 8878) without a zstd library, for TIFF
compression 50000: the GPU hosts have no zstd module and Python 3.12 has
none in its standard library.

Read: the frame at the start of a chunk, as libtiff reads it, with or
without the frame content size and the content checksum (XXH64, checked); raw,
RLE and compressed blocks; literals raw, RLE and Huffman-coded (one or
four streams, the table described by FSE-coded or direct weights, or
reused by a treeless block); sequences with predefined, RLE,
FSE-compressed and repeated tables; the three repeat offsets. No
dictionaries: a frame that names one raises ValueError, as does any
corrupt frame (the engine then skips the image and names it). The
decoding loops are Python: this path only has to be right.
"""

from __future__ import annotations

import struct

_MAGIC = 0xFD2FB528
_SKIPPABLE = 0x184D2A50          # ... 0x184D2A5F
_BLOCK_MAX = 1 << 17
_M64 = (1 << 64) - 1

# Literals_Length and Match_Length codes: (baseline, extra bits)
_LL = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10),
    (2048, 11), (4096, 12), (8192, 13), (16384, 14), (32768, 15),
    (65536, 16)]
_ML = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16)]
# the predefined distributions (accuracy log, normalized counts)
_LL_DEFAULT = (6, [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2,
                   2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1])
_ML_DEFAULT = (6, [1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7)
_OF_DEFAULT = (5, [1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5)
# (largest symbol, largest accuracy log) of Literals_Length, Offset,
# Match_Length
_LIMITS = ((35, 9), (31, 8), (52, 9))


def _corrupt(what: str) -> ValueError:
    return ValueError(f"corrupt Zstandard data: {what}")


class _Backward:
    """A bitstream read from its end towards its start, as Zstandard's
    Huffman and FSE streams are: the last byte's highest set bit marks
    the start; past the stream's first byte it reads zeros."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise _corrupt("a bitstream without its end mark")
        rev = data[::-1] + b"\0" * 8
        # w32[i]: reversed bytes i .. i + 3 as one big-endian integer
        self.w32 = [int.from_bytes(rev[i:i + 4], "big")
                    for i in range(len(data) + 4)]
        self.n = 8 * len(data)
        self.pos = 9 - data[-1].bit_length()   # past the end mark

    def peek(self, k: int) -> int:
        """The next k <= 24 bits."""
        p = self.pos
        if p >= self.n:
            return 0
        return (self.w32[p >> 3] >> (32 - k - (p & 7))) & ((1 << k) - 1)

    def read(self, k: int) -> int:
        if k > 24:
            hi = self.read(k - 24)
            return (hi << 24) | self.read(24)
        v = self.peek(k)
        self.pos += k
        return v

    def done(self) -> bool:
        """True when every bit was read, and not one more."""
        return self.pos == self.n


class _Forward:
    """A little-endian bitstream read from its start (FSE table
    descriptions)."""

    def __init__(self, data: bytes, start: int):
        self.data, self.start, self.bit = data, start, 0

    def read(self, k: int) -> int:
        at = self.start + (self.bit >> 3)
        chunk = int.from_bytes(self.data[at:at + 5], "little")
        v = (chunk >> (self.bit & 7)) & ((1 << k) - 1)
        self.bit += k
        return v

    def peek(self, k: int) -> int:
        v = self.read(k)
        self.bit -= k
        return v

    def end(self) -> int:
        """The byte after the description."""
        return self.start + ((self.bit + 7) >> 3)


def _read_counts(data: bytes, at: int, max_symbol: int,
                 max_log: int) -> tuple:
    """An FSE table description (RFC 8878 4.1.1) at data[at:] ->
    (accuracy log, normalized counts, the offset after it)."""
    bits = _Forward(data, at)
    log = bits.read(4) + 5
    if log > max_log:
        raise _corrupt(f"FSE accuracy log {log} above {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    n_bits = log + 1
    counts = []
    while remaining > 1:
        if len(counts) > max_symbol:
            raise _corrupt("FSE table past its largest symbol")
        top = 2 * threshold - 1 - remaining
        low = bits.peek(n_bits - 1) if n_bits > 1 else 0
        if low < top:
            value = low
            bits.bit += n_bits - 1
        else:
            value = bits.read(n_bits)
            if value >= threshold:
                value -= top
        count = value - 1
        remaining -= abs(count)
        counts.append(count)
        if count == 0:
            while True:
                repeat = bits.read(2)
                counts += [0] * repeat
                if repeat < 3:
                    break
        while remaining < threshold:
            n_bits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise _corrupt("FSE table description")
    if bits.end() > len(data):
        raise _corrupt("FSE table description past its block")
    return log, counts, bits.end()


def _fse_table(log: int, counts: list) -> list:
    """The decoding table of (symbol, bits to read, baseline), 2^log
    states (zstd's FSE_buildDTable)."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    for s, c in enumerate(counts):
        if c == -1:
            symbols[high] = s
            high -= 1
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbols[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise _corrupt("FSE table does not fill its states")
    following = [1 if c == -1 else c for c in counts]
    table = []
    for s in symbols:
        nxt = following[s]
        following[s] += 1
        n_bits = log - (nxt.bit_length() - 1)
        table.append((s, n_bits, (nxt << n_bits) - size))
    return table


def _huffman_table(weights: list) -> tuple:
    """Huffman weights of the symbols 0..n-2 (the last one's implied) ->
    (max bits, decoding table over every max-bits prefix of (symbol,
    code length))."""
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise _corrupt("Huffman weights all zero")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise _corrupt("Huffman weights do not complete a tree")
    weights = weights + [rest.bit_length()]
    if max_bits > 11:
        raise _corrupt(f"Huffman codes of {max_bits} bits")
    table = []
    for w in range(1, max_bits + 1):
        for s, sw in enumerate(weights):
            if sw == w:
                table += [(s, max_bits + 1 - w)] * (1 << (w - 1))
    return max_bits, table


def _huffman_description(data: bytes, at: int) -> tuple:
    """The Huffman tree description at data[at:] -> (table, offset after
    it)."""
    head = data[at]
    at += 1
    if head >= 128:                       # direct: 4 bits a weight
        n = head - 127
        raw = data[at:at + (n + 1) // 2]
        if len(raw) < (n + 1) // 2:
            raise _corrupt("Huffman weights past their block")
        weights = [(raw[i // 2] >> (0 if i % 2 else 4)) & 15
                   for i in range(n)]
        return _huffman_table(weights), at + (n + 1) // 2
    if at + head > len(data):
        raise _corrupt("Huffman weights past their block")
    log, counts, start = _read_counts(data[:at + head], at, 255, 6)
    table = _fse_table(log, counts)
    bits = _Backward(data[start:at + head])
    states = [bits.read(log), bits.read(log)]
    weights = []
    # two interleaved states share the table; the stream ends when
    # reading a state's update would go past its start
    while True:
        for k in (0, 1):
            sym, n_bits, base = table[states[k]]
            weights.append(sym)
            if bits.pos + n_bits > bits.n:
                weights.append(table[states[k ^ 1]][0])
                if len(weights) > 255:
                    raise _corrupt("too many Huffman weights")
                return _huffman_table(weights), at + head
            states[k] = base + bits.read(n_bits)
        if len(weights) > 255:
            raise _corrupt("too many Huffman weights")


def _huffman_stream(data: bytes, huffman: tuple, count: int) -> bytes:
    max_bits, table = huffman
    bits = _Backward(data)
    out = bytearray(count)
    w32, mask = bits.w32, (1 << max_bits) - 1
    pos, n = bits.pos, bits.n
    for i in range(count):
        if pos < n:
            sym, length = table[(w32[pos >> 3] >> (32 - max_bits
                                                   - (pos & 7))) & mask]
        else:
            sym, length = table[0]
        out[i] = sym
        pos += length
    bits.pos = pos
    if not bits.done():
        raise _corrupt("Huffman stream length")
    return bytes(out)


class _State:
    """What a frame's blocks carry over: the Huffman table, the three
    sequence tables, the repeat offsets."""

    def __init__(self):
        self.huffman = None
        self.tables = [None, None, None]      # LL, OF, ML
        self.reps = [1, 4, 8]


def _literals(data: bytes, st: _State) -> tuple:
    """The literals section of a compressed block -> (literals, offset of
    the sequences section)."""
    b0 = data[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):                         # raw, RLE
        if fmt in (0, 2):
            size, at = b0 >> 3, 1
        elif fmt == 1:
            size, at = (b0 >> 4) + (data[1] << 4), 2
        else:
            size, at = (b0 >> 4) + (data[1] << 4) + (data[2] << 12), 3
        if kind == 0:
            if at + size > len(data):
                raise _corrupt("raw literals past their block")
            return data[at:at + size], at + size
        if at >= len(data):
            raise _corrupt("RLE literals past their block")
        return data[at:at + 1] * size, at + 1
    n_head = (3, 3, 4, 5)[fmt]
    head = int.from_bytes(data[:n_head], "little")
    width = (10, 10, 14, 18)[fmt]
    size = (head >> 4) & ((1 << width) - 1)
    comp = (head >> (4 + width)) & ((1 << width) - 1)
    end = n_head + comp
    if end > len(data) or size > _BLOCK_MAX:
        raise _corrupt("Huffman literals past their block")
    at = n_head
    if kind == 2:
        st.huffman, at = _huffman_description(data[:end], at)
    elif st.huffman is None:
        raise _corrupt("treeless literals without an earlier table")
    if fmt == 0:
        return _huffman_stream(data[at:end], st.huffman, size), end
    sizes = struct.unpack_from("<3H", data, at)
    at += 6
    seg = (size + 3) // 4
    if 3 * seg > size:
        raise _corrupt("four Huffman streams of too few literals")
    out = []
    for k in range(4):
        n = sizes[k] if k < 3 else end - at
        if n < 0 or at + n > end:
            raise _corrupt("Huffman stream past its block")
        out.append(_huffman_stream(data[at:at + n], st.huffman,
                                   seg if k < 3 else size - 3 * seg))
        at += n
    return b"".join(out), end


def _sequence_tables(data: bytes, at: int, st: _State) -> int:
    modes = data[at]
    if modes & 3:
        raise _corrupt("reserved bits of the symbol compression modes")
    at += 1
    for k, (shift, default) in enumerate(((6, _LL_DEFAULT), (4, _OF_DEFAULT),
                                          (2, _ML_DEFAULT))):
        mode = (modes >> shift) & 3
        max_symbol, max_log = _LIMITS[k]
        if mode == 0:
            st.tables[k] = (default[0], _fse_table(*default))
        elif mode == 1:
            if at >= len(data) or data[at] > max_symbol:
                raise _corrupt("RLE sequence symbol")
            st.tables[k] = (0, [(data[at], 0, 0)])
            at += 1
        elif mode == 2:
            log, counts, at = _read_counts(data, at, max_symbol, max_log)
            st.tables[k] = (log, _fse_table(log, counts))
        elif st.tables[k] is None:
            raise _corrupt("repeated sequence table without an earlier one")
    return at


def _block(data: bytes, st: _State, out: bytearray) -> None:
    """One compressed block, appended to `out` (the frame so far)."""
    lits, at = _literals(data, st)
    if at >= len(data):
        raise _corrupt("a block without its sequences section")
    b0 = data[at]
    if b0 < 128:
        n_seq, at = b0, at + 1
    elif b0 < 255:
        n_seq, at = ((b0 - 128) << 8) + data[at + 1], at + 2
    else:
        n_seq, at = data[at + 1] + (data[at + 2] << 8) + 0x7F00, at + 3
    if n_seq == 0:
        if at != len(data):
            raise _corrupt("bytes after a block's literals")
        out += lits
        return
    at = _sequence_tables(data, at, st)
    (ll_log, ll_t), (of_log, of_t), (ml_log, ml_t) = st.tables
    bits = _Backward(data[at:])
    read = bits.read
    ll_s, of_s, ml_s = read(ll_log), read(of_log), read(ml_log)
    reps = st.reps
    lit = 0
    for i in range(n_seq):
        of_code = of_t[of_s][0]
        ml_code = ml_t[ml_s][0]
        ll_code = ll_t[ll_s][0]
        if of_code > 31 or ml_code > 52 or ll_code > 35:
            raise _corrupt("sequence code out of range")
        value = (1 << of_code) + read(of_code)
        base, n = _ML[ml_code]
        ml = base + read(n)
        base, n = _LL[ll_code]
        ll = base + read(n)
        if value > 3:
            offset = value - 3
            reps = [offset, reps[0], reps[1]]
        else:
            idx = value - 1 + (ll == 0)
            if idx == 0:
                offset = reps[0]
            elif idx == 3:
                offset = reps[0] - 1
                reps = [offset, reps[0], reps[1]]
            else:
                offset = reps[idx]
                reps = [offset] + [r for j, r in enumerate(reps) if j != idx]
        if i + 1 < n_seq:
            _, n, base = ll_t[ll_s]
            ll_s = base + read(n)
            _, n, base = ml_t[ml_s]
            ml_s = base + read(n)
            _, n, base = of_t[of_s]
            of_s = base + read(n)
        if lit + ll > len(lits):
            raise _corrupt("a sequence past the literals")
        out += lits[lit:lit + ll]
        lit += ll
        if offset < 1 or offset > len(out):
            raise _corrupt(f"match offset {offset} outside the frame")
        start = len(out) - offset
        if offset >= ml:
            out += out[start:start + ml]
        else:
            pattern = bytes(out[start:])
            out += (pattern * (ml // offset + 1))[:ml]
    if not bits.done():
        raise _corrupt("sequence bitstream length")
    st.reps = reps
    out += lits[lit:]


def _frame(data: bytes, at: int) -> tuple:
    """One frame at data[at:] (after its magic) -> (content, offset
    after the frame)."""
    desc = data[at]
    at += 1
    fcs_flag, single = desc >> 6, (desc >> 5) & 1
    if desc & 8:
        raise _corrupt("reserved bit of the frame header")
    if not single:
        at += 1                                  # window descriptor
    did_size = (0, 1, 2, 4)[desc & 3]
    if did_size:
        did = int.from_bytes(data[at:at + did_size], "little")
        at += did_size
        if did:
            raise ValueError(f"Zstandard frame with dictionary {did}: "
                             "dictionaries are not supported")
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    size = None
    if fcs_size:
        size = int.from_bytes(data[at:at + fcs_size], "little")
        size += 256 if fcs_size == 2 else 0
        at += fcs_size
    st = _State()
    out = bytearray()
    while True:
        if at + 3 > len(data):
            raise _corrupt("frame ends inside a block header")
        head = int.from_bytes(data[at:at + 3], "little")
        at += 3
        last, kind, n = head & 1, (head >> 1) & 3, head >> 3
        if n > _BLOCK_MAX:
            raise _corrupt(f"block of {n} bytes")
        if kind == 0:
            if at + n > len(data):
                raise _corrupt("raw block past the data")
            out += data[at:at + n]
            at += n
        elif kind == 1:
            if at >= len(data):
                raise _corrupt("RLE block past the data")
            out += data[at:at + 1] * n
            at += 1
        elif kind == 2:
            if at + n > len(data):
                raise _corrupt("compressed block past the data")
            _block(data[at:at + n], st, out)
            at += n
        else:
            raise _corrupt("reserved block type")
        if last:
            break
    if size is not None and size != len(out):
        raise _corrupt(f"frame content size {size}, decoded {len(out)}")
    if desc & 4:
        if at + 4 > len(data):
            raise _corrupt("frame ends inside its checksum")
        (want,) = struct.unpack_from("<I", data, at)
        at += 4
        if xxh64(bytes(out)) & 0xFFFFFFFF != want:
            raise ValueError("Zstandard content checksum mismatch")
    return bytes(out), at


def decompress(data: bytes) -> bytes:
    """The frame at the start of `data`, decoded, as libtiff's decoder
    takes a strip or tile: it stops at the end of the first frame, so
    bytes after it are ignored and a skippable frame gives nothing.
    Raises ValueError on what is not a valid Zstandard frame."""
    try:
        (magic,) = struct.unpack_from("<I", data, 0)
        if magic & 0xFFFFFFF0 == _SKIPPABLE:
            return b""
        if magic != _MAGIC:
            raise _corrupt(f"magic {magic:#x}")
        return _frame(data, 4)[0]
    except (IndexError, struct.error) as e:
        raise _corrupt(f"truncated ({e!r})") from e


_P1 = 11400714785074694791
_P2 = 14029467366897019727
_P3 = 1609587929392839161
_P4 = 9650029242287828579
_P5 = 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data` (the content checksum's hash)."""
    n = len(data)
    at = 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
             (seed - _P1) & _M64]
        stripes = n // 32
        lanes = struct.unpack_from(f"<{4 * stripes}Q", data)
        v1, v2, v3, v4 = v
        for i in range(0, 4 * stripes, 4):
            v1 = _round(v1, lanes[i])
            v2 = _round(v2, lanes[i + 1])
            v3 = _round(v3, lanes[i + 2])
            v4 = _round(v4, lanes[i + 3])
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & _M64
        for x in (v1, v2, v3, v4):
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
        at = 32 * stripes
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while at + 8 <= n:
        (lane,) = struct.unpack_from("<Q", data, at)
        h = (_rotl(h ^ _round(0, lane), 27) * _P1 + _P4) & _M64
        at += 8
    if at + 4 <= n:
        (word,) = struct.unpack_from("<I", data, at)
        h = (_rotl(h ^ (word * _P1 & _M64), 23) * _P2 + _P3) & _M64
        at += 4
    while at < n:
        h = _rotl(h ^ (data[at] * _P5 & _M64), 11) * _P1 & _M64
        at += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)
