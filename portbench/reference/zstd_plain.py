"""A plain Zstandard frame decoder (RFC 8878) and seekable-format seek-table
parser, written for the benchmark's comparison.

It is independent of the program under test: it imports nothing of it and
shares none of its code. Speed matters only because every run pays for it,
so each sequence reads its bits from one small window of the stream.

``decode_frame(buf, pos)`` returns ``(content, end, has_checksum)`` and
raises ``Corrupt`` on any violation it can see: bad magic, reserved bits,
an offset past the window or the output, a bitstream not consumed exactly,
a wrong content size or content checksum.
"""

from __future__ import annotations

import struct

ZSTD_MAGIC = 0xFD2FB528
SKIPPABLE_SEEK_MAGIC = 0x184D2A5E
SEEKABLE_MAGIC = 0x8F92EAB1
BLOCK_MAX = 1 << 17

M64 = (1 << 64) - 1
P1 = 0x9E3779B185EBCA87
P2 = 0xC2B2AE3D27D4EB4F
P3 = 0x165667B19E3779F9
P4 = 0x85EBCA77C2B2AE63
P5 = 0x27D4EB2F165667C5


class Corrupt(ValueError):
    """The bytes are not a valid frame or seek table."""


# ------------------------------------------------------------------ XXH64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (the frame content checksum keeps its low 32 bits)."""
    n = len(data)
    p = 0
    if n >= 32:
        v1 = (seed + P1 + P2) & M64
        v2 = (seed + P2) & M64
        v3 = seed
        v4 = (seed - P1) & M64
        words = struct.unpack_from(f"<{(n // 32) * 4}Q", data, 0)
        for i in range(0, len(words), 4):
            v1 = (v1 + words[i] * P2) & M64
            v1 = (((v1 << 31) | (v1 >> 33)) & M64) * P1 & M64
            v2 = (v2 + words[i + 1] * P2) & M64
            v2 = (((v2 << 31) | (v2 >> 33)) & M64) * P1 & M64
            v3 = (v3 + words[i + 2] * P2) & M64
            v3 = (((v3 << 31) | (v3 >> 33)) & M64) * P1 & M64
            v4 = (v4 + words[i + 3] * P2) & M64
            v4 = (((v4 << 31) | (v4 >> 33)) & M64) * P1 & M64
        h = (((v1 << 1) | (v1 >> 63)) + ((v2 << 7) | (v2 >> 57))
             + ((v3 << 12) | (v3 >> 52)) + ((v4 << 18) | (v4 >> 46))) & M64
        for v in (v1, v2, v3, v4):
            v = (v * P2) & M64
            v = (((v << 31) | (v >> 33)) & M64) * P1 & M64
            h = ((h ^ v) * P1 + P4) & M64
        p = (n // 32) * 32
    else:
        h = (seed + P5) & M64
    h = (h + n) & M64
    while p + 8 <= n:
        k = struct.unpack_from("<Q", data, p)[0]
        k = (k * P2) & M64
        k = (((k << 31) | (k >> 33)) & M64) * P1 & M64
        h ^= k
        h = ((((h << 27) | (h >> 37)) & M64) * P1 + P4) & M64
        p += 8
    if p + 4 <= n:
        h ^= (struct.unpack_from("<I", data, p)[0] * P1) & M64
        h = ((((h << 23) | (h >> 41)) & M64) * P2 + P3) & M64
        p += 4
    while p < n:
        h ^= (data[p] * P5) & M64
        h = ((((h << 11) | (h >> 53)) & M64) * P1) & M64
        p += 1
    h ^= h >> 33
    h = (h * P2) & M64
    h ^= h >> 29
    h = (h * P3) & M64
    h ^= h >> 32
    return h


# ------------------------------------------------------------ bit readers


def _highbit(v: int) -> int:
    return v.bit_length() - 1


class _Backward:
    """Backward bitstream: the last byte holds a sentinel bit; ``pos`` is the
    number of payload bits left, read from the top down. Bits read past the
    start are zeros, and ``pos`` goes negative."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise Corrupt("bitstream without its end mark")
        self.data = data
        self.pos = (len(data) - 1) * 8 + _highbit(data[-1])

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        lo = self.pos
        if lo >= 0:
            b = lo >> 3
            return (int.from_bytes(self.data[b:b + 9], "little") >> (lo & 7)) & ((1 << n) - 1)
        if lo + n <= 0:
            return 0
        return (int.from_bytes(self.data[:8], "little") & ((1 << (lo + n)) - 1)) << -lo


# -------------------------------------------------------------- FSE tables


def read_fse_description(data: bytes, pos: int, max_symbol: int, max_log: int):
    """Normalised counts of an FSE table description (RFC 8878 4.1.1);
    returns (counts, accuracy_log, bytes used)."""
    bits = int.from_bytes(data[pos:pos + 512], "little")
    bp = 0
    log = (bits & 15) + 5
    bp = 4
    if log > max_log:
        raise Corrupt("FSE accuracy log too large")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts = []
    prev0 = False
    while remaining > 1 and len(counts) <= max_symbol:
        if prev0:
            while True:
                r = (bits >> bp) & 3
                bp += 2
                counts.extend([0] * r)
                if r != 3:
                    break
            if len(counts) > max_symbol:
                raise Corrupt("FSE zero run past the last symbol")
        mx = (2 * threshold - 1) - remaining
        low = (bits >> bp) & (threshold - 1)
        if low < mx:
            c = low
            bp += nbits - 1
        else:
            c = (bits >> bp) & (2 * threshold - 1)
            if c >= threshold:
                c -= mx
            bp += nbits
        c -= 1
        remaining -= -c if c < 0 else c
        counts.append(c)
        prev0 = c == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise Corrupt("FSE description does not sum to its table")
    used = (bp + 7) >> 3
    if pos + used > len(data):
        raise Corrupt("FSE description past its section")
    return counts, log, used


def build_fse_table(counts, log: int):
    """Decode table of (symbol, bits, baseline) lists (RFC 8878 4.1.1)."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = [0] * len(counts)
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    p = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            sym[p] = s
            p = (p + step) & mask
            while p > high:
                p = (p + step) & mask
    if p != 0:
        raise Corrupt("FSE spread does not return to zero")
    nb = [0] * size
    base = [0] * size
    for u in range(size):
        s = sym[u]
        ns = nxt[s]
        nxt[s] += 1
        b = log - _highbit(ns)
        nb[u] = b
        base[u] = (ns << b) - size
    return sym, nb, base, log


def _rle_table(symbol: int):
    return [symbol], [0], [0], 0


# ------------------------------------------------------------------ Huffman


def _huffman_table(data: bytes, pos: int):
    """Huffman tree description (RFC 8878 4.2.1); returns (table, bytes used)
    where table = (symbols, bits, max_bits) indexed by the next max_bits."""
    hb = data[pos]
    if hb >= 128:
        nw = hb - 127
        used = 1 + (nw + 1) // 2
        raw = data[pos + 1:pos + used]
        if len(raw) < (nw + 1) // 2:
            raise Corrupt("Huffman weights past the section")
        weights = []
        for i in range(nw):
            b = raw[i >> 1]
            weights.append(b >> 4 if i % 2 == 0 else b & 15)
    else:
        used = 1 + hb
        if pos + used > len(data):
            raise Corrupt("Huffman weights past the section")
        weights = _fse_weights(data[pos + 1:pos + used])
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0 or any(w > 11 for w in weights):
        raise Corrupt("Huffman weights out of range")
    max_bits = _highbit(total) + 1
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise Corrupt("Huffman weights do not complete a tree")
    weights.append(_highbit(rest) + 1)
    if max_bits > 11:
        raise Corrupt("Huffman code longer than 11 bits")
    size = 1 << max_bits
    syms = [0] * size
    bits = [0] * size
    p = 0
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                n = 1 << (w - 1)
                syms[p:p + n] = [s] * n
                bits[p:p + n] = [max_bits + 1 - w] * n
                p += n
    if p != size:
        raise Corrupt("Huffman table does not fill")
    return (syms, bits, max_bits), used


def _fse_weights(data: bytes):
    counts, log, used = read_fse_description(data, 0, 255, 6)
    sym, nb, base, log = build_fse_table(counts, log)
    br = _Backward(data[used:])
    s1 = br.read(log)
    s2 = br.read(log)
    if br.pos < 0:
        raise Corrupt("Huffman weight stream too short")
    out = []
    while True:
        out.append(sym[s1])
        s1 = base[s1] + br.read(nb[s1])
        if br.pos < 0:
            out.append(sym[s2])
            break
        out.append(sym[s2])
        s2 = base[s2] + br.read(nb[s2])
        if br.pos < 0:
            out.append(sym[s1])
            break
        if len(out) > 255:
            raise Corrupt("too many Huffman weights")
    if len(out) > 255:
        raise Corrupt("too many Huffman weights")
    return out


def _huffman_stream(table, data: bytes, n: int, out: bytearray) -> None:
    syms, bits, mb = table
    if not data or data[-1] == 0:
        raise Corrupt("Huffman stream without its end mark")
    pos = (len(data) - 1) * 8 + _highbit(data[-1])
    mask = (1 << mb) - 1
    wbase = 0
    win = 0
    wtop = -1
    for _ in range(n):
        if pos - mb < wbase or pos > wtop:
            if pos >= 64:
                b0 = (pos - 64) >> 3
            else:
                b0 = 0
            win = int.from_bytes(data[b0:b0 + 9], "little")
            wbase = b0 << 3
            wtop = wbase + 72
            if pos - mb < wbase and wbase > 0:
                raise Corrupt("Huffman window")
        sh = pos - mb - wbase
        v = (win >> sh) & mask if sh >= 0 else (win << -sh) & mask
        out.append(syms[v])
        pos -= bits[v]
    if pos != 0:
        raise Corrupt("Huffman stream not consumed exactly")


def _literals(data: bytes, pos: int, end: int, st) -> tuple[bytes, int]:
    b0 = data[pos]
    ltype = b0 & 3
    sf = (b0 >> 2) & 3
    if ltype < 2:
        if sf in (0, 2):
            size, hl = b0 >> 3, 1
        elif sf == 1:
            size, hl = (b0 >> 4) + (data[pos + 1] << 4), 2
        else:
            size, hl = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12), 3
        if ltype == 0:
            if pos + hl + size > end:
                raise Corrupt("raw literals past the block")
            return bytes(data[pos + hl:pos + hl + size]), pos + hl + size
        if pos + hl >= end:
            raise Corrupt("RLE literals past the block")
        return bytes([data[pos + hl]]) * size, pos + hl + 1
    hl, nbits = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[sf]
    v = int.from_bytes(data[pos:pos + hl], "little")
    regen = (v >> 4) & ((1 << nbits) - 1)
    comp = (v >> (4 + nbits)) & ((1 << nbits) - 1)
    p = pos + hl
    if p + comp > end or regen > BLOCK_MAX:
        raise Corrupt("compressed literals past the block")
    stop = p + comp
    if ltype == 2:
        st["huf"], used = _huffman_table(data, p)
        p += used
    elif st["huf"] is None:
        raise Corrupt("repeated Huffman table without a table")
    out = bytearray()
    if sf == 0:
        _huffman_stream(st["huf"], data[p:stop], regen, out)
    else:
        if p + 6 > stop:
            raise Corrupt("jump table past the literals")
        s1, s2, s3 = struct.unpack_from("<3H", data, p)
        p += 6
        s4 = stop - p - s1 - s2 - s3
        if s4 < 1:
            raise Corrupt("Huffman streams past the literals")
        seg = (regen + 3) // 4
        if 3 * seg > regen:
            raise Corrupt("four streams of too few literals")
        for k, sz in enumerate((s1, s2, s3, s4)):
            _huffman_stream(st["huf"], data[p:p + sz], seg if k < 3 else regen - 3 * seg, out)
            p += sz
    return bytes(out), stop


# ---------------------------------------------------------------- sequences

LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512,
                             1024, 2048, 4096, 8192, 16384, 32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259,
                                515, 1027, 2051, 4099, 8195, 16387, 32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3,
               2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
_DEFAULTS = {}


def _default(kind):
    t = _DEFAULTS.get(kind)
    if t is None:
        counts, log = {"ll": LL_DEFAULT, "of": OF_DEFAULT, "ml": ML_DEFAULT}[kind]
        t = _DEFAULTS[kind] = build_fse_table(counts, log)
    return t


def _seq_table(data, p, end, mode, kind, st):
    max_sym, max_log = {"ll": (35, 9), "of": (31, 8), "ml": (52, 9)}[kind]
    if mode == 0:
        t = _default(kind)
    elif mode == 1:
        if p >= end or data[p] > max_sym:
            raise Corrupt("RLE sequence code out of range")
        t = _rle_table(data[p])
        p += 1
    elif mode == 2:
        counts, log, used = read_fse_description(data, p, max_sym, max_log)
        t = build_fse_table(counts, log)
        p += used
    else:
        t = st[kind]
        if t is None:
            raise Corrupt("repeated sequence table without a table")
    st[kind] = t
    return t, p


def _sequences(data: bytes, p: int, end: int, lits: bytes, out: bytearray, st) -> None:
    b0 = data[p]
    if b0 == 0:
        nseq, p = 0, p + 1
    elif b0 < 128:
        nseq, p = b0, p + 1
    elif b0 < 255:
        nseq, p = ((b0 - 128) << 8) + data[p + 1], p + 2
    else:
        nseq, p = data[p + 1] + (data[p + 2] << 8) + 0x7F00, p + 3
    if nseq == 0:
        if p != end:
            raise Corrupt("bytes after an empty sequence section")
        out += lits
        return
    modes = data[p]
    p += 1
    if modes & 3:
        raise Corrupt("reserved sequence mode bits")
    (ll_s, ll_n, ll_b, ll_l), p = _seq_table(data, p, end, modes >> 6, "ll", st)
    (of_s, of_n, of_b, of_l), p = _seq_table(data, p, end, (modes >> 4) & 3, "of", st)
    (ml_s, ml_n, ml_b, ml_l), p = _seq_table(data, p, end, (modes >> 2) & 3, "ml", st)
    if p >= end:
        raise Corrupt("no sequence bitstream")
    bs = data[p:end]
    if bs[-1] == 0:
        raise Corrupt("sequence bitstream without its end mark")
    pos = (len(bs) - 1) * 8 + _highbit(bs[-1])

    def init(n):
        nonlocal pos
        pos -= n
        if pos < 0:
            raise Corrupt("sequence bitstream too short")
        b = pos >> 3
        return (int.from_bytes(bs[b:b + 9], "little") >> (pos & 7)) & ((1 << n) - 1)

    lls = init(ll_l)
    ofs = init(of_l)
    mls = init(ml_l)
    rep = st["rep"]
    r0, r1, r2 = rep
    window = st["window"]
    lp = 0
    nlit = len(lits)
    for i in range(nseq):
        if pos >= 128:
            b = (pos - 128) >> 3
        else:
            b = 0
        win = int.from_bytes(bs[b:b + 17], "little")
        wb = b << 3
        ofc = of_s[ofs]
        llc = ll_s[lls]
        mlc = ml_s[mls]
        if ofc > 31:
            raise Corrupt("offset code out of range")
        pos -= ofc
        if pos < wb:
            raise Corrupt("sequence bitstream overread")
        ofv = (1 << ofc) + ((win >> (pos - wb)) & ((1 << ofc) - 1))
        n = ML_BITS[mlc]
        pos -= n
        ml = ML_BASE[mlc] + ((win >> (pos - wb)) & ((1 << n) - 1))
        n = LL_BITS[llc]
        pos -= n
        ll = LL_BASE[llc] + ((win >> (pos - wb)) & ((1 << n) - 1))
        if pos < wb:
            raise Corrupt("sequence bitstream overread")
        if ofv > 3:
            off = ofv - 3
            r2, r1, r0 = r1, r0, off
        else:
            idx = ofv - 1 + (ll == 0)
            if idx == 0:
                off = r0
            else:
                off = r0 - 1 if idx == 3 else (r1 if idx == 1 else r2)
                if off <= 0:
                    raise Corrupt("repeat offset of zero")
                if idx > 1:
                    r2 = r1
                r1 = r0
                r0 = off
        if i != nseq - 1:
            n = ll_n[lls]
            pos -= n
            lls = ll_b[lls] + ((win >> (pos - wb)) & ((1 << n) - 1))
            n = ml_n[mls]
            pos -= n
            mls = ml_b[mls] + ((win >> (pos - wb)) & ((1 << n) - 1))
            n = of_n[ofs]
            pos -= n
            ofs = of_b[ofs] + ((win >> (pos - wb)) & ((1 << n) - 1))
            if pos < wb:
                raise Corrupt("sequence bitstream overread")
        if lp + ll > nlit:
            raise Corrupt("sequence takes more literals than the block has")
        out += lits[lp:lp + ll]
        lp += ll
        if off > len(out) or off > window:
            raise Corrupt("match offset past the window")
        start = len(out) - off
        if off >= ml:
            out += out[start:start + ml]
        else:
            while ml > 0:
                take = min(off, ml)
                out += out[start:start + take]
                ml -= take
    if pos != 0:
        raise Corrupt("sequence bitstream not consumed exactly")
    st["rep"] = (r0, r1, r2)
    out += lits[lp:]


# -------------------------------------------------------------------- frame


def decode_frame(buf: bytes, pos: int = 0):
    """Decode the zstd frame at ``pos``: returns (content, end, has_checksum)."""
    if len(buf) < pos + 6 or struct.unpack_from("<I", buf, pos)[0] != ZSTD_MAGIC:
        raise Corrupt("not a zstd frame")
    p = pos + 4
    fd = buf[p]
    p += 1
    fcs_flag = fd >> 6
    single = (fd >> 5) & 1
    if fd & 8:
        raise Corrupt("reserved frame header bit")
    has_checksum = bool(fd & 4)
    did_size = (0, 1, 2, 4)[fd & 3]
    window = None
    if not single:
        wd = buf[p]
        p += 1
        wlog = 10 + (wd >> 3)
        window = (1 << wlog) + ((1 << wlog) >> 3) * (wd & 7)
    if did_size:
        if int.from_bytes(buf[p:p + did_size], "little"):
            raise Corrupt("frame needs a dictionary")
        p += did_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    fcs = None
    if fcs_size:
        fcs = int.from_bytes(buf[p:p + fcs_size], "little")
        if fcs_size == 2:
            fcs += 256
        p += fcs_size
    if window is None:
        window = fcs
    st = {"huf": None, "ll": None, "of": None, "ml": None, "rep": (1, 4, 8),
          "window": window}
    out = bytearray()
    block_max = min(window, BLOCK_MAX)
    while True:
        if p + 3 > len(buf):
            raise Corrupt("block header past the end")
        bh = int.from_bytes(buf[p:p + 3], "little")
        p += 3
        last = bh & 1
        btype = (bh >> 1) & 3
        size = bh >> 3
        before = len(out)
        if btype == 0:
            if p + size > len(buf):
                raise Corrupt("raw block past the end")
            out += buf[p:p + size]
            p += size
        elif btype == 1:
            if p >= len(buf):
                raise Corrupt("RLE block past the end")
            out += bytes([buf[p]]) * size
            p += 1
        elif btype == 2:
            end = p + size
            if end > len(buf) or size > block_max:
                raise Corrupt("compressed block past the end or over its size")
            lits, q = _literals(buf, p, end, st)
            _sequences(buf, q, end, lits, out, st)
            p = end
        else:
            raise Corrupt("reserved block type")
        if len(out) - before > block_max:
            raise Corrupt("block content over its size")
        if last:
            break
    if fcs is not None and fcs != len(out):
        raise Corrupt("content size differs from the header")
    if has_checksum:
        if p + 4 > len(buf):
            raise Corrupt("checksum past the end")
        if struct.unpack_from("<I", buf, p)[0] != xxh64(bytes(out)) & 0xFFFFFFFF:
            raise Corrupt("content checksum mismatch")
        p += 4
    return bytes(out), p, has_checksum


# --------------------------------------------------------------- seek table


def parse_seek_table_foot(archive: bytes):
    """The seek table appended to ``archive`` (the Foot layout): returns
    (entries [(compressed, decompressed)], table_start)."""
    if len(archive) < 17:
        raise Corrupt("archive shorter than a seek table")
    n, desc, magic = struct.unpack_from("<IBI", archive, len(archive) - 9)
    if magic != SEEKABLE_MAGIC:
        raise Corrupt("no seekable magic at the end")
    if desc & 0x7C:
        raise Corrupt("reserved seek table descriptor bits")
    per = 12 if desc & 0x80 else 8
    size = n * per + 9
    start = len(archive) - 8 - size
    if start < 0:
        raise Corrupt("seek table larger than the archive")
    smagic, fsize = struct.unpack_from("<II", archive, start)
    if smagic != SKIPPABLE_SEEK_MAGIC or fsize != size:
        raise Corrupt("seek table frame header")
    entries = [struct.unpack_from("<II", archive, start + 8 + i * per) for i in range(n)]
    return entries, start
