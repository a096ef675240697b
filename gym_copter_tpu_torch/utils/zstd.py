"""Zstandard (RFC 8878) in Python: a full decoder and a raw-block encoder.

The JAX package's orbax checkpoints compress every chunk and every OCDBT
node with zstd, through tensorstore.  The port reads them without either
library, so it carries the format here:

* `decompress` decodes any sequence of zstd and skippable frames without
  a dictionary: frames with or without `Frame_Content_Size` (tensorstore
  writes none), raw, RLE and compressed blocks; raw, RLE and Huffman
  literals (direct or FSE-compressed weights, 1 or 4 streams, "treeless"
  reuse of the previous table); the three sequence tables in predefined,
  RLE, FSE-compressed and repeat modes; repeat offsets; overlapping
  matches; and the `Content_Checksum` (`xxh64`).  Table state and repeat
  offsets carry across the blocks of a frame and start anew with each
  frame.  Every decoding step is a lookup in a table built per block.
* `compress` writes one frame of raw blocks (at most 128 KiB each) with
  its content size: valid zstd that any decoder reads, stored uncompressed.

Malformed input raises `ZstdError`.
"""

from __future__ import annotations

import struct

MAGIC = 0xFD2FB528
MAX_BLOCK = 1 << 17

# Literals_Length and Match_Length codes: baseline and extra bits (RFC
# 8878 §3.1.1.3.2.1.1)
LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                             256, 512, 1024, 2048, 4096, 8192, 16384,
                             32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                      13, 14, 15, 16]
ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                131, 259, 515, 1027, 2051, 4099, 8195,
                                16387, 32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                      13, 14, 15, 16]

# predefined distributions (§3.1.1.3.2.2): (accuracy log, counts)
LL_DEFAULT = (6, [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
                  2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1])
ML_DEFAULT = (6, [1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7)
OF_DEFAULT = (5, [1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5)

# (largest symbol, largest accuracy log) per table: LL, OF, ML
_LIMITS = ((35, 9), (31, 8), (52, 9))


class ZstdError(ValueError):
    """The input is not valid zstd (or uses a dictionary)."""


# ---------------------------------------------------------------- xxHash64

_P1 = 11400714785074694791
_P2 = 14029467366897019727
_P3 = 1609587929392839161
_P4 = 9650029242287828579
_P5 = 2870177450012600261
_M64 = (1 << 64) - 1


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (((acc << 31) | (acc >> 33)) & _M64) * _P1 & _M64


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of `data` (the checksum zstd frames carry the low 32 bits of)."""
    data = bytes(data)
    n = len(data)
    p = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed & _M64
        v4 = (seed - _P1) & _M64
        lanes = struct.unpack_from(f'<{n // 8 - n // 8 % 4}Q', data)
        for i in range(0, len(lanes), 4):
            v1 = _round(v1, lanes[i])
            v2 = _round(v2, lanes[i + 1])
            v3 = _round(v3, lanes[i + 2])
            v4 = _round(v4, lanes[i + 3])
        p = n - n % 32
        h = (((v1 << 1) | (v1 >> 63)) + ((v2 << 7) | (v2 >> 57))
             + ((v3 << 12) | (v3 >> 52)) + ((v4 << 18) | (v4 >> 46))) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(data[p:p + 8], 'little'))
        h = ((((h << 27) | (h >> 37)) & _M64) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= int.from_bytes(data[p:p + 4], 'little') * _P1 & _M64
        h = ((((h << 23) | (h >> 41)) & _M64) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= data[p] * _P5 & _M64
        h = (((h << 11) | (h >> 53)) & _M64) * _P1 & _M64
        p += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)


# ---------------------------------------------------------------- bit readers

class _BackwardBits:
    """Reader of a zstd backward bitstream `buf[start:end]`: its last byte's
    highest set bit marks the end, and bits are read from there towards
    the first byte.  Reading past the first byte yields zeros and is
    counted in `overread`."""

    __slots__ = ('buf', 'start', 'ptr', 'acc', 'n', 'overread')

    def __init__(self, buf, start: int, end: int):
        if end <= start or buf[end - 1] == 0:
            raise ZstdError('bitstream without its end mark')
        last = buf[end - 1]
        self.buf, self.start, self.ptr = buf, start, end - 1
        self.n = last.bit_length() - 1
        self.acc = last & ((1 << self.n) - 1)
        self.overread = 0

    def read(self, k: int) -> int:
        if self.n < k:
            take = min(self.ptr - self.start, 8)
            if take:
                self.acc = (self.acc << (8 * take)) | int.from_bytes(
                    self.buf[self.ptr - take:self.ptr], 'little')
                self.ptr -= take
                self.n += 8 * take
            if self.n < k:
                self.overread += k - self.n
                self.acc <<= k - self.n
                self.n = k
        self.n -= k
        v = self.acc >> self.n
        self.acc &= (1 << self.n) - 1
        return v

    def finished(self) -> bool:
        """Every bit read, none past the start."""
        return self.n == 0 and self.ptr == self.start and not self.overread


def _read_fse_table(buf, p: int, end: int, max_symbol: int, max_log: int):
    """The FSE table description at buf[p:] (§4.1.1): (decode table,
    bytes read)."""
    window = int.from_bytes(buf[p:min(end, p + 512)], 'little')
    avail = 8 * (min(end, p + 512) - p)
    pos = 4
    log = (window & 15) + 5
    if log > max_log:
        raise ZstdError(f'accuracy log {log} > {max_log}')
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts = []
    previous0 = False
    while remaining > 1 and len(counts) <= max_symbol:
        if previous0:
            while True:  # 2-bit repeat fields: 3 means 3 and another field
                rep = (window >> pos) & 3
                pos += 2
                counts += [0] * rep
                if rep != 3:
                    break
            if len(counts) > max_symbol:
                raise ZstdError('FSE table: too many symbols')
        bits = window >> pos
        big = (2 * threshold - 1) - remaining
        if bits & (threshold - 1) < big:
            count = bits & (threshold - 1)
            pos += nbits - 1
        else:
            count = bits & (2 * threshold - 1)
            if count >= threshold:
                count -= big
            pos += nbits
        count -= 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        previous0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or pos > avail:
        raise ZstdError('corrupt FSE table description')
    return _fse_decode_table(log, counts), (pos + 7) // 8


def _fse_decode_table(log: int, counts):
    """(log, symbol[], nbits[], base[]) of an FSE table (§4.1.1): state s
    decodes symbol[s], then reads nbits[s] bits b and goes to base[s] + b."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    nxt = list(counts)
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            nxt[s] = 1
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(c if c > 0 else 0):
            symbol[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise ZstdError('FSE counts do not fill the table')
    nbits = [0] * size
    base = [0] * size
    for u in range(size):
        x = nxt[symbol[u]]
        nxt[symbol[u]] = x + 1
        nbits[u] = log - (x.bit_length() - 1)
        base[u] = (x << nbits[u]) - size
    return log, symbol, nbits, base


_PREDEFINED = [_fse_decode_table(*d) for d in (LL_DEFAULT, OF_DEFAULT,
                                                ML_DEFAULT)]


# ---------------------------------------------------------------- Huffman

def _huffman_table(weights):
    """(max bits, symbol[], length[]) of the prefix code with `weights`,
    the last weight implied (§4.2.1): index = the next max-bits bits."""
    total = sum(1 << (w - 1) for w in weights if w)
    if not total:
        raise ZstdError('Huffman weights all zero')
    maxbits = total.bit_length()
    if maxbits > 11:
        raise ZstdError(f'Huffman code of {maxbits} bits > 11')
    rest = (1 << maxbits) - total
    if rest & (rest - 1):
        raise ZstdError('Huffman weights do not complete a power of 2')
    weights = list(weights) + [rest.bit_length()]
    if len(weights) > 256:
        raise ZstdError('more than 256 Huffman symbols')
    sym, length = [], []
    for w in range(1, maxbits + 1):
        span = 1 << (w - 1)
        for s, ws in enumerate(weights):
            if ws == w:
                sym += [s] * span
                length += [maxbits + 1 - w] * span
    return maxbits, sym, length


def _read_huffman_tree(buf, p: int, end: int):
    """The Huffman tree description at buf[p:] (§4.2.1): (table, bytes
    read)."""
    header = buf[p]
    if header >= 128:  # direct: 4-bit weights, two per byte
        n = header - 127
        size = (n + 1) // 2
        if p + 1 + size > end:
            raise ZstdError('truncated Huffman weights')
        weights = []
        for b in buf[p + 1:p + 1 + size]:
            weights += [b >> 4, b & 15]
        return _huffman_table(weights[:n]), 1 + size
    if p + 1 + header > end or header == 0:
        raise ZstdError('truncated Huffman weights')
    (log, symbol, nbits, base), used = _read_fse_table(buf, p + 1,
                                                       p + 1 + header, 255, 6)
    bits = _BackwardBits(buf, p + 1 + used, p + 1 + header)
    s1, s2 = bits.read(log), bits.read(log)
    weights = []
    while len(weights) < 255:  # two interleaved states until overread
        weights.append(symbol[s1])
        s1 = base[s1] + bits.read(nbits[s1])
        if bits.overread:
            weights.append(symbol[s2])
            break
        weights.append(symbol[s2])
        s2 = base[s2] + bits.read(nbits[s2])
        if bits.overread:
            weights.append(symbol[s1])
            break
    else:
        raise ZstdError('too many Huffman weights')
    if any(w > 11 for w in weights):
        raise ZstdError('Huffman weight > 11')
    return _huffman_table(weights), 1 + header


def _huffman_stream(buf, start: int, end: int, count: int, table,
                    out: bytearray) -> None:
    """Append `count` symbols of the Huffman stream buf[start:end]."""
    maxbits, sym, length = table
    if end <= start or buf[end - 1] == 0:
        raise ZstdError('Huffman stream without its end mark')
    last = buf[end - 1]
    nb = last.bit_length() - 1
    acc = last & ((1 << nb) - 1)
    ptr = end - 1
    decoded = bytearray(count)
    for i in range(count):
        if nb < maxbits:
            take = min(ptr - start, 7)
            if take:
                acc = ((acc & ((1 << nb) - 1)) << (8 * take)) | int.from_bytes(
                    buf[ptr - take:ptr], 'little')
                ptr -= take
                nb += 8 * take
            if nb < maxbits:
                idx = (acc << (maxbits - nb)) & ((1 << maxbits) - 1)
                decoded[i] = sym[idx]
                nb -= length[idx]
                if nb < 0:
                    raise ZstdError('Huffman stream overread')
                continue
        idx = (acc >> (nb - maxbits)) & ((1 << maxbits) - 1)
        decoded[i] = sym[idx]
        nb -= length[idx]
    if nb != 0 or ptr != start:
        raise ZstdError('Huffman stream not consumed exactly')
    out += decoded


# ---------------------------------------------------------------- blocks

class _FrameState:
    """What carries from one block of a frame to the next."""

    def __init__(self):
        self.huffman = None
        self.tables = [None, None, None]  # LL, OF, ML
        self.rep = [1, 4, 8]


def _literals(buf, p: int, end: int, st: _FrameState):
    """(literals, position after the literals section)."""
    b0 = buf[p]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:  # raw or RLE
        if fmt in (0, 2):
            size, p = b0 >> 3, p + 1
        elif fmt == 1:
            size, p = (b0 >> 4) + (buf[p + 1] << 4), p + 2
        else:
            size = (b0 >> 4) + (buf[p + 1] << 4) + (buf[p + 2] << 12)
            p += 3
        if kind == 0:
            if p + size > end:
                raise ZstdError('truncated raw literals')
            return bytearray(buf[p:p + size]), p + size
        if p >= end:
            raise ZstdError('truncated RLE literals')
        return bytearray(buf[p:p + 1]) * size, p + 1
    hsize, width = ((3, 10), (3, 10), (4, 14), (5, 18))[fmt]
    h = int.from_bytes(buf[p:p + hsize], 'little')
    size = (h >> 4) & ((1 << width) - 1)
    csize = (h >> (4 + width)) & ((1 << width) - 1)
    p += hsize
    stop = p + csize
    if stop > end:
        raise ZstdError('truncated Huffman literals')
    if kind == 2:
        st.huffman, used = _read_huffman_tree(buf, p, stop)
        p += used
    elif st.huffman is None:
        raise ZstdError('treeless literals without an earlier table')
    out = bytearray()
    if fmt == 0:
        _huffman_stream(buf, p, stop, size, st.huffman, out)
    else:
        if p + 6 > stop:
            raise ZstdError('truncated jump table')
        s1, s2, s3 = (int.from_bytes(buf[p + i:p + i + 2], 'little')
                      for i in (0, 2, 4))
        edges = [p + 6, p + 6 + s1, p + 6 + s1 + s2, p + 6 + s1 + s2 + s3,
                 stop]
        if edges[3] > stop:
            raise ZstdError('jump table past the literals')
        each = (size + 3) // 4
        counts = [each, each, each, size - 3 * each]
        if counts[3] < 0:
            raise ZstdError('literals too few for 4 streams')
        for i in range(4):
            _huffman_stream(buf, edges[i], edges[i + 1], counts[i],
                            st.huffman, out)
    return out, stop


def _block(buf, p: int, end: int, st: _FrameState, out: bytearray,
           frame_start: int) -> None:
    """Decode the compressed block buf[p:end] onto `out`."""
    lits, p = _literals(buf, p, end, st)
    if p >= end:
        raise ZstdError('block without a sequences section')
    b0 = buf[p]
    if b0 < 128:
        nseq, p = b0, p + 1
    elif b0 < 255:
        nseq, p = ((b0 - 128) << 8) + buf[p + 1], p + 2
    else:
        nseq, p = buf[p + 1] + (buf[p + 2] << 8) + 0x7F00, p + 3
    if nseq == 0:
        if p != end:
            raise ZstdError('bytes after an empty sequences section')
        out += lits
        return
    modes = buf[p]
    p += 1
    if modes & 3:
        raise ZstdError('reserved bits of the compression modes set')
    for i, shift in enumerate((6, 4, 2)):  # LL, OF, ML
        mode = (modes >> shift) & 3
        max_symbol, max_log = _LIMITS[i]
        if mode == 0:
            st.tables[i] = _PREDEFINED[i]
        elif mode == 1:
            if buf[p] > max_symbol:
                raise ZstdError('RLE symbol out of range')
            st.tables[i] = (0, [buf[p]], [0], [0])
            p += 1
        elif mode == 2:
            st.tables[i], used = _read_fse_table(buf, p, end, max_symbol,
                                                 max_log)
            p += used
        elif st.tables[i] is None:
            raise ZstdError('repeat mode without an earlier table')
    (ll_log, ll_sym, ll_nb, ll_base), (of_log, of_sym, of_nb, of_base), \
        (ml_log, ml_sym, ml_nb, ml_base) = st.tables
    bits = _BackwardBits(buf, p, end)
    read = bits.read
    ll_s, of_s, ml_s = read(ll_log), read(of_log), read(ml_log)
    rep = st.rep
    lit = 0
    for i in range(nseq):
        of_code, ml_code, ll_code = of_sym[of_s], ml_sym[ml_s], ll_sym[ll_s]
        if of_code > 31:
            raise ZstdError('offset code > 31')
        ofv = (1 << of_code) + read(of_code)
        ml = ML_BASE[ml_code] + read(ML_BITS[ml_code])
        ll = LL_BASE[ll_code] + read(LL_BITS[ll_code])
        if ofv > 3:
            offset = ofv - 3
            rep[2], rep[1], rep[0] = rep[1], rep[0], offset
        else:
            idx = ofv - 1 + (ll == 0)
            if idx == 0:
                offset = rep[0]
            else:
                offset = rep[idx] if idx < 3 else rep[0] - 1
                if idx != 1:
                    rep[2] = rep[1]
                rep[1], rep[0] = rep[0], offset
        if i != nseq - 1:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
        if lit + ll > len(lits):
            raise ZstdError('sequence past the literals')
        out += lits[lit:lit + ll]
        lit += ll
        src = len(out) - offset
        if offset <= 0 or src < frame_start:
            raise ZstdError('match offset before the frame')
        if offset >= ml:
            out += out[src:src + ml]
        else:  # overlapping: the last `offset` bytes repeat
            out += (out[src:] * (ml // offset + 1))[:ml]
    if not bits.finished():
        raise ZstdError('sequences bitstream not consumed exactly')
    out += lits[lit:]


def _frame(buf, p: int, out: bytearray) -> int:
    """Decode the zstd frame whose header starts at buf[p] (after the
    magic) onto `out`; the position after the frame."""
    n = len(buf)
    if p >= n:
        raise ZstdError('truncated frame header')
    fhd = buf[p]
    p += 1
    fcs_flag, single, checksum, did_flag = (fhd >> 6, (fhd >> 5) & 1,
                                           (fhd >> 2) & 1, fhd & 3)
    if fhd & 8:
        raise ZstdError('reserved bit of the frame header set')
    if not single:
        p += 1  # window descriptor: the whole frame is kept in memory
    did_size = (0, 1, 2, 4)[did_flag]
    if did_size and int.from_bytes(buf[p:p + did_size], 'little'):
        raise ZstdError('frames that need a dictionary are not supported')
    p += did_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content_size = None
    if fcs_size:
        content_size = int.from_bytes(buf[p:p + fcs_size], 'little')
        content_size += 256 if fcs_size == 2 else 0
    p += fcs_size
    st = _FrameState()
    start = len(out)
    while True:
        if p + 3 > n:
            raise ZstdError('truncated block header')
        h = buf[p] | (buf[p + 1] << 8) | (buf[p + 2] << 16)
        p += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 1:  # RLE: one byte, `size` times
            if p >= n:
                raise ZstdError('truncated RLE block')
            out += buf[p:p + 1] * size
            p += 1
        else:
            if size > MAX_BLOCK or p + size > n:
                raise ZstdError('block larger than 128 KiB or truncated')
            if kind == 0:
                out += buf[p:p + size]
            elif kind == 2:
                _block(buf, p, p + size, st, out, start)
            else:
                raise ZstdError('reserved block type')
            p += size
        if last:
            break
    if content_size is not None and len(out) - start != content_size:
        raise ZstdError(f'frame holds {len(out) - start} bytes, its header '
                        f'says {content_size}')
    if checksum:
        if p + 4 > n:
            raise ZstdError('truncated content checksum')
        want = int.from_bytes(buf[p:p + 4], 'little')
        if xxh64(out[start:]) & 0xFFFFFFFF != want:
            raise ZstdError('content checksum mismatch')
        p += 4
    return p


def decompress(data) -> bytes:
    """The content of the zstd frames in `data`, concatenated; skippable
    frames are skipped."""
    buf = bytes(data)
    out = bytearray()
    p = 0
    if not buf:
        raise ZstdError('no frame')
    while p < len(buf):
        if p + 4 > len(buf):
            raise ZstdError('truncated magic number')
        magic = int.from_bytes(buf[p:p + 4], 'little')
        if magic == MAGIC:
            p = _frame(buf, p + 4, out)
        elif magic & 0xFFFFFFF0 == 0x184D2A50:
            if p + 8 > len(buf):
                raise ZstdError('truncated skippable frame')
            p += 8 + int.from_bytes(buf[p + 4:p + 8], 'little')
            if p > len(buf):
                raise ZstdError('truncated skippable frame')
        else:
            raise ZstdError(f'not a zstd frame (magic {magic:#010x})')
    return bytes(out)


def compress(data) -> bytes:
    """One zstd frame holding `data` in raw blocks, with its content size
    and no checksum."""
    data = bytes(data)
    n = len(data)
    if n < 256:
        fcs_flag, fcs = 0, n.to_bytes(1, 'little')
    elif n < 65536 + 256:
        fcs_flag, fcs = 1, (n - 256).to_bytes(2, 'little')
    elif n < 1 << 32:
        fcs_flag, fcs = 2, n.to_bytes(4, 'little')
    else:
        fcs_flag, fcs = 3, n.to_bytes(8, 'little')
    parts = [MAGIC.to_bytes(4, 'little'), bytes([fcs_flag << 6 | 0x20]), fcs]
    p = 0
    while True:
        size = min(MAX_BLOCK, n - p)
        last = p + size == n
        parts += [(size << 3 | last).to_bytes(3, 'little'), data[p:p + size]]
        p += size
        if last:
            return b''.join(parts)
