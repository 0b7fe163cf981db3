"""rANS 4x8 block codec (CRAM 3.0) — bitstream-compatible with
``rANS_static.c`` of the htscodecs C reference.

Frame: 1-byte order (0/1), u32-LE compressed size (excluding the 9-byte
header), u32-LE uncompressed size, then an interleaved frequency table
([sym][run?][freq 1-2B]... 0-terminated; nested per-context for order 1)
followed by the rANS payload (L = 1<<23, byte renormalisation).
"""

from __future__ import annotations

import numpy as np

from ..ops import freq as fq
from ..ops import rans8_core as core8

TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT


def _as_u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return data.astype(np.uint8, copy=False)
    return np.frombuffer(bytes(data), dtype=np.uint8)


def _normalise_o0(F: list[int], in_size: int) -> None:
    """O0 normalisation to TOTFREQ with the *0.98 retry
    (``rANS_static.c:106-133``).  Operates on raw counts in-place."""
    tr = ((TOTFREQ << 31) // in_size) + ((1 << 30) // in_size)
    while True:
        fsum = 0
        m = 0
        M = 0
        for j in range(256):
            if not F[j]:
                continue
            if m < F[j]:
                m, M = F[j], j
            F[j] = (F[j] * tr) >> 31
            if F[j] == 0:
                F[j] = 1
            fsum += F[j]
        fsum += 1
        if fsum < TOTFREQ:
            F[M] += TOTFREQ - fsum
        elif fsum - TOTFREQ > F[M] // 2:
            tr = 2104533975  # ~0.98 in 1.31 fixed point
            continue
        else:
            F[M] -= fsum - TOTFREQ
        break


def _normalise_o1_row(F: list[int], T: int) -> None:
    """O1 per-row normalisation via double multiply
    (``rANS_static.c:461-492``); float op order is replicated since the
    result is stored in the stream."""
    p = float(TOTFREQ) / T
    while True:
        t2 = 0
        m = 0
        M = 0
        for j in range(256):
            if not F[j]:
                continue
            if m < F[j]:
                m, M = F[j], j
            F[j] = int(F[j] * p)
            if F[j] == 0:
                F[j] = 1
            t2 += F[j]
        t2 += 1
        if t2 < TOTFREQ:
            F[M] += TOTFREQ - t2
        elif t2 - TOTFREQ >= F[M] // 2:
            p = 0.98
            continue
        else:
            F[M] -= t2 - TOTFREQ
        break


def _put_freq(out: bytearray, f: int) -> None:
    if f < 128:
        out.append(f)
    else:
        out.append(128 | (f >> 8))
        out.append(f & 0xFF)


class _TableWriter:
    """Interleaved [sym][run?][payload-per-sym] serialiser shared by the
    O0 table and each O1 row (``rANS_static.c:138-165,494-543``)."""

    def __init__(self, out: bytearray):
        self.out = out
        self.rle = 0

    def put_sym(self, j: int, present) -> None:
        if self.rle:
            self.rle -= 1
        else:
            self.out.append(j)
            if j and present[j - 1]:
                run = j + 1
                while run < 256 and present[run]:
                    run += 1
                self.rle = run - (j + 1)
                self.out.append(self.rle)


def build_tables_o0(data: np.ndarray):
    """Order-0 table build: (serialised table, freq (256,) u32,
    start (256,) u32)."""
    in_size = len(data)
    if in_size == 0:
        raise ValueError("rans4x8 cannot encode an empty block")
    F = [int(v) for v in fq.hist8(data)]
    _normalise_o0(F, in_size)

    tab = bytearray()
    w = _TableWriter(tab)
    start = np.zeros(256, dtype=np.uint32)
    x = 0
    for j in range(256):
        if F[j]:
            w.put_sym(j, F)
            _put_freq(tab, F[j])
            start[j] = x
            x += F[j]
    tab.append(0)
    return bytes(tab), np.asarray(F, dtype=np.uint32), start


def _compress_o0(data: np.ndarray) -> bytes:
    in_size = len(data)
    tab, F, start = build_tables_o0(data)
    payload = core8.enc_o0(data, start, F, TF_SHIFT)
    comp_sz = len(tab) + len(payload)
    head = bytearray([0])
    head += comp_sz.to_bytes(4, "little")
    head += in_size.to_bytes(4, "little")
    return bytes(head) + bytes(tab) + payload


def build_tables_o1(data: np.ndarray):
    """Order-1 table build: (serialised table, freq2d, start2d)."""
    in_size = len(data)
    Fnp, Tnp = fq.hist1_4(data)
    F = Fnp.astype(np.int64)
    T = [int(v) for v in Tnp]
    q = in_size >> 2
    for k in (1, 2, 3):
        F[0][data[k * q]] += 1  # quarter-leading bytes are coded in context 0
    T[0] += 3

    tab = bytearray()
    wi = _TableWriter(tab)
    start2d = np.zeros((256, 256), dtype=np.uint32)
    freq2d = np.zeros((256, 256), dtype=np.uint32)
    for i in range(256):
        if T[i] == 0:
            continue
        Fi = [int(v) for v in F[i]]
        _normalise_o1_row(Fi, T[i])

        wi.put_sym(i, T)
        wj = _TableWriter(tab)
        x = 0
        for j in range(256):
            if Fi[j]:
                wj.put_sym(j, Fi)
                _put_freq(tab, Fi[j])
                start2d[i, j] = x
                freq2d[i, j] = Fi[j]
                x += Fi[j]
        tab.append(0)
    tab.append(0)
    return bytes(tab), freq2d, start2d


def _compress_o1(data: np.ndarray) -> bytes:
    in_size = len(data)
    if in_size < 4:
        return _compress_o0(data)
    tab, freq2d, start2d = build_tables_o1(data)
    payload = core8.enc_o1(data, start2d, freq2d, TF_SHIFT)
    comp_sz = len(tab) + len(payload)
    head = bytearray([1])
    head += comp_sz.to_bytes(4, "little")
    head += in_size.to_bytes(4, "little")
    return bytes(head) + bytes(tab) + payload


def _get_freq(buf, pos: int) -> tuple[int, int]:
    f = buf[pos]
    pos += 1
    if f >= 128:
        f = ((f & 127) << 8) | buf[pos]
        pos += 1
    return f, pos


def parse_tables_o0(buf):
    """Parse the order-0 table block.  Returns (payload pos, slot LUTs
    ssym/sfreq/sbase, per-symbol f1d/b1d) or None."""
    in_size = len(buf)
    pos = 9
    end = in_size
    ssym = np.zeros(TOTFREQ, dtype=np.uint8)
    sfreq = np.zeros(TOTFREQ, dtype=np.uint32)
    sbase = np.zeros(TOTFREQ, dtype=np.uint32)
    f1d = np.zeros(256, dtype=np.uint32)
    b1d = np.zeros(256, dtype=np.uint32)
    rle = 0
    x = 0
    j = buf[pos]
    pos += 1
    while True:
        if pos > end - 16:
            return None
        f, pos = _get_freq(buf, pos)
        if x + f > TOTFREQ:
            return None
        ssym[x:x + f] = j
        sfreq[x:x + f] = f
        sbase[x:x + f] = np.arange(f, dtype=np.uint32)
        f1d[j] = f
        b1d[j] = x
        x += f
        if not rle and pos < end and j + 1 == buf[pos]:
            j = buf[pos]
            rle = buf[pos + 1]
            pos += 2
        elif rle:
            rle -= 1
            j += 1
            if j > 255:
                return None
        else:
            j = buf[pos]
            pos += 1
        if not j:
            break
    if x < TOTFREQ - 1 or x > TOTFREQ:
        return None
    if pos > end - 16:
        return None
    return pos, ssym, sfreq, sbase, f1d, b1d


def _uncompress_o0(buf) -> bytes | None:
    in_size = len(buf)
    if in_size < 26 or buf[0] != 0:
        return None
    in_sz = int.from_bytes(buf[1:5], "little")
    out_sz = int.from_bytes(buf[5:9], "little")
    if in_sz != in_size - 9 or out_sz >= 2**31 - 1:
        return None
    r = parse_tables_o0(buf)
    if r is None:
        return None
    pos, ssym, sfreq, sbase, _f1d, _b1d = r
    out = core8.dec_o0(buf, pos, len(buf), out_sz, ssym, sfreq, sbase,
                       TF_SHIFT)
    return None if out is None else out.tobytes()


def parse_tables_o1(buf, want_sfb: bool = True):
    """Parse the order-1 table block.  Returns (payload pos, sfb
    (256,4096), f2d, b2d) or None.  ``want_sfb=False`` skips the 1 MiB
    slot -> symbol table (sfb is returned as None): the batch decoder
    reads only f2d / b2d."""
    in_size = len(buf)
    pos = 9
    end = in_size
    sfb = np.zeros((256, TOTFREQ), dtype=np.uint8) if want_sfb else None
    f2d = np.zeros((256, 256), dtype=np.uint32)
    b2d = np.zeros((256, 256), dtype=np.uint32)
    rle_i = 0
    i = buf[pos]
    pos += 1
    while True:
        x = 0
        rle_j = 0
        j = buf[pos]
        pos += 1
        while True:
            if pos > end - 16:
                return None
            f, pos = _get_freq(buf, pos)
            if not f:
                f = TOTFREQ  # stored-zero quirk (rANS_static.c:771-772)
            if x + f > TOTFREQ:
                return None
            if want_sfb:
                sfb[i, x:x + f] = j
            f2d[i, j] = f
            b2d[i, j] = x
            x += f
            if not rle_j and pos < end and j + 1 == buf[pos]:
                j = buf[pos]
                rle_j = buf[pos + 1]
                pos += 2
            elif rle_j:
                rle_j -= 1
                j += 1
                if j > 255:
                    return None
            else:
                j = buf[pos]
                pos += 1
            if not j:
                break
        if x < TOTFREQ - 1 or x > TOTFREQ:
            return None
        if x < TOTFREQ and want_sfb:
            # Historic streams fill 4095 of 4096 slots
            # (rANS_static.c:797-800).
            sfb[i, x] = sfb[i, x - 1]
        if not rle_i and pos < end and i + 1 == buf[pos]:
            i = buf[pos]
            rle_i = buf[pos + 1]
            pos += 2
        elif rle_i:
            rle_i -= 1
            i += 1
            if i > 255:
                return None
        else:
            i = buf[pos]
            pos += 1
        if not i:
            break

    if pos > end - 16:
        return None
    return pos, sfb, f2d, b2d


def _uncompress_o1(buf) -> bytes | None:
    in_size = len(buf)
    if in_size < 27 or buf[0] != 1:
        return None
    in_sz = int.from_bytes(buf[1:5], "little")
    out_sz = int.from_bytes(buf[5:9], "little")
    if in_sz != in_size - 9 or out_sz >= 2**31 - 1:
        return None
    r = parse_tables_o1(buf)
    if r is None:
        return None
    pos, sfb, f2d, b2d = r
    out = core8.dec_o1(buf, pos, len(buf), out_sz, sfb, f2d, b2d, TF_SHIFT)
    return None if out is None else out.tobytes()


def compress(data, order: int) -> bytes:
    data = _as_u8(data)
    return _compress_o1(data) if order else _compress_o0(data)


def uncompress(buf) -> bytes:
    buf = bytes(buf)
    if len(buf) < 9:
        raise ValueError("corrupt rans4x8 stream")
    out = _uncompress_o1(buf) if buf[0] else _uncompress_o0(buf)
    if out is None:
        raise ValueError("corrupt rans4x8 stream")
    return out
