"""Plain NumPy reference writer of rANS-Nx16 order-1 streams (CRAM 3.1).

What htscodecs' ``rans_compress_4x16`` writes for a block with order 1
and no transform flags (rANS_static4x16pr.c): the order byte, the
uncompressed size as a 7-bit big-endian varint, the order-1 frequency
tables (precision byte, alphabet, one delta-coded row per context) and
the payload of four interleaved 32-bit states with 16-bit
renormalisation (``lanes.encode``).  A body as long as the block or
longer is replaced by the block itself under the CAT flag.

The table arithmetic follows the C: the 10- or 12-bit choice from an
entropy estimate whose floating-point order is part of the format,
the fixed-point normalisation with its one retry, and the scale-up to
the chosen total.  Tables longer than 1000 bytes, which htscodecs would
try to compress with order 0, do not occur for the quality alphabets
this benchmark runs, and are refused.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from . import lanes

L = 1 << 15
X_CAT = 0x20


def varint(v: int) -> bytes:
    """htscodecs' unsigned varint: 7-bit groups, most significant first,
    the high bit set on every byte but the last."""
    groups = [v & 0x7F]
    v >>= 7
    while v:
        groups.append(v & 0x7F)
        v >>= 7
    return bytes([g | 0x80 for g in groups[:0:-1]] + [groups[0]])


def o1_counts(block: np.ndarray) -> np.ndarray:
    """Pair counts F[context, symbol] (int64, 256 x 256): every byte in
    the context of the one before it, the first in context 0, and the
    first bytes of quarters 1-3 once more in context 0."""
    n = len(block)
    ctx = np.empty(n, np.int64)
    ctx[0] = 0
    ctx[1:] = block[:-1]
    F = np.bincount(ctx * 256 + block, minlength=65536).reshape(256, 256)
    q = n >> 2
    for k in (1, 2, 3):
        F[0, block[k * q]] += 1
    return F.astype(np.int64)


def _round2(v: int) -> int:
    return 1 << (v - 1).bit_length() if v > 0 else 0


def _logbits(a: float) -> float:
    (i,) = struct.unpack("<q", struct.pack("<d", float(a)))
    return (i - 4606921278410026770) * 1.539095918623324e-16


def pick_shift(used: list[int], F: np.ndarray, T: np.ndarray):
    """(shift, caps): 10 or 12 bits, and each row's scale target."""
    e10 = e12 = 0.0
    max_tot = 0
    caps = {}
    for i in used:
        cap = _round2(int(T[i]))
        row = [(j, int(F[i, j])) for j in range(256) if F[i, j]]
        sm10 = sum(1 for _j, f in row if cap // f > 1024)
        sm12 = sum(1 for _j, f in row if cap // f > 4096)
        l10 = math.log(1024 + sm10)
        l12 = math.log(4096 + sm12)
        t = int(T[i])
        for _j, f in row:
            x = int(1024.0 * f / t)
            e10 -= f * (_logbits(max(x, 1)) - l10)
            x = int(4096.0 * f / t)
            e12 -= f * (_logbits(max(x, 1)) - l12)
            e10 += 4
            e12 += 6
        if len(row) < 64 and cap > 128:
            cap //= 2
        if cap > 1024:
            cap //= 2
        cap = min(cap, 4096)
        caps[i] = cap
        max_tot = max(max_tot, cap)
    small = (e10 / e12 < 1.01) if e12 != 0.0 else False
    return (10 if small or max_tot <= 1024 else 12), caps


def normalise(row: dict[int, int], size: int, tot: int) -> dict[int, int]:
    """Scale counts {symbol: count} to sum to ``tot`` (htscodecs
    normalise_freq: 1.31 fixed point, the largest count takes the
    rounding, one retry from the scaled counts)."""
    F = dict(row)
    syms = sorted(F)
    loop = 0
    while True:
        tr = ((tot << 31) // size) + ((1 << 30) // size)
        new_size = m = M = 0
        for j in syms:
            if m < F[j]:
                m, M = F[j], j
            F[j] = (F[j] * tr) >> 31 or 1
            new_size += F[j]
        adjust = tot - new_size
        if adjust > 0:
            F[M] += adjust
        elif adjust < 0:
            if F[M] > -adjust and (loop == 1 or F[M] // 2 >= -adjust):
                F[M] += adjust
            else:
                if loop < 1:
                    loop += 1
                    size = new_size
                    continue
                adjust += F[M] - 1
                F[M] = 1
                for j in syms:
                    if not adjust:
                        break
                    if F[j] >= 2:
                        d = adjust if F[j] > -adjust else 1 - F[j]
                        F[j] += d
                        adjust -= d
        break
    if F[M] <= 0:
        raise ValueError("frequencies do not normalise")
    return F


def alphabet_bytes(present: list[int]) -> bytes:
    """The symbol set, ascending, as htscodecs writes it: each symbol
    that starts a run of consecutive symbols is followed by the count of
    the rest of the run; 0 ends the list."""
    have = set(present)
    out = bytearray()
    rle = 0
    for j in sorted(present):
        if rle:
            rle -= 1
            continue
        out.append(j)
        if j and (j - 1) in have:
            run = j + 1
            while run < 256 and run in have:
                run += 1
            rle = run - (j + 1)
            out.append(rle)
    out.append(0)
    return bytes(out)


def row_bytes(alphabet: list[int], F: dict[int, int]) -> bytes:
    """One order-1 row over the alphabet: a varint per symbol, a run of
    zeros stored as 0 and the count of further zeros."""
    out = bytearray()
    zeros = 0
    for j in alphabet:
        f = F.get(j, 0)
        if f:
            if zeros:
                out += bytes([0, zeros - 1])
                zeros = 0
            out += varint(f)
        else:
            zeros += 1
    if zeros:
        out += bytes([0, zeros - 1])
    return bytes(out)


def tables(block: np.ndarray):
    """(table bytes, shift, freq (256,256) uint32, start (256,256)
    uint32) of one block."""
    F = o1_counts(block)
    T = F.sum(axis=1)
    used = sorted(set(np.flatnonzero(np.bincount(block, minlength=256))
                      .tolist()) | {0})
    shift, caps = pick_shift(used, F, T)
    freq = np.zeros((256, 256), np.uint32)
    start = np.zeros((256, 256), np.uint32)
    head = bytearray([shift << 4])
    head += alphabet_bytes(used)
    for i in used:
        cap = caps[i]
        if shift == 10 and cap > 1024:
            cap = 1024
        row = {j: int(F[i, j]) for j in used if F[i, j]}
        N = normalise(row, int(T[i]), cap) if row else {}
        head += row_bytes(used, N)
        scale = (1 << shift) // cap if N else 1
        x = 0
        for j in sorted(N):
            freq[i, j] = N[j] * scale
            start[i, j] = x
            x += N[j] * scale
    if len(head) > 1000:
        raise ValueError("order-1 tables over 1000 bytes are not covered")
    return bytes(head), shift, freq, start


def compress_o1(blocks: np.ndarray) -> list[bytes]:
    """The order-1 streams of a (B, n) batch of blocks, n >= 4."""
    B, n = blocks.shape
    tabs = [tables(blocks[b]) for b in range(B)]
    freq = np.stack([t[2] for t in tabs])
    start = np.stack([t[3] for t in tabs])
    shift = np.array([t[1] for t in tabs], np.uint32)
    payloads = lanes.encode(blocks, freq, start, shift, L, 16, 1)
    out = []
    for b in range(B):
        body = tabs[b][0] + payloads[b]
        if len(body) >= n:
            out.append(bytes([X_CAT]) + varint(n) + blocks[b].tobytes())
        else:
            out.append(bytes([1]) + varint(n) + body)
    return out
