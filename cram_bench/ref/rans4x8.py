"""Plain NumPy reference writer of rANS 4x8 order-1 streams (CRAM 3.0).

What htscodecs' ``rans_compress`` (rANS_static.c) writes for a block
with order 1: the order byte, the compressed size after the 9-byte
header and the uncompressed size as little-endian u32, the order-1
tables, then the payload of four interleaved 32-bit states with byte
renormalisation (``lanes.encode``, up to two bytes a step).

Each context's row is scaled to 4096 in double arithmetic, its
largest count taking the rounding so that the row sums to 4095, with a
retry at 0.98 (rANS_static.c).  Tables are written symbol by symbol:
a symbol that extends a run of present symbols is implied by the run
count after the run's first symbol; a frequency under 128 takes one
byte, others two.
"""

from __future__ import annotations

import numpy as np

from . import lanes
from .rans4x16 import o1_counts

L = 1 << 23
TOTFREQ = 4096


def normalise_row(row: dict[int, int], T: int) -> dict[int, int]:
    F = dict(row)
    syms = sorted(F)
    p = TOTFREQ / T
    while True:
        t2 = m = M = 0
        for j in syms:
            if m < F[j]:
                m, M = F[j], j
            F[j] = int(F[j] * p) or 1
            t2 += F[j]
        t2 += 1
        if t2 < TOTFREQ:
            F[M] += TOTFREQ - t2
        elif t2 - TOTFREQ >= F[M] // 2:
            p = 0.98
            continue
        else:
            F[M] -= t2 - TOTFREQ
        return F


class _Symbols:
    """Writes symbols with the run counts of rANS_static.c: a symbol
    whose predecessor is present starts a run, and the run's further
    symbols are left out."""

    def __init__(self, out: bytearray, present):
        self.out = out
        self.present = present
        self.skip = 0

    def put(self, j: int) -> None:
        if self.skip:
            self.skip -= 1
            return
        self.out.append(j)
        if j and self.present(j - 1):
            run = j + 1
            while run < 256 and self.present(run):
                run += 1
            self.skip = run - (j + 1)
            self.out.append(self.skip)


def _put_freq(out: bytearray, f: int) -> None:
    out += bytes([f]) if f < 128 else bytes([128 | (f >> 8), f & 0xFF])


def tables(block: np.ndarray):
    """(table bytes, freq (256,256) uint32, start (256,256) uint32)."""
    F = o1_counts(block)
    T = F.sum(axis=1)
    tab = bytearray()
    ctxs = _Symbols(tab, lambda j: T[j] != 0)
    freq = np.zeros((256, 256), np.uint32)
    start = np.zeros((256, 256), np.uint32)
    for i in np.flatnonzero(T).tolist():
        N = normalise_row({j: int(F[i, j])
                           for j in np.flatnonzero(F[i]).tolist()}, int(T[i]))
        ctxs.put(i)
        syms = _Symbols(tab, lambda j, N=N: N.get(j, 0) != 0)
        x = 0
        for j in sorted(N):
            syms.put(j)
            _put_freq(tab, N[j])
            freq[i, j] = N[j]
            start[i, j] = x
            x += N[j]
        tab.append(0)
    tab.append(0)
    return bytes(tab), freq, start


def compress_o1(blocks: np.ndarray) -> list[bytes]:
    """The order-1 streams of a (B, n) batch of blocks, n >= 4."""
    B, n = blocks.shape
    tabs = [tables(blocks[b]) for b in range(B)]
    freq = np.stack([t[1] for t in tabs])
    start = np.stack([t[2] for t in tabs])
    shift = np.full(B, 12, np.uint32)
    payloads = lanes.encode(blocks, freq, start, shift, L, 8, 2)
    out = []
    for b in range(B):
        body = tabs[b][0] + payloads[b]
        out.append(bytes([1]) + len(body).to_bytes(4, "little")
                   + n.to_bytes(4, "little") + body)
    return out
