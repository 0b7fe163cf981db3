"""4-state interleaved rANS cores, 16-bit renormalisation (CRAM 3.1).

Host reference engine: exact integer re-derivation of the state machine
in ``htscodecs/rANS_word.h`` (L = 1<<15; at most one
16-bit word emitted/consumed per symbol) with the interleave layouts of
``rANS_static4x16pr.c`` (order-0: symbol i -> state i&3; order-1: four
contiguous quarters, state 3 takes the tail, quarter-leading bytes
coded in context 0).

Layout of a payload (forward order): four little-endian u32 state
flushes (state 0 first), then the renormalisation words, which the
encoder produced back-to-front.

These Python loops are the *oracle* implementation.  Production paths:
the C host kernels (native/) and the batched CUDA engine
(ops/rans_vmem.py) — all three must agree bit-for-bit.
"""

from __future__ import annotations

import numpy as np

RANS_L = 1 << 15


def _enc_put(x: int, start: int, freq: int, shift: int, words: list[int]) -> int:
    x_max = ((RANS_L >> shift) << 16) * freq
    if x >= x_max:
        words.append(x & 0xFFFF)
        x >>= 16
    return ((x // freq) << shift) + (x % freq) + start


def _payload(states: list[int], words: list[int]) -> bytes:
    out = bytearray()
    for x in states:
        out += int(x).to_bytes(4, "little")
    for w in reversed(words):
        out += int(w).to_bytes(2, "little")
    return bytes(out)


def enc_o0(data, start, freq, shift: int) -> bytes:
    """Order-0 encode of ``data`` given (start, freq) tables summing to
    1<<shift.  Returns the rANS payload (no frequency header)."""
    n = len(data)
    X = [RANS_L] * 4
    words: list[int] = []
    start = [int(v) for v in start]
    freq = [int(v) for v in freq]
    data = data.tolist() if isinstance(data, np.ndarray) else list(data)
    for i in range(n - 1, -1, -1):
        s = data[i]
        j = i & 3
        X[j] = _enc_put(X[j], start[s], freq[s], shift, words)
    return _payload(X, words)


def dec_o0(buf, pos: int, end: int, out_sz: int,
           ssym, sfreq, sbase, shift: int) -> np.ndarray | None:
    """Order-0 decode from ``buf[pos:end]`` using slot LUTs
    (ssym/sfreq/sbase indexed by the low ``shift`` bits of the state)."""
    if end - pos < 16:
        return None
    mask = (1 << shift) - 1
    X = [0] * 4
    for j in range(4):
        X[j] = int.from_bytes(buf[pos:pos + 4], "little")
        pos += 4
        if X[j] < RANS_L:
            return None
    out = np.empty(out_sz, dtype=np.uint8)
    ssym = ssym.tolist()
    sfreq = sfreq.tolist()
    sbase = sbase.tolist()
    for i in range(out_sz):
        j = i & 3
        x = X[j]
        m = x & mask
        out[i] = ssym[m]
        x = sfreq[m] * (x >> shift) + sbase[m]
        if x < RANS_L and pos + 1 < end:
            x = (x << 16) | int.from_bytes(buf[pos:pos + 2], "little")
            pos += 2
        X[j] = x
    return out


def enc_o1(data, start2d, freq2d, shift: int) -> bytes:
    """Order-1 encode: 4 quarters, pair (context=prev byte, symbol=next),
    quarter-leading bytes in context 0, state 3 owns the tail."""
    n = len(data)
    X = [RANS_L] * 4
    words: list[int] = []
    q = n >> 2
    start2d = start2d.tolist()
    freq2d = freq2d.tolist()
    data = data.tolist() if isinstance(data, np.ndarray) else list(data)

    # State-3 tail: indices n-2 down to 4q-1 (n mod 4 symbols).
    l3 = data[n - 1]
    for i in range(n - 2, 4 * q - 2, -1):
        c = data[i]
        X[3] = _enc_put(X[3], start2d[c][l3], freq2d[c][l3], shift, words)
        l3 = c
    last = [data[1 * q - 1], data[2 * q - 1], data[3 * q - 1], l3]

    for k in range(q - 2, -1, -1):
        for j in (3, 2, 1, 0):
            c = data[j * q + k]
            lj = last[j]
            X[j] = _enc_put(X[j], start2d[c][lj], freq2d[c][lj], shift, words)
            last[j] = c

    for j in (3, 2, 1, 0):
        lj = last[j]
        X[j] = _enc_put(X[j], start2d[0][lj], freq2d[0][lj], shift, words)

    return _payload(X, words)


def dec_o1(buf, pos: int, end: int, out_sz: int,
           sfb, f2d, b2d, shift: int) -> np.ndarray | None:
    """Order-1 decode.  ``sfb[ctx][slot]`` maps a state's low bits to a
    symbol; ``f2d/b2d[ctx][sym]`` are its freq and cumulative base."""
    if end - pos < 16:
        return None
    mask = (1 << shift) - 1
    X = [0] * 4
    for j in range(4):
        X[j] = int.from_bytes(buf[pos:pos + 4], "little")
        pos += 4
        if X[j] < RANS_L:
            return None
    q = out_sz >> 2
    out = np.empty(out_sz, dtype=np.uint8)
    sfb = sfb.tolist()
    f2d = f2d.tolist()
    b2d = b2d.tolist()
    ctx = [0, 0, 0, 0]
    for k in range(q):
        for j in range(4):
            x = X[j]
            m = x & mask
            c = sfb[ctx[j]][m]
            out[j * q + k] = c
            x = f2d[ctx[j]][c] * (x >> shift) + m - b2d[ctx[j]][c]
            if x < RANS_L and pos + 1 < end:
                x = (x << 16) | int.from_bytes(buf[pos:pos + 2], "little")
                pos += 2
            X[j] = x
            ctx[j] = c
    l3 = ctx[3]
    x = X[3]
    for i in range(4 * q, out_sz):
        m = x & mask
        c = sfb[l3][m]
        out[i] = c
        x = f2d[l3][c] * (x >> shift) + m - b2d[l3][c]
        if x < RANS_L and pos + 1 < end:
            x = (x << 16) | int.from_bytes(buf[pos:pos + 2], "little")
            pos += 2
        l3 = c
    return out


def build_o0_luts(F, shift: int):
    """Expand a normalised freq table into slot LUTs.

    Returns (ssym, sfreq, sbase) uint8/uint16/uint16 arrays of length
    1<<shift, or None if the table is inconsistent (sum != 1<<shift).
    """
    tot = 1 << shift
    x = 0
    ssym = np.zeros(tot, dtype=np.uint8)
    sfreq = np.zeros(tot, dtype=np.uint32)
    sbase = np.zeros(tot, dtype=np.uint32)
    for j in range(256):
        f = int(F[j])
        if f:
            if f > tot - x:
                return None
            ssym[x:x + f] = j
            sfreq[x:x + f] = f
            sbase[x:x + f] = np.arange(f, dtype=np.uint32)
            x += f
    if x != tot:
        return None
    return ssym, sfreq, sbase
