"""4-state interleaved rANS cores, 8-bit renormalisation (CRAM 3.0).

Exact integer re-derivation of ``rANS_byte.h`` of the htscodecs C reference:
L = 1<<23, x_max = ((L >> shift) << 8) * freq, up to TWO byte
emissions/consumptions per symbol.  Interleave layouts follow
``rANS_static.c`` (order-0: symbol i -> state i&3 with the tail decoded
without a state advance; order-1: four quarters as in the 4x16 codec).

Host oracle implementation (pure Python); the batched engine is
ops/rans8_vmem.py.
"""

from __future__ import annotations

import numpy as np

RANS8_L = 1 << 23


def _enc_put(x: int, start: int, freq: int, shift: int, out: list[int]) -> int:
    x_max = ((RANS8_L >> shift) << 8) * freq
    if x >= x_max:
        out.append(x & 0xFF)
        x >>= 8
        if x >= x_max:
            out.append(x & 0xFF)
            x >>= 8
    return ((x // freq) << shift) + (x % freq) + start


def _payload(states: list[int], rev_bytes: list[int]) -> bytes:
    out = bytearray()
    for x in states:
        out += int(x).to_bytes(4, "little")
    out += bytes(reversed(rev_bytes))
    return bytes(out)


def _dec_renorm(x: int, buf, pos: int, end: int) -> tuple[int, int]:
    # At most two byte consumptions (rANS_byte.h renorm semantics).
    if x < RANS8_L and pos < end:
        x = ((x << 8) | buf[pos]) & 0xFFFFFFFF
        pos += 1
        if x < RANS8_L and pos < end:
            x = ((x << 8) | buf[pos]) & 0xFFFFFFFF
            pos += 1
    return x, pos


def enc_o0(data, start, freq, shift: int) -> bytes:
    n = len(data)
    X = [RANS8_L] * 4
    rev: list[int] = []
    start = [int(v) for v in start]
    freq = [int(v) for v in freq]
    data = data.tolist() if isinstance(data, np.ndarray) else list(data)
    for i in range(n - 1, -1, -1):
        s = data[i]
        j = i & 3
        X[j] = _enc_put(X[j], start[s], freq[s], shift, rev)
    return _payload(X, rev)


def dec_o0(buf, pos: int, end: int, out_sz: int,
           ssym, sfreq, sbase, shift: int) -> np.ndarray | None:
    if end - pos < 16:
        return None
    mask = (1 << shift) - 1
    X = [0] * 4
    for j in range(4):
        X[j] = int.from_bytes(buf[pos:pos + 4], "little")
        pos += 4
        if X[j] < RANS8_L:
            return None
    out = np.empty(out_sz, dtype=np.uint8)
    ssym = ssym.tolist()
    sfreq = sfreq.tolist()
    sbase = sbase.tolist()
    body = out_sz & ~3
    for i in range(body):
        j = i & 3
        x = X[j]
        m = x & mask
        out[i] = ssym[m]
        x = sfreq[m] * (x >> shift) + sbase[m]
        x, pos = _dec_renorm(x, buf, pos, end)
        X[j] = x
    # Tail symbols are read without advancing the state
    # (rANS_static.c:346-355).
    for i in range(body, out_sz):
        out[i] = ssym[X[i & 3] & mask]
    return out


def enc_o1(data, start2d, freq2d, shift: int) -> bytes:
    n = len(data)
    X = [RANS8_L] * 4
    rev: list[int] = []
    q = n >> 2
    start2d = start2d.tolist()
    freq2d = freq2d.tolist()
    data = data.tolist() if isinstance(data, np.ndarray) else list(data)

    l3 = data[n - 1]
    for i in range(n - 2, 4 * q - 2, -1):
        c = data[i]
        X[3] = _enc_put(X[3], start2d[c][l3], freq2d[c][l3], shift, rev)
        l3 = c
    last = [data[1 * q - 1], data[2 * q - 1], data[3 * q - 1], l3]

    for k in range(q - 2, -1, -1):
        for j in (3, 2, 1, 0):
            c = data[j * q + k]
            lj = last[j]
            X[j] = _enc_put(X[j], start2d[c][lj], freq2d[c][lj], shift, rev)
            last[j] = c

    for j in (3, 2, 1, 0):
        lj = last[j]
        X[j] = _enc_put(X[j], start2d[0][lj], freq2d[0][lj], shift, rev)

    return _payload(X, rev)


def dec_o1(buf, pos: int, end: int, out_sz: int,
           sfb, f2d, b2d, shift: int) -> np.ndarray | None:
    if end - pos < 16:
        return None
    mask = (1 << shift) - 1
    X = [0] * 4
    for j in range(4):
        X[j] = int.from_bytes(buf[pos:pos + 4], "little")
        pos += 4
        if X[j] < RANS8_L:
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
            x, pos = _dec_renorm(x, buf, pos, end)
            X[j] = x
            ctx[j] = c
    l3 = ctx[3]
    x = X[3]
    for i in range(4 * q, out_sz):
        m = x & mask
        c = sfb[l3][m]
        out[i] = c
        x = f2d[l3][c] * (x >> shift) + m - b2d[l3][c]
        x, pos = _dec_renorm(x, buf, pos, end)
        l3 = c
    return out
