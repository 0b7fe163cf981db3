"""Bit-packing transform (X_PACK).

Packs 2/4/8 symbols per byte when the alphabet has <=16 symbols
(behavioural parity with ``htscodecs/pack.c``).
Pure array transforms — ideal vmap/Pallas material; the NumPy forms
here are the host reference and are already vectorised.
"""

from __future__ import annotations

import numpy as np


def pack(data: np.ndarray) -> tuple[np.ndarray, bytes, int]:
    """Bit-pack ``data``.

    Returns (packed, meta, nsym_flag) where meta is the serialised map
    (count byte + symbol list) and nsym_flag is the number of distinct
    symbols (256 wraps to byte 0 in meta, mirroring the reference).
    When the alphabet exceeds 16 symbols the data is returned verbatim
    with a 1-byte meta, exactly as ``pack.c:56-84``.
    """
    present = np.bincount(data, minlength=256) > 0 if len(data) else np.zeros(256, bool)
    syms = np.flatnonzero(present)
    n = len(syms)

    if n > 16:
        return data.copy(), bytes([n & 0xFF]), n

    meta = bytes([n & 0xFF]) + bytes(syms.tolist())
    code = np.zeros(256, dtype=np.uint8)
    code[syms] = np.arange(n, dtype=np.uint8)
    c = code[data]

    if n > 4:  # 2 values per byte
        half = len(data) // 2 * 2
        packed = (c[0:half:2] | (c[1:half:2] << 4)).astype(np.uint8)
        if len(data) & 1:
            packed = np.concatenate([packed, c[half:]])
    elif n > 2:  # 4 values per byte
        q = len(data) // 4 * 4
        packed = (c[0:q:4] | (c[1:q:4] << 2) | (c[2:q:4] << 4) | (c[3:q:4] << 6)).astype(np.uint8)
        if len(data) != q:
            tail = 0
            for k, v in enumerate(c[q:]):
                tail |= int(v) << (2 * k)
            packed = np.concatenate([packed, np.array([tail], dtype=np.uint8)])
    elif n > 1:  # 8 values per byte
        o = len(data) // 8 * 8
        packed = np.zeros(o // 8, dtype=np.uint8)
        for b in range(8):
            packed |= c[b:o:8] << b
        if len(data) != o:
            tail = 0
            for k, v in enumerate(c[o:]):
                tail |= int(v) << k
            packed = np.concatenate([packed, np.array([tail], dtype=np.uint8)])
    else:  # constant (or empty) input: zero bytes of payload
        packed = np.zeros(0, dtype=np.uint8)

    return packed, meta, n


def unpack_meta(buf, pos: int, end: int) -> tuple[np.ndarray | None, int, int]:
    """Parse the pack map.  Returns (map symbols, values-per-byte, new pos).

    values-per-byte is 0 (constant), 1 (verbatim), 2, 4 or 8, matching
    ``pack.c:165-198`` (note: the reference calls this field "nsym").
    """
    if pos >= end:
        return None, 0, pos
    n = buf[pos]
    if n == 0:
        n = 256
    if n <= 1:
        vpb = 0
    elif n <= 2:
        vpb = 8
    elif n <= 4:
        vpb = 4
    elif n <= 16:
        vpb = 2
    else:
        return np.zeros(16, dtype=np.uint8), 1, pos + 1
    if end - pos <= 1:
        return None, 0, pos
    pos += 1
    have = min(n, end - pos)
    if have < n:
        return None, 0, pos
    m = np.zeros(16, dtype=np.uint8)
    m[:n] = np.frombuffer(bytes(buf[pos:pos + n]), dtype=np.uint8)
    return m, vpb, pos + n


def unpack(data: np.ndarray, out_len: int, vpb: int, pmap: np.ndarray) -> np.ndarray | None:
    """Expand packed codes back to symbols (``pack.c:211-348``)."""
    if vpb == 1:
        return data[:out_len].copy()
    if vpb == 0:
        return np.full(out_len, pmap[0], dtype=np.uint8)

    if vpb == 8:
        if (out_len + 7) // 8 > len(data):
            return None
        olen = out_len & ~7
        bits = np.unpackbits(data[: olen // 8], bitorder="little")
        out = pmap[bits[:olen]]
        if out_len != olen:
            c = int(data[olen // 8])
            tail = [(c >> k) & 1 for k in range(out_len - olen)]
            out = np.concatenate([out, pmap[np.array(tail, dtype=np.uint8)]])
        return out.astype(np.uint8)

    if vpb == 4:
        if (out_len + 3) // 4 > len(data):
            return None
        olen = out_len & ~3
        d = data[: olen // 4]
        codes = np.empty((len(d), 4), dtype=np.uint8)
        for k in range(4):
            codes[:, k] = (d >> (2 * k)) & 3
        out = pmap[codes.reshape(-1)]
        if out_len != olen:
            c = int(data[olen // 4])
            tail = [(c >> (2 * k)) & 3 for k in range(out_len - olen)]
            out = np.concatenate([out, pmap[np.array(tail, dtype=np.uint8)]])
        return out.astype(np.uint8)

    if vpb == 2:
        if (out_len + 1) // 2 > len(data):
            return None
        olen = out_len & ~1
        d = data[: olen // 2]
        codes = np.empty((len(d), 2), dtype=np.uint8)
        codes[:, 0] = d & 15
        codes[:, 1] = d >> 4
        out = pmap[codes.reshape(-1)]
        if out_len != olen:
            c = int(data[olen // 2])
            out = np.concatenate([out, pmap[np.array([c & 15], dtype=np.uint8)]])
        return out.astype(np.uint8)

    return None
