"""Seeded input generators for the smoke run and the tests.

Data comes from ``numpy.random.default_rng(seed)`` so that any two
consumers (the port and the JAX package in the tests; the kernels and
their plain versions in ``chip_smoke.py``) can be handed the same
arrays.  ``synth_tables`` builds valid dense rANS tables at a CHOSEN
precision (10 or 12 bits per block), which the host table build
cannot be asked for: it picks the precision itself.  ``r8_tables``
gives the rANS 4x8 tables of a batch as the native table build makes them.
"""

from __future__ import annotations

import numpy as np

PACK_SHIFT = 13
_BUCKETS = (4, 8, 16, 24, 32, 48, 64, 72, 80, 96)


def synth_quality(n_blocks: int, n: int, seed: int = 42) -> np.ndarray:
    """4-symbol run-structured quality values (the shape of modern
    sequencer output): (n_blocks, n) uint8."""
    rng = np.random.default_rng(seed)
    syms = np.array([2, 12, 23, 37], np.uint8) + 33
    m = max(n // 8, 1)
    out = np.empty((n_blocks, n), np.uint8)
    for b in range(n_blocks):
        vals = rng.choice(4, size=m, p=[0.05, 0.10, 0.15, 0.70])
        lens = rng.geometric(0.25, size=m).clip(1, 60)
        seq = np.repeat(vals, lens)[:n]
        if len(seq) < n:
            seq = np.pad(seq, (0, n - len(seq)), constant_values=3)
        out[b] = syms[seq]
    return out


def synth_wide(n_blocks: int, n: int, nsym: int, seed: int = 7) -> np.ndarray:
    """``nsym``-symbol data with pair structure (every odd byte repeats
    its predecessor), so order 1 compresses it: (n_blocks, n) uint8."""
    rng = np.random.default_rng(seed)
    out = rng.integers(33, 33 + nsym, size=(n_blocks, n)).astype(np.uint8)
    out[:, 1::2] = out[:, 0::2][:, :out[:, 1::2].shape[1]]
    return out


def synth_tables(blocks: np.ndarray, shift, order: int):
    """Valid dense tables for ``blocks`` at the given precision.

    blocks (B,N) u8; shift an int or (B,) vector of 10/12.  Returns
    (alpha (B,A) u8, packed (B,A,A) i32 — (B,A) for order 0 — as
    ``base << 13 | freq``, A).  Every (context, symbol) pair the block
    contains has freq >= 1 and every used row sums to ``1 << shift``;
    pairs that do not occur are holes (freq 0).  Order-1 contexts
    follow the 4-quarter layout: the quarter leaders are coded in
    context byte 0, which is why byte 0 is always in the alphabet."""
    B, N = blocks.shape
    sv = np.broadcast_to(np.asarray(shift, np.int64), (B,))
    als = [np.union1d(blocks[b], [0]).astype(np.uint8) for b in range(B)]
    amax = max(len(a) for a in als)
    A = next((c for c in _BUCKETS if amax <= c), amax)
    alpha = np.zeros((B, A), np.uint8)
    packed = np.zeros((B, A, A) if order == 1 else (B, 1, A), np.int32)
    q = N >> 2
    for b, al in enumerate(als):
        a = len(al)
        alpha[b, :a] = al
        alpha[b, a:] = al[-1]
        d = np.searchsorted(al, blocks[b])
        if order == 1:
            ctx = np.empty(N, np.int64)
            ctx[1:] = d[:-1]
            ctx[[0, q, 2 * q, 3 * q] if q else [0]] = 0
            cnt = np.zeros((a, a), np.int64)
            np.add.at(cnt, (ctx, d), 1)
        else:
            cnt = np.bincount(d, minlength=a)[None, :].astype(np.int64)
        T = 1 << int(sv[b])
        tot = cnt.sum(axis=1, keepdims=True)
        npres = (cnt > 0).sum(axis=1, keepdims=True)
        f = np.where(cnt > 0,
                     1 + cnt * (T - npres) // np.maximum(tot, 1), 0)
        rows = np.flatnonzero(tot[:, 0] > 0)
        f[rows, cnt[rows].argmax(axis=1)] += T - f[rows].sum(axis=1)
        base = np.cumsum(f, axis=1) - f
        packed[b, :cnt.shape[0], :a] = (base << PACK_SHIFT) | f
    if order == 0:
        packed = packed[:, 0, :]
    return alpha, packed, A


def r8_tables(blocks: np.ndarray, order: int):
    """Dense rANS 4x8 tables of a batch from the native table build
    (``native.r8_build_tables_dense``), padded to the batch's alphabet
    bucket as the batch layer pads them: (alpha (B,A) u8, packed
    (B,A,A) i32 — (B,A) for order 0).  Rows normalise to 4095 slots."""
    from .. import native
    res = [native.r8_build_tables_dense(b, order) for b in blocks]
    if any(r is None for r in res):
        raise ValueError("r8_tables: alphabet wider than the dense tables")
    amax = max(len(r[1]) for r in res)
    A = next((c for c in _BUCKETS if amax <= c), amax)
    B = len(res)
    alpha = np.zeros((B, A), np.uint8)
    packed = np.zeros((B, A, A) if order == 1 else (B, A), np.int32)
    for b, (_tab, al, pk) in enumerate(res):
        a = len(al)
        alpha[b, :a] = al
        alpha[b, a:] = al[-1]
        if order == 1:
            packed[b, :a, :a] = pk
        else:
            packed[b, :a] = pk
    return alpha, packed
