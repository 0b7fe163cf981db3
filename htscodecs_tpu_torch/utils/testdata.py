"""Seeded input generators for the smoke run and the tests.

Data comes from ``numpy.random.default_rng(seed)`` so that any two
consumers (the port and the JAX package in the tests; the kernels and
their plain versions in ``chip_smoke.py``) can be handed the same
arrays.  ``synth_tables`` builds valid dense rANS tables at a CHOSEN
precision (10 or 12 bits per block), which the host table build
cannot be asked for: it picks the precision itself.  ``r8_tables``
gives the rANS 4x8 tables of a batch as the native table build makes them.
For the range-coder engines: ``arith_blocks`` (ragged batches over a
chosen model width), ``synth_fqz_jobs`` (fqzcomp_qual jobs of
fixed-length records) and two triple generators for ``rc_enc``.
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


def synth_wide(n_blocks: int, n: int, nsym: int, seed: int = 7,
               lo: int = 33) -> np.ndarray:
    """``nsym``-symbol data (bytes lo .. lo + nsym - 1) with pair
    structure (every odd byte repeats its predecessor), so order 1
    compresses it: (n_blocks, n) uint8."""
    rng = np.random.default_rng(seed)
    out = rng.integers(lo, lo + nsym, size=(n_blocks, n)).astype(np.uint8)
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


def r8_tables(blocks: np.ndarray, order: int, max_a: int = 96):
    """Dense rANS 4x8 tables of a batch from the native table build
    (``native.r8_build_tables_dense``), padded to the batch's alphabet
    bucket as the batch layer pads them: (alpha (B,A) u8, packed
    (B,A,A) i32 — (B,A) for order 0).  Rows normalise to 4095 slots.
    ``max_a`` up to 256 gives alphabets wider than the batch layer's
    (unpadded past the widest bucket), for the kernels' grid."""
    from .. import native
    res = [native.r8_build_tables_dense(b, order, max_a) for b in blocks]
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


def arith_blocks(n_blocks: int, n: int, width: int, seed: int):
    """A ragged batch for the arith_dynamic engine: (blocks (B, n) u8
    over ``width`` symbols, skewed so that the model's order matters;
    lens (B,) i32, the second block 7 bytes short; max_syms (B,) i32 =
    max symbol + 1 of each block's coded prefix).  ``width`` 256 gives
    blocks that hold byte 255."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, width, (n_blocks, n)).astype(np.int64)
    blocks = (v * v // max(width // 3, 1) % width).astype(np.uint8)
    blocks[:, 0] = width - 1
    lens = np.full(n_blocks, n, np.int32)
    lens[1 % n_blocks] = max(n - 7, 1)
    ms = np.array([int(blocks[b, :lens[b]].max()) + 1
                   for b in range(n_blocks)], np.int32)
    return blocks, lens, ms


def synth_fqz_jobs(n_jobs: int, n_rec: int, rec_len: int, seed: int = 42):
    """fqzcomp_qual jobs as ``models.fqz.compress`` takes them: a list
    of (data (n_rec * rec_len,) u8, lens, flags) with ``n_rec`` records
    of ``rec_len`` values each.  The values are ``synth_quality``'s
    (four symbols in geometric runs), drawn to the full length: no
    record repeats its predecessor, so every value is a coded event."""
    rng = np.random.default_rng(seed)
    syms = np.array([2, 12, 23, 37], np.uint8) + 33
    n = n_rec * rec_len
    m = n // 3 + 64
    jobs = []
    for _ in range(n_jobs):
        vals = rng.choice(4, size=m, p=[0.05, 0.10, 0.15, 0.70])
        lens = rng.geometric(0.25, size=m).clip(1, 60)
        seq = np.repeat(vals, lens)
        while len(seq) < n:             # ~1.3 n expected: all but never
            seq = np.concatenate([seq, seq])
        jobs.append((syms[seq[:n]], [rec_len] * n_rec, [0] * n_rec))
    return jobs


def _u16_triple(rows):
    a = np.asarray(rows, np.uint16).reshape(-1, 3)
    return a[:, 0].copy(), a[:, 1].copy(), a[:, 2].copy()


def ff_run_triples(reps: int):
    """One block's (acc, f, tot) u16 triples that drive the range coder
    through both kinds of deferred run: four events after which a carry
    resolves a run of two pending bytes (they come out as 0x00), then
    ``reps`` events that code the top 1/256 of the range each, which
    defers a run of about ``reps`` bytes of 0xFF, then one event that
    ends it."""
    return _u16_triple([(255, 1, 257), (255, 1, 257), (1020, 4, 1024),
                        (254, 2, 256)] + [(255, 1, 256)] * reps
                       + [(1, 1, 2)])


def random_triples(n_blocks: int, n: int, seed: int):
    """Ragged random valid triples (acc + f <= tot, f >= 1): a list of
    ``n_blocks`` (acc, f, tot) u16 array triples, block b three events
    shorter than block b - 1."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_blocks):
        k = max(n - 3 * b, 1)
        tot = rng.integers(2, 65536, k)
        f = (rng.random(k) * (tot - 1)).astype(np.int64) + 1
        acc = (rng.random(k) * (tot - f + 1)).astype(np.int64)
        out.append((acc.astype(np.uint16), f.astype(np.uint16),
                    tot.astype(np.uint16)))
    return out


NAME_STYLES = ("illumina", "sra", "pacbio", "zeros")


def synth_names(n: int, style: str, seed: int = 42) -> bytes:
    """A block of ``n`` newline-terminated read names, as a sequencer or
    an archive emits them:

    - ``illumina``: ``HSQ1004:134:C0D8DACXX:<lane>:<tile>:<x>:<y>``, one
      lane, tiles in increasing order, x ascending within a tile;
    - ``sra``: ``SRR062634.<i>`` with a running index, about 2 % of the
      names repeating their predecessor (the mates of a pair);
    - ``pacbio``: ``m130802_..._s1_p0/<zmw>/<start>_<end>``, a few
      subreads per ZMW;
    - ``zeros``: fixed-width fields with leading zeros
      (``EAS139_<run>:<lane>:<tile>:<x>:<y>``, zero-padded)."""
    rng = np.random.default_rng(seed)
    if style == "illumina":
        lane = int(rng.integers(1, 9))
        tiles = np.sort(rng.choice(np.array(
            [s * 1000 + sw * 100 + t for s in (1, 2) for sw in (1, 2, 3)
             for t in range(1, 17)]), size=n))
        xs = rng.integers(1000, 21000, n)
        ys = rng.integers(1000, 200000, n)
        order = np.lexsort((xs, tiles))
        names = [f"HSQ1004:134:C0D8DACXX:{lane}:{t}:{x}:{y}" for t, x, y
                 in zip(tiles[order], xs[order], ys[order])]
    elif style == "sra":
        step = (rng.random(n) >= 0.02).astype(np.int64)
        idx = int(rng.integers(1, 10 ** 7)) + np.cumsum(step)
        names = [f"SRR062634.{i}" for i in idx]
    elif style == "pacbio":
        movie = "m130802_221257_00127_c100560082550000001823094812221334_s1_p0"
        zmw = int(rng.integers(0, 1000))
        start = 0
        names = []
        for _ in range(n):
            if rng.random() < 0.3:
                zmw += int(rng.integers(1, 40))
                start = 0
            end = start + int(rng.integers(200, 20000))
            names.append(f"{movie}/{zmw}/{start}_{end}")
            start = end + int(rng.integers(30, 60))
    elif style == "zeros":
        tiles = np.sort(rng.integers(1, 120, n))
        xs = rng.integers(0, 20000, n)
        ys = rng.integers(0, 2000, n)
        run = int(rng.integers(1, 99))
        names = [f"EAS139_{run:04d}:{1 + t // 60}:{t:04d}:{x:05d}:{y:04d}"
                 for t, x, y in zip(tiles, xs, ys)]
    else:
        raise ValueError(f"unknown name style {style!r}")
    return ("\n".join(names) + "\n").encode()
