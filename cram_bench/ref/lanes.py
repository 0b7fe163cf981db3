"""The interleaved order-1 rANS encode of whole blocks, in plain NumPy.

Both CRAM codecs that this benchmark holds the port to (rANS-Nx16 of
CRAM 3.1 and rANS 4x8 of CRAM 3.0) split a block of n bytes into four
quarters of q = n >> 2 bytes, one state each; state 3 also codes the
n - 4q tail bytes first, and every quarter's first byte is coded in
context 0 last (htscodecs rANS_static4x16pr.c and rANS_static.c).  The
encoder walks each quarter backwards, symbol data[i + 1] in context
data[i], and the four states emit their renormalisation output into one
shared sequence, state 3 first within a step, that the stream stores
reversed after the four final states.

Every state is a lane of one NumPy vector: the steps of all blocks of a
batch run together, so a batch costs about as many vector steps as one
block has (n - 3q).  Nothing here knows either codec's tables or
framing; ``encode`` takes the per-block (freq, start) tables and the
renormalisation of the codec.
"""

from __future__ import annotations

import numpy as np

CHUNK = 4096        # steps gathered and recorded per pass


def _positions(n: int):
    """(S, base, first): steps of the walk, and per state j the position
    of the symbol coded at step s (base[j] - s) and the first step at
    which state j is active."""
    q = n >> 2
    tail = n - 4 * q
    S = n - 3 * q
    base = np.array([j * q + q - 1 + tail for j in range(3)] + [n - 1],
                    np.int64)
    first = np.array([tail, tail, tail, 0], np.int64)
    return S, base, first


def encode(blocks: np.ndarray, freq: np.ndarray, start: np.ndarray,
           shift: np.ndarray, lower: int, renorm_bits: int,
           max_emit: int) -> list[bytes]:
    """Order-1 rANS payloads (four u32 states, then the output units in
    stream order) of B blocks of one length.

    blocks (B, n) uint8, n >= 4; freq / start (B, 256, 256) indexed
    [context, symbol]; shift (B,) table precision; lower the state's
    lower bound L; renorm_bits 16 (rANS-Nx16, one word at most) or 8
    (rANS 4x8, up to ``max_emit`` bytes)."""
    B, n = blocks.shape
    if n < 4:
        raise ValueError("order-1 lanes need blocks of 4 bytes or more")
    S, base, first = _positions(n)
    lanes = 4 * B
    shift = np.asarray(shift, np.uint32)
    sh_l = np.repeat(shift, 4)
    # x_max = ((L >> shift) << renorm_bits) * freq, as a left shift
    xm_shift = (np.uint32(int(np.log2(lower)) + renorm_bits) - sh_l)
    total = np.left_shift(np.uint32(1), sh_l)
    flat_f = freq.reshape(B, -1).astype(np.uint32)
    flat_c = start.reshape(B, -1).astype(np.uint32)
    boff = (np.arange(B, dtype=np.int64) * 65536)[:, None]

    x = np.full(lanes, lower, np.uint32)
    units: list[list[np.ndarray]] = [[] for _ in range(B)]
    unit_mask = np.uint32((1 << renorm_bits) - 1)
    rb = np.uint32(renorm_bits)
    e = np.empty(lanes, bool)
    sh = np.empty(lanes, np.uint32)
    qv = np.empty(lanes, np.uint32)
    for s0 in range(0, S, CHUNK):
        s = np.arange(s0, min(s0 + CHUNK, S), dtype=np.int64)
        C = len(s)
        pos = base[None, :] - s[:, None]                     # (C, 4)
        active = s[:, None] >= first[None, :]
        pos = np.where(active, pos, 1)
        sym = blocks[:, pos]                                 # (B, C, 4)
        ctx = blocks[:, pos - 1]
        ctx[:, s == S - 1, :] = 0
        key = (ctx.astype(np.int64) << 8 | sym).reshape(B, -1) + boff
        f = flat_f.ravel()[key].reshape(B, C, 4).transpose(1, 0, 2)
        c = flat_c.ravel()[key].reshape(B, C, 4).transpose(1, 0, 2)
        f = np.ascontiguousarray(f).reshape(C, lanes)
        c = np.ascontiguousarray(c).reshape(C, lanes)
        act = np.broadcast_to(active[:, None, :], (C, B, 4)).reshape(C, lanes)
        if (act & (f == 0)).any():
            raise ValueError("a coded pair has no frequency")
        g = np.where(act, total[None, :] - f, 0).astype(np.uint32)
        c = np.where(act, c, 0).astype(np.uint32)
        f = np.where(act, f, 1).astype(np.uint32)
        xm = np.where(act, np.left_shift(f, xm_shift[None, :]),
                      np.uint32(0xFFFFFFFF)).astype(np.uint32)
        xs = np.empty((max_emit, C, lanes), np.uint32)
        es = np.empty((max_emit, C, lanes), bool)
        for t in range(C):
            for k in range(max_emit):
                xs[k, t] = x
                np.greater_equal(x, xm[t], out=e)
                es[k, t] = e
                np.multiply(e, rb, out=sh, casting="unsafe")
                np.right_shift(x, sh, out=x)
            np.floor_divide(x, f[t], out=qv)
            qv *= g[t]
            x += qv
            x += c[t]
        # stream order within a step: state 3 first, each state's units
        # in the order it emitted them
        xs = (xs & unit_mask).reshape(max_emit, C, B, 4)[..., ::-1]
        es = es.reshape(max_emit, C, B, 4)[..., ::-1]
        xs = xs.transpose(2, 1, 3, 0)                        # (B, C, 4, k)
        es = es.transpose(2, 1, 3, 0)
        for b in range(B):
            units[b].append(xs[b][es[b]])
    dt = "<u2" if renorm_bits == 16 else "u1"
    out = []
    st = x.reshape(B, 4).astype("<u4")
    for b in range(B):
        body = np.concatenate(units[b])[::-1].astype(dt)
        out.append(st[b].tobytes() + body.tobytes())
    return out
