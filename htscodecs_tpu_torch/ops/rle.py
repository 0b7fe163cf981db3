"""Run-length transform (X_RLE).

Behavioural parity with ``htscodecs/rle.c``: a scoring
pass picks which symbols benefit from RLE, then runs of those symbols
are split into a literals stream and a varint run-length stream.

The NumPy forms here are vectorised host code.
"""

from __future__ import annotations

import numpy as np

from ..utils import varint


def find_syms(data: np.ndarray) -> np.ndarray:
    """Score symbols: +1 each time a byte repeats its predecessor,
    -1 otherwise; symbols with positive score get run-length coded
    (``rle.c:48-98``)."""
    if not len(data):
        return np.zeros(0, dtype=np.uint8)
    rep = np.empty(len(data), dtype=bool)
    rep[0] = False
    rep[1:] = data[1:] == data[:-1]
    delta = np.where(rep, 1, -1)
    saved = np.zeros(256, dtype=np.int64)
    np.add.at(saved, data, delta)
    return np.flatnonzero(saved > 0).astype(np.uint8)


def encode(data: np.ndarray, rle_syms: np.ndarray | None = None):
    """Returns (literals, runs bytes, rle_syms)."""
    if rle_syms is None:
        rle_syms = find_syms(data)
    in_rle = np.zeros(256, dtype=bool)
    in_rle[rle_syms] = True

    n = len(data)
    if n == 0:
        return np.zeros(0, dtype=np.uint8), b"", rle_syms

    # Run boundaries: start of each maximal run of equal bytes.
    change = np.empty(n, dtype=bool)
    change[0] = True
    change[1:] = data[1:] != data[:-1]
    starts = np.flatnonzero(change)
    lens = np.diff(np.append(starts, n))
    vals = data[starts]

    keep = in_rle[vals]
    # Literals: one byte per run for RLE'd symbols, the full run
    # otherwise — select positions with a mask (run start, or any
    # position of a non-RLE run).
    run_id = np.cumsum(change) - 1
    lit_mask = change | ~keep[run_id]
    lits = data[lit_mask]
    # Run lengths as big-endian 7-bit varints, vectorised by width.
    rl = (lens[keep] - 1).astype(np.int64)
    if len(rl) == 0:
        return lits, b"", rle_syms
    nb = np.ones(len(rl), np.int64)
    for thr in (1 << 7, 1 << 14, 1 << 21, 1 << 28):
        nb += rl >= thr
    ends = np.cumsum(nb)
    runs = np.zeros(int(ends[-1]), np.uint8)
    pos0 = ends - 1                       # last (low-7-bits) byte
    runs[pos0] = rl & 0x7F
    rest = rl >> 7
    shiftpos = pos0
    while (rest > 0).any():
        m = rest > 0
        shiftpos = shiftpos - 1
        runs[shiftpos[m]] = (rest[m] & 0x7F) | 0x80
        rest = rest >> 7
    return lits, runs.tobytes(), rle_syms


def decode(lits, runs: bytes, rle_syms, out_len_max: int):
    """Expand literals+runs.  Returns uint8 array or None on error."""
    in_rle = np.zeros(256, dtype=bool)
    in_rle[np.asarray(rle_syms, dtype=np.uint8)] = True

    lits = np.asarray(lits, dtype=np.uint8)
    is_run = in_rle[lits]
    nrun = int(is_run.sum())
    # parse nrun varints sequentially (get_uint reads 0 at exhaustion,
    # like the reference's safe variant), expand with one np.repeat
    rlens = np.empty(nrun, np.int64)
    rpos = 0
    rend = len(runs)
    for k in range(nrun):
        rlens[k], rpos = varint.get_uint(runs, rpos, rend)
    counts = np.ones(len(lits), np.int64)
    counts[is_run] += rlens
    # the scalar loop rejects exactly when any prefix would pass
    # out_len_max; with positive counts that is total > out_len_max
    if int(counts.sum()) > out_len_max:
        return None
    return np.repeat(lits, counts)
