"""Frequency-table machinery for the static rANS codecs.

Bit-exact re-derivation of the reference's table pipeline
(``htscodecs/rANS_static4x16pr.c:103-358,620-691``):
power-of-two normalisation, alphabet RLE serialisation, delta-coded
order-1 rows, and the 10-vs-12-bit entropy heuristic.

All of this is host-side control work (tables are at most 256 entries);
the device kernels only ever see the finished (start, freq) tables.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from ..utils import varint

TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT
TF_SHIFT_O1 = 12
TF_SHIFT_O1_FAST = 10
TOTFREQ_O1 = 1 << TF_SHIFT_O1
TOTFREQ_O1_FAST = 1 << TF_SHIFT_O1_FAST


def round2(v: int) -> int:
    """Round up to the next power of two (round2 in the reference)."""
    if v <= 0:
        return 0
    return 1 << (v - 1).bit_length()


def hist8(data: np.ndarray) -> np.ndarray:
    """Order-0 histogram (uint32[256])."""
    return np.bincount(data, minlength=256).astype(np.uint64)


def present8(data: np.ndarray) -> np.ndarray:
    """Symbol presence map (0/1 per symbol)."""
    h = np.bincount(data, minlength=256)
    return (h > 0).astype(np.uint32)


def hist1_4(data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Order-1 transition histogram with initial context 0.

    Returns (F, T) where F[l, c] counts symbol c following context l
    (the first byte counted against context 0) and T[l] = sum_c F[l, c].
    Matches ``utils.h:137-202`` semantics.
    """
    F = np.zeros((256, 256), dtype=np.uint64)
    if len(data):
        ctx = np.empty(len(data), dtype=np.uint8)
        ctx[0] = 0
        ctx[1:] = data[:-1]
        np.add.at(F, (ctx, data), 1)
    return F, F.sum(axis=1)


def normalise_freq(F: list[int], size: int, tot: int) -> int:
    """Scale raw counts in-place so they sum exactly to ``tot``.

    Mirrors the reference's fixed-point scale + largest-symbol adjust +
    one retry pass (``rANS_static4x16pr.c:116-163``).  Returns 0 on
    success, -1 if the distribution cannot be normalised.
    """
    if not size:
        return 0

    loop = 0
    while True:
        tr = ((tot << 31) // size) + ((1 << 30) // size)
        new_size = 0
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
                j = 0
                while adjust and j < 256:
                    if F[j] >= 2:
                        d = F[j] > -adjust
                        mm = adjust if d else 1 - F[j]
                        F[j] += mm
                        adjust -= mm
                    j += 1
        break

    return 0 if F[M] > 0 else -1


def normalise_freq_shift(F: list[int], size: int, max_tot: int) -> None:
    """Left-shift all freqs so a power-of-two total reaches ``max_tot``."""
    if size == 0 or size == max_tot:
        return
    shift = 0
    while size < max_tot:
        size *= 2
        shift += 1
    for i in range(256):
        F[i] <<= shift


def encode_alphabet(out: bytearray, F) -> int:
    """Serialise the set of used symbols with ascending-run RLE.

    Format (``rANS_static4x16pr.c:181-206``): each new symbol byte,
    followed (when it directly extends the previous symbol) by a run
    count of further consecutive symbols; terminated by 0.
    """
    start = len(out)
    rle = 0
    for j in range(256):
        if F[j]:
            if rle:
                rle -= 1
            else:
                out.append(j)
                if j and F[j - 1]:
                    run = j + 1
                    while run < 256 and F[run]:
                        run += 1
                    rle = run - (j + 1)
                    out.append(rle)
    out.append(0)
    return len(out) - start


def decode_alphabet(buf, pos: int, end: int) -> tuple[np.ndarray | None, int]:
    """Inverse of :func:`encode_alphabet`.

    Two-phase transcription of ``rANS_static4x16pr.c:208-255`` (a fast
    loop while 3+ bytes remain, then a bounds-checked tail) so that
    truncated-stream acceptance/rejection matches the reference exactly.
    Returns (presence array F or None on error, new position).
    """
    F = np.zeros(256, dtype=np.uint32)
    if pos == end:
        return F, pos

    rle = 0
    j = buf[pos]
    pos += 1
    if pos + 2 < end:
        while True:
            F[j] = 1
            if not rle and j + 1 == buf[pos]:
                j = buf[pos]
                rle = buf[pos + 1]
                pos += 2
            elif rle:
                rle -= 1
                j += 1
                if j > 255:
                    return None, pos
            else:
                j = buf[pos]
                pos += 1
            if not (j and pos + 2 < end):
                break

    if j:
        while True:
            F[j] = 1
            if pos >= end:
                return None, pos
            if not rle and j + 1 == buf[pos]:
                if pos + 1 >= end:
                    return None, pos
                j = buf[pos]
                rle = buf[pos + 1]
                pos += 2
            elif rle:
                rle -= 1
                j += 1
                if j > 255:
                    return None, pos
            else:
                j = buf[pos]
                pos += 1
            if not (j and pos < end):
                break

    return F, pos


def encode_freq(out: bytearray, F) -> int:
    """Order-0 table: alphabet then varint freq per present symbol."""
    start = len(out)
    encode_alphabet(out, F)
    for j in range(256):
        if F[j]:
            varint.put_uint(out, int(F[j]))
    return len(out) - start


def decode_freq(buf, pos: int, end: int) -> tuple[np.ndarray | None, int, int]:
    """Returns (F[256] or None, fsum, new position)."""
    if pos == end:
        return None, 0, pos
    A, pos = decode_alphabet(buf, pos, end)
    if A is None:
        return None, 0, pos
    F = np.zeros(256, dtype=np.uint32)
    tot = 0
    for j in range(256):
        if A[j]:
            f, pos = varint.get_uint(buf, pos, end)
            F[j] = f & 0xFFFFFFFF
            tot += int(F[j])
    return F, tot, pos


def encode_freq_d(out: bytearray, F0, F) -> int:
    """Order-1 row delta-coded against the order-0 alphabet.

    Zero frequencies are run-length folded: a run of ``dz`` zeros is
    stored as the two bytes [0, dz-1] (``rANS_static4x16pr.c:295-325``).
    """
    start = len(out)
    dz = 0
    for j in range(256):
        if F0[j]:
            if F[j] != 0:
                if dz:
                    del out[len(out) - (dz - 1):]
                    out.append(dz - 1)
                dz = 0
                varint.put_uint(out, int(F[j]))
            else:
                dz += 1
                out.append(0)
    if dz:
        del out[len(out) - (dz - 1):]
        out.append(dz - 1)
    return len(out) - start


def decode_freq_d(buf, pos: int, end: int, F0) -> tuple[np.ndarray | None, int, int]:
    """Returns (F row or None, total, new position)."""
    if pos == end:
        return None, 0, pos
    F = np.zeros(256, dtype=np.uint32)
    T = 0
    dz = 0
    for j in range(256):
        if pos >= end:
            break
        if not F0[j]:
            continue
        if dz:
            f = 0
            dz -= 1
        else:
            if pos >= end:
                return None, 0, pos
            f, pos = varint.get_uint(buf, pos, end)
            if f == 0:
                if pos >= end:
                    return None, 0, pos
                dz = buf[pos]
                pos += 1
        F[j] = f & 0xFFFFFFFF
        T += int(F[j])
    return F, T, pos


def fast_log(a: float) -> float:
    """Bit-twiddled log approximation, reproduced exactly
    (``rANS_static4x16pr.c:620-623``)."""
    (x,) = struct.unpack("<q", struct.pack("<d", a))
    return (x - 4606921278410026770) * 1.539095918623324e-16


def compute_shift(F0, F, T) -> tuple[int, list[int]]:
    """Pick the order-1 table precision (10 vs 12 bits).

    Entropy estimate replicated operation-for-operation from
    ``rANS_static4x16pr.c:629-691`` (the float accumulation order
    matters: the chosen shift is stored in the stream).
    Returns (shift, S) where S[i] is the per-row scale target.
    """
    e10 = 0.0
    e12 = 0.0
    max_tot = 0
    S = [0] * 256
    for i in range(256):
        if F0[i] == 0:
            continue
        max_val = round2(int(T[i]))
        ns = 0
        sm10 = 0
        sm12 = 0
        Fi = F[i]
        for j in range(256):
            fij = int(Fi[j])
            if fij and max_val // fij > TOTFREQ_O1_FAST:
                sm10 += 1
            if fij and max_val // fij > TOTFREQ_O1:
                sm12 += 1
        l10 = math.log(TOTFREQ_O1_FAST + sm10)
        l12 = math.log(TOTFREQ_O1 + sm12)
        Ti = int(T[i])
        for j in range(256):
            fij = int(Fi[j])
            if fij:
                ns += 1
                x = int(float(TOTFREQ_O1_FAST) * fij / Ti)
                e10 -= fij * (fast_log(max(x, 1)) - l10)
                x = int(float(TOTFREQ_O1) * fij / Ti)
                e12 -= fij * (fast_log(max(x, 1)) - l12)
                e10 += 4
                e12 += 6
        if ns < 64 and max_val > 128:
            max_val //= 2
        if max_val > 1024:
            max_val //= 2
        if max_val > TOTFREQ_O1:
            max_val = TOTFREQ_O1
        S[i] = max_val
        if max_tot < max_val:
            max_tot = max_val
    # C computes e10/e12 with IEEE semantics: /0 gives inf/nan which
    # compare false against 1.01.
    ratio_small = (e10 / e12 < 1.01) if e12 != 0.0 else False
    shift = (
        TF_SHIFT_O1_FAST
        if ratio_small or max_tot <= TOTFREQ_O1_FAST
        else TF_SHIFT_O1
    )
    return shift, S
