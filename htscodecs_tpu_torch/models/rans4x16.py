"""rANS 4x16 block codec (CRAM 3.1) — bitstream-compatible compress /
uncompress with the full transform stack (STRIPE / PACK / RLE / CAT /
NOSZ).

Stream framing parity with ``htscodecs/rANS_static4x16pr.c``:
order byte (bit0 order-1, 0x08 stripe, 0x10 no-size, 0x20 cat,
0x40 rle, 0x80 pack; stripe lane count in order>>8), varint original
size unless NOSZ, transform metadata, then the rANS payload.

This module is host-side framing; the per-block entropy loops live in
ops/rans_core.py (oracle), the native host kernels, and
ops/rans_vmem.py (batched CUDA engine, reached through models/batch.py).
"""

from __future__ import annotations

import numpy as np

from ..ops import freq as fq
from ..ops import pack as packmod
from ..ops import rle as rlemod
from ..ops import rans_core as core
from ..utils import varint

X_PACK = 0x80
X_RLE = 0x40
X_CAT = 0x20
X_NOSZ = 0x10
X_STRIPE = 0x08

import os as _os

from .. import native as _native


def _use_native() -> bool:
    """The native host coders, unless switched off by the environment.
    Asked at call time: the C library is built at first use, not when
    this module is imported."""
    return (_os.environ.get("HTSCODECS_TORCH_NATIVE", "1") != "0"
            and _native.available())


TF_SHIFT = fq.TF_SHIFT
TOTFREQ = fq.TOTFREQ


def _as_u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return data.astype(np.uint8, copy=False)
    return np.frombuffer(bytes(data), dtype=np.uint8)


def compress_bound(size: int, order: int) -> int:
    N = order >> 8
    if not N:
        N = 4
    order &= 0xFF
    sz = int(
        (1.05 * size + 257 * 3 + 4)
        if (order & 1) == 0
        else (1.05 * size + 257 * 257 * 3 + 4 + 257 * 3 + 4)
    )
    sz += (1 if order & X_PACK else 0)
    sz += (1 + 257 * 3 + 4) if order & X_RLE else 0
    sz += 20
    sz += (1 + 5 * N) if order & X_STRIPE else 0
    return sz + (sz & 1) + 2


# ---------------------------------------------------------------------------
# Order-0 / order-1 block primitives (freq header + payload)

def _compress_o0(data: np.ndarray) -> bytes:
    n = len(data)
    if n == 0:
        return b""
    if _use_native():
        out = _native.enc_o0(data)
        if out is not None:
            return out

    F = [int(v) for v in fq.hist8(data)]
    fsum = n
    max_val = min(fq.round2(fsum), TOTFREQ)
    if fq.normalise_freq(F, fsum, max_val) < 0:
        raise ValueError("normalise failed")

    head = bytearray()
    fq.encode_freq(head, F)

    fq.normalise_freq_shift(F, max_val, TOTFREQ)
    start = np.zeros(256, dtype=np.uint32)
    x = 0
    for j in range(256):
        start[j] = x
        x += F[j]
    payload = _ENGINE.enc_o0(data, start, np.asarray(F, dtype=np.uint32), TF_SHIFT)
    return bytes(head) + payload


def _uncompress_o0(buf, pos: int, end: int, out_sz: int) -> np.ndarray | None:
    if end - pos < 16 or out_sz >= 2**31 - 1:
        return None
    if _use_native():
        return _native.dec_o0(bytes(buf[pos:end]), out_sz)
    # The reference parses tables against in+in_size-8.
    tab_end = end - 8
    F, fsum, pos = fq.decode_freq(buf, pos, tab_end)
    if F is None:
        return None
    Fl = [int(v) for v in F]
    fq.normalise_freq_shift(Fl, fsum, TOTFREQ)
    luts = core.build_o0_luts(Fl, TF_SHIFT)
    if luts is None:
        return None
    ssym, sfreq, sbase = luts
    if pos + 16 > end:
        return None
    return _ENGINE.dec_o0(buf, pos, end, out_sz, ssym, sfreq, sbase, TF_SHIFT)


def _compress_o1(data: np.ndarray) -> bytes:
    n = len(data)
    if _use_native() and n >= 4:
        out = _native.enc_o1(data)
        if out is not None:
            return out
    Fnp, Tnp = fq.hist1_4(data)
    F = Fnp.astype(np.int64)
    T = Tnp.astype(np.int64)
    q = n >> 2
    for k in (1, 2, 3):
        F[0][data[k * q]] += 1
    T[0] += 3

    head = bytearray()
    head.append(0)  # uncompressed-tables marker, patched below

    F0 = fq.present8(data).astype(np.int64)
    F0[0] = 1
    fq.encode_alphabet(head, F0)

    shift, S = fq.compute_shift(F0, F, T)

    start2d = np.zeros((256, 256), dtype=np.uint32)
    freq2d = np.zeros((256, 256), dtype=np.uint32)
    for i in range(256):
        if F0[i] == 0:
            continue
        max_val = S[i]
        if shift == fq.TF_SHIFT_O1_FAST and max_val > fq.TOTFREQ_O1_FAST:
            max_val = fq.TOTFREQ_O1_FAST
        Fi = [int(v) for v in F[i]]
        if fq.normalise_freq(Fi, int(T[i]), max_val) < 0:
            raise ValueError("normalise failed")
        fq.encode_freq_d(head, F0, Fi)
        fq.normalise_freq_shift(Fi, max_val, 1 << shift)
        x = 0
        for j in range(256):
            start2d[i, j] = x
            x += Fi[j]
            freq2d[i, j] = Fi[j]

    head[0] = shift << 4
    if len(head) > 1000:
        # Try O0-compressing the frequency tables themselves.
        u_freq = bytes(head[1:])
        c_freq = _compress_o0(np.frombuffer(u_freq, dtype=np.uint8))
        if len(c_freq) + 6 < len(head):
            new = bytearray()
            new.append(head[0] | 1)
            varint.put_uint(new, len(u_freq))
            varint.put_uint(new, len(c_freq))
            new += c_freq
            head = new

    payload = _ENGINE.enc_o1(data, start2d, freq2d, shift)
    return bytes(head) + payload


def _uncompress_o1(buf, pos: int, end: int, out_sz: int) -> np.ndarray | None:
    if end - pos < 16 or out_sz >= 2**31 - 1:
        return None
    if _use_native():
        return _native.dec_o1(bytes(buf[pos:end]), out_sz)

    shift = buf[pos] >> 4
    if shift not in (fq.TF_SHIFT_O1, fq.TF_SHIFT_O1_FAST):
        return None
    compressed = buf[pos] & 1
    pos += 1

    tab_buf = buf
    tab_pos = pos
    tab_end = end
    resume_pos = None
    if compressed:
        u_sz, pos = varint.get_uint(buf, pos, end)
        c_sz, pos = varint.get_uint(buf, pos, end)
        if c_sz >= end - pos - 16:
            return None
        blob = _uncompress_o0(buf, pos, pos + c_sz, u_sz)
        if blob is None:
            return None
        resume_pos = pos + c_sz
        tab_buf = blob.tobytes()
        tab_pos = 0
        tab_end = len(tab_buf)

    F0, tab_pos = fq.decode_alphabet(tab_buf, tab_pos, tab_end)
    if F0 is None or tab_pos >= tab_end:
        return None

    tot = 1 << shift
    sfb = np.zeros((256, tot), dtype=np.uint8)
    f2d = np.zeros((256, 256), dtype=np.uint32)
    b2d = np.zeros((256, 256), dtype=np.uint32)
    for i in range(256):
        if F0[i] == 0:
            continue
        Frow, T, tab_pos = fq.decode_freq_d(tab_buf, tab_pos, tab_end, F0)
        if Frow is None:
            return None
        if not T:
            continue
        Fl = [int(v) for v in Frow]
        fq.normalise_freq_shift(Fl, T, tot)
        x = 0
        for j in range(256):
            f = Fl[j]
            if f:
                if f > tot - x:
                    return None
                sfb[i, x:x + f] = j
                f2d[i, j] = f
                b2d[i, j] = x
                x += f
        if x != tot:
            return None

    if resume_pos is not None:
        pos = resume_pos
    else:
        pos = tab_pos
    if pos + 16 > end:
        return None
    return _ENGINE.dec_o1(buf, pos, end, out_sz, sfb, f2d, b2d, shift)


# ---------------------------------------------------------------------------
# Public wrapper with transforms

def compress(data, order: int) -> bytes:
    """Compress one block.  ``order`` uses the reference's bit-field
    (bit0 order-1, plus X_* flags; stripe lane count in bits 8+)."""
    data = _as_u8(data)
    in_size = len(data)

    if in_size <= 20:
        order &= ~X_STRIPE

    if _use_native() and not (order & X_STRIPE) and in_size:
        r = _native.compress_wrapped(data, order)
        if r is not None:
            return r

    if order & X_STRIPE:
        N = order >> 8
        if N == 0:
            N = 4
        if N > 255:
            raise ValueError("stripe N too large")
        out = bytearray()
        out.append(order & ~X_NOSZ & 0xFF)
        varint.put_uint(out, in_size)
        out.append(N)
        lanes = [data[j::N] for j in range(N)]
        streams = []
        for lane in lanes:
            methods = [m for m in (1, 64, 128, 0) if (order & m) == m]
            best = None
            for m in methods:
                cand = compress(lane, m | X_NOSZ)
                if best is None or len(cand) < len(best):
                    best = cand
            streams.append(best)
        for s in streams:
            varint.put_uint(out, len(s))
        for s in streams:
            out += s
        return bytes(out)

    if order & X_CAT:
        out = bytearray([X_CAT])
        varint.put_uint(out, in_size)
        out += data.tobytes()
        return bytes(out)

    do_pack = order & X_PACK
    do_rle = order & X_RLE
    no_size = order & X_NOSZ

    out = bytearray()
    order_byte = order & 0xFF
    out.append(order_byte)
    if not no_size:
        varint.put_uint(out, in_size)

    order &= 0xF

    if do_pack and in_size:
        packed, pmeta, nsym = packmod.pack(data)
        if len(pmeta) == 1 and pmeta[0] > 16:
            out[0] &= ~X_PACK & 0xFF
            do_pack = 0
        else:
            data = packed
            in_size = len(packed)
            out += pmeta
            varint.put_uint(out, in_size)
    elif do_pack:
        out[0] &= ~X_PACK & 0xFF

    if do_rle and in_size:
        lits, runs, rle_syms = rlemod.encode(data)
        rmeta = bytes([len(rle_syms) & 0xFF]) + bytes(rle_syms.tolist()) + runs
        rle_len = len(lits)
        if rle_len + len(rmeta) >= 0.99 * in_size:
            out[0] &= ~X_RLE & 0xFF
            do_rle = 0
        else:
            c_rmeta = _compress_o0(np.frombuffer(rmeta, dtype=np.uint8))
            if len(c_rmeta) < len(rmeta):
                varint.put_uint(out, len(rmeta) * 2)
                varint.put_uint(out, rle_len)
                varint.put_uint(out, len(c_rmeta))
                out += c_rmeta
            else:
                varint.put_uint(out, len(rmeta) * 2 + 1)
                varint.put_uint(out, rle_len)
                out += rmeta
            data = lits
            in_size = rle_len
    elif do_rle:
        out[0] &= ~X_RLE & 0xFF

    if order and in_size < 8:
        out[0] &= ~1
        order &= ~1

    body = _compress_o1(data) if order == 1 else _compress_o0(data)

    if len(body) >= in_size:
        out[0] = (out[0] & ~3 & 0xFF) | X_CAT | no_size
        body = data.tobytes()

    return bytes(out) + body


def uncompress(buf, out_size: int | None = None) -> bytes:
    """Decompress one block.  ``out_size`` is required for NOSZ streams."""
    buf = bytes(buf) if not isinstance(buf, (bytes, bytearray, memoryview)) else buf
    result = _uncompress_into(memoryview(bytes(buf)), out_size)
    if result is None:
        raise ValueError("corrupt rans4x16 stream")
    return result.tobytes()


def _uncompress_into(buf, out_size: int | None) -> np.ndarray | None:
    in_size = len(buf)
    if in_size == 0:
        return None
    pos = 0
    end = in_size

    if buf[0] & X_STRIPE:
        pos = 1
        ulen, pos = varint.get_uint(buf, pos, end)
        if pos >= in_size:
            return None
        N = buf[pos]
        pos += 1
        if N == 0:
            return None
        if out_size is not None and ulen != out_size:
            return None
        clens = []
        clen_tot = 0
        for i in range(N):
            c, pos = varint.get_uint(buf, pos, end)
            clens.append(c)
            clen_tot += c
            if pos > in_size or c > in_size or c < 1:
                return None
        if pos + clen_tot > in_size:
            return None
        # Lanes decode against the rest of the stripe container, matching
        # the reference (rANS_static4x16pr.c:1412-1426).
        stripe_end = pos + clen_tot
        ulens = [ulen // N + (1 if (ulen % N) > i else 0) for i in range(N)]
        lanes = []
        for i in range(N):
            lane = _uncompress_into(buf[pos:stripe_end], ulens[i])
            if lane is None or len(lane) != ulens[i]:
                return None
            lanes.append(lane)
            pos += clens[i]
        out = np.zeros(ulen, dtype=np.uint8)
        for i in range(N):
            out[i::N] = lanes[i]
        return out

    order = buf[0]
    pos = 1
    do_pack = order & X_PACK
    do_rle = order & X_RLE
    do_cat = order & X_CAT
    no_size = order & X_NOSZ
    order &= 1

    if not no_size:
        osz, pos = varint.get_uint(buf, pos, end)
    else:
        if out_size is None:
            return None
        osz = out_size
    if out_size is not None and osz > out_size:
        return None

    tmp1_size = osz

    pmap = None
    vpb = 0
    unpacked_sz = 0
    if do_pack:
        pmap, vpb, pos = packmod.unpack_meta(buf, pos, end)
        if pmap is None:
            return None
        unpacked_sz = osz
        psz, pos = varint.get_uint(buf, pos, end)
        if psz > tmp1_size:
            return None
        tmp1_size = psz

    rle_meta = None
    if do_rle:
        u_meta_size, pos = varint.get_uint(buf, pos, end)
        rle_len, pos = varint.get_uint(buf, pos, end)
        if rle_len > tmp1_size:
            return None
        if u_meta_size & 1:
            u_meta = u_meta_size // 2
            avail = end - pos
            u_meta = min(u_meta, avail)
            rle_meta = bytes(buf[pos:pos + u_meta])
            c_meta_size = u_meta
            u_meta_size = u_meta
        else:
            c_meta_size, pos2 = varint.get_uint(buf, pos, end)
            u_meta_size //= 2
            blob = _uncompress_o0(buf, pos2, end, u_meta_size)
            if blob is None:
                return None
            rle_meta = blob.tobytes()
            pos = pos2
        if c_meta_size + pos > in_size:
            return None
        pos += c_meta_size
        tmp1_size = rle_len

    if end - pos:
        if do_cat:
            if tmp1_size > end - pos or (out_size is not None and tmp1_size > out_size):
                return None
            tmp1 = np.frombuffer(bytes(buf[pos:pos + tmp1_size]), dtype=np.uint8)
        elif order:
            tmp1 = _uncompress_o1(buf, pos, end, tmp1_size)
        else:
            tmp1 = _uncompress_o0(buf, pos, end, tmp1_size)
        if tmp1 is None:
            return None
    else:
        tmp1 = np.zeros(0, dtype=np.uint8)
        tmp1_size = 0

    if do_rle:
        if u_meta_size == 0 or rle_meta is None or len(rle_meta) == 0:
            return None
        nsyms = rle_meta[0] if rle_meta[0] else 256
        if len(rle_meta) < 1 + nsyms:
            return None
        tmp2 = rlemod.decode(
            tmp1,
            rle_meta[1 + nsyms:],
            np.frombuffer(rle_meta[1:1 + nsyms], dtype=np.uint8),
            osz if not do_pack else osz,
        )
        if tmp2 is None:
            return None
    else:
        tmp2 = tmp1

    if do_pack:
        if vpb == 1:
            unpacked_sz = len(tmp2)
        out = packmod.unpack(tmp2, unpacked_sz, vpb, pmap)
        if out is None:
            return None
        return out

    return tmp2


# ---------------------------------------------------------------------------
# Engine dispatch: the oracle Python loops by default; the native host
# kernels override this when available (see native/).

class _PyEngine:
    enc_o0 = staticmethod(core.enc_o0)
    dec_o0 = staticmethod(core.dec_o0)
    enc_o1 = staticmethod(core.enc_o1)
    dec_o1 = staticmethod(core.dec_o1)


_ENGINE = _PyEngine()


def set_engine(engine) -> None:
    global _ENGINE
    _ENGINE = engine


def get_engine():
    return _ENGINE
