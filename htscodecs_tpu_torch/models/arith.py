"""arith_dynamic block codec (CRAM 3.1 adaptive arithmetic coder).

The port's own copy of ``htscodecs_tpu/models/arith.py``: the host codec
with every transform, the fallback of the batch layer
(``models/batch.py: arith_compress_blocks``) and the reference of its
tests.

Bitstream parity with ``htscodecs/arith_dynamic.c``:
order byte = 2-bit order | X_PACK(0x80) | X_RLE(0x40) | X_CAT(0x20) |
X_NOSZ(0x10) | X_STRIPE(0x08) | X_EXT(0x04, bzip2).  Adaptive models
carry no frequency tables; the first payload byte is max-symbol+1.

X_RLE here is not a byte transform: it couples a literal byte model
with 258-symbol run models over an escalating context chain
(MAX_RUN=4).
"""

from __future__ import annotations

import bz2

import numpy as np

from ..ops import pack as packmod
from ..ops.range_coder import RangeDecoder, RangeEncoder, SimpleModel
from ..utils import varint

X_PACK = 0x80
X_RLE = 0x40
X_CAT = 0x20
X_NOSZ = 0x10
X_STRIPE = 0x08
X_EXT = 0x04
X_ORDER = 0x03

MAX_RUN = 4
NSYM_RUN = 258

import os as _os

from .. import native as _native

def _use_native() -> bool:
    """The native host coders, unless switched off by the environment.
    Asked at call time: the C library is built at first use, not when
    this module is imported."""
    return (_os.environ.get("HTSCODECS_TORCH_NATIVE", "1") != "0"
            and _native.available())


def compress_bound(size: int, order: int) -> int:
    base = int(
        (1.05 * size + 257 * 3 + 4)
        if (order & X_ORDER) == 0
        else (1.05 * size + 257 * 257 * 3 + 4 + 257 * 3 + 4)
    )
    return base + (1 if order & X_PACK else 0) + ((1 + 257 * 3 + 4) if order & X_RLE else 0) + 5


def _as_u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return data.astype(np.uint8, copy=False)
    return np.frombuffer(bytes(data), dtype=np.uint8)


def _max_plus_1(data) -> int:
    m = int(max(data)) if len(data) else 0
    return m + 1


# ---------------------------------------------------------------------------
# Entropy primitives (payload = [max_sym byte][range-coded stream])

def _enc_o0(data: list[int]) -> bytes:
    m = _max_plus_1(data)
    model = SimpleModel(256, m)
    rc = RangeEncoder()
    for b in data:
        model.encode(rc, b)
    return bytes([m & 0xFF]) + rc.finish()


def _dec_o0(buf, pos: int, end: int, out_sz: int) -> np.ndarray:
    m = buf[pos] if buf[pos] else 256
    model = SimpleModel(256, m)
    rc = RangeDecoder(buf, pos + 1, end)
    out = np.empty(out_sz, dtype=np.uint8)
    for i in range(out_sz):
        out[i] = model.decode(rc)
    return out


def _enc_o1(data: list[int]) -> bytes:
    m = _max_plus_1(data)
    models = [SimpleModel(256, m) for _ in range(256)]
    rc = RangeEncoder()
    last = 0
    for b in data:
        models[last].encode(rc, b)
        last = b
    return bytes([m & 0xFF]) + rc.finish()


def _dec_o1(buf, pos: int, end: int, out_sz: int) -> np.ndarray:
    m = buf[pos] if buf[pos] else 256
    models = [SimpleModel(256, m) for _ in range(256)]
    rc = RangeDecoder(buf, pos + 1, end)
    out = np.empty(out_sz, dtype=np.uint8)
    last = 0
    for i in range(out_sz):
        last = models[last].decode(rc)
        out[i] = last
    return out


def _enc_rle(data: list[int], order1: bool) -> bytes:
    """O0_RLE / O1_RLE: literal model + run models keyed by literal then
    an escalating context chain (``arith_dynamic.c:392-567``)."""
    m = _max_plus_1(data)
    n = len(data)
    if order1:
        lit_models = [SimpleModel(256, m) for _ in range(256)]
    else:
        lit_model = SimpleModel(256, m)
    run_models = [SimpleModel(NSYM_RUN, MAX_RUN) for _ in range(NSYM_RUN)]
    rc = RangeEncoder()
    last = 0
    i = 0
    while i < n:
        b = data[i]
        if order1:
            lit_models[last].encode(rc, b)
        else:
            lit_model.encode(rc, b)
        run = 0
        last = b
        i += 1
        while i < n and data[i] == last:
            run += 1
            i += 1
        rctx = last
        while True:
            c = run if run < MAX_RUN else MAX_RUN - 1
            run_models[rctx].encode(rc, c)
            run -= c
            if rctx == last:
                rctx = 256
            elif rctx < NSYM_RUN - 1:
                rctx += 1
            if c == MAX_RUN - 1 and run == 0:
                run_models[rctx].encode(rc, 0)
            if not run:
                break
    return bytes([m & 0xFF]) + rc.finish()


def _dec_rle(buf, pos: int, end: int, out_sz: int, order1: bool) -> np.ndarray:
    m = buf[pos] if buf[pos] else 256
    if order1:
        lit_models = [SimpleModel(256, m) for _ in range(256)]
    else:
        lit_model = SimpleModel(256, m)
    run_models = [SimpleModel(NSYM_RUN, MAX_RUN) for _ in range(NSYM_RUN)]
    rc = RangeDecoder(buf, pos + 1, end)
    out = np.empty(out_sz, dtype=np.uint8)
    last = 0
    i = 0
    while i < out_sz:
        if order1:
            b = lit_models[last].decode(rc)
        else:
            b = lit_model.decode(rc)
        out[i] = b
        last = b
        run = 0
        rctx = last
        while True:
            r = run_models[rctx].decode(rc)
            if rctx == last:
                rctx = 256
            elif rctx < NSYM_RUN - 1:
                rctx += 1
            run += r
            if not (r == MAX_RUN - 1 and run < out_sz):
                break
        while run and i + 1 < out_sz:
            run -= 1
            i += 1
            out[i] = last
        i += 1
    return out


# ---------------------------------------------------------------------------
# Public wrapper

def compress(data, order: int) -> bytes:
    data = _as_u8(data)
    in_size = len(data)

    if in_size <= 20:
        order &= ~X_STRIPE

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
        # Per-lane brute-forced method lists (arith_dynamic.c:690-693).
        m = [[1, 64, 0], [1, 0], [1, 128], [1, 128]]
        streams = []
        for i in range(N):
            methods = m[min(i, 3)]
            best = None
            best_j = 0
            for j, meth in enumerate(methods):
                if (order & 3) == 0 and (meth & 1):
                    continue
                cand = compress(data[i::N], meth | X_NOSZ)
                if best is None or len(cand) < len(best):
                    best = cand
                    best_j = j
            streams.append(best)
        for s in streams:
            varint.put_uint(out, len(s))
        for s in streams:
            out += s
        return bytes(out)

    do_pack = order & X_PACK
    do_rle = order & X_RLE
    no_size = order & X_NOSZ
    do_ext = order & X_EXT

    out = bytearray()
    out.append(order & 0xFF)
    if not no_size:
        varint.put_uint(out, in_size)

    order &= 3

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

    if do_rle and not in_size:
        out[0] &= ~X_RLE & 0xFF
        do_rle = 0

    if order and in_size < 8:
        out[0] &= ~3 & 0xFF
        order = 0

    if do_ext:
        body = bz2.compress(bytes(data), 9)
    elif _use_native():
        body = _native.arith_enc(data, order == 1, bool(do_rle))
        if body is None:
            raise ValueError("arith encode failed")
    else:
        lst = data.tolist() if isinstance(data, np.ndarray) else list(data)
        if do_rle:
            body = _enc_rle(lst, order == 1)
        else:
            body = _enc_o1(lst) if order == 1 else _enc_o0(lst)

    if len(body) >= in_size:
        out[0] = (out[0] & ~(3 | X_EXT) & 0xFF) | X_CAT | no_size
        body = bytes(data)

    return bytes(out) + body


def uncompress(buf, out_size: int | None = None) -> bytes:
    result = _uncompress_into(memoryview(bytes(buf)), out_size)
    if result is None:
        raise ValueError("corrupt arith stream")
    return result.tobytes() if isinstance(result, np.ndarray) else bytes(result)


def _uncompress_into(buf, out_size: int | None):
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
        # Each lane decodes against the rest of the stripe container, as
        # the reference does — short range-coder streams rely on the
        # trailing slack to pass RC_StartDecode's 5-byte priming check.
        stripe_end = pos + clen_tot
        ulens = [ulen // N + (1 if (ulen % N) > i else 0) for i in range(N)]
        out = np.zeros(ulen, dtype=np.uint8)
        for i in range(N):
            lane = _uncompress_into(buf[pos:stripe_end], ulens[i])
            if lane is None or len(lane) != ulens[i]:
                return None
            out[i::N] = lane
            pos += clens[i]
        return out

    order = buf[0]
    pos = 1
    do_pack = order & X_PACK
    do_rle = order & X_RLE
    do_cat = order & X_CAT
    no_size = order & X_NOSZ
    do_ext = order & X_EXT
    order &= 3

    if not no_size:
        osz, pos = varint.get_uint(buf, pos, end)
    else:
        if out_size is None:
            return None
        osz = out_size
    if osz >= 2**31 - 1:
        return None
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

    if end - pos:
        if do_cat:
            if tmp1_size > end - pos or (out_size is not None and tmp1_size > out_size):
                return None
            tmp1 = np.frombuffer(bytes(buf[pos:pos + tmp1_size]), dtype=np.uint8)
        elif do_ext:
            try:
                blob = bz2.decompress(bytes(buf[pos:end]))
            except OSError:
                return None
            if len(blob) != tmp1_size:
                return None
            tmp1 = np.frombuffer(blob, dtype=np.uint8)
        elif _use_native():
            tmp1 = _native.arith_dec(bytes(buf[pos:end]), tmp1_size,
                                     order == 1, bool(do_rle))
        elif do_rle:
            tmp1 = _dec_rle(buf, pos, end, tmp1_size, order == 1)
        else:
            tmp1 = _dec_o1(buf, pos, end, tmp1_size) if order == 1 else _dec_o0(buf, pos, end, tmp1_size)
        if tmp1 is None:
            return None
    else:
        tmp1 = np.zeros(0, dtype=np.uint8)
        tmp1_size = 0

    if do_pack:
        if vpb == 1:
            unpacked_sz = len(tmp1)
        out = packmod.unpack(tmp1, unpacked_sz, vpb, pmap)
        if out is None:
            return None
        return out

    return tmp1
