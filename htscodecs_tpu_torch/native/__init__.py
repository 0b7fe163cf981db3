"""Native host kernels: build-on-demand ctypes bindings.

Compiles ``hostkernels.c`` with the system compiler at first use into
the package's ``_build/`` directory (keyed by content hash, so a stale
library is never loaded) and exposes numpy-friendly wrappers for the
functions the batched rANS 4x16 and 4x8 paths, the adaptive codecs
(arith_dynamic, fqzcomp_qual) and the name codec (tokenise_name3) call.  Without a compiler
``available()`` is False and the callers use the pure-Python oracle
engines.

This is the port's own copy of the host runtime: the library name and
the build directory differ from the JAX package's, and nothing is
shared between the two at run time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "hostkernels.c"
BUILD_DIR = _HERE.parent / "_build"

_lib = None
_lib_lock = threading.Lock()
build_seconds = 0.0     # wall time of the build, when this process built

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i64 = ctypes.c_int64
_i32 = ctypes.c_int32
_int = ctypes.c_int


def _build() -> ctypes.CDLL | None:
    global build_seconds
    if not _SRC.exists():
        return None
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libhtshost_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # per-process tmp name: two processes racing the first build
        # each compile privately, then atomically publish via replace
        tmp = BUILD_DIR / f".host_{tag}.{os.getpid()}.so"
        t0 = time.perf_counter()
        for cc in ("gcc", "cc", "clang"):
            try:
                r = subprocess.run(
                    [cc, "-O3", "-march=native", "-shared", "-fPIC",
                     "-o", str(tmp), str(_SRC), "-lm"],
                    capture_output=True, timeout=300,
                )
            except (OSError, subprocess.TimeoutExpired):
                continue
            if r.returncode == 0:
                tmp.replace(so)
                build_seconds = time.perf_counter() - t0
                break
        else:
            return None
    try:
        return ctypes.CDLL(str(so))
    except OSError:
        return None


def _sig(fn, res, args):
    fn.restype = res
    fn.argtypes = args


def get_lib():
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                lib = _build()
                if lib is not None:
                    _declare(lib)
                _lib = lib if lib is not None else False
    return _lib or None


def _declare(lib) -> None:
    for nm in ("r16_enc_o0", "r16_enc_o1", "r16_dec_o0", "r16_dec_o1"):
        _sig(getattr(lib, nm), _i64, [_u8p, _i64, _u8p, _i64])
    _sig(lib.r16_build_tables_o0, _i64,
         [_u8p, _i64, _u8p, _i64, _u32p, _u32p])
    _sig(lib.r16_build_tables_o1, _i64,
         [_u8p, _i64, _u8p, _i64, _u32p, _u32p, _i32p])
    _sig(lib.r16_parse_tables_o0, _i64, [_u8p, _i64, _u8p, _u16p, _u16p])
    _sig(lib.r16_parse_tables_o1, _i64,
         [_u8p, _i64, _u8p, _u16p, _u16p, _i32p])
    _sig(lib.r16_gather_params_o1, _i64,
         [_u8p, _i64, _u32p, _u32p, _u16p, _u16p])
    _sig(lib.r16_build_tables_o1_dense, _i64,
         [_u8p, _i64, _u8p, _i64, _u8p, _i32p, _i32, _i32p, _i32p])
    _sig(lib.r16_parse_tables_o1_dense, _i64,
         [_u8p, _i64, _u8p, _i32p, _i32, _i32p, _i32p])
    _sig(lib.r16_serialize_o1_dense_batch, _i64,
         [_u8p, _i32p, _u16p, _i32p, _i32, _i32, _u8p, _i64, _i64p])
    _sig(lib.r16_serialize_o1_sparse12_batch, _i64,
         [_u8p, _i32p, _u8p, _u8p, _i32p, _i32, _i32, _i32, _i32, _u8p,
          _i64, _i64p])
    _sig(lib.r16_serialize_o0_batch, _i64,
         [_u16p, _i32, _u8p, _i64, _i64p])
    _sig(lib.r16_compress_wrapped, _i64, [_u8p, _i64, _i32, _u8p, _i64])
    for nm in ("r8_build_tables_o0_dense", "r8_build_tables_o1_dense"):
        _sig(getattr(lib, nm), _i64,
             [_u8p, _i64, _u8p, _i64, _u8p, _i32p, _i32, _i32p])
    for nm in ("arith_enc_o0", "arith_enc_o1", "arith_enc_o0_rle",
               "arith_enc_o1_rle", "arith_dec_o0", "arith_dec_o1",
               "arith_dec_o0_rle", "arith_dec_o1_rle"):
        _sig(getattr(lib, nm), _i64, [_u8p, _i64, _u8p, _i64])
    _sig(lib.tok3_tokenize, _i64,
         [_u8p, _i64p, _i64p, _i64, _u8p, _i64, _i64p, _i32p])
    _sig(lib.tok3_detokenize, _i64,
         [_u8p, _i64p, _i64p, _i32, _i64, _u8p, _i64])
    _sig(lib.fqz_stats1, _i64,
         [_u8p, _i64, _i64p, _i64p, _i64, _i64, _u8p, _i64p, _i64p, _i64p,
          _i64p])
    _sig(lib.fqz_stats2, _i64, [_u8p, _i64, _i64p, _i64p, _i64, _u8p, _i64p])
    # data, n, lens, flags, nrec, gflags, nparam, max_sel, max_sym, stab,
    # pm_ints, qmaps, qtabs, ptabs, dtabs: the arguments fqz_enc,
    # fqz_enc_replay and (from gflags on) fqz_dec share
    _gp = [_int, _int, _int, _int, _u8p] + [_u32p] * 5
    _sig(lib.fqz_enc, _i64,
         [_u8p, _i64, _u32p, _u32p, _i64] + _gp + [_u8p, _i64])
    _sig(lib.fqz_enc_replay, _i64,
         [_u8p, _i64, _u32p, _u32p, _i64] + _gp + [_u16p] * 3 + [_i64])
    _sig(lib.fqz_dec, _i64,
         [_u8p, _i64, _i64] + _gp + [_u8p, _u32p, _u8p, _i64])


def available() -> bool:
    return get_lib() is not None


def _u8(arr) -> tuple:
    a = np.ascontiguousarray(arr, dtype=np.uint8)
    return a, a.ctypes.data_as(_u8p)


def _coder(fn_name: str, data, cap: int, trim: bool):
    a, ap = _u8(data)
    out = np.empty(cap, dtype=np.uint8)
    r = getattr(get_lib(), fn_name)(ap, len(a), out.ctypes.data_as(_u8p), cap)
    if r < 0:
        return None
    return out[:r].tobytes() if trim else out


def enc_o0(data: np.ndarray) -> bytes | None:
    """Full order-0 block (freq header + payload)."""
    return _coder("r16_enc_o0", data, int(1.1 * len(data) + 4096), True)


def enc_o1(data: np.ndarray) -> bytes | None:
    return _coder("r16_enc_o1", data,
                  int(1.1 * len(data) + 257 * 257 * 3 + 4096), True)


def dec_o0(blob, out_sz: int) -> np.ndarray | None:
    return _coder("r16_dec_o0", np.frombuffer(bytes(blob), np.uint8),
                  out_sz, False)


def dec_o1(blob, out_sz: int) -> np.ndarray | None:
    return _coder("r16_dec_o1", np.frombuffer(bytes(blob), np.uint8),
                  out_sz, False)


def build_tables_o0(data: np.ndarray):
    """Returns (header bytes, starts (256,) u32, freqs (256,) u32)."""
    lib = get_lib()
    a, ap = _u8(data)
    hdr = np.empty(257 * 3 + 16, dtype=np.uint8)
    st = np.empty(256, dtype=np.uint32)
    fr = np.empty(256, dtype=np.uint32)
    hl = lib.r16_build_tables_o0(
        ap, len(a), hdr.ctypes.data_as(_u8p), len(hdr),
        st.ctypes.data_as(_u32p), fr.ctypes.data_as(_u32p))
    if hl < 0:
        return None
    return hdr[:hl].tobytes(), st, fr


def build_tables_o1(data: np.ndarray):
    """Order-1 table build over all 256 contexts.  Returns (header
    bytes, starts (256,256) u32, freqs (256,256) u32, shift) or None."""
    lib = get_lib()
    a, ap = _u8(data)
    hdr = np.empty(257 * 257 * 3 + 64, dtype=np.uint8)
    st = np.empty((256, 256), dtype=np.uint32)
    fr = np.empty((256, 256), dtype=np.uint32)
    sh = _i32(0)
    hl = lib.r16_build_tables_o1(
        ap, len(a), hdr.ctypes.data_as(_u8p), len(hdr),
        st.ctypes.data_as(_u32p), fr.ctypes.data_as(_u32p),
        ctypes.byref(sh))
    if hl < 0:
        return None
    return hdr[:hl].tobytes(), st, fr, int(sh.value)


def parse_tables_o1(blob):
    """Order-1 table parse.  Returns (payload offset, sfb (256, 1<<shift)
    u8 slot -> symbol per context, f2d (256,256) u16 freqs, b2d
    (256,256) u16 bases, shift) or None."""
    lib = get_lib()
    a, ap = _u8(np.frombuffer(bytes(blob), dtype=np.uint8))
    sfb = np.empty(256 << 12, dtype=np.uint8)
    f2d = np.empty(65536, dtype=np.uint16)
    b2d = np.empty(65536, dtype=np.uint16)
    sh = _i32(0)
    off = lib.r16_parse_tables_o1(
        ap, len(a), sfb.ctypes.data_as(_u8p), f2d.ctypes.data_as(_u16p),
        b2d.ctypes.data_as(_u16p), ctypes.byref(sh))
    if off < 0:
        return None
    shift = int(sh.value)
    return (int(off), sfb[:256 << shift].reshape(256, 1 << shift),
            f2d.reshape(256, 256), b2d.reshape(256, 256), shift)


def gather_params_o1(data: np.ndarray, starts: np.ndarray, freqs: np.ndarray):
    """Per-symbol (start, freq) u16 order-1 coding parameters in the v1
    engine's processing order (``ops/rans_jax.py``: quarter steps
    k = q-2..0 with states 3..0, then the four context-0 leaders).
    Needs len(data) % 4 == 0 and len(data) >= 8.  Returns (st (K,4),
    fr (K,4)) u16 or None."""
    lib = get_lib()
    a, ap = _u8(data)
    n = len(a)
    st32 = np.ascontiguousarray(starts, dtype=np.uint32)
    fr32 = np.ascontiguousarray(freqs, dtype=np.uint32)
    so = np.empty(n, dtype=np.uint16)
    fo = np.empty(n, dtype=np.uint16)
    w = lib.r16_gather_params_o1(
        ap, n, st32.ctypes.data_as(_u32p), fr32.ctypes.data_as(_u32p),
        so.ctypes.data_as(_u16p), fo.ctypes.data_as(_u16p))
    if w < 0:
        return None
    return so.reshape(-1, 4), fo.reshape(-1, 4)


_TLBUF = threading.local()


def _dense_bufs(max_a: int):
    """Per-thread scratch for the dense table builders (a fresh 200 KB
    np.empty per call costs more than the C work at small blocks)."""
    b = getattr(_TLBUF, "bufs", None)
    if b is None or b[3] < max_a:
        # worst-case header: alphabet + per-row freq deltas; the C side
        # compresses anything over 1000 B, but budget the raw size (the
        # 4x8 order-1 build asks for max_a + 2 rows of 1028 bytes)
        hdr = np.empty(max(257 * 257 * 3, (max_a + 2) * 1028) + 64,
                       dtype=np.uint8)
        alpha = np.empty(max_a, dtype=np.uint8)
        packed = np.empty(max_a * max_a, dtype=np.int32)
        b = (hdr, alpha, packed, max_a)
        _TLBUF.bufs = b
    return b


def build_tables_o1_dense(data: np.ndarray, max_a: int = 96):
    """Dense order-1 table build for the batched engines.

    Returns (header bytes, alpha (a,) u8, packed (a,a) i32, shift) or
    None (error / alphabet wider than max_a -> caller falls back)."""
    lib = get_lib()
    a, ap = _u8(data)
    hdr, alpha, packed, _ = _dense_bufs(max_a)
    na = _i32(0)
    sh = _i32(0)
    hl = lib.r16_build_tables_o1_dense(
        ap, len(a), hdr.ctypes.data_as(_u8p), len(hdr),
        alpha.ctypes.data_as(_u8p), packed.ctypes.data_as(_i32p),
        max_a, ctypes.byref(na), ctypes.byref(sh))
    if hl < 0:
        return None
    n = na.value
    return (hdr[:hl].tobytes(), alpha[:n].copy(),
            packed[:n * n].reshape(n, n).copy(), int(sh.value))


def r8_build_tables_dense(data: np.ndarray, order: int, max_a: int = 96):
    """Dense rANS 4x8 table build (CRAM 3.0) for the batched engines.

    Returns (serialised table bytes, alpha (a,) u8, packed i32 —
    (a,) for order 0, (a,a) for order 1) or None."""
    lib = get_lib()
    a, ap = _u8(data)
    hdr, alpha, packed, _ = _dense_bufs(max_a)
    na = _i32(0)
    fn = (lib.r8_build_tables_o1_dense if order
          else lib.r8_build_tables_o0_dense)
    tl = fn(ap, len(a), hdr.ctypes.data_as(_u8p), len(hdr),
            alpha.ctypes.data_as(_u8p), packed.ctypes.data_as(_i32p),
            max_a, ctypes.byref(na))
    if tl < 0:
        return None
    n = na.value
    pk = (packed[:n * n].reshape(n, n).copy() if order
          else packed[:n].copy())
    return hdr[:tl].tobytes(), alpha[:n].copy(), pk


def parse_tables_o1_dense(blob, max_a: int = 96):
    """Dense order-1 table parse for the batched decoder.

    Returns (payload offset, alpha (a,) u8, packed (a,a) i32, shift)
    or None."""
    lib = get_lib()
    a, ap = _u8(np.frombuffer(bytes(blob), dtype=np.uint8))
    _hdr, alpha, packed, _ = _dense_bufs(max_a)
    na = _i32(0)
    sh = _i32(0)
    off = lib.r16_parse_tables_o1_dense(
        ap, len(a), alpha.ctypes.data_as(_u8p),
        packed.ctypes.data_as(_i32p), max_a,
        ctypes.byref(na), ctypes.byref(sh))
    if off < 0:
        return None
    n = na.value
    return (int(off), alpha[:n].copy(),
            packed[:n * n].reshape(n, n).copy(), int(sh.value))


def parse_tables_o0(blob):
    """Returns (header length, ssym u8[4096], sfreq u16, sbase u16)."""
    lib = get_lib()
    a, ap = _u8(np.frombuffer(bytes(blob), dtype=np.uint8))
    ssym = np.empty(4096, dtype=np.uint8)
    sfreq = np.empty(4096, dtype=np.uint16)
    sbase = np.empty(4096, dtype=np.uint16)
    hl = lib.r16_parse_tables_o0(
        ap, len(a), ssym.ctypes.data_as(_u8p),
        sfreq.ctypes.data_as(_u16p), sbase.ctypes.data_as(_u16p))
    if hl < 0:
        return None
    return int(hl), ssym, sfreq, sbase


def compress_wrapped(data: np.ndarray, order: int):
    """Full non-STRIPE transform-wrapper encode (pack/RLE/framing/CAT)
    in one native call; byte-identical to models/rans4x16.compress.
    Returns stream bytes or None (caller keeps the Python path)."""
    lib = get_lib()
    if lib is None:
        return None
    a, ap = _u8(data)
    n = len(a)
    cap = 3 * n + 2048 + 257 * 257 * 3
    buf = np.empty(cap, np.uint8)
    r = lib.r16_compress_wrapped(ap, n, order, buf.ctypes.data_as(_u8p), cap)
    if r < 0:
        return None
    return buf[:r].tobytes()


def _split_arena(arena: np.ndarray, offs: np.ndarray) -> list[bytes]:
    ab = arena.tobytes()
    return [ab[offs[b]:offs[b + 1]] for b in range(len(offs) - 1)]


def serialize_o1_dense_batch(alphas: np.ndarray, asz: np.ndarray,
                             freqs: np.ndarray, shifts: np.ndarray):
    """Batched order-1 header serialisation from pre-built tables.

    alphas (B, Apad) u8, asz (B,) i32, freqs (B, Apad, Apad) u16
    pre-shift normalised rows, shifts (B,) i32.  Returns a list of B
    header byte strings (byte-identical to build_tables_o1_dense's)
    or None."""
    lib = get_lib()
    if lib is None:
        return None
    B, Apad = alphas.shape
    al = np.ascontiguousarray(alphas, np.uint8)
    az = np.ascontiguousarray(asz, np.int32)
    fr = np.ascontiguousarray(freqs, np.uint16)
    sh = np.ascontiguousarray(shifts, np.int32)
    offs = np.empty(B + 1, np.int64)
    cap = int(B) * (3 * Apad * Apad + 3 * Apad + 80) + 64
    arena = np.empty(cap, np.uint8)
    r = lib.r16_serialize_o1_dense_batch(
        al.ctypes.data_as(_u8p), az.ctypes.data_as(_i32p),
        fr.ctypes.data_as(_u16p), sh.ctypes.data_as(_i32p),
        B, Apad, arena.ctypes.data_as(_u8p), cap, offs.ctypes.data_as(_i64p))
    if r < 0:
        return None
    return _split_arena(arena, offs)


# the errors of r16_serialize_o1_sparse12_batch that name a fault of
# its input (the others, -1 and -2, give None as the dense serialiser's)
_SPARSE12_ERRORS = {
    -3: "value prefix narrower than the batch's max nonzero count",
    -4: "context row total is not a power of two <= 4096",
    -5: "bitmap bit set past the Apad*Apad table entries (pad bit set)",
}


def serialize_o1_sparse12_batch(alphas: np.ndarray, asz: np.ndarray,
                                bitmap: np.ndarray, vals12: np.ndarray,
                                shifts: np.ndarray):
    """Batched order-1 header serialisation from the sparse 12-bit
    transport (``ops/tables_v2.pack_freqs_sparse12``): presence bitmap
    (B, ceil(Apad^2/8)) u8 and row-compacted packed values (B, VW) u8,
    where VW may be any prefix wide enough for the batch's max nonzero
    count.  Byte-identical to ``serialize_o1_dense_batch`` on the
    unpacked frequencies.  Raises ValueError naming the fault for a
    prefix too narrow, a row that is not normalised or a pad bit set;
    returns a list of B header byte strings, or None."""
    lib = get_lib()
    if lib is None:
        return None
    B, Apad = alphas.shape
    al = np.ascontiguousarray(alphas, np.uint8)
    az = np.ascontiguousarray(asz, np.int32)
    bm = np.ascontiguousarray(bitmap, np.uint8)
    vv = np.ascontiguousarray(vals12, np.uint8)
    sh = np.ascontiguousarray(shifts, np.int32)
    offs = np.empty(B + 1, np.int64)
    cap = int(B) * (3 * Apad * Apad + 3 * Apad + 80) + 64
    arena = np.empty(cap, np.uint8)
    r = lib.r16_serialize_o1_sparse12_batch(
        al.ctypes.data_as(_u8p), az.ctypes.data_as(_i32p),
        bm.ctypes.data_as(_u8p), vv.ctypes.data_as(_u8p),
        sh.ctypes.data_as(_i32p), B, Apad, bm.shape[1], vv.shape[1],
        arena.ctypes.data_as(_u8p), cap, offs.ctypes.data_as(_i64p))
    if r in _SPARSE12_ERRORS:
        raise ValueError(f"serialize_o1_sparse12: {_SPARSE12_ERRORS[r]}")
    if r < 0:
        return None
    return _split_arena(arena, offs)


def serialize_o0_batch(freqs: np.ndarray):
    """Batched order-0 header serialisation.  freqs (B, 256) u16
    pre-shift normalised counts.  Returns list of B header byte
    strings (byte-identical to build_tables_o0's) or None."""
    lib = get_lib()
    if lib is None:
        return None
    B = freqs.shape[0]
    fr = np.ascontiguousarray(freqs, np.uint16)
    offs = np.empty(B + 1, np.int64)
    cap = int(B) * (257 * 3 + 16) + 64
    arena = np.empty(cap, np.uint8)
    r = lib.r16_serialize_o0_batch(
        fr.ctypes.data_as(_u16p), B, arena.ctypes.data_as(_u8p), cap,
        offs.ctypes.data_as(_i64p))
    if r < 0:
        return None
    return _split_arena(arena, offs)


# ---------------------------------------------------------------------
# tokenise_name3: the name tokeniser and the token replay

MAX_TBLOCKS = 128 * 16


def tok3_tokenize(blk: bytes, starts: np.ndarray, lens: np.ndarray):
    """Native name tokeniser.  Returns ({tid: descriptor bytes},
    max_tok) or None (unsupported input -> Python path)."""
    lib = get_lib()
    a, ap = _u8(np.frombuffer(blk, dtype=np.uint8))
    st = np.ascontiguousarray(starts, np.int64)
    ln = np.ascontiguousarray(lens, np.int64)
    nreads = len(st)
    dlens = np.zeros(MAX_TBLOCKS, np.int64)
    mt = _i32(0)
    cap = 2 * len(a) + 24 * nreads + 65536
    for _ in range(2):
        arena = np.empty(cap, np.uint8)
        r = lib.tok3_tokenize(
            ap, st.ctypes.data_as(_i64p), ln.ctypes.data_as(_i64p), nreads,
            arena.ctypes.data_as(_u8p), cap, dlens.ctypes.data_as(_i64p),
            ctypes.byref(mt))
        if r >= 0:
            desc = {}
            off = 0
            for t in range(MAX_TBLOCKS):
                if dlens[t]:
                    desc[t] = arena[off:off + dlens[t]].tobytes()
                    off += dlens[t]
            return desc, int(mt.value)
        if r <= -10:                 # arena too small: exact size given
            cap = int(-r - 10)
            continue
        return None
    return None


def tok3_detokenize(desc: dict, max_tok: int, nreads: int, out_cap: int):
    """Native token replay.  desc: {tid: decompressed bytes}.
    Returns the NUL-separated names blob or None (corrupt / Python
    path)."""
    lib = get_lib()
    doffs = np.full(MAX_TBLOCKS, 0, np.int64)
    dls = np.full(MAX_TBLOCKS, -1, np.int64)
    total = sum(len(b) for b in desc.values())
    arena = np.empty(max(total, 1), np.uint8)
    off = 0
    for t, b in desc.items():
        doffs[t] = off
        dls[t] = len(b)
        arena[off:off + len(b)] = np.frombuffer(b, np.uint8)
        off += len(b)
    out = np.empty(out_cap, np.uint8)
    r = lib.tok3_detokenize(
        arena.ctypes.data_as(_u8p), doffs.ctypes.data_as(_i64p),
        dls.ctypes.data_as(_i64p), max_tok, nreads,
        out.ctypes.data_as(_u8p), out_cap)
    if r < 0:
        return None
    return out[:r].tobytes()


# ---------------------------------------------------------------------
# adaptive codecs: arith_dynamic and fqzcomp_qual

def arith_enc(data, order1: bool, rle: bool) -> bytes | None:
    """arith_dynamic entropy body (max-symbol byte + range-coded
    stream) of one block; ``rle`` selects the run-model variant."""
    a = data if isinstance(data, np.ndarray) \
        else np.frombuffer(bytes(data), np.uint8)
    nm = f"arith_enc_o{1 if order1 else 0}{'_rle' if rle else ''}"
    return _coder(nm, a, int(len(a) * 1.1 + 4096), True)


def arith_dec(blob, out_sz: int, order1: bool, rle: bool) -> np.ndarray | None:
    nm = f"arith_dec_o{1 if order1 else 0}{'_rle' if rle else ''}"
    return _coder(nm, np.frombuffer(bytes(blob), np.uint8), out_sz, False)


def _u32(a) -> tuple:
    a = np.ascontiguousarray(a, dtype=np.uint32)
    return a, a.ctypes.data_as(_u32p)


def _fqz_params(gp, packed) -> tuple:
    """(keep-alive arrays, ctypes arguments) of a parameter set as
    ``models.fqz._pack_gp`` flattens it."""
    pm_ints, qmaps, qtabs, ptabs, dtabs, stab = packed
    st, stp = _u8(stab)
    keep = [st]
    ptrs = []
    for a in (pm_ints, qmaps, qtabs, ptabs, dtabs):
        arr, ptr = _u32(a)
        keep.append(arr)
        ptrs.append(ptr)
    return keep, (gp.gflags, gp.nparam, gp.max_sel, gp.max_sym, stp, *ptrs)


def fqz_enc_scan(data, lens, flags, gp, packed) -> bytes | None:
    """Range-coded fqz payload (no varint/params header)."""
    lib = get_lib()
    a, ap = _u8(data)
    ln, lnp = _u32(lens)
    fl, flp = _u32(flags)
    _keep, gargs = _fqz_params(gp, packed)
    cap = int(len(a) * 1.1 + 100000)
    out = np.empty(cap, np.uint8)
    r = lib.fqz_enc(ap, len(a), lnp, flp, len(ln), *gargs,
                    out.ctypes.data_as(_u8p), cap)
    return out[:r].tobytes() if r >= 0 else None


def fqz_enc_replay(data, lens, flags, gp, packed):
    """Model-replay pass: per-event (acc, f, tot) u16 triples in exact
    stream order (sel/len/rev/dup record events included), no range
    coder: the input of the ``rc_enc`` kernel (ops/rc_vmem.py).
    Returns (acc, f, tot) arrays trimmed to the event count, or None."""
    lib = get_lib()
    if lib is None:
        return None
    a, ap = _u8(data)
    ln, lnp = _u32(lens)
    fl, flp = _u32(flags)
    _keep, gargs = _fqz_params(gp, packed)
    cap_ev = int(len(a) + 7 * len(ln) + 16)
    acc, f, tot = (np.empty(cap_ev, np.uint16) for _ in range(3))
    r = lib.fqz_enc_replay(
        ap, len(a), lnp, flp, len(ln), *gargs,
        acc.ctypes.data_as(_u16p), f.ctypes.data_as(_u16p),
        tot.ctypes.data_as(_u16p), cap_ev)
    if r < 0:
        return None
    return acc[:r], f[:r], tot[:r]


def fqz_dec_scan(blob, total, gp, packed):
    """Returns (out u8 array, rec_lens, rec_revs, nrec) or None."""
    lib = get_lib()
    a, ap = _u8(np.frombuffer(bytes(blob), dtype=np.uint8))
    _keep, gargs = _fqz_params(gp, packed)
    out = np.zeros(total, np.uint8)
    max_rec = total + 1
    rec_lens = np.zeros(max_rec, np.uint32)
    rec_revs = np.zeros(max_rec, np.uint8)
    r = lib.fqz_dec(ap, len(a), total, *gargs, out.ctypes.data_as(_u8p),
                    rec_lens.ctypes.data_as(_u32p),
                    rec_revs.ctypes.data_as(_u8p), max_rec)
    if r < 0:
        return None
    return out, rec_lens, rec_revs, int(r)


def fqz_stats1(data: np.ndarray, st: np.ndarray, ls: np.ndarray,
               d2f: np.ndarray, nrec: int | None = None):
    """One-pass fqz picker statistics: (pos,sym) histograms (all /
    read-2), per-segment byte sums, adjacent-duplicate count (real
    records only: a trailing tail pseudo-segment never dedups).
    Returns (hb (128,256) i64, h2, sums (nseg,) i64, dedup) or None."""
    lib = get_lib()
    if lib is None:
        return None
    a, ap = _u8(data)
    nseg = len(st)
    if nrec is None:
        nrec = nseg
    st64 = np.ascontiguousarray(st, np.int64)
    ls64 = np.ascontiguousarray(ls, np.int64)
    df, dfp = _u8(d2f)
    hb = np.empty((128, 256), np.int64)
    h2 = np.empty((128, 256), np.int64)
    sums = np.empty(max(nseg, 1), np.int64)
    dd = np.zeros(1, np.int64)
    r = lib.fqz_stats1(
        ap, len(a), st64.ctypes.data_as(_i64p), ls64.ctypes.data_as(_i64p),
        nseg, nrec, dfp, hb.ctypes.data_as(_i64p), h2.ctypes.data_as(_i64p),
        sums.ctypes.data_as(_i64p), dd.ctypes.data_as(_i64p))
    if r < 0:
        return None
    return hb, h2, sums[:nseg], int(dd[0])


def fqz_stats2(data: np.ndarray, st: np.ndarray, ls: np.ndarray,
               qb4: np.ndarray):
    """Selector-bin (pos,sym) histogram: k4 (4,128,256) i64 or None."""
    lib = get_lib()
    if lib is None:
        return None
    a, ap = _u8(data)
    st64 = np.ascontiguousarray(st, np.int64)
    ls64 = np.ascontiguousarray(ls, np.int64)
    qb, qbp = _u8(qb4)
    k4 = np.empty((4, 128, 256), np.int64)
    r = lib.fqz_stats2(
        ap, len(a), st64.ctypes.data_as(_i64p), ls64.ctypes.data_as(_i64p),
        len(st), qbp, k4.ctypes.data_as(_i64p))
    if r < 0:
        return None
    return k4
