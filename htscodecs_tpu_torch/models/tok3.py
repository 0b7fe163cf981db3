"""tokenise_name3 read-name codec (CRAM 3.1).

Counterpart of ``htscodecs_tpu/models/tok3.py``.  Bitstream parity
with htscodecs' ``tokenise_name3.c``: names are diffed against the most
similar previous name (found via a trie with platform-specific prefix
heuristics), split into typed column tokens (ALPHA / CHAR / DIGITS /
DIGITS0 / deltas / MATCH), and each (token#, type) pair's byte stream
is compressed independently with the rANS 4x16 or arith_dynamic engines
(level-dependent brute-force method search).

Frame: u32-LE last_start, u32-LE nreads, u8 use_arith, then per
non-empty descriptor a type byte (|128 new token#, |64 dup-of-earlier
pointer) followed by varint-framed compressed bytes.

The tokeniser itself is string processing and stays on the host (the
native C tokeniser, or the Python one below when that is off or
declines); the entropy work (up to 2048 small descriptor blocks) goes
through ``models.batch``: on encode every (descriptor,
candidate-method) payload of the rANS backend is an entropy job of the
batch layer's shape groups when ``engine`` is not "host", on decode
every rANS descriptor stream is one block of ``uncompress_blocks``.
Both entry points take ``device`` (default ``"cuda"``; with no card
that default raises, ``device="cpu"`` runs the plain PyTorch versions).
"""

from __future__ import annotations

import os as _os

import numpy as np

from . import arith as arithmod
from . import batch as batchmod
from . import rans4x16 as ransmod
from .. import native as _native
from ..ops import rans_v2
from ..utils import varint


def _use_native() -> bool:
    """The native tokeniser and token replay, unless switched off by the
    environment.  Asked at call time: the C library is built at first
    use, not when this module is imported."""
    return (_os.environ.get("HTSCODECS_TORCH_NATIVE", "1") != "0"
            and _native.available())


# Token types (tokenise_name3.c:125-126)
N_TYPE, N_ALPHA, N_CHAR, N_DIGITS0, N_DZLEN, N_DUP, N_DIFF, \
    N_DIGITS, N_DDELTA, N_DDELTA0, N_MATCH, N_NOP, N_END = range(13)

MAX_TOKENS = 128
MAX_TBLOCKS = MAX_TOKENS << 4
MAX_NAMES = 10_000_000

_ALPHA = frozenset(range(ord("A"), ord("Z") + 1)) | frozenset(range(ord("a"), ord("z") + 1))
_DIGIT = frozenset(range(ord("0"), ord("9") + 1))
_PUNCT = (frozenset(range(33, 48)) | frozenset(range(58, 65))
          | frozenset(range(91, 97)) | frozenset(range(123, 127)))
_ALPHA_OR_PUNCT = _ALPHA | _PUNCT


class _Trie:
    __slots__ = ("n", "next")

    def __init__(self, n: int):
        self.n = n
        self.next: dict[int, _Trie] = {}


class _Ctx:
    """Encoder/decoder context: per-name token history plus the
    descriptor streams keyed by (token# << 4) | type."""

    def __init__(self, nreads: int):
        self.counter = 0
        self.head = _Trie(0)
        # lc[i] = [name_bytes, ntok, types, ints, strs]
        self.lc: list = [None] * (nreads + 1)
        self.lc[0] = [b"", 0, [0] * MAX_TOKENS, [0] * MAX_TOKENS, [0] * MAX_TOKENS]
        self.desc: dict[int, bytearray] = {}
        self.dcount = [0] * MAX_TOKENS
        self.icount = [0] * MAX_TOKENS
        self.max_tok = 1

    def put(self, tid: int, b) -> None:
        d = self.desc.get(tid)
        if d is None:
            d = self.desc[tid] = bytearray()
        if isinstance(b, int):
            d.append(b)
        else:
            d.extend(b)


def _build_trie(ctx: _Ctx, name: bytes, n: int) -> None:
    t = ctx.head
    for c in name:
        if c & 0x80:
            raise ValueError("8-bit name bytes unsupported")
        x = t.next.get(c)
        if x is None:
            x = _Trie(n)
            t.next[c] = x
        t = x


def _search_trie(ctx: _Ctx, name: bytes, n: int):
    """Returns (pnum, exact, is_fixed, fixed_len) — the most similar
    previous name via trie walk with per-platform prefix heuristics
    (tokenise_name3.c:620-712)."""
    length = len(name)
    exact = 0
    fixed_len = 0
    is_fixed = 0

    if length and name[0] == ord("@"):
        d = name[1:]
        l = length - 1
    else:
        d = name
        l = length
    f = 1 if length and name[0] == ord(">") else 0

    if l > 70 and d[f + 0] == ord("m") and d[7] == ord("_") and \
            d[f + 14] == ord("_") and d[f + 61] == ord("/"):
        prefix_len = 60  # PacBio
        is_fixed = 0
    elif l == 17 and d[f + 5] == ord(":") and d[f + 11] == ord(":"):
        prefix_len = 6  # IonTorrent
        fixed_len = 6
        is_fixed = 1
    elif l > 37 and d[f + 8] == ord("-") and d[f + 13] == ord("-") and \
            d[f + 18] == ord("-") and d[f + 23] == ord("-") and \
            (ord("0") <= d[f + 0] <= ord("9") or ord("a") <= d[f + 0] <= ord("f")) and \
            (ord("0") <= d[f + 35] <= ord("9") or ord("a") <= d[f + 35] <= ord("f")):
        prefix_len = 37  # ONT
        fixed_len = 37
        is_fixed = 1
    else:
        # Illumina: trim back to lane:tile:x:y
        i = 0
        while i < length and name[i] > ord(" "):
            i += 1
        colons = 0
        while i > 0 and colons < 4:
            i -= 1
            if name[i] == ord(":"):
                colons += 1
        if colons == 4:
            fixed_len = i + 1
            prefix_len = i + 1
            is_fixed = 1
        else:
            prefix_len = 2**31 - 1
            is_fixed = 0

    t = ctx.head
    from_ = -1
    p3 = -1
    i = 0
    for c in name:
        i += 1
        t = t.next[c & 127]
        from_ = t.n
        if i == prefix_len:
            p3 = t.n
        t.n = n

    exact = 1 if (n != from_ and length) else 0
    return (from_ if exact else p3), exact, is_fixed, fixed_len


def _scan_digits(name: bytes, i: int, length: int) -> tuple[int, int]:
    """Scan up to 9 digits from position i; returns (end, value)."""
    s = i
    v = 0
    while s < length and name[s] in _DIGIT and s - i < 9:
        v = v * 10 + name[s] - ord("0")
        s += 1
    return s, v


def _encode_name(ctx: _Ctx, name: bytes, mode: int = 1) -> None:
    length = len(name)
    cnum = ctx.counter
    ctx.counter += 1
    pnum, exact, is_fixed, fixed_len = _search_trie(ctx, name, cnum)
    if pnum < 0:
        pnum = cnum - 1 if cnum else 0

    plc = ctx.lc[pnum]
    if plc is None:
        # pnum == cnum (self-reference): the reference guards every use
        # with pnum < cnum, so the contents are never read.
        plc = [b"", 0, [], [], []]

    if exact and length == len(plc[0]):
        ctx.put(0 << 4, N_DUP)
        ctx.put((0 << 4) | N_DUP, (cnum - pnum).to_bytes(4, "little"))
        ctx.lc[cnum] = [name, plc[1], list(plc[2]), list(plc[3]), list(plc[4])]
        return

    ctx.put(0 << 4, N_DIFF)
    ctx.put((0 << 4) | N_DIFF, (cnum - pnum).to_bytes(4, "little"))

    types = [0] * MAX_TOKENS
    ints = [0] * MAX_TOKENS
    strs = [0] * MAX_TOKENS

    p_ntok = plc[1]
    p_types = plc[2]
    p_ints = plc[3]
    p_strs = plc[4]
    p_name = plc[0]
    usable_prev = pnum < cnum

    ntok = 1
    i = 0

    def bump_max_tok(nt):
        if nt >= ctx.max_tok:
            ctx.dcount[ctx.max_tok] = 0
            ctx.icount[ctx.max_tok] = 0
            ctx.max_tok = nt + 1

    if is_fixed:
        if ntok >= MAX_TOKENS:
            raise ValueError("too many tokens")
        bump_max_tok(ntok)
        if usable_prev and ntok < p_ntok and p_types[ntok] == N_ALPHA and \
                p_ints[ntok] == fixed_len and name[:fixed_len] == p_name[:fixed_len]:
            ctx.put(ntok << 4, N_MATCH)
        else:
            ctx.put(ntok << 4, N_ALPHA)
            ctx.put((ntok << 4) | N_ALPHA, name[:fixed_len] + b"\x00")
        ints[ntok] = fixed_len
        strs[ntok] = 0
        types[ntok] = N_ALPHA
        ntok += 1
        i = fixed_len

    while i < length:
        if ntok >= MAX_TOKENS:
            raise ValueError("too many tokens")
        bump_max_tok(ntok)
        c = name[i]

        as_digits0 = False
        if c in _ALPHA:
            s = i + 1
            while s < length and name[s] in _ALPHA_OR_PUNCT:
                s += 1
            if s - i == 1:
                # single-byte strings are better encoded as chars
                if usable_prev and ntok < p_ntok and p_types[ntok] == N_CHAR:
                    if c == p_ints[ntok]:
                        ctx.put(ntok << 4, N_MATCH)
                    else:
                        ctx.put(ntok << 4, N_CHAR)
                        ctx.put((ntok << 4) | N_CHAR, c)
                else:
                    ctx.put(ntok << 4, N_CHAR)
                    ctx.put((ntok << 4) | N_CHAR, c)
                ints[ntok] = c
                types[ntok] = N_CHAR
            else:
                if usable_prev and ntok < p_ntok and p_types[ntok] == N_ALPHA and \
                        s - i == p_ints[ntok] and \
                        name[i:s] == p_name[p_strs[ntok]:p_strs[ntok] + (s - i)]:
                    ctx.put(ntok << 4, N_MATCH)
                else:
                    ctx.put(ntok << 4, N_ALPHA)
                    ctx.put((ntok << 4) | N_ALPHA, name[i:s] + b"\x00")
                ints[ntok] = s - i
                strs[ntok] = i
                types[ntok] = N_ALPHA
                i = s - 1
        elif c == ord("0"):
            as_digits0 = True
        elif c in _DIGIT:
            s, v = _scan_digits(name, i, length)
            if usable_prev and ntok < p_ntok and p_types[ntok] == N_DIGITS0 and \
                    p_strs[ntok] == s - i:
                as_digits0 = True
            else:
                if usable_prev and ntok < p_ntok and p_types[ntok] == N_DIGITS:
                    d = v - p_ints[ntok]
                    if d == 0:
                        ctx.put(ntok << 4, N_MATCH)
                    elif mode == 1 and 0 <= d < 256 and \
                            (5 + ctx.dcount[ntok]) > ctx.icount[ntok]:
                        ctx.put(ntok << 4, N_DDELTA)
                        ctx.put((ntok << 4) | N_DDELTA, d)
                        ctx.dcount[ntok] += 1
                    else:
                        ctx.put(ntok << 4, N_DIGITS)
                        ctx.put((ntok << 4) | N_DIGITS, v.to_bytes(4, "little"))
                        ctx.icount[ntok] += 1
                else:
                    ctx.put(ntok << 4, N_DIGITS)
                    ctx.put((ntok << 4) | N_DIGITS, v.to_bytes(4, "little"))
                ints[ntok] = v
                types[ntok] = N_DIGITS
                i = s - 1
        else:
            if usable_prev and ntok < p_ntok and p_types[ntok] == N_CHAR:
                if c == p_ints[ntok]:
                    ctx.put(ntok << 4, N_MATCH)
                else:
                    ctx.put(ntok << 4, N_CHAR)
                    ctx.put((ntok << 4) | N_CHAR, c)
            else:
                ctx.put(ntok << 4, N_CHAR)
                ctx.put((ntok << 4) | N_CHAR, c)
            ints[ntok] = c
            types[ntok] = N_CHAR

        if as_digits0:
            # leading-zero (or fixed-width) digits: length + value
            s, v = _scan_digits(name, i, length)
            if usable_prev and ntok < p_ntok and p_types[ntok] == N_DIGITS0:
                d = v - p_ints[ntok]
                if d == 0 and p_strs[ntok] == s - i:
                    ctx.put(ntok << 4, N_MATCH)
                elif mode == 1 and 0 <= d < 256 and p_strs[ntok] == s - i:
                    ctx.put(ntok << 4, N_DDELTA0)
                    ctx.put((ntok << 4) | N_DDELTA0, d)
                else:
                    ctx.put((ntok << 4) | N_DZLEN, s - i)
                    ctx.put(ntok << 4, N_DIGITS0)
                    ctx.put((ntok << 4) | N_DIGITS0, v.to_bytes(4, "little"))
            else:
                ctx.put((ntok << 4) | N_DZLEN, s - i)
                ctx.put(ntok << 4, N_DIGITS0)
                ctx.put((ntok << 4) | N_DIGITS0, v.to_bytes(4, "little"))
            strs[ntok] = s - i  # stored length
            ints[ntok] = v
            types[ntok] = N_DIGITS0
            i = s - 1

        ntok += 1
        i += 1

    if ntok >= MAX_TOKENS:
        raise ValueError("too many tokens")
    bump_max_tok(ntok)
    ctx.put(ntok << 4, N_END)

    ctx.lc[cnum] = [name, ntok, types, ints, strs]


# ---------------------------------------------------------------------------
# Per-descriptor entropy coding

RMETHODS = [
    [0, 128],                                    # level 1
    [0, 192 + 8],                                # level 3
    [0, 128, 193 + 8],                           # level 5
    [0, 1, 129, 65, 193, 193 + 8],               # level 7
    [0, 1, 128, 129, 64, 65, 192, 193, 193 + 8], # level 9
]


def _compress_desc(data: bytes, level: int, use_arith: int) -> bytes:
    level = (level - 1) // 2
    level = max(0, min(4, level))
    enc = arithmod.compress if use_arith else ransmod.compress
    arr = np.frombuffer(data, dtype=np.uint8)
    best = None
    best_m = 0
    for m in RMETHODS[level]:
        if len(data) % 4 != 0 and (m & 8):
            continue
        blob = enc(arr, m)
        if best is None or len(blob) < len(best):
            best = blob
            best_m = m
    blob = enc(arr, best_m)  # the reference always re-encodes the winner
    out = bytearray()
    varint.put_uint(out, len(blob))
    return bytes(out) + blob


def _uncompress_desc(buf, pos: int, end: int, use_arith: int):
    """Returns (data bytes, bytes consumed incl. varint) or None."""
    clen, p2 = varint.get_uint(buf, pos, end)
    dec = arithmod._uncompress_into if use_arith else ransmod._uncompress_into
    out = dec(memoryview(bytes(buf[p2:end])), None)
    if out is None:
        return None
    return bytes(out), (p2 - pos) + clen


def _descriptor_jobs(desc: dict, order: list, level: int):
    """The rANS method search of every descriptor with its entropy
    stages deferred: returns (jobs, cands), where jobs are the batch
    layer's (data, order01) entropy jobs and cands[tid] lists
    (method, candidate) pairs for ``batch._finish``.  A method whose
    peel raises is coded whole on the host here."""
    lvl = max(0, min(4, (level - 1) // 2))
    jobs: list = []
    cands: dict[int, list] = {}
    for i in order:
        data = np.frombuffer(bytes(desc[i]), np.uint8)
        lst = []
        for m in RMETHODS[lvl]:
            if len(data) % 4 != 0 and (m & 8):
                continue
            try:
                lst.append((m, batchmod._peel_encode(data, m, jobs)))
            except ValueError:
                lst.append((m, ("done", ransmod.compress(data, m))))
        cands[i] = lst
    return jobs, cands


def _peek_ulen(buf, pos: int, end: int) -> int:
    clen, p2 = varint.get_uint(buf, pos, end)
    # skip the codec's order byte, then its stored uncompressed size
    ulen, _ = varint.get_uint(buf, p2 + 1, end)
    return ulen


def _descriptors(blk: bytes):
    """Tokenise a block of \\n or \\0 separated names: returns (desc,
    order, nreads, last_start), desc the descriptor streams {tid:
    bytearray} after the all-MATCH TYPE drop and order the tids of the
    non-empty ones, ascending (the container's order)."""
    # bytes <= '\n' (or with the top bit set, which C's signed-char
    # comparison also treats as separators) terminate names
    arr = np.frombuffer(blk, np.uint8)
    seps = np.flatnonzero((arr <= 10) | (arr >= 128))
    nreads = len(seps)
    if nreads <= 0:
        raise ValueError("no complete names in block")
    if nreads > MAX_NAMES:
        raise ValueError("name codec caps at 10 million records")

    starts_a = np.empty(nreads, np.int64)
    starts_a[0] = 0
    starts_a[1:] = seps[:-1] + 1
    lens_a = seps - starts_a
    last_start = int(seps[-1]) + 1

    ctx = _Ctx(nreads)
    tokenized = False
    if _use_native():
        r = _native.tok3_tokenize(blk, starts_a, lens_a)
        if r is not None:
            desc_map, max_tok = r
            ctx.desc = {t: bytearray(b) for t, b in desc_map.items()}
            ctx.max_tok = max_tok
            tokenized = True
    if not tokenized:
        names = [blk[starts_a[k]:starts_a[k] + lens_a[k]]
                 for k in range(nreads)]
        for n, name in enumerate(names):
            _build_trie(ctx, name, n)
        for name in names:
            _encode_name(ctx, name, 1)

    # Drop all-MATCH TYPE streams when other streams for that token
    # exist (regenerable on decode).
    for tnum in range(ctx.max_tok):
        tid = tnum << 4
        d = ctx.desc.get(tid)
        if not d:
            continue
        da = np.frombuffer(bytes(d), np.uint8)
        if (da[1:] == N_MATCH).all():
            if any(ctx.desc.get(tid + k) for k in range(1, 16)):
                del ctx.desc[tid]
    order = [i for i in range(ctx.max_tok * 16) if ctx.desc.get(i)]
    return ctx.desc, order, nreads, last_start


# ---------------------------------------------------------------------------
# Public API

def encode_names(blk: bytes, level: int = 9, use_arith: bool = False,
                 return_last_start: bool = False,
                 engine: str | None = None, device="cuda"):
    """Compress a block of \\n or \\0 separated read names.

    Only whole (terminated) names are encoded; the offset of the first
    unterminated byte is returned when ``return_last_start`` is set.

    engine: "host" (default) compresses descriptors with the native
    scalar coders; "auto"/"device" defers every (descriptor,
    candidate-method) entropy payload into models.batch's shared
    device groups — the encode twin of the batched descriptor decode.
    Streams are byte-identical either way; the default favours the
    host because descriptor groups are small (override with
    HTSCODECS_TORCH_TOK3_ENC_ENGINE).  ``device`` is the batch layer's.
    """
    dev = rans_v2.check_device(device)
    if engine is None:
        engine = _os.environ.get("HTSCODECS_TORCH_TOK3_ENC_ENGINE", "host")
    desc, order, nreads, last_start = _descriptors(bytes(blk))

    # Compress descriptors and find dups.  For the rANS backend every
    # (descriptor, candidate-method) pair defers its entropy payload
    # into models.batch's shared device groups — the encode-side twin
    # of the batched descriptor decode below (up to 2048 streams x
    # |rmethods| candidates per name block); the arith backend keeps
    # the host loop (adaptive scans favour a host core per stream).
    comp: dict[int, bytes] = {}
    dup_from: dict[int, int] = {}
    if not use_arith and order and engine != "host":
        jobs, cands = _descriptor_jobs(desc, order, level)
        res = batchmod._encode_entropy_jobs(jobs, engine, dev) if jobs else {}
        for i in order:
            data = None
            best = None
            for m, cand in cands[i]:
                s = batchmod._finish(cand, res)
                if s is None:                    # entropy group declined
                    if data is None:
                        data = np.frombuffer(bytes(desc[i]), np.uint8)
                    s = ransmod.compress(data, m)
                if best is None or len(s) < len(best):
                    best = s
            head = bytearray()
            varint.put_uint(head, len(best))
            comp[i] = bytes(head) + best
    for i in order:
        if i not in comp:
            comp[i] = _compress_desc(bytes(desc[i]), level, use_arith)
    for i in order:
        blob = comp[i]
        df = 0
        for j in order:
            if j >= i:
                break
            if len(blob) != len(comp[j]) or len(blob) <= 4:
                continue
            if blob == comp[j]:
                df = j
                break
        dup_from[i] = df

    out = bytearray()
    out += last_start.to_bytes(4, "little")
    out += nreads.to_bytes(4, "little")
    out.append(1 if use_arith else 0)
    last_tnum = -1
    for i in order:
        ttype8 = i & 15
        if (i >> 4) != last_tnum:
            ttype8 |= 128
            last_tnum = i >> 4
        if dup_from[i]:
            out.append(ttype8 | 64)
            out.append(dup_from[i] >> 4)
            out.append(dup_from[i] & 15)
        else:
            out.append(ttype8)
            out += comp[i]

    if return_last_start:
        return bytes(out), last_start
    return bytes(out)


def _append_fixed(v: int, l: int) -> bytes:
    """Fixed-width digit printer (append_uint32_fixed).  The leading
    position is v // 10^(l-1) WITHOUT range reduction, exactly as the
    reference's switch — overlong values yield ':'-style bytes."""
    if l > 9:
        l = 9  # the reference's switch tops out at 9 digits
    out = bytearray()
    for k in range(l, 0, -1):
        p = 10 ** (k - 1)
        out.append((48 + v // p) & 0xFF)
        v %= p
    return bytes(out)


def _append_var(v: int) -> bytes:
    """Variable-width printer (append_uint32_var): zero prints nothing."""
    return str(v).encode() if v else b""


def _parse_container(buf):
    """Walk a tok3 container: returns (jobs, dups, desc_buf, max_tok,
    nreads, ulen, use_arith), where jobs lists (tid, payload offset,
    clen) of every stored descriptor stream, dups (tid, earlier tid)
    pointers in stream order and desc_buf the TYPE streams regenerated
    for tokens whose all-MATCH TYPE stream the encoder dropped."""
    sz = len(buf)
    if sz < 9:
        raise ValueError("corrupt tok3 stream")
    ulen = int.from_bytes(buf[0:4], "little")
    nreads = int.from_bytes(buf[4:8], "little")
    use_arith = buf[8]
    if ulen >= 2**31 - 1024 or nreads < 0 or nreads > MAX_NAMES:
        raise ValueError("corrupt tok3 stream")

    desc_buf: dict[int, bytes] = {}
    jobs: list[tuple[int, int, int]] = []
    dups: list[tuple[int, int]] = []
    known: set[int] = set()
    max_tok = 1
    tnum = -1
    o = 9
    while o < sz:
        ttype = buf[o]
        o += 1
        if ttype & 64:
            if o + 2 >= sz:
                raise ValueError("corrupt tok3 stream")
            j = (buf[o] << 4) + buf[o + 1]
            o += 2
            if ttype & 128:
                tnum += 1
                if tnum >= MAX_TOKENS:
                    raise ValueError("corrupt tok3 stream")
                max_tok = tnum + 1
            if (ttype & 15) != 0 and (ttype & 128):
                if tnum < 0:
                    raise ValueError("corrupt tok3 stream")
                desc_buf[tnum << 4] = bytes([ttype & 15]) + bytes([N_MATCH]) * (nreads - 1)
                known.add(tnum << 4)
            if tnum < 0:
                raise ValueError("corrupt tok3 stream")
            i = (tnum << 4) | (ttype & 15)
            if j >= i or j not in known:
                raise ValueError("corrupt tok3 stream")
            dups.append((i, j))
            known.add(i)
            continue

        if ttype & 128:
            tnum += 1
            if tnum >= MAX_TOKENS:
                raise ValueError("corrupt tok3 stream")
            max_tok = tnum + 1
        if (ttype & 15) != 0 and (ttype & 128):
            if tnum < 0:
                raise ValueError("corrupt tok3 stream")
            desc_buf[tnum << 4] = bytes([ttype & 15]) + bytes([N_MATCH]) * (nreads - 1)
            known.add(tnum << 4)
        if tnum < 0:
            raise ValueError("corrupt tok3 stream")
        i = (tnum << 4) | (ttype & 15)
        if i >= MAX_TBLOCKS:
            raise ValueError("corrupt tok3 stream")
        clen, p2 = varint.get_uint(buf, o, sz)
        if p2 + clen > sz:
            raise ValueError("corrupt tok3 stream")
        jobs.append((i, p2, clen))
        known.add(i)
        o = p2 + clen
    return jobs, dups, desc_buf, max_tok, nreads, ulen, use_arith


def decode_names(buf, device="cuda") -> bytes:
    """Decompress to \\0-separated names (one trailing NUL per name).
    ``device`` is the batch layer's, for the rANS descriptor streams."""
    dev = rans_v2.check_device(device)
    buf = memoryview(bytes(buf))
    sz = len(buf)
    jobs, dups, desc_buf, max_tok, nreads, ulen, use_arith = \
        _parse_container(buf)

    # Decompress every descriptor stream in one batched call (up to
    # 2048 small blocks per name block — the natural batching axis,
    # tokenise_name3.c:1246-1300).  Arith-backed blocks stay on the
    # host coder, as in the reference.
    if use_arith:
        # the adaptive decoder reads ahead of its clen by design, so
        # each descriptor decodes against the container REMAINDER
        # (tokenise_name3.c passes in_size - o, not clen)
        for i, p2, _clen in jobs:
            r = arithmod._uncompress_into(memoryview(bytes(buf[p2:sz])), None)
            if r is None:
                raise ValueError("corrupt tok3 stream")
            desc_buf[i] = bytes(r)
    elif jobs:
        # rANS streams are self-contained: exact clen slices batch
        # without dragging the whole container into every group
        try:
            datas = batchmod.uncompress_blocks(
                [bytes(buf[p2:p2 + clen]) for _i, p2, clen in jobs],
                device=dev)
        except ValueError:
            raise ValueError("corrupt tok3 stream") from None
        for (i, _p, _c), data in zip(jobs, datas):
            desc_buf[i] = data
    # duplicate-block pointers resolve in stream order (targets are
    # always earlier blocks, tokenise_name3.c:1513-1531)
    for i, j in dups:
        if j not in desc_buf:
            raise ValueError("corrupt tok3 stream")
        desc_buf[i] = desc_buf[j]

    # Replay tokens (native when available; it returns None on corrupt
    # streams and the Python replay below re-raises precisely).
    if _use_native():
        r = _native.tok3_detokenize(
            {t: bytes(b) for t, b in desc_buf.items()},
            max_tok, nreads, ulen + 16 * (nreads + 2) + 1024)
        if r is not None:
            return r
    desc = {i: [b, 0] for i, b in desc_buf.items()}  # buf, cursor

    def get_type(ntok):
        d = desc.get(ntok << 4)
        if d is None or d[1] >= len(d[0]):
            return -1
        v = d[0][d[1]]
        d[1] += 1
        return v

    def get_bytes(tid, n):
        d = desc.get(tid)
        if d is None or d[1] + n > len(d[0]):
            return None
        v = d[0][d[1]:d[1] + n]
        d[1] += n
        return v

    def get_alpha(tid):
        d = desc.get(tid)
        if d is None or d[1] >= len(d[0]):
            return None
        e = d[0].find(0, d[1])
        if e < 0:
            e = len(d[0]) - 1  # unterminated: consume to end (bounded)
        v = d[0][d[1]:e]
        d[1] = e + 1
        return v

    lc: list = [None] * (nreads + 1)
    out = bytearray()
    counter = 0

    while True:
        cnum = counter
        if cnum >= nreads + 1:
            raise ValueError("corrupt tok3 stream")
        counter += 1
        t0 = get_type(0)
        if t0 < 0 or t0 >= max_tok * 16:
            counter -= 1
            break
        db = get_bytes(0 << 4 | t0, 4)
        if db is None:
            raise ValueError("corrupt tok3 stream")
        dist = int.from_bytes(db, "little")
        if dist > cnum:
            raise ValueError("corrupt tok3 stream")
        pnum = cnum - dist
        if pnum < 0:
            pnum = 0

        if t0 == N_DUP:
            if pnum == cnum or lc[pnum] is None:
                raise ValueError("corrupt tok3 stream")
            plc = lc[pnum]
            out += plc[0] + b"\x00"
            lc[cnum] = plc
            continue

        plc = lc[pnum] if lc[pnum] is not None else [b"", 0, [], [], []]
        name = bytearray()
        types = [0] * MAX_TOKENS
        ints = [0] * MAX_TOKENS
        strs = [0] * MAX_TOKENS
        ended = False
        for ntok in range(1, min(MAX_TOKENS, max_tok)):
            tok = get_type(ntok)
            if tok == N_CHAR:
                b = get_bytes((ntok << 4) | N_CHAR, 1)
                if b is None:
                    raise ValueError("corrupt tok3 stream")
                name += b
                types[ntok] = N_CHAR
                ints[ntok] = b[0]
            elif tok == N_ALPHA:
                a = get_alpha((ntok << 4) | N_ALPHA)
                if a is None:
                    raise ValueError("corrupt tok3 stream")
                types[ntok] = N_ALPHA
                strs[ntok] = len(name)
                ints[ntok] = len(a)
                name += a
            elif tok == N_DIGITS0:
                vl = get_bytes((ntok << 4) | N_DZLEN, 1)
                vb = get_bytes((ntok << 4) | N_DIGITS0, 4)
                if vl is None or vb is None:
                    raise ValueError("corrupt tok3 stream")
                v = int.from_bytes(vb, "little")
                name += _append_fixed(v, vl[0])
                types[ntok] = N_DIGITS0
                ints[ntok] = v
                strs[ntok] = vl[0]
            elif tok == N_DDELTA0:
                if ntok >= plc[1]:
                    raise ValueError("corrupt tok3 stream")
                b = get_bytes((ntok << 4) | N_DDELTA0, 1)
                if b is None:
                    raise ValueError("corrupt tok3 stream")
                v = (b[0] + plc[3][ntok]) & 0xFFFFFFFF
                name += _append_fixed(v, plc[4][ntok])
                types[ntok] = N_DIGITS0
                ints[ntok] = v
                strs[ntok] = plc[4][ntok]
            elif tok == N_DIGITS:
                vb = get_bytes((ntok << 4) | N_DIGITS, 4)
                if vb is None:
                    raise ValueError("corrupt tok3 stream")
                v = int.from_bytes(vb, "little")
                name += _append_var(v)
                types[ntok] = N_DIGITS
                ints[ntok] = v
            elif tok == N_DDELTA:
                if ntok >= plc[1]:
                    raise ValueError("corrupt tok3 stream")
                b = get_bytes((ntok << 4) | N_DDELTA, 1)
                if b is None:
                    raise ValueError("corrupt tok3 stream")
                v = (b[0] + plc[3][ntok]) & 0xFFFFFFFF
                name += _append_var(v)
                types[ntok] = N_DIGITS
                ints[ntok] = v
            elif tok == N_NOP:
                types[ntok] = N_NOP
            elif tok == N_MATCH:
                if ntok >= plc[1]:
                    raise ValueError("corrupt tok3 stream")
                pt = plc[2][ntok]
                if pt == N_CHAR:
                    name.append(plc[3][ntok] & 0xFF)
                    types[ntok] = N_CHAR
                    ints[ntok] = plc[3][ntok]
                elif pt == N_ALPHA:
                    if plc[3][ntok] < 0:
                        raise ValueError("corrupt tok3 stream")
                    types[ntok] = N_ALPHA
                    strs[ntok] = len(name)
                    ints[ntok] = plc[3][ntok]
                    name += plc[0][plc[4][ntok]:plc[4][ntok] + plc[3][ntok]]
                elif pt == N_DIGITS:
                    name += _append_var(plc[3][ntok])
                    types[ntok] = N_DIGITS
                    ints[ntok] = plc[3][ntok]
                elif pt == N_DIGITS0:
                    name += _append_fixed(plc[3][ntok], plc[4][ntok])
                    types[ntok] = N_DIGITS0
                    ints[ntok] = plc[3][ntok]
                    strs[ntok] = plc[4][ntok]
                else:
                    raise ValueError("corrupt tok3 stream")
            else:  # N_END or an elided end
                types[ntok] = N_END
                lc[cnum] = [bytes(name), ntok, types, ints, strs]
                out += name + b"\x00"
                ended = True
                break
        if not ended:
            raise ValueError("corrupt tok3 stream")

    return bytes(out)
