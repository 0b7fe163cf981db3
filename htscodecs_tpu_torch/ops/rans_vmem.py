"""The batched rANS 4x16 engine: four CUDA kernels and what surrounds
them.

Counterpart of ``htscodecs_tpu/ops/rans_vmem.py`` (the Pallas engine of
the JAX package).  Each kernel has, in this module, its wrapper (which
checks its arguments, launches on the current stream and counts the
launch), its plain PyTorch version (a loop over steps, vectorised over
blocks, integer-exact in int64 with explicit masks) and a source note.
A wrapper uses the plain version only for tensors that lie on the CPU;
for CUDA tensors it launches the kernel or raises.

``rans16_dec``  csrc/rans16_dec.cu
    replaces ``_build_kernel`` / ``_dec_vmem`` (decode, order 0 and 1).
    Bound by memory traffic (words + tables + states in, B*N bytes
    out).  One 4-thread group per block, state order renormalisation by
    warp ballot, binary search over monotone u16 base rows read through
    L1/L2, bytes written straight to (B, N).
``sf_fetch``    csrc/sf_fetch.cu
    replaces ``_build_fetch_kernel`` / ``_sf_fetch``
    (out[b,k] = tbl[b, idx[b,k]]).  Bound by memory traffic (12 bytes
    per query plus the tables).  One coalesced indexed load per query.
``rans16_enc``  csrc/rans16_enc.cu
    replaces ``_build_enc_kernel_pf`` and the stitch sort of
    ``_enc_vmem``.  Bound by memory traffic (4 bytes per symbol in,
    emitted words out).  One 4-thread group per block owns the block's
    emission sequence, so words are ranked by ballot + popcount and
    reversed in place at the end: no segment capacity, no retry, no
    sort; the divide is the card's exact integer divide.
``rans16_enc_fused``  csrc/rans16_enc_fused.cu
    replaces ``_build_enc_kernel`` (the encode with the table fetch
    inside the kernel, ``_enc_vmem(prefetch=False)``) and its stitch
    sort.  Reads one symbol byte and one context byte per symbol and
    looks ``(start, freq)`` up in the block's own base rows, so the
    4-byte index and the 4-byte ``sf`` value per symbol of the
    ``sf_fetch`` + ``rans16_enc`` pair never touch device memory.
    Same step, ranking and reversal as ``rans16_enc``; its outputs
    equal that pair's bit for bit.

Tensor conventions are those of ``ops/convert.py``: states int32 and
words int16 hold the bits of the u32 / u16 values.
"""

from __future__ import annotations

import torch

from .. import cuda_build
from . import rans_v2
from .convert import Tables

RANS_L = 1 << 15
_M32 = 0xFFFFFFFF

# launches per kernel: each wrapper adds one where it launches its
# kernel and nowhere else (the 4x8 engine in ops/rans8_vmem.py, the
# range-coder engines in ops/arith_vmem.py and ops/rc_vmem.py and the
# packed-row engine in ops/rans_pallas.py count in the same table)
LAUNCHES = {"rans16_dec": 0, "sf_fetch": 0, "rans16_enc": 0,
            "rans16_enc_fused": 0, "rans8_enc": 0, "rans8_dec": 0,
            "arith_enc": 0, "arith_dec": 0, "rc_enc": 0,
            "rans16_dec_packed": 0, "rans16_enc_packed": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)}, got {t.dtype} "
            f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


# ---------------------------------------------------------------------------
# rans16_dec

def _dec_geometry(N: int, order: int):
    if order == 1:
        q = N >> 2
        return q, q + (N - 4 * q)
    q = -(-N // 4)
    return q, q


def rans16_dec(states, words, counts, tables: Tables, N: int, order: int):
    """Decode B blocks of N bytes.

    states (B,4) int32, words (B,W) int16, counts (B,) int32, tables
    with bases (B, A if order else 1, A+1) int16.  Returns (B,N) uint8.
    """
    B, W = words.shape
    A = tables.alpha.shape[1]
    dev = words.device
    _require(states, "states", torch.int32, (B, 4), dev)
    _require(words, "words", torch.int16, (B, W), dev)
    _require(counts, "counts", torch.int32, (B,), dev)
    _require(tables.alpha, "alpha", torch.uint8, (B, A), dev)
    _require(tables.bases, "bases", torch.int16,
             (B, A if order == 1 else 1, A + 1), dev)
    _require(tables.shift, "shift", torch.int32, (B,), dev)
    if order not in (0, 1) or N <= 0 or W < 1:
        raise ValueError("rans16_dec: bad geometry")
    if dev.type == "cpu":
        return _rans16_dec_plain(states, words, counts, tables, N, order)
    out = torch.empty((B, N), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.get_lib().rans16_dec_launch(
            states.data_ptr(), words.data_ptr(), counts.data_ptr(),
            tables.bases.data_ptr(), tables.alpha.data_ptr(),
            tables.shift.data_ptr(), out.data_ptr(),
            B, W, A, N, order, _stream(words))
    cuda_build.check(err, "rans16_dec")
    LAUNCHES["rans16_dec"] += 1
    return out


def _rans16_dec_plain(states, words, counts, tables: Tables, N: int,
                      order: int):
    """Plain PyTorch version of rans16_dec (same arguments)."""
    B = words.shape[0]
    A = tables.alpha.shape[1]
    rows_all = tables.bases.to(torch.int64)                 # (B,Ac,A+1)
    bidx = torch.arange(B, device=words.device)[:, None]

    def lookup(ctx, m):
        if order == 1:
            rows = rows_all[bidx, ctx]                      # (B,4,A+1)
        else:
            rows = rows_all[:, 0][:, None, :].expand(B, 4, A + 1)
        return _slot_lookup(rows, m)
    return _dec16_scan(states, words, counts, lookup, tables.alpha,
                       tables.shift, N, order)


def _dec16_scan(states, words, counts, lookup, alpha, shift, N: int,
                order: int):
    """The 4x16 decode scan of the plain versions.  ``lookup(ctx, m)``
    resolves slots m (B,4) in context rows ctx (B,4) to (sym, base,
    freq), each (B,4) int64; counts (B,) bound each block's word reads
    (None: the whole row).  Returns (B, N) uint8."""
    B, W = words.shape
    dev = words.device
    q, K = _dec_geometry(N, order)
    i64 = torch.int64
    X = states.to(i64) & _M32                               # (B,4)
    wl = words.to(i64) & 0xFFFF
    nw = (torch.full((B, 1), W, dtype=i64, device=dev) if counts is None
          else counts.to(i64).clamp(max=W)[:, None])
    sh = shift.to(i64)[:, None]
    mask = (torch.ones_like(sh) << sh) - 1
    lanes = torch.arange(4, device=dev)
    p = torch.zeros((B,), dtype=i64, device=dev)
    ctx = torch.zeros((B, 4), dtype=i64, device=dev)
    out = torch.zeros((B, N), dtype=torch.uint8, device=dev)
    for s in range(K):
        if order == 1:
            act = (lanes == 3) if s >= q else lanes >= 0
        else:
            act = lanes >= 0
        act = act[None, :]
        m = X & mask
        sym, bs, f = lookup(ctx, m)
        Xn = (f * (X >> sh) + m - bs) & _M32
        need = (Xn < RANS_L) & act
        ni = need.to(i64)
        pos = p[:, None] + ni.cumsum(dim=1) - ni
        w = torch.where(pos < nw, wl.gather(1, pos.clamp(max=W - 1)),
                        torch.zeros_like(pos))
        Xn = torch.where(need, ((Xn << 16) | w) & _M32, Xn)
        X = torch.where(act, Xn, X)
        p = p + ni.sum(dim=1)
        ctx = torch.where(act, sym, ctx)
        byte = alpha.gather(1, sym)                         # (B,4) u8
        if order == 1:
            if s < q:
                out[:, torch.arange(4, device=dev) * q + s] = byte
            else:
                out[:, 4 * q + (s - q)] = byte[:, 3]
        else:
            n_here = min(4, N - 4 * s)
            out[:, 4 * s:4 * s + n_here] = byte[:, :n_here]
    return out


def _slot_lookup(rows, m):
    """Slot -> symbol over monotone base rows.  rows (B,4,A+1) int64, m
    (B,4): the symbol is the last of the first A entries that is <= m
    (entry 0 with base 0 when there is none), freq = its successor's
    base minus its own.  Returns (sym, base, freq)."""
    A = rows.shape[2] - 1
    c = (rows[:, :, :A] <= m[:, :, None]).sum(dim=2)
    sym = (c - 1).clamp(min=0)
    bs = torch.where(c > 0, rows.gather(2, sym[:, :, None])[:, :, 0],
                     torch.zeros_like(c))
    f = rows.gather(2, (sym + 1)[:, :, None])[:, :, 0] - bs
    return sym, bs, f


# ---------------------------------------------------------------------------
# sf_fetch

def sf_fetch(tbl, idx):
    """out[b, k] = tbl[b, idx[b, k]].  tbl (B,T) int32, idx (B,KQ)
    int32 (clamped into [0, T)); returns (B,KQ) int32."""
    B, T = tbl.shape
    KQ = idx.shape[1]
    dev = tbl.device
    _require(tbl, "tbl", torch.int32, (B, T), dev)
    _require(idx, "idx", torch.int32, (B, KQ), dev)
    if T < 1:
        raise ValueError("sf_fetch: empty table")
    if dev.type == "cpu":
        return _sf_fetch_plain(tbl, idx)
    out = torch.empty((B, KQ), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.get_lib().sf_fetch_launch(
            tbl.data_ptr(), idx.data_ptr(), out.data_ptr(), B, T, KQ,
            _stream(tbl))
    cuda_build.check(err, "sf_fetch")
    LAUNCHES["sf_fetch"] += 1
    return out


def _sf_fetch_plain(tbl, idx):
    """Plain PyTorch version of sf_fetch."""
    T = tbl.shape[1]
    return torch.gather(tbl, 1, idx.clamp(0, T - 1).to(torch.int64))


# ---------------------------------------------------------------------------
# rans16_enc

def rans16_enc(sf, shift, K: int, geom: int, order: int):
    """Encode B blocks from their prefetched streams.

    sf (B, 4K) int32: ``start | freq << 12`` per symbol in processing
    order (step-major, processing lane minor); shift (B,) int32; geom
    the order-1 state-3 tail length or the order-0 first-step pad.
    Returns (states (B,4) int32 in state order, words (B,4K) int16 in
    forward order, counts (B,) int32).  Words past a block's count are
    unspecified.
    """
    B = sf.shape[0]
    dev = sf.device
    _require(sf, "sf", torch.int32, (B, 4 * K), dev)
    _require(shift, "shift", torch.int32, (B,), dev)
    if order not in (0, 1) or K < 1 or not 0 <= geom <= 3:
        raise ValueError("rans16_enc: bad geometry")
    if dev.type == "cpu":
        return _rans16_enc_plain(sf, shift, K, geom, order)
    cap = 4 * K
    states = torch.empty((B, 4), dtype=torch.int32, device=dev)
    words = torch.empty((B, cap), dtype=torch.int16, device=dev)
    counts = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.get_lib().rans16_enc_launch(
            sf.data_ptr(), shift.data_ptr(), states.data_ptr(),
            words.data_ptr(), counts.data_ptr(), B, K, geom, cap, order,
            _stream(sf))
    cuda_build.check(err, "rans16_enc")
    LAUNCHES["rans16_enc"] += 1
    return states, words, counts


def _rans16_enc_plain(sf, shift, K: int, geom: int, order: int):
    """Plain PyTorch version of rans16_enc (same arguments)."""
    sfl = sf.to(torch.int64).view(sf.shape[0], K, 4)
    return _enc16_scan(lambda s: _split_sf(sfl[:, s, :]), shift, K, geom,
                       order)


def _split_sf(v):
    """``start | freq << 12`` values -> (start, freq)."""
    return v & 0xFFF, (v >> 12) & 0x1FFF


def _enc16_scan(fetch, shift, K: int, geom: int, order: int):
    """The 4x16 encode scan of the plain versions.  ``fetch(s)`` gives
    step s's (start, freq), each (B,4) int64 in [0, 2^32), processing
    lane minor."""
    B = shift.shape[0]
    dev = shift.device
    i64 = torch.int64
    cap = 4 * K
    sh = shift.to(i64)[:, None]
    xmult = (RANS_L >> sh) << 16
    lanes = torch.arange(4, device=dev)
    X = torch.full((B, 4), RANS_L, dtype=i64, device=dev)
    # emission-order buffer with one spill column for non-emitting lanes
    buf = torch.zeros((B, cap + 1), dtype=i64, device=dev)
    n = torch.zeros((B,), dtype=i64, device=dev)
    for s in range(K):
        ok = _enc_active(lanes, s, geom, order)
        start, f = fetch(s)
        emit = ok & (X >= ((xmult * f) & _M32))
        ei = emit.to(i64)
        rank = n[:, None] + ei.cumsum(dim=1) - ei
        buf.scatter_(1, torch.where(emit, rank, torch.full_like(rank, cap)),
                     X & 0xFFFF)
        x2 = torch.where(emit, X >> 16, X)
        fs = torch.where(f > 0, f, torch.ones_like(f))
        qq = x2 // fs
        xn = ((qq << sh) + (x2 - qq * fs) + start) & _M32
        X = torch.where(ok, xn, X)
        n = n + ei.sum(dim=1)
    fwd = _reverse_emitted(buf[:, :cap], n)
    return (_to_i32_bits(X.flip(1)), _to_i16_bits(fwd), n.to(torch.int32))


def _enc_active(lanes, s: int, geom: int, order: int):
    """(1,4) bool: the processing lanes that code a symbol at step s.
    Order 1: the first geom steps are the state-3 tail (lane 0 alone);
    order 0: the first step skips the geom padded lanes."""
    if order == 1:
        ok = (lanes == 0) if s < geom else lanes >= 0
    else:
        ok = (lanes >= geom) if s == 0 else lanes >= 0
    return ok[None, :]


def _reverse_emitted(buf, n):
    """Forward order = reverse of emission order: out[b, i] =
    buf[b, n[b]-1-i] for i < n[b], 0 past it."""
    cap = buf.shape[1]
    i = torch.arange(cap, device=buf.device)[None, :]
    src = (n[:, None] - 1 - i).clamp(min=0)
    return torch.where(i < n[:, None], buf.gather(1, src),
                       torch.zeros_like(src))


# ---------------------------------------------------------------------------
# rans16_enc_fused

def _require_enc_inputs(name, sym, ctx, tables: Tables, K, geom, order):
    """Argument checks shared by the encoders that fetch their own
    table entries (rans16_enc_fused here, rans8_enc in rans8_vmem)."""
    B = sym.shape[0]
    A = tables.alpha.shape[1]
    dev = sym.device
    _require(sym, "sym", torch.uint8, (B, 4 * K), dev)
    _require(ctx, "ctx", torch.uint8, (B, 4 * K), dev)
    _require(tables.bases, "bases", torch.int16,
             (B, A if order == 1 else 1, A + 1), dev)
    _require(tables.shift, "shift", torch.int32, (B,), dev)
    if order not in (0, 1) or K < 1 or not 0 <= geom <= 3:
        raise ValueError(f"{name}: bad geometry")


def rans16_enc_fused(sym, ctx, tables: Tables, K: int, geom: int, order: int):
    """Encode B blocks, looking each symbol's (start, freq) up in the
    block's own base rows inside the kernel.

    sym, ctx (B, 4K) uint8: dense symbol and context per symbol in
    processing order (step-major, processing lane minor; ``enc_inputs``
    makes them); tables with bases (B, A if order else 1, A+1) int16.
    The entry read is ``ctx * A + sym`` clamped into the block's table,
    as ``sf_fetch`` clamps its index (ctx is ignored at order 0).
    Returns what ``rans16_enc`` returns, bit for bit what it returns
    after ``sf_fetch``.
    """
    _require_enc_inputs("rans16_enc_fused", sym, ctx, tables, K, geom, order)
    B = sym.shape[0]
    A = tables.alpha.shape[1]
    dev = sym.device
    if dev.type == "cpu":
        return _rans16_enc_fused_plain(sym, ctx, tables, K, geom, order)
    cap = 4 * K
    states = torch.empty((B, 4), dtype=torch.int32, device=dev)
    words = torch.empty((B, cap), dtype=torch.int16, device=dev)
    counts = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.get_lib().rans16_enc_fused_launch(
            sym.data_ptr(), ctx.data_ptr(), tables.bases.data_ptr(),
            tables.shift.data_ptr(), states.data_ptr(), words.data_ptr(),
            counts.data_ptr(), B, K, A, geom, cap, order, _stream(sym))
    cuda_build.check(err, "rans16_enc_fused")
    LAUNCHES["rans16_enc_fused"] += 1
    return states, words, counts


def _table_entries(sym, ctx, tables: Tables, K: int, order: int):
    """fetch(s) -> ((B,4) int64 base of the entry, base of its
    successor): the in-kernel lookup of the fused encoders, with
    ``sf_fetch``'s clamp of the flat index."""
    B = sym.shape[0]
    A = tables.alpha.shape[1]
    Ac = A if order == 1 else 1
    rows = tables.bases.to(torch.int64).reshape(B, Ac * (A + 1))
    syl = sym.to(torch.int64).view(B, K, 4)
    cxl = ctx.to(torch.int64).view(B, K, 4)

    def fetch(s):
        idx = syl[:, s, :]
        if order == 1:
            idx = idx + cxl[:, s, :] * A
        idx = idx.clamp(max=Ac * A - 1)
        at = (idx // A) * (A + 1) + idx % A
        return rows.gather(1, at), rows.gather(1, at + 1)
    return fetch


def _rans16_enc_fused_plain(sym, ctx, tables: Tables, K: int, geom: int,
                            order: int):
    """Plain PyTorch version of rans16_enc_fused (same arguments)."""
    entries = _table_entries(sym, ctx, tables, K, order)

    def fetch(s):
        start, nxt = entries(s)
        # the value sf_table would hold for this entry (int32 bits)
        return _split_sf((start | ((nxt - start) << 12)) & _M32)
    return _enc16_scan(fetch, tables.shift, K, geom, order)


def _to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _to_i16_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^16) -> int16 with the same low 16 bits."""
    return torch.where(x >= (1 << 15), x - (1 << 16), x).to(torch.int16)


# ---------------------------------------------------------------------------
# What surrounds the encode kernels (tensor in, tensor out).  Decode
# needs nothing around rans16_dec: the base rows are in ``Tables`` and
# the kernel writes (B, N) bytes directly.

def sf_table(tables: Tables) -> torch.Tensor:
    """(B, Ac*A) int32 ``start | freq << 12`` per (context, symbol).
    start <= 4095 for any freq > 0 entry and freq <= 4096 fits 13
    bits; freq-0 entries are never queried by an active lane."""
    rows = tables.bases.to(torch.int32)
    start = rows[:, :, :-1]
    freq = rows[:, :, 1:] - start
    return (start | (freq << 12)).reshape(rows.shape[0], -1).contiguous()


def enc_inputs(blocks: torch.Tensor, tables: Tables, order: int):
    """Dense symbol and context per symbol in processing order, (B, 4K)
    uint8 each, with K and geom (``rans_v2._enc_proc_inputs`` on the
    dense block; the (K,4,B) views of block-major storage come back as
    (B, 4K) without a copy)."""
    B, N = blocks.shape
    dense = rans_v2._densify(blocks, tables.alpha)
    sym_p, ctx_p, _valid, K, geom = rans_v2._enc_proc_inputs(dense, N, order)
    return (sym_p.permute(2, 0, 1).reshape(B, 4 * K),
            ctx_p.permute(2, 0, 1).reshape(B, 4 * K), K, geom)


def enc_queries(blocks: torch.Tensor, tables: Tables, order: int):
    """What the prefetching encoder's two kernels read, from the raw
    blocks: the per-block (start | freq << 12) tables, the flat
    (context, symbol) query per symbol in processing order (B, 4K)
    int32, K and geom.  Counterpart of ``_enc_vmem``'s pre-processing."""
    A = tables.alpha.shape[1]
    sym, ctx, K, geom = enc_inputs(blocks, tables, order)
    qidx = sym.to(torch.int32)
    if order == 1:
        qidx += ctx.to(torch.int32) * A
    return sf_table(tables), qidx, K, geom


def enc_batch(blocks: torch.Tensor, tables: Tables, order: int,
              prefetch: bool = True):
    """Encode a batch of equal-length blocks: counterpart of
    ``_enc_vmem``.  blocks (B,N) uint8.  ``prefetch=True`` gathers the
    table entries first (``sf_fetch``) and encodes from them
    (``rans16_enc``); ``prefetch=False`` launches the one kernel that
    looks them up itself (``rans16_enc_fused``).  Returns (states (B,4)
    int32, words (B,cap) int16 forward, counts (B,)), the same bits
    either way."""
    if not prefetch:
        sym, ctx, K, geom = enc_inputs(blocks, tables, order)
        return rans16_enc_fused(sym, ctx, tables, K, geom, order)
    tbl, qidx, K, geom = enc_queries(blocks, tables, order)
    sf = sf_fetch(tbl, qidx)
    del qidx
    return rans16_enc(sf, tables.shift, K, geom, order)
