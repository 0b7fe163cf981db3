"""The batched arith_dynamic engine (CRAM 3.1 adaptive range coder): two
CUDA kernels and what surrounds them.

Counterpart of BOTH ``htscodecs_tpu/ops/arith_vmem.py`` (the Pallas
order-0 kernels) and the batch part of ``htscodecs_tpu/ops/arith_jax.py``
(the XLA scans that serve order 1 and every batch the Pallas kernels
refuse).  One module serves both orders and every model width up to 256:
the kernels take the order as a template parameter and the width at run
time, so no batch of plain order-0/1 blocks goes to the host for its
alphabet, its stream length or its carry pattern.

``arith_enc``  csrc/arith_enc.cu
    replaces ``_build_enc_kernel`` / ``_enc_vmem`` and ``_enc_scan``.
    The model walk and update depend only on the symbols, so the chain
    runs in three stages, one warp each, with ``per_warp`` blocks in the
    lanes of every warp: the models (in shared memory, initialised by
    the kernel, as ``arith_dec`` keeps them; no bank is built; the
    symbols staged through shared memory) hand (acc, f, total) records
    to the range chain, which takes the totals' reciprocals in parallel
    and divides through them (``rc_udiv``), then queues (acc * r,
    shifts) for low, the carry and the bytes (``rc_enc``'s two stages,
    the same code), whose bytes go out from a shared-memory ring in
    16-byte stores.  Records and queue entries pass in two buffers of
    ``chunk`` symbols per block.  No events, no stitch sort, no
    expansion on the host, no saturation fallback.
``arith_dec``  csrc/arith_dec.cu
    replaces ``_build_dec_kernel`` / ``_dec_vmem`` and ``_dec_scan``.
    One thread per block: range / total, code / range, search by
    cumulative frequency, the same model update, with the models in
    shared memory, initialised by the kernel (no bank is built): one row
    per block at order 0; at order 1 a context -> slot map and a pool of
    ``pool`` rows per block, claimed as contexts first occur, and the
    contexts past the pool in a global bank that the wrapper allocates
    only when the pool is smaller than M.  The next stream bytes are
    loaded a symbol ahead.  No divide is left on the chain: range /
    total through a reciprocal kept beside each row's total
    (``_recip_table`` holds every total's, read a symbol ahead), code /
    range not at all (the walk compares products).

Both are bound by memory traffic on paper and by the latency of serial
chains in fact (see the source notes).  The coder core
(``csrc/rc_core.cuh``: the model rows, the range and low stages) is
shared with ``ops/rc_vmem.py``.

The order-1 pool (``pool_rows`` for ``arith_dec``, ``enc_pool_rows``
for ``arith_enc``): the launch aims to hold all B blocks on the card at
once.  With ``G`` blocks per CTA (``tpb`` threads of one block each for
``arith_dec``, ``per_warp`` blocks for ``arith_enc``), ceil(B / G) CTAs
spread over the SMs, ceil(CTAs / SMs) per SM; each CTA gets an even
share of the SM's shared memory less the 1 KB the runtime keeps per
CTA (at most the 227 KB one CTA may hold).  ``arith_enc`` first takes
its stage buffers from that share: per block two buffers of ``chunk``
8-byte records, 4-byte reciprocals, 8-byte queue entries and symbols,
and a ring of ``ring`` bytes.  Each block gets a G-th of what is left
less its 256-byte map and 44 bytes of padding, in rows of M + 3 words
(the model and the reciprocals of its total and of the total + 16)
rounded up to 16 bytes: at least 1 row and at most M.  On an H100
(228 KB per SM, 132 SMs) ``arith_dec`` of B = 4096 blocks at 4 per CTA
gets 22 rows of width 71 and ``arith_enc`` at 8 per warp 11, where
synth4's blocks use 5 contexts.

Each wrapper uses its plain PyTorch version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.  The plain
versions follow ``arith_jax._enc_one / dec_one / _model_update``: one
loop over the byte index, all blocks at once, int64 arithmetic masked
to 32 bits.  They keep the coder's output as events inside and expand
the deferred runs at their end.

Invalid input is defined as the JAX device functions define it (a read
past a block's byte count gives 0, a payload under 6 bytes decodes
nothing, a walk past the last model entry gives position M), not as the
host coder does (which stops reading at the end of a truncated stream).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda_build
from . import convert
from .rans_v2 import check_device
from .rans_vmem import LAUNCHES, _M32, _require, _stream

TOP = 1 << 24
THRES = 0xFF000000
MAX_FREQ = (1 << 16) - 17
STEP = 16
NSYM = 256          # widest model (the C model's NSYM)

# warps per SM that the arith_dec launch aims for: on an H100, 4096
# blocks ran fastest at 4 threads per CTA (8 warps per SM); 31 warps per
# SM were limited by the SM's instruction rate, 1 warp of 32 divergent
# threads by latency; 1024 blocks ran fastest at 1 thread per CTA, as
# this rule gives (chip_smoke.py prints the sweeps)
_WARPS_PER_SM = 8

# arith_enc: CTAs (three warps each) per SM that the launch aims for: on
# an H100 the blocks-per-warp sweep of chip_smoke.py ran fastest at 8 per
# warp for 4096 blocks and at 2 for 1024, ~4 CTAs per SM either way (the
# time grows with the CTAs per SM, not with the lanes that work); and the
# stage buffers' defaults
_ENC_CTAS_PER_SM = 4
ENC_CHUNK = 64      # symbols per record / queue buffer and block
ENC_RING = 256      # bytes of each block's output ring


def threads_per_cta(B: int, dev: torch.device) -> int:
    """Threads per CTA of ``arith_dec`` (one block per thread): the
    smallest power of two (at most 32) that keeps the launch within
    ``_WARPS_PER_SM`` warps per SM.  Each thread runs a long divergent
    loop, so blocks that share a warp serialise where warps overlap."""
    slots = (torch.cuda.get_device_properties(dev).multi_processor_count
             * _WARPS_PER_SM)
    tpb = 1
    while tpb < 32 and -(-B // tpb) > slots:
        tpb *= 2
    return tpb


def blocks_per_warp(B: int, sms: int) -> int:
    """Blocks in the lanes of each stage warp of ``arith_enc``: the
    smallest power of two (at most 32) that keeps the launch within
    ``_ENC_CTAS_PER_SM`` CTAs per SM on a card of ``sms`` SMs."""
    g = 1
    while g < 32 and -(-B // g) > sms * _ENC_CTAS_PER_SM:
        g *= 2
    return g


_CTA_RESERVED = 1024   # shared memory the runtime keeps per CTA


def _row_stride(M: int) -> int:
    """Words between two model rows: M entries, the total, two
    reciprocals, rounded up to 16 bytes (csrc/rc_core.cuh:
    row_stride)."""
    return (M + 7) & ~3


def _model_words(M: int, order: int, pool: int) -> int:
    """Shared-memory words of one block's models (csrc/rc_core.cuh:
    model_words): the 64-word context map and ``pool`` rows at order 1,
    one row at order 0, after a row padding of (-M) % 4 words; an odd
    number of 16-byte units."""
    w = (64 + pool * _row_stride(M) if order else _row_stride(M)) + (-M) % 4
    return 4 * (-(-w // 4) | 1)


def _enc_stage_bytes(G: int, chunk: int, ring: int) -> int:
    """Shared memory of ``arith_enc``'s stage buffers for G blocks: two
    buffers of ``chunk`` 8-byte records, 4-byte reciprocals and 8-byte
    queue entries per block, rounded up to 16 bytes, a ring of ``ring``
    bytes and two buffers of ``chunk`` symbols per block."""
    return -(-(40 * chunk * G) // 16) * 16 + G * (ring + 2 * chunk)


def _enc_smem(M: int, order: int, pool: int, G: int, chunk: int,
              ring: int) -> int:
    """Shared memory of one ``arith_enc`` CTA (csrc/arith_enc.cu:
    arith_enc_smem)."""
    return 4 * G * _model_words(M, order, pool) + _enc_stage_bytes(G, chunk,
                                                                    ring)


def _pool_for(M: int, B: int, G: int, reserved: int, smem_per_sm: int,
              sms: int) -> int:
    """Order-1 rows per block when ceil(B / G) CTAs of G blocks share the
    SMs and each CTA first gives ``reserved`` bytes to other uses (the
    rule in the module docstring)."""
    ctas = -(-B // G)
    per_sm = max(1, -(-ctas // sms))
    per_cta = smem_per_sm // per_sm - _CTA_RESERVED - reserved
    # a block's words: the map, the row padding and at most 8 words of
    # rounding besides the rows
    words = per_cta // G // 4 - 64 - 3 - 8
    return max(1, min(M, words // _row_stride(M)))


def pool_rows(M: int, B: int, tpb: int, smem_per_sm: int, sms: int) -> int:
    """Order-1 model rows in shared memory per block of an ``arith_dec``
    launch of B blocks at ``tpb`` per CTA on a card of ``sms`` SMs with
    ``smem_per_sm`` bytes each."""
    return _pool_for(M, B, tpb, 0, smem_per_sm, sms)


def enc_pool_rows(M: int, B: int, per_warp: int, chunk: int, ring: int,
                  smem_per_sm: int, sms: int) -> int:
    """The same for an ``arith_enc`` launch of ``per_warp`` blocks per
    CTA, its stage buffers reserved first."""
    return _pool_for(M, B, per_warp, _enc_stage_bytes(per_warp, chunk, ring),
                     smem_per_sm, sms)


def default_pool(M: int, B: int, tpb: int, dev: torch.device) -> int:
    """``pool_rows`` for the card of ``dev``."""
    p = torch.cuda.get_device_properties(dev)
    return pool_rows(M, B, tpb, p.shared_memory_per_multiprocessor,
                     p.multi_processor_count)


def _recip_table(dev: torch.device) -> torch.Tensor:
    """(65536,) int32 bits of floor((2^32 - 1) / max(t, 1)) on ``dev``:
    the reciprocals of every model total that ``arith_dec`` reads
    (``csrc/rc_core.cuh``: rc_udiv_recip)."""
    q = 0xFFFFFFFF // torch.arange(65536, dtype=torch.int64,
                                   device=dev).clamp(min=1)
    return ((q + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def _require_model(name: str, msyms, M: int, order: int, B: int, dev) -> None:
    _require(msyms, "msyms", torch.int32, (B,), dev)
    if order not in (0, 1) or not 1 <= M <= NSYM:
        raise ValueError(f"{name}: order must be 0 or 1 and 1 <= M <= {NSYM}")


# ---------------------------------------------------------------------------
# the plain coder and model (shared with ops/rc_vmem.py)

class _PlainCoder:
    """RC_Encode / RC_ShiftLow for B blocks at once in int64, after
    ``arith_jax._enc_one / _shift_low``.  A flush is kept as one event
    ``ffnum << 16 | run byte << 8 | byte``; ``finish`` runs the five last
    shifts and expands the events to (bytes (B, 2 * nsym + 8) uint8,
    counts (B,) int32)."""

    def __init__(self, B: int, nsym: int, dev):
        i64 = torch.int64
        self.E = 2 * nsym + 5                   # at most this many shifts
        self.cap = 2 * nsym + 8
        # one spill column for the shifts that flush nothing
        self.ev = torch.zeros((B, self.E + 1), dtype=i64, device=dev)
        self.nev = torch.zeros((B,), dtype=i64, device=dev)
        self.low = torch.zeros((B,), dtype=i64, device=dev)
        self.range = torch.full((B,), _M32, dtype=i64, device=dev)
        self.cache = torch.zeros((B,), dtype=i64, device=dev)
        self.ffnum = torch.zeros((B,), dtype=i64, device=dev)
        self.carry = torch.zeros((B,), dtype=i64, device=dev)

    def _shift_low(self, need) -> None:
        flush = need & ((self.low < THRES) | (self.carry != 0))
        evt = ((self.ffnum << 16) | (((self.carry - 1) & 0xFF) << 8)
               | ((self.cache + self.carry) & 0xFF))
        idx = torch.where(flush, self.nev, torch.full_like(self.nev, self.E))
        self.ev.scatter_(1, idx[:, None], evt[:, None])
        self.nev = self.nev + flush.to(torch.int64)
        self.cache = torch.where(flush, self.low >> 24, self.cache)
        self.ffnum = torch.where(flush, torch.zeros_like(self.ffnum),
                                 self.ffnum + need.to(torch.int64))
        self.carry = torch.where(flush, torch.zeros_like(self.carry),
                                 self.carry)
        self.low = torch.where(need, (self.low << 8) & _M32, self.low)

    def encode(self, acc, f, tot, active) -> None:
        r = self.range // tot.clamp(min=1)
        low = (self.low + acc * r) & _M32
        self.carry = self.carry + (active & (low < self.low)).to(torch.int64)
        self.low = torch.where(active, low, self.low)
        self.range = torch.where(active, (r * f.clamp(min=1)) & _M32,
                                 self.range)
        for _ in range(2):
            need = active & (self.range < TOP)
            self.range = torch.where(need, (self.range << 8) & _M32,
                                     self.range)
            self._shift_low(need)

    def finish(self):
        every = torch.ones_like(self.low, dtype=torch.bool)
        for _ in range(5):
            self._shift_low(every)
        dev = self.low.device
        ev = self.ev[:, :self.E]
        live = torch.arange(self.E, device=dev)[None, :] < self.nev[:, None]
        rep = torch.where(live, 1 + (ev >> 16), torch.zeros_like(ev))
        ends = rep.cumsum(dim=1)
        counts = ends[:, -1]
        # byte t of a row belongs to the first event that ends past it:
        # the event's own byte first, then its deferred run
        t = torch.arange(self.cap, device=dev)[None, :].expand(
            ev.shape[0], self.cap).contiguous()
        j = torch.searchsorted(ends, t, right=True).clamp(max=self.E - 1)
        e = ev.gather(1, j)
        start = ends.gather(1, j) - rep.gather(1, j)
        byte = torch.where(t == start, e & 0xFF, (e >> 8) & 0xFF)
        out = torch.where(t < counts[:, None], byte, torch.zeros_like(byte))
        return out.to(torch.uint8), counts.to(torch.int32)


class _PlainModels:
    """The adaptive models of B blocks (one per context at order 1) in
    int64, after ``arith_jax._model_update``."""

    def __init__(self, msyms, M: int, order: int):
        bank = convert.model_bank(msyms, M, order).to(torch.int64)
        self.M = M
        self.freqs = (bank[:, :, :M] & 0xFFFF).contiguous()
        self.syms = (bank[:, :, :M] >> 16).contiguous()
        self.totals = bank[:, :, M].contiguous()
        dev = msyms.device
        self.bidx = torch.arange(bank.shape[0], device=dev)
        self.iota = torch.arange(M, device=dev)[None, :]

    def rows(self, ctx):
        """(freqs (B,M), syms (B,M), total (B,)) of each block's
        context."""
        return (self.freqs[self.bidx, ctx], self.syms[self.bidx, ctx],
                self.totals[self.bidx, ctx])

    def update(self, ctx, fr, sy, total, p, active) -> None:
        """freq[p] += STEP; halve every entry and recompute the total
        when it passes MAX_FREQ; THEN one swap with p - 1 if freq[p] >
        freq[p - 1].  p == M (no entry) moves only the total."""
        at_p = (self.iota == p[:, None]) & active[:, None]
        fr = fr + at_p.to(torch.int64) * STEP
        total = total + active.to(torch.int64) * STEP
        norm = active & (total > MAX_FREQ)
        fr = torch.where(norm[:, None], fr - (fr >> 1), fr)
        total = torch.where(norm, fr.sum(dim=1), total)
        at_prev = (self.iota == (p - 1)[:, None]) & active[:, None]
        f_at = (fr * at_p).sum(dim=1)
        f_prev = (fr * at_prev).sum(dim=1)
        s_at = (sy * at_p).sum(dim=1)
        s_prev = (sy * at_prev).sum(dim=1)
        swap = (active & (p > 0) & (p < self.M) & (f_at > f_prev))[:, None]
        fr = torch.where(swap & at_p, f_prev[:, None],
                         torch.where(swap & at_prev, f_at[:, None], fr))
        sy = torch.where(swap & at_p, s_prev[:, None],
                         torch.where(swap & at_prev, s_at[:, None], sy))
        self.freqs[self.bidx, ctx] = fr
        self.syms[self.bidx, ctx] = sy
        self.totals[self.bidx, ctx] = total


# ---------------------------------------------------------------------------
# arith_enc

def arith_enc(blocks, lens, msyms, M: int, order: int, per_warp: int = 0,
              pool: int = 0, chunk: int = 0, ring: int = 0):
    """Encode B blocks.

    blocks (B, N) uint8, lens (B,) int32 (bytes of each row that are
    coded), msyms (B,) int32 (max symbol + 1 of each block, at most M),
    M the model width (1..256).  Launch arguments, which do not change
    the result, 0 taking the default as every caller but chip_smoke.py
    does: ``per_warp`` blocks in the lanes of each stage warp (1..32;
    ``blocks_per_warp``), ``pool`` order-1 rows in shared memory per
    block (1..M; ``enc_pool_rows``, the contexts past them take rows of
    a global bank), ``chunk`` symbols per stage buffer (``ENC_CHUNK``)
    and ``ring`` bytes of output ring per block (a power of two >= 16;
    ``ENC_RING``).  Returns (bytes (B, 2N + 8) uint8 in stream order,
    counts (B,) int32); bytes past a block's count are unspecified.
    The max-symbol byte that precedes the payload in a stream is not
    part of it."""
    B, N = blocks.shape
    dev = blocks.device
    _require(blocks, "blocks", torch.uint8, (B, N), dev)
    _require(lens, "lens", torch.int32, (B,), dev)
    _require_model("arith_enc", msyms, M, order, B, dev)
    if not (0 <= per_warp <= 32 and 0 <= pool <= M and chunk >= 0
            and (ring == 0 or (ring >= 16 and ring & (ring - 1) == 0))):
        raise ValueError(f"arith_enc: per_warp must be in 0..32, pool in "
                         f"0..{M}, ring 0 or a power of two >= 16")
    if dev.type == "cpu":
        return _arith_enc_plain(blocks, lens, msyms, M, order)
    cap = 2 * N + 8
    props = torch.cuda.get_device_properties(dev)
    G = per_warp or blocks_per_warp(B, props.multi_processor_count)
    chunk, ring = chunk or ENC_CHUNK, ring or ENC_RING
    pool = (pool or enc_pool_rows(M, B, G, chunk, ring,
                                  props.shared_memory_per_multiprocessor,
                                  props.multi_processor_count)) \
        if order else M
    gbank = (torch.empty(B * (M - pool) * _row_stride(M) + 4,
                         dtype=torch.int32, device=dev)
             if pool < M else None)
    out = torch.empty((B, cap), dtype=torch.uint8, device=dev)
    counts = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.get_lib().arith_enc_launch(
            blocks.data_ptr(), lens.data_ptr(), msyms.data_ptr(),
            None if gbank is None else gbank.data_ptr(), out.data_ptr(),
            counts.data_ptr(), B, N, M, cap, order, G, pool, chunk, ring,
            _stream(blocks))
    cuda_build.check(err, "arith_enc")
    LAUNCHES["arith_enc"] += 1
    return out, counts


def _arith_enc_plain(blocks, lens, msyms, M: int, order: int):
    """Plain PyTorch version of arith_enc (same arguments)."""
    B, N = blocks.shape
    i64 = torch.int64
    models = _PlainModels(msyms, M, order)
    coder = _PlainCoder(B, N, blocks.device)
    ln = lens.to(i64)
    data = blocks.to(i64)
    ctx = torch.zeros((B,), dtype=i64, device=blocks.device)
    for i in range(N):
        active = i < ln
        sym = data[:, i]
        fr, sy, total = models.rows(ctx)
        match = sy == sym[:, None]
        found = match.any(dim=1)
        # a symbol the model does not hold codes as position M
        p = torch.where(found, match.to(i64).argmax(dim=1),
                        torch.full_like(sym, M))
        acc = (fr * (models.iota < p[:, None])).sum(dim=1)
        f = (fr * match).sum(dim=1)
        coder.encode(acc, f, total, active)
        models.update(ctx, fr, sy, total, p, active)
        if order == 1:
            ctx = torch.where(active,
                              torch.where(found, sym, torch.zeros_like(sym)),
                              ctx)
    return coder.finish()


# ---------------------------------------------------------------------------
# arith_dec

def arith_dec(stream, counts, lens, msyms, M: int, K: int, order: int,
              threads: int = 0, pool: int = 0):
    """Decode B blocks.

    stream (B, W) uint8 (each row a payload, after the max-symbol byte),
    counts (B,) int32 (bytes that belong to each block: a read past them
    gives 0), lens (B,) int32 (bytes to decode, at most K), msyms (B,)
    int32, M the model width (1..256).  ``threads``: threads per CTA,
    one block each (0 takes ``threads_per_cta``).  ``pool``: order-1
    model rows in shared memory per block (1..M; the contexts past them
    take rows of a global bank); 0, as every caller but the comparison
    grid of chip_smoke.py leaves it, takes ``default_pool``.  Neither changes the result.  Returns (B, K)
    uint8; bytes past a block's length are 0, and a block with fewer
    than 6 stream bytes decodes nothing."""
    B, W = stream.shape
    dev = stream.device
    _require(stream, "stream", torch.uint8, (B, W), dev)
    _require(counts, "counts", torch.int32, (B,), dev)
    _require(lens, "lens", torch.int32, (B,), dev)
    _require_model("arith_dec", msyms, M, order, B, dev)
    if W < 1 or K < 0:
        raise ValueError("arith_dec: bad geometry")
    if not 0 <= pool <= M:
        raise ValueError(f"arith_dec: pool must be in 0..{M}")
    if dev.type == "cpu":
        return _arith_dec_plain(stream, counts, lens, msyms, M, K, order)
    tpb = threads or threads_per_cta(B, dev)
    pool = (pool or default_pool(M, B, tpb, dev)) if order else M
    gbank = (torch.empty(B * (M - pool) * _row_stride(M) + 4,
                         dtype=torch.int32, device=dev)
             if pool < M else None)
    rtab = _recip_table(dev)
    out = torch.empty((B, K), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.get_lib().arith_dec_launch(
            stream.data_ptr(), counts.data_ptr(), lens.data_ptr(),
            msyms.data_ptr(), None if gbank is None else gbank.data_ptr(),
            rtab.data_ptr(), out.data_ptr(), B, W, K, M, order, tpb, pool,
            _stream(stream))
    cuda_build.check(err, "arith_dec")
    LAUNCHES["arith_dec"] += 1
    return out


def _arith_dec_plain(stream, counts, lens, msyms, M: int, K: int, order: int):
    """Plain PyTorch version of arith_dec (same arguments)."""
    B, W = stream.shape
    dev = stream.device
    i64 = torch.int64
    models = _PlainModels(msyms, M, order)
    by = stream.to(i64)
    nb = counts.to(i64).clamp(min=0, max=W)
    ok = nb >= 6
    ln = torch.where(ok, lens.to(i64).clamp(min=0, max=K),
                     torch.zeros_like(nb))
    code = torch.zeros((B,), dtype=i64, device=dev)
    for k in range(min(5, W)):
        code = ((code << 8) | by[:, k]) & _M32
    code = torch.where(ok, code, torch.zeros_like(code))
    rng = torch.full((B,), _M32, dtype=i64, device=dev)
    pos = torch.full((B,), 5, dtype=i64, device=dev)
    ctx = torch.zeros((B,), dtype=i64, device=dev)
    out = torch.zeros((B, K), dtype=torch.uint8, device=dev)
    for i in range(K):
        active = i < ln
        fr, sy, total = models.rows(ctx)
        tot = total.clamp(min=1)
        div = rng >= tot
        r = torch.where(div, rng // tot, rng)
        target = torch.where(div, code // r.clamp(min=1),
                             torch.zeros_like(code)).clamp(max=0xFFFF)
        le = fr.cumsum(dim=1) <= target[:, None]
        p = le.sum(dim=1)                       # M: past the last entry
        at_p = models.iota == p[:, None]
        f = (fr * at_p).sum(dim=1)
        sym = (sy * at_p).sum(dim=1)
        acc = (fr * le).sum(dim=1)
        code = torch.where(active, (code - acc * r) & _M32, code)
        rng = torch.where(active, (r * f.clamp(min=1)) & _M32, rng)
        for _ in range(2):
            need = active & (rng < TOP)
            byte = torch.where(
                pos < nb, by.gather(1, pos.clamp(max=W - 1)[:, None])[:, 0],
                torch.zeros_like(pos))
            code = torch.where(need, ((code << 8) | byte) & _M32, code)
            pos = pos + need.to(i64)
            rng = torch.where(need, (rng << 8) & _M32, rng)
        models.update(ctx, fr, sy, total, p, active)
        out[:, i] = torch.where(active, sym, torch.zeros_like(sym)) \
            .to(torch.uint8)
        if order == 1:
            ctx = torch.where(active, sym, ctx)
    return out


# ---------------------------------------------------------------------------
# Batch entry points (numpy in; the contract of arith_jax.enc_batch /
# dec_batch, which never return None here)

def _model_width(max_syms, B: int):
    ms = np.ascontiguousarray(max_syms, dtype=np.int32)
    if ms.shape != (B,) or (B and (ms.min() < 1 or ms.max() > NSYM)):
        raise ValueError(f"max_syms must be {B} values in 1..{NSYM} "
                         "(a stream's max-symbol byte 0 means 256)")
    return ms, int(ms.max()) if B else 1


def enc_batch(blocks: np.ndarray, lens: np.ndarray, max_syms: np.ndarray,
              order: int, device="cuda") -> list[bytes]:
    """Batched adaptive encode.  blocks (B, N) u8 padded; lens (B,);
    max_syms (B,) = each block's max symbol + 1 (1..256; the first
    payload byte of a stream, which stores 256 as 0).  Returns a list of
    B payload byte strings (without that byte)."""
    dev = check_device(device)
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    B = blocks.shape[0]
    ms, M = _model_width(max_syms, B)
    if B == 0:
        return []
    ln = np.ascontiguousarray(lens, dtype=np.int32)
    out, counts = arith_enc(convert._tensor(blocks, dev),
                            convert._tensor(ln, dev),
                            convert._tensor(ms, dev), M, order)
    return convert.payloads_to_reference(out, counts)


def dec_batch(streams, out_sizes, max_syms, order: int,
              device="cuda") -> np.ndarray:
    """Batched adaptive decode.  streams: list of payload byte strings
    (starting at the range-coded data, the max-symbol byte already
    consumed); out_sizes, max_syms: per-block ints (max_syms 1..256).
    Returns (B, max out size) u8, each row valid to its out size."""
    dev = check_device(device)
    B = len(streams)
    ms, M = _model_width(max_syms, B)
    ln = np.ascontiguousarray(out_sizes, dtype=np.int32)
    K = int(ln.max()) if B else 0
    if B == 0 or K <= 0:
        return np.zeros((B, max(K, 0)), np.uint8)
    stream, counts = convert.payloads_from_reference(
        [bytes(s) for s in streams], dev)
    out = arith_dec(stream, counts, convert._tensor(ln, dev),
                    convert._tensor(ms, dev), M, K, order)
    return out.cpu().numpy()
