"""The batched rANS 4x8 engine (CRAM 3.0): two CUDA kernels and what
surrounds them.

Counterpart of ``htscodecs_tpu/ops/rans8_vmem.py``.  The 4x16 engine's
design (``ops/rans_vmem.py``: one 4-thread group per block, ordered
stream claims by warp ballot) with the ``rANS_byte.h`` parameters: L =
1 << 23, the table precision fixed at 12 bits, byte renormalisation
with up to TWO bytes emitted or consumed per state and step.  Byte
order inside a step is state 0..3 on decode (processing lane 0..3 on
encode), a state's two bytes adjacent, low byte first on encode; the
forward stream is the full reverse of the emission sequence.

The encoder reads packed rows, as the 4x16 encoder does.  The decoder
reads monotone int16 base rows; 4x8 table rows normalise to 4095 slots
(a quirk of the C reference), so their successor column holds the
PER-ROW total (``_b16_fill_rowtot``), not ``1 << 12``, and ``freq =
base[sym+1] - base[sym]`` holds as in the 4x16 tables.

``rans8_dec``  csrc/rans8_dec.cu
    replaces ``_build_dec_kernel`` / ``_dec_vmem8`` (decode, order 0
    and 1, with the order-0 tail that reads the last N & 3 symbols from
    the final states without advancing them).  Bound by memory traffic
    (stream bytes + tables + states in, B*N bytes out), by the chain of
    one step in fact: the CTA's base rows and alphabets sit in shared
    memory when they fit (``tables_in_smem``) with a slot index per row
    (``slot_index``; ``slot_lookup_indexed`` is the lookup through it),
    each block's stream is staged ahead of the chain in a shared ring
    with ``cp.async``, and CTAs of ``threads`` threads (32, 64 or 128; 4
    per block) spread a batch over all SMs.
``rans8_enc``  csrc/rans8_enc.cu
    replaces ``_build_enc_kernel`` / ``_enc_vmem8`` and its stitch
    sort.  Reads the raw block bytes and the packed ``base << 13 |
    freq`` rows (so a row's total never enters it), on the 4x16
    encoder's layout (``rans_vmem.rans16_enc_packed``): entries beside
    the reciprocals of their freqs in shared memory where they fit
    (``rans_vmem.enc_tables_in_smem``), the bytes staged in reverse by
    ``cp.async``, the lookup pipelined ahead of the chain, and the bytes
    written in forward order at the END of each block's row.  Bound by
    operations; the chain of one state per thread sets the time.

Each wrapper uses its plain PyTorch version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.  States are
int32 bit patterns (``ops/convert.py``); the stream is plain uint8.
"""

from __future__ import annotations

import torch

from .. import cuda_build
from . import convert, rans_v2, rans_vmem
from .convert import Tables
# the 4x8 decoder keeps its tables and indexes its rows as the 4x16
# decoder does (the same shared-memory rule and slot index of 64-slot
# steps), with its own ring of STAGE bytes per block
from .rans_vmem import (IDX_N, LAUNCHES, TABLES_SMEM_MAX, _M32,  # noqa: F401
                        _aligned, _enc_active, _require, _slot_lookup,
                        _stream, _to_i32_bits, enc_tables_in_smem,
                        slot_index, slot_lookup_indexed)

RANS8_L = 1 << 23
SHIFT = 12
MASK = (1 << SHIFT) - 1


def _b16_fill_rowtot(packed: torch.Tensor) -> torch.Tensor:
    """``rans_v2._b16_fill`` with PER-ROW totals: packed (B, Ac, A) i32
    as ``base << 13 | freq`` -> (B, Ac, A+1) i32 monotone base rows
    whose holes take the next valid entry's base and whose trailing
    holes and appended column hold the row's own total (4095 or 4096;
    0 for an unused row)."""
    fq = packed & rans_v2.PACK_MASK
    bs = packed >> rans_v2.PACK_SHIFT
    tote = torch.where(fq > 0, bs + fq, torch.zeros_like(bs)) \
        .amax(dim=2, keepdim=True)
    filled = torch.where(fq > 0, bs, tote)
    bfill = torch.cummin(filled.flip(2), dim=2).values.flip(2)
    return torch.cat([bfill, tote], dim=2)


# ---------------------------------------------------------------------------
# rans8_dec

def _dec_geometry(N: int, order: int):
    """(q, K): order 1 runs q quarter steps and the state-3 tail;
    order 0 runs N >> 2 full steps (its last N & 3 symbols are read
    from the final states)."""
    q = N >> 2
    return (q, q + (N - 4 * q)) if order == 1 else (q, q)


DEC_THREADS = 32     # threads per rans8_dec CTA (8 blocks)
STAGE = 256          # staged stream bytes per block (csrc/rans8_dec.cu: SB)


def _dec_smem(bpc: int, A: int, order: int, tables: bool) -> int:
    """Shared memory of one ``rans8_dec`` CTA of ``bpc`` blocks
    (csrc/rans8_dec.cu: rans8_dec_smem; ``rans_vmem._dec_smem`` with
    this decoder's ring)."""
    return rans_vmem._dec_smem(bpc, A, order, tables, STAGE)


def tables_in_smem(threads: int, A: int, order: int) -> bool:
    """Whether a ``rans8_dec`` launch copies its tables into shared
    memory (``rans_vmem.dec_tables_in_smem``'s rule with this decoder's
    ring)."""
    return rans_vmem.dec_tables_in_smem(threads, A, order, STAGE)


def rans8_dec(states, stream, counts, tables: Tables, N: int, order: int,
              threads: int = 0, global_tables: bool = False):
    """Decode B blocks.

    states (B,4) int32, stream (B,W) uint8 (the bytes after the 16
    state bytes), counts (B,) int32 (bytes that belong to each block: a
    read past them gives 0), tables with bases (B, A if order else 1,
    A+1) int16.  Order 0 needs N >= 4.  Launch arguments, which do not
    change the result: ``threads`` per CTA (32, 64 or 128; 0 takes
    ``DEC_THREADS``), ``global_tables`` reads the tables from global
    memory even where ``tables_in_smem`` would copy them (the wide-table
    route).  Returns (B,N) uint8.
    """
    B, W = stream.shape
    A = tables.alpha.shape[1]
    dev = stream.device
    _require(states, "states", torch.int32, (B, 4), dev)
    _require(stream, "stream", torch.uint8, (B, W), dev)
    _require(counts, "counts", torch.int32, (B,), dev)
    _require(tables.alpha, "alpha", torch.uint8, (B, A), dev)
    _require(tables.bases, "bases", torch.int16,
             (B, A if order == 1 else 1, A + 1), dev)
    if order not in (0, 1) or N <= 0 or W < 1:
        raise ValueError("rans8_dec: bad geometry")
    if order == 0 and N < 4:
        raise ValueError("rans8_dec: order 0 needs N >= 4 (a full step "
                         "would run before the tail is read)")
    if threads not in (0, 32, 64, 128):
        raise ValueError("rans8_dec: threads must be 0, 32, 64 or 128")
    if dev.type == "cpu":
        return _rans8_dec_plain(states, stream, counts, tables, N, order)
    threads = threads or DEC_THREADS
    smem_tables = not global_tables and tables_in_smem(threads, A, order)
    if stream.data_ptr() % 16:
        stream = stream.clone()         # the kernel stages aligned segments
    out = torch.empty((B, N), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.get_lib().rans8_dec_launch(
            states.data_ptr(), stream.data_ptr(), counts.data_ptr(),
            tables.bases.data_ptr(), tables.alpha.data_ptr(), out.data_ptr(),
            B, W, A, N, order, threads, int(smem_tables), _stream(stream))
    cuda_build.check(err, "rans8_dec")
    LAUNCHES["rans8_dec"] += 1
    return out


def _rans8_dec_plain(states, stream, counts, tables: Tables, N: int,
                     order: int):
    """Plain PyTorch version of rans8_dec (same arguments)."""
    B, W = stream.shape
    A = tables.alpha.shape[1]
    dev = stream.device
    q, K = _dec_geometry(N, order)
    i64 = torch.int64
    X = states.to(i64) & _M32                               # (B,4)
    by = stream.to(i64)
    nb = counts.to(i64).clamp(max=W)[:, None]
    rows_all = tables.bases.to(i64)                         # (B,Ac,A+1)
    alpha = tables.alpha
    bidx = torch.arange(B, device=dev)[:, None]
    lanes = torch.arange(4, device=dev)
    p = torch.zeros((B,), dtype=i64, device=dev)
    ctx = torch.zeros((B, 4), dtype=i64, device=dev)
    out = torch.zeros((B, N), dtype=torch.uint8, device=dev)
    row0 = rows_all[:, 0][:, None, :].expand(B, 4, A + 1)

    def claim(pos):
        return torch.where(pos < nb, by.gather(1, pos.clamp(max=W - 1)),
                           torch.zeros_like(pos))

    for s in range(K):
        if order == 1:
            act = (lanes == 3) if s >= q else lanes >= 0
            rows = rows_all[bidx, ctx]                      # (B,4,A+1)
        else:
            act = lanes >= 0
            rows = row0
        act = act[None, :]
        m = X & MASK
        sym, bs, f = _slot_lookup(rows, m)
        Xn = (f * (X >> SHIFT) + m - bs) & _M32
        # whether a second byte is needed does not depend on the first
        # byte's value, so every offset is known before any read
        need1 = (Xn < RANS8_L) & act
        need2 = need1 & (Xn < (RANS8_L >> 8))
        c = need1.to(i64) + need2.to(i64)
        pos = p[:, None] + c.cumsum(dim=1) - c
        Xn = torch.where(need1, ((Xn << 8) | claim(pos)) & _M32, Xn)
        Xn = torch.where(need2, ((Xn << 8) | claim(pos + 1)) & _M32, Xn)
        X = torch.where(act, Xn, X)
        p = p + c.sum(dim=1)
        ctx = torch.where(act, sym, ctx)
        byte = alpha.gather(1, sym)                         # (B,4) u8
        if order == 0:
            out[:, 4 * s:4 * s + 4] = byte
        elif s < q:
            out[:, lanes * q + s] = byte
        else:
            out[:, 4 * q + (s - q)] = byte[:, 3]
    r = N & 3
    if order == 0 and r:
        sym, _bs, _f = _slot_lookup(row0, X & MASK)
        out[:, 4 * K:] = alpha.gather(1, sym)[:, :r]
    return out


# ---------------------------------------------------------------------------
# rans8_enc

def rans8_enc(blocks, alpha, packed, order: int):
    """Encode B blocks of N bytes with packed rows.

    blocks (B,N) uint8 raw bytes (order 1: N >= 4), alpha (B,A) uint8
    (A <= 255), packed (B, A if order else 1, A) int32 ``base << 13 |
    freq`` (a one-symbol row's freq may be 4096).  A byte maps to the
    number of alphabet entries below it (``rans_v2._densify``); a dense
    symbol or context past the alphabet reads freq 0 and start 0, and a
    freq of 0 divides by 1 (the JAX engine divides by zero there, the
    one case in which the two differ).  Returns (states (B,4) int32 in state order,
    bytes (B, 8K) uint8, counts (B,) int32): block b's stream in forward
    order is the LAST counts[b] bytes of its row
    (``convert.streams8_to_reference`` reads it); the bytes before them
    are unspecified."""
    B, N = blocks.shape
    A = alpha.shape[1]
    dev = blocks.device
    _require(blocks, "blocks", torch.uint8, (B, N), dev)
    _require(alpha, "alpha", torch.uint8, (B, A), dev)
    _require(packed, "packed", torch.int32, (B, A if order else 1, A), dev)
    if order not in (0, 1) or N < (4 if order else 1) or not 1 <= A <= 255:
        raise ValueError("rans8_enc: bad geometry")
    if dev.type == "cpu":
        return _rans8_enc_plain(blocks, alpha, packed, order)
    K, _geom = rans_vmem._enc_geometry(N, order)
    cap = 8 * K
    blocks = _aligned(blocks)
    states = torch.empty((B, 4), dtype=torch.int32, device=dev)
    out = torch.empty((B, cap), dtype=torch.uint8, device=dev)
    counts = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.get_lib().rans8_enc_launch(
            blocks.data_ptr(), alpha.data_ptr(), packed.data_ptr(),
            states.data_ptr(), out.data_ptr(), counts.data_ptr(),
            B, N, A, order, cap, int(enc_tables_in_smem(A, order)),
            _stream(blocks))
    cuda_build.check(err, "rans8_enc")
    LAUNCHES["rans8_enc"] += 1
    return states, out, counts


def _rans8_enc_plain(blocks, alpha, packed, order: int):
    """Plain PyTorch version of rans8_enc (same arguments); alphabets of
    256 are taken too (the comparison grid encodes its widest tables
    here)."""
    B, N = blocks.shape
    A = alpha.shape[1]
    dev = blocks.device
    i64 = torch.int64
    dense = rans_v2._densify(blocks, alpha)
    sym_p, ctx_p, _valid, K, geom = rans_v2._enc_proc_inputs(dense, N, order)
    sym = sym_p.permute(2, 0, 1).to(i64)                    # (B,K,4)
    ctx = ctx_p.permute(2, 0, 1).to(i64)
    pk = packed.reshape(B, -1).to(i64)
    A2 = pk.shape[1]
    cap = 8 * K
    xmult = (RANS8_L >> SHIFT) << 8
    lanes = torch.arange(4, device=dev)
    X = torch.full((B, 4), RANS8_L, dtype=i64, device=dev)
    # forward-order buffer with one spill column for non-emitting lanes
    buf = torch.zeros((B, cap + 1), dtype=i64, device=dev)
    spill = torch.full((B, 4), cap, dtype=i64, device=dev)
    n = torch.zeros((B,), dtype=i64, device=dev)
    for s in range(K):
        ok = _enc_active(lanes, s, geom, order)
        sy, cx = sym[:, s, :], ctx[:, s, :]
        inside = (sy < A) & (cx < A)
        key = torch.where(inside, sy + (cx * A if order else 0),
                          torch.zeros_like(sy))
        e = torch.where(inside, pk.gather(1, key.clamp(max=A2 - 1)),
                        torch.zeros_like(sy))
        start, f = e >> rans_v2.PACK_SHIFT, e & rans_v2.PACK_MASK
        x_max = xmult * f
        # up to two bytes, low byte first; the second only if the state
        # is still too large after the first
        emit1 = ok & (X >= x_max)
        x1 = torch.where(emit1, X >> 8, X)
        emit2 = emit1 & (x1 >= x_max)
        x2 = torch.where(emit2, x1 >> 8, x1)
        c = emit1.to(i64) + emit2.to(i64)
        rank = n[:, None] + c.cumsum(dim=1) - c
        buf.scatter_(1, torch.where(emit1, cap - 1 - rank, spill), X & 0xFF)
        buf.scatter_(1, torch.where(emit2, cap - 2 - rank, spill), x1 & 0xFF)
        fs = torch.where(f > 0, f, torch.ones_like(f))
        qq = x2 // fs
        xn = ((qq << SHIFT) + (x2 - qq * fs) + start) & _M32
        X = torch.where(ok, xn, X)
        n = n + c.sum(dim=1)
    return (_to_i32_bits(X.flip(1)), buf[:, :cap].to(torch.uint8),
            n.to(torch.int32))


# ---------------------------------------------------------------------------
# What surrounds the kernels (tensor in, tensor out)

def enc_batch(blocks: torch.Tensor, alpha, packed, order: int):
    """Encode a batch of equal-length blocks: counterpart of
    ``_enc_vmem8``.  blocks (B,N) uint8 on the engine's device; alpha
    (B,A) and packed (B,A,A) (order 0: (B,A)) as numpy arrays or
    tensors, moved there as they are.  Returns ``rans8_enc``'s (states,
    bytes with each stream at the end of its row, counts)."""
    dev = blocks.device
    B = blocks.shape[0]
    al = convert.as_tensor(alpha, torch.uint8, dev)
    A = al.shape[1]
    pk = convert.as_tensor(packed, torch.int32, dev).view(
        B, A if order else 1, A)
    return rans8_enc(blocks, al, pk, order)


def dec_batch(states, stream, counts, tables: Tables, N: int, order: int):
    """Decode a batch of equal-length blocks: counterpart of
    ``_dec_vmem8``.  The kernel writes (B, N) bytes directly and reads
    the order-0 tail itself, so nothing surrounds it."""
    return rans8_dec(states, stream, counts, tables, N, order)
