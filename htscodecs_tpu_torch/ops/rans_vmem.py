"""The batched rANS 4x16 engine: three CUDA kernels and what surrounds
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
# kernel and nowhere else
LAUNCHES = {"rans16_dec": 0, "sf_fetch": 0, "rans16_enc": 0}


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
    B, W = words.shape
    A = tables.alpha.shape[1]
    dev = words.device
    q, K = _dec_geometry(N, order)
    i64 = torch.int64
    X = states.to(i64) & _M32                               # (B,4)
    wl = words.to(i64) & 0xFFFF
    nw = counts.to(i64).clamp(max=W)[:, None]
    rows_all = tables.bases.to(i64)                         # (B,Ac,A+1)
    alpha = tables.alpha
    sh = tables.shift.to(i64)[:, None]
    mask = (torch.ones_like(sh) << sh) - 1
    bidx = torch.arange(B, device=dev)[:, None]
    lanes = torch.arange(4, device=dev)
    p = torch.zeros((B,), dtype=i64, device=dev)
    ctx = torch.zeros((B, 4), dtype=i64, device=dev)
    out = torch.zeros((B, N), dtype=torch.uint8, device=dev)
    for s in range(K):
        if order == 1:
            act = (lanes == 3) if s >= q else lanes >= 0
            rows = rows_all[bidx, ctx]                      # (B,4,A+1)
        else:
            act = lanes >= 0
            rows = rows_all[:, 0][:, None, :].expand(B, 4, A + 1)
        act = act[None, :]
        m = X & mask
        c = (rows[:, :, :A] <= m[:, :, None]).sum(dim=2)
        sym = (c - 1).clamp(min=0)
        bs = torch.where(c > 0, rows.gather(2, sym[:, :, None])[:, :, 0],
                         torch.zeros_like(c))
        f = rows.gather(2, (sym + 1)[:, :, None])[:, :, 0] - bs
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
    B = sf.shape[0]
    dev = sf.device
    i64 = torch.int64
    cap = 4 * K
    sh = shift.to(i64)[:, None]
    xmult = (RANS_L >> sh) << 16
    lanes = torch.arange(4, device=dev)
    X = torch.full((B, 4), RANS_L, dtype=i64, device=dev)
    # emission-order buffer with one spill column for non-emitting lanes
    buf = torch.zeros((B, cap + 1), dtype=i64, device=dev)
    n = torch.zeros((B,), dtype=i64, device=dev)
    sfl = sf.to(i64).view(B, K, 4)
    for s in range(K):
        if order == 1:
            ok = (lanes == 0) if s < geom else lanes >= 0
        else:
            ok = (lanes >= geom) if s == 0 else lanes >= 0
        ok = ok[None, :]
        v = sfl[:, s, :]
        start = v & 0xFFF
        f = (v >> 12) & 0x1FFF
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
    # forward order = reverse of emission order
    i = torch.arange(cap, device=dev)[None, :]
    src = (n[:, None] - 1 - i).clamp(min=0)
    fwd = torch.where(i < n[:, None], buf[:, :cap].gather(1, src),
                      torch.zeros_like(src))
    states = X.flip(1)
    return (_to_i32_bits(states), _to_i16_bits(fwd), n.to(torch.int32))


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


def enc_queries(blocks: torch.Tensor, tables: Tables, order: int):
    """What the encoder's two kernels read, from the raw blocks: the
    per-block (start | freq << 12) tables, the flat (context, symbol)
    query per symbol in processing order (B, 4K) int32, K and geom.
    Counterpart of ``_enc_vmem``'s pre-processing."""
    B, N = blocks.shape
    A = tables.alpha.shape[1]
    dense = rans_v2._densify(blocks, tables.alpha)
    sym_p, ctx_p, _valid, K, geom = rans_v2._enc_proc_inputs(dense, N, order)
    del dense, _valid
    # (K,4,B) views of block-major storage -> (B, 4K), no copy
    qidx = sym_p.permute(2, 0, 1).reshape(B, 4 * K).to(torch.int32)
    if order == 1:
        qidx += ctx_p.permute(2, 0, 1).reshape(B, 4 * K).to(torch.int32) * A
    return sf_table(tables), qidx, K, geom


def enc_batch(blocks: torch.Tensor, tables: Tables, order: int):
    """Encode a batch of equal-length blocks: counterpart of
    ``_enc_vmem(prefetch=True)``.  blocks (B,N) uint8.  Returns
    (states (B,4) int32, words (B,cap) int16 forward, counts (B,))."""
    tbl, qidx, K, geom = enc_queries(blocks, tables, order)
    sf = sf_fetch(tbl, qidx)
    del qidx
    return rans16_enc(sf, tables.shift, K, geom, order)
