"""Batched rANS 4x16 engines, first generation (gather-based): a test
oracle.

Counterpart of ``htscodecs_tpu/ops/rans_jax.py``; the name is kept so
that a reader finds it, and the module imports no JAX.  In the JAX
package these are plain ``lax.scan`` engines (no Pallas kernel),
superseded on every production path by the dense-alphabet engines and
kept as an independent implementation for conformance tests; the round
trip step ``parallel.pipeline.roundtrip_o1`` runs on them.  Here they
are the same step loops in PyTorch operations over (K, B, 4) tensors on
the inputs' device, so they get no CUDA kernel of their own; they run at
small sizes only.

Values are u32 / u16 in the reference; here they are held in int64
lanes and masked to 32 bits after each operation that can leave that
range, so every state, word and symbol equals the JAX engine's.
"""

from __future__ import annotations

import numpy as np
import torch

from .rans_v2 import check_device

RANS_L = 1 << 15
_M32 = 0xFFFFFFFF
_I64 = torch.int64


def _t(x, dev) -> torch.Tensor:
    """numpy or tensor -> int64 tensor on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=_I64)
    return torch.from_numpy(np.ascontiguousarray(x).astype(np.int64)).to(dev)


# ---------------------------------------------------------------------------
# encode

def _enc_scan(starts, freqs, valid, shift: int):
    """Core reverse scan.

    starts/freqs/valid: (K, B, 4) per-step per-state coding parameters
    in PROCESSING order (step 0 is encoded first; int tensors and a bool
    tensor).  Returns final states (B, 4), words (K, B, 4) (the low 16
    bits of the state before each step) and emit flags (K, B, 4) bool,
    in processing order."""
    K, B, _ = starts.shape
    dev = starts.device
    x = torch.full((B, 4), RANS_L, dtype=_I64, device=dev)
    xmax_mult = (RANS_L >> shift) << 16
    words = torch.empty((K, B, 4), dtype=_I64, device=dev)
    emits = torch.empty((K, B, 4), dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=_I64, device=dev)
    for k in range(K):
        start = starts[k].to(_I64)
        freq = freqs[k].to(_I64)
        ok = valid[k]
        x_max = (xmax_mult * freq) & _M32
        emit = (x >= x_max) & ok
        words[k] = x & 0xFFFF
        emits[k] = emit
        x2 = torch.where(emit, x >> 16, x)
        q = x2 // torch.where(ok, freq, one)
        newx = ((q << shift) + (x2 - q * freq) + start) & _M32
        x = torch.where(ok, newx, x)
    return x, words, emits


def _enc_compact(xf, words, emits, shift: int, cap: int):
    """Compact emitted words into forward-order streams.

    Emission processing order is step ascending with state 3 first; the
    stream is written backwards, so forward order is the exact reverse:
    (K-1-k, states 0..3) ascending.  Returns ((B, cap) int64 u16 values,
    (B,) counts)."""
    K, B, _ = words.shape
    dev = words.device
    w = words.flip(0).flip(2).permute(1, 0, 2).reshape(B, -1)
    e = emits.flip(0).flip(2).permute(1, 0, 2).reshape(B, -1)
    idx = e.to(_I64).cumsum(dim=1) - 1
    n = idx[:, -1] + 1
    tgt = torch.where(e, idx, torch.full_like(idx, cap)).clamp(max=cap)
    out = torch.zeros((B, cap + 1), dtype=_I64, device=dev)
    out.scatter_(1, tgt, torch.where(e, w, torch.zeros_like(w)))
    return out[:, :cap], n


def _run_enc(st_p, fr_p, va_p, shift: int, N: int):
    xf, words, emits = _enc_scan(st_p, fr_p, va_p, shift)
    out, n = _enc_compact(xf, words, emits, shift, int(N + 16))
    # scan lanes are in processing order (state 3 first); flip to 0..3
    return (xf.flip(1).cpu().numpy().astype(np.uint32),
            out.cpu().numpy().astype(np.uint16),
            n.cpu().numpy().astype(np.int32))


def enc_o0_batch(blocks: np.ndarray, start: np.ndarray, freq: np.ndarray,
                 shift: int = 12, device="cuda"):
    """Batched order-0 payload encode.

    blocks (B, N) uint8; start/freq (B, 256) normalised tables.  Returns
    (states (B,4) u32, words (B, N+16) u16, counts (B,)) as numpy
    arrays; payload = states LE ++ words[:count] LE."""
    dev = check_device(device)
    B, N = blocks.shape
    K = (N + 3) // 4
    pad = K * 4 - N
    sy = np.pad(blocks, ((0, 0), (0, pad))).reshape(B, K, 4)
    valid = np.ones((B, K, 4), dtype=bool)
    if pad:
        valid[:, -1, 4 - pad:] = False
    b_idx = np.arange(B)[:, None, None]
    st = start[b_idx, sy].astype(np.uint32)
    fr = freq[b_idx, sy].astype(np.uint32)
    # processing order: steps reversed, states 3..0 within a step
    st_p = np.transpose(st[:, ::-1, ::-1], (1, 0, 2))
    fr_p = np.transpose(fr[:, ::-1, ::-1], (1, 0, 2))
    va_p = np.transpose(valid[:, ::-1, ::-1], (1, 0, 2))
    return _run_enc(_t(st_p, dev), _t(fr_p, dev),
                    torch.from_numpy(np.ascontiguousarray(va_p)).to(dev),
                    shift, N)


def o1_params(blocks: np.ndarray):
    """(ctx, sym, valid) (K, B, 4) of the order-1 encode in processing
    order (state 3 first within a step is applied by the caller): the
    state-3 tail, then the quarter steps k = q-2..0, then the four
    context-0 quarter leaders.  Returns (ctx, sym, valid, K, q)."""
    B, N = blocks.shape
    q = N >> 2
    tail = N - 4 * q
    K = tail + q
    ctx = np.zeros((K, B, 4), dtype=np.int32)
    sym = np.zeros((K, B, 4), dtype=np.int32)
    valid = np.zeros((K, B, 4), dtype=bool)
    for s in range(tail):
        i3 = N - 2 - s
        ctx[s, :, 3] = blocks[:, i3]
        sym[s, :, 3] = blocks[:, i3 + 1]
        valid[s, :, 3] = True
    if q >= 2:
        ks = np.arange(q - 2, -1, -1)
        c = blocks[:, (ks[:, None] + np.arange(4)[None, :] * q)]
        nx = blocks[:, (ks[:, None] + np.arange(4)[None, :] * q + 1)]
        ctx[tail:tail + q - 1] = np.transpose(c, (1, 0, 2))
        sym[tail:tail + q - 1] = np.transpose(nx, (1, 0, 2))
        valid[tail:tail + q - 1] = True
    ctx[K - 1] = 0
    sym[K - 1] = blocks[:, (np.arange(4) * q)]
    valid[K - 1] = True
    return ctx, sym, valid, K, q


def enc_o1_batch(blocks: np.ndarray, start2d: np.ndarray, freq2d: np.ndarray,
                 shift: int, device="cuda"):
    """Batched order-1 payload encode.

    blocks (B, N) uint8 with N >= 8; start2d/freq2d (B, 256, 256).
    Handles the state-3 tail and the four context-0 quarter leaders."""
    dev = check_device(device)
    B, N = blocks.shape
    ctx, sym, valid, _K, _q = o1_params(blocks)
    b_idx = np.arange(B)[None, :, None]
    st = start2d[b_idx, ctx, sym].astype(np.uint32)
    fr = freq2d[b_idx, ctx, sym].astype(np.uint32)
    # within a step the processing order is state 3 first
    return _run_enc(_t(st[:, :, ::-1], dev), _t(fr[:, :, ::-1], dev),
                    torch.from_numpy(np.ascontiguousarray(
                        valid[:, :, ::-1])).to(dev), shift, N)


# ---------------------------------------------------------------------------
# decode

def _renorm(X, p, buf, need):
    """Feed each state that needs it one word of its block's stream, in
    state order: (new X, new p)."""
    W = buf.shape[1]
    ni = need.to(_I64)
    off = ni.cumsum(dim=1) - ni
    src = (p[:, None] + off).clamp(max=W - 1)
    w = torch.gather(buf, 1, src)
    can = need & ((p[:, None] + off) < W)
    X = torch.where(can, ((X << 16) | w) & _M32, X)
    return X, p + (ni * can.to(_I64)).sum(dim=1)


def _dec_o0_scan(X0, buf, p0, ssym, sfb, shift: int, K: int):
    """X0 (B,4) initial states; buf (B,W) word stream (u16 values); p0
    (B,) initial word pointers; ssym (B, 1<<shift) symbols; sfb (B,
    1<<shift) packed ``freq << 16 | base``.  Returns symbols (K, B, 4)
    and the final (X, p)."""
    X, p = X0.to(_I64), p0.to(_I64)
    buf, ssym, sfb = buf.to(_I64), ssym.to(_I64), sfb.to(_I64)
    mask = (1 << shift) - 1
    syms = torch.empty((K,) + tuple(X.shape), dtype=_I64, device=X.device)
    for k in range(K):
        m = X & mask
        syms[k] = torch.gather(ssym, 1, m)
        fb = torch.gather(sfb, 1, m)
        X = ((fb >> 16) * (X >> shift) + (fb & 0xFFFF)) & _M32
        X, p = _renorm(X, p, buf, X < RANS_L)
    return syms, X, p


def dec_o0_batch(states: np.ndarray, words: np.ndarray, out_sz: int,
                 ssym: np.ndarray, sfreq: np.ndarray, sbase: np.ndarray,
                 shift: int = 12, device="cuda") -> np.ndarray:
    """Batched order-0 payload decode.

    states (B,4) u32; words (B,W) u16 renormalisation stream; slot
    tables (B, 1<<shift).  Returns (B, out_sz) uint8."""
    dev = check_device(device)
    B = states.shape[0]
    K = (out_sz + 3) // 4
    sfb = (sfreq.astype(np.int64) << 16) | sbase.astype(np.int64)
    syms, _, _ = _dec_o0_scan(
        _t(states, dev), _t(words, dev),
        torch.zeros((B,), dtype=_I64, device=dev), _t(ssym, dev),
        _t(sfb, dev), shift, K)
    out = syms.cpu().numpy().astype(np.uint8)             # (K, B, 4)
    return np.transpose(out, (1, 0, 2)).reshape(B, K * 4)[:, :out_sz]


def _dec_o1_scan(X0, buf, p0, sfb_flat, fbb_flat, shift: int, K: int,
                 q: int):
    """sfb_flat (B, 256<<shift) symbol per (ctx * tot + slot); fbb_flat
    (B, 65536) packed ``freq << 16 | base`` per (ctx, sym).  States 0-2
    stop after q steps; state 3 runs all K (the tail).  Returns symbols
    (K, B, 4) and the final (X, p)."""
    X, p = X0.to(_I64), p0.to(_I64)
    buf, sfb_flat, fbb_flat = (buf.to(_I64), sfb_flat.to(_I64),
                               fbb_flat.to(_I64))
    dev = X.device
    mask = (1 << shift) - 1
    ctx = torch.zeros_like(X)
    tail = torch.tensor([False, False, False, True], device=dev)[None, :]
    syms = torch.empty((K,) + tuple(X.shape), dtype=_I64, device=dev)
    for s in range(K):
        act = torch.ones_like(tail) if s < q else tail
        m = X & mask
        sym = torch.gather(sfb_flat, 1, (ctx << shift) + m)
        fb = torch.gather(fbb_flat, 1, (ctx << 8) | sym)
        Xn = ((fb >> 16) * (X >> shift) + m - (fb & 0xFFFF)) & _M32
        Xn, pn = _renorm(Xn, p, buf, (Xn < RANS_L) & act)
        X = torch.where(act, Xn, X)
        p = pn
        ctx = torch.where(act, sym, ctx)
        syms[s] = sym
    return syms, X, p


def syms_to_bytes(syms: torch.Tensor, out_sz: int, q: int) -> torch.Tensor:
    """(K, B, 4) order-1 symbols -> (B, out_sz): the four quarters, then
    state 3's tail."""
    B = syms.shape[1]
    main = syms[:q].permute(1, 2, 0).reshape(B, 4 * q)
    if 4 * q >= out_sz:
        return main[:, :out_sz]
    return torch.cat([main, syms[q:, :, 3].permute(1, 0)], dim=1)


def dec_o1_batch(states: np.ndarray, words: np.ndarray, out_sz: int,
                 sfb: np.ndarray, f2d: np.ndarray, b2d: np.ndarray,
                 shift: int, device="cuda") -> np.ndarray:
    """Batched order-1 payload decode.

    sfb (B, 256, 1<<shift) context-slot -> symbol; f2d/b2d (B, 256,
    256).  Returns (B, out_sz) uint8."""
    dev = check_device(device)
    B = states.shape[0]
    q = out_sz >> 2
    K = q + (out_sz - 4 * q)
    fbb = ((f2d.astype(np.int64) << 16) | b2d.astype(np.int64)).reshape(B, -1)
    syms, _, _ = _dec_o1_scan(
        _t(states, dev), _t(words, dev),
        torch.zeros((B,), dtype=_I64, device=dev), _t(sfb.reshape(B, -1), dev),
        _t(fbb, dev), shift, K, q)
    return syms_to_bytes(syms, out_sz, q).cpu().numpy().astype(np.uint8)
