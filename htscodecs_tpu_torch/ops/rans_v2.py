"""Batched rANS 4x16: dense-alphabet tables and the batch entry points.

Counterpart of ``htscodecs_tpu/ops/rans_v2.py``.  What is carried over:

- the **dense-alphabet table format**: per block, the sorted alphabet
  (``alpha (B, A) u8``, padded with duplicates of the last symbol) and
  one packed i32 table ``(base << 13) | freq`` of shape ``(B, A, A)``
  for order 1 (``(B, A)`` for order 0), built on the host by
  ``densify_*`` from the frequency tables;
- the tensor helpers the engines share: ``_densify`` (byte -> alphabet
  index), ``_b16_fill`` (packed table -> monotone cumulative-base rows)
  and ``_enc_proc_inputs`` (symbols and contexts in the encoder's
  reverse processing order);
- the batch entries ``dec_o1_batch / dec_o0_batch / enc_o1_batch /
  enc_o0_batch`` with the same numpy argument and return contract,
  plus a per-block shift vector and an explicit ``device``.

The JAX package's scan engines, encode and decode variant tables and
autotune plumbing are not carried over: here the batch entries always
run the CUDA engine in ``ops/rans_vmem.py``, its one encoder
(``rans16_enc_packed``, from the packed rows) and its decoder
(``rans16_dec``, from the base rows of ``convert.Tables``), or their
plain PyTorch versions when ``device`` is the CPU.

State-transition maths is bit-identical to ``rANS_word.h`` (L = 1<<15,
16-bit renormalisation), so streams match the C reference byte for
byte.  The 4-quarter order-1 layout mirrors
``rANS_static4x16pr.c:786-846`` (encode) and ``:1024-1114`` (decode).
"""

from __future__ import annotations

import numpy as np
import torch

RANS_L = 1 << 15
CHUNK = 128          # words per stream chunk (bucket granularity)
MAX_DENSE_A = 96     # above this the callers use the host scalar coder
SEG = 128            # emission slots per compaction segment
SEG_CAP = 32         # per-segment word cap tiers of the reference's
SEG_CAP2 = 64        # sort-compaction (kept for the shared contract;
                     # the CUDA encoder has no segment capacity)

# i32 packing of (base, freq): both <= 4096 (12-bit tables)
PACK_SHIFT = 13
PACK_MASK = (1 << PACK_SHIFT) - 1


def _round_a(a: int) -> int:
    """Pad alphabet size to a small set of buckets (the same buckets as
    the JAX package, so both sides see identical table shapes)."""
    for cand in (4, 8, 16, 24, 32, 48, 64, 72, 80, 96):
        if a <= cand:
            return cand
    return a


# ---------------------------------------------------------------------------
# Host-side dense table construction (numpy)

def densify_group(f2d: np.ndarray, b2d: np.ndarray):
    """Build dense per-block alphabets + packed tables from (B,256,256)
    freq/base arrays (order-1).

    Returns (alpha (B, A) u8 padded with duplicates of the last symbol,
    packed (B, A, A) i32, A) or None if the group's alphabet exceeds
    MAX_DENSE_A.  The alphabet is the sorted set of symbols that occur
    as context or coded symbol, always including 0 (the reference
    forces present[0]=1, rANS_static4x16pr.c:731).
    """
    B = f2d.shape[0]
    used = (f2d > 0)
    present = used.any(axis=1) | used.any(axis=2)          # (B, 256)
    present[:, 0] = True
    sizes = present.sum(axis=1)
    amax = int(sizes.max())
    if amax > MAX_DENSE_A:
        return None
    A = _round_a(amax)
    alpha = np.zeros((B, A), np.uint8)
    for b in range(B):
        al = np.flatnonzero(present[b]).astype(np.uint8)
        alpha[b, :len(al)] = al
        # pad by repeating the last symbol: keeps rows sorted and the
        # padded entries carry freq 0 so they are never selected.
        alpha[b, len(al):] = al[-1] if len(al) else 0
    bidx = np.arange(B)[:, None, None]
    a_ctx = alpha[:, :, None].astype(np.int64)
    a_sym = alpha[:, None, :].astype(np.int64)
    f = f2d[bidx, a_ctx, a_sym].astype(np.int32)
    bse = b2d[bidx, a_ctx, a_sym].astype(np.int32)
    # padded duplicate rows/columns alias a real symbol's entries; zero
    # them so the symbol search never picks a pad.
    dup = np.arange(A)[None, :] >= sizes[:, None]             # (B, A)
    pad = dup[:, None, :] | dup[:, :, None]
    f = np.where(pad, 0, f)
    bse = np.where(pad, 0, bse)
    return alpha, ((bse << PACK_SHIFT) | f).astype(np.int32), A


def extract_dense(f2d: np.ndarray, b2d: np.ndarray):
    """One block's (256,256) freq/start tables -> (alphabet, packed
    (a,a) i32) dense sub-table, or None if the alphabet is too wide."""
    used = f2d > 0
    present = used.any(axis=0) | used.any(axis=1)
    present[0] = True
    al = np.flatnonzero(present)
    if len(al) > MAX_DENSE_A:
        return None
    f = f2d[np.ix_(al, al)].astype(np.int32)
    bse = b2d[np.ix_(al, al)].astype(np.int32)
    return al, (bse << PACK_SHIFT) | f


def densify_builds(builds):
    """Streaming variant of densify_group for encode-side table builds.

    builds: iterable of (freqs (256,256), starts (256,256)) per block,
    OR of pre-extracted (alphabet, packed (a,a)) pairs from
    extract_dense.  The full (B,256,256) arrays are never stacked.
    Returns (alpha (B,A) u8, packed (B,A,A) i32, A) or None.
    """
    als, subs = [], []
    for first, second in builds:
        if first.ndim == 2:
            r = extract_dense(first, second)
            if r is None:
                return None
            al, sub = r
        else:
            al, sub = first, second
        als.append(al)
        subs.append(sub)
    B = len(als)
    A = _round_a(max(len(a) for a in als))
    alpha = np.zeros((B, A), np.uint8)
    packed = np.zeros((B, A, A), np.int32)
    for b, (al, sub) in enumerate(zip(als, subs)):
        a = len(al)
        alpha[b, :a] = al
        alpha[b, a:] = al[-1] if a else 0
        packed[b, :a, :a] = sub
    return alpha, packed, A


def densify_group_o0(freqs: np.ndarray, starts: np.ndarray):
    """Order-0 variant: (B,256) freq/start -> (alpha, packed (B,A) i32, A)."""
    B = freqs.shape[0]
    present = freqs > 0
    present[:, 0] = True
    sizes = present.sum(axis=1)
    amax = int(sizes.max())
    if amax > MAX_DENSE_A:
        return None
    A = _round_a(amax)
    alpha = np.zeros((B, A), np.uint8)
    for b in range(B):
        al = np.flatnonzero(present[b]).astype(np.uint8)
        alpha[b, :len(al)] = al
        alpha[b, len(al):] = al[-1] if len(al) else 0
    bidx = np.arange(B)[:, None]
    a_i = alpha.astype(np.int64)
    f = freqs[bidx, a_i].astype(np.int32)
    bse = starts[bidx, a_i].astype(np.int32)
    dup = np.arange(A)[None, :] >= sizes[:, None]
    f = np.where(dup, 0, f)
    bse = np.where(dup, 0, bse)
    return alpha, ((bse << PACK_SHIFT) | f).astype(np.int32), A


# ---------------------------------------------------------------------------
# Tensor helpers (run on whatever device their inputs live on)

_DENSIFY_CHUNK = 1 << 26     # bytes looked up per pass (bounds the i64 index)


def _densify(blocks: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """byte (B,N) u8 -> dense alphabet index (B,N) i32: the number of
    alphabet entries below the byte.  Built as a per-block 256-entry
    lookup table (a compare-count against the sorted alphabet) that the
    bytes then index."""
    B, N = blocks.shape
    vals = torch.arange(256, device=blocks.device, dtype=torch.int32)
    lut = (alpha[:, None, :].to(torch.int32) < vals[None, :, None]) \
        .sum(dim=2, dtype=torch.int32)                       # (B, 256)
    out = torch.empty((B, N), dtype=torch.int32, device=blocks.device)
    rows = max(1, _DENSIFY_CHUNK // max(N, 1))
    for r0 in range(0, B, rows):
        out[r0:r0 + rows] = torch.gather(
            lut[r0:r0 + rows], 1, blocks[r0:r0 + rows].to(torch.int64))
    return out


def _b16_fill(packed: torch.Tensor, shift) -> torch.Tensor:
    """(B,A,A) packed i32 -> (B, A_ctx, A+1) i32 monotone-filled
    cumulative-base table.  Holes (freq 0) take the NEXT valid entry's
    base via a reverse cumulative min (bases strictly increase over
    valid entries, so a valid entry keeps its own base); trailing holes
    and the appended column get 1 << shift.  A symbol search over such
    a row needs no validity mask, and freq = row[s+1] - row[s].
    ``shift`` is an int or a (B,) tensor."""
    B, A = packed.shape[0], packed.shape[1]
    fq = packed & PACK_MASK
    bs = packed >> PACK_SHIFT
    if isinstance(shift, int):
        tote = torch.full((B, A, 1), 1 << shift, dtype=torch.int32,
                          device=packed.device)
    else:
        one = torch.ones((), dtype=torch.int32, device=packed.device)
        tote = (one << shift.to(torch.int32))[:, None, None].expand(B, A, 1)
    filled = torch.where(fq > 0, bs, tote)
    bfill = torch.cummin(filled.flip(2), dim=2).values.flip(2)
    return torch.cat([bfill, tote], dim=2)


def _enc_proc_inputs(dense: torch.Tensor, N: int, order: int):
    """Processing-order inputs for the reverse encode scan.

    dense (B, N) alphabet indices -> (sym_p, ctx_p (K,4,B) u8, valid
    (K,4,B) bool, K, geom) with lanes flipped to the encoder's
    state-3-first processing order.  geom is the order-1 lane-3 tail
    length or the order-0 first-step pad count — validity is a pure
    function of (step, lane, geom), which lets the kernel recompute it.
    The returned tensors are (K,4,B) views of block-major (B,K,4)
    storage, the layout the CUDA encoder reads.
    Mirrors rANS_static4x16pr.c:786-846 (main quarters, state-3 tail,
    context-0 quarter leaders)."""
    B = dense.shape[0]
    dev = dense.device
    dense = dense.to(torch.uint8)
    if order == 1:
        q = N >> 2
        if q == 0:
            raise ValueError("order-1 batch encode needs N >= 4")
        tail = N - 4 * q
        K = tail + q
        D4 = dense[:, :4 * q].reshape(B, 4, q)
        sym = torch.zeros((B, K, 4), dtype=torch.uint8, device=dev)
        ctx = torch.zeros((B, K, 4), dtype=torch.uint8, device=dev)
        # tail steps s = 0..tail-1, rANS state 3 alone
        for s in range(tail):
            sym[:, s, 3] = dense[:, N - 1 - s]
            ctx[:, s, 3] = dense[:, N - 2 - s]
        # quarter steps in reverse: symbol D4[.., k], context D4[.., k-1];
        # the quarter leaders (k = 0) are coded in context 0
        sym[:, tail:, :] = D4.flip(2).permute(0, 2, 1)
        if q > 1:
            ctx[:, tail:K - 1, :] = D4[:, :, :-1].flip(2).permute(0, 2, 1)
        valid = torch.ones((B, K, 4), dtype=torch.bool, device=dev)
        valid[:, :tail, :3] = False
        geom = tail
    else:
        K = -(-N // 4)
        pad = K * 4 - N
        dpad = torch.nn.functional.pad(dense, (0, pad))
        sym = dpad.reshape(B, K, 4).flip(1)
        ctx = torch.zeros_like(sym)
        valid = torch.ones((B, K, 4), dtype=torch.bool, device=dev)
        if pad:
            valid[:, 0, 4 - pad:] = False
        geom = pad
    # processing order within a step is state 3 first
    sym = sym.flip(2).contiguous()
    ctx = ctx.flip(2).contiguous()
    valid = valid.flip(2).contiguous()
    return (sym.permute(1, 2, 0), ctx.permute(1, 2, 0),
            valid.permute(1, 2, 0), K, geom)


# ---------------------------------------------------------------------------
# Batch entry points (numpy in, numpy out)

def check_device(device) -> torch.device:
    """Resolve ``device``; the default CUDA device without a card is an
    error, never a silent CPU run."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


def _dec_tensor(states, words, out_sz: int, alpha, packed, shift,
                order: int, dev, counts=None) -> torch.Tensor:
    """The batch decode as a (B, out_sz) uint8 tensor on ``dev``, queued
    on its current stream and not yet copied back."""
    from . import convert, rans_vmem
    tables = convert.tables_from_reference(alpha, packed, shift, dev)
    st, wd, cnt = convert.streams_from_reference(states, words, dev, counts)
    return rans_vmem.rans16_dec(st, wd, cnt, tables, out_sz, order)


def _dec_batch(states, words, out_sz: int, alpha, packed, shift, order: int,
               device, counts):
    dev = check_device(device)
    return _dec_tensor(states, words, out_sz, alpha, packed, shift, order,
                       dev, counts).cpu().numpy()


def dec_o1_batch(states, words, out_sz: int, alpha, packed, shift,
                 device="cuda", counts=None):
    """Batched order-1 decode.

    states (B,4) u32; words (B,W) u16; alpha (B,A) u8; packed (B,A,A)
    i32; shift an int or a (B,) vector; counts (B,) optional per-block
    word counts (default W: every block may read its whole row).
    Returns (B, out_sz) u8.
    """
    return _dec_batch(states, words, out_sz, alpha, packed, shift, 1,
                      device, counts)


def dec_o0_batch(states, words, out_sz: int, alpha, packed, shift=12,
                 device="cuda", counts=None):
    return _dec_batch(states, words, out_sz, alpha, packed, shift, 0,
                      device, counts)


def _enc_tensors(blocks, alpha, packed, shift, order: int, dev):
    """The encoder's outputs as tensors on ``dev``: (states, words, counts)
    of ``rans_vmem.rans16_enc_packed`` (each block's stream the last
    counts[b] words of its row)."""
    from . import convert, rans_vmem
    bt = convert.as_tensor(np.ascontiguousarray(blocks, dtype=np.uint8),
                           torch.uint8, dev)
    B = bt.shape[0]
    al = convert.as_tensor(alpha, torch.uint8, dev)
    pk = convert.as_tensor(packed, torch.int32, dev).reshape(B, -1)
    sv = convert.as_tensor(convert.shift_vector(shift, B), torch.int32, dev)
    return rans_vmem.rans16_enc_packed(bt, al, pk, sv, order)


def _enc_batch(blocks, alpha, packed, shift, order: int, device):
    from . import convert
    dev = check_device(device)
    return convert.streams_to_reference(
        *_enc_tensors(blocks, alpha, packed, shift, order, dev))


def enc_o1_batch(blocks: np.ndarray, alpha, packed, shift, device="cuda"):
    """Batched order-1 encode via dense tables.  Returns (states (B,4)
    u32, words (B,cap) u16 forward order, counts (B,) i32); only
    ``words[b, :counts[b]]`` is meaningful."""
    return _enc_batch(blocks, alpha, packed, shift, 1, device)


def enc_o0_batch(blocks: np.ndarray, alpha, packed, shift=12, device="cuda"):
    return _enc_batch(blocks, alpha, packed, shift, 0, device)
