"""On-device rANS 4x16 frequency-table construction (orders 0 and 1).

Counterpart of ``htscodecs_tpu/ops/tables_v2.py``.  That module builds
the per-block normalised tables in XLA; here the same steps are plain
PyTorch operations on the tensor's device (no hand-written kernel: none
of them is a Pallas kernel in the JAX package).  What differs, because
the card's idiom differs from the TPU's:

- **histograms** are counted with ``torch.bincount`` on a flat int32
  index (order 1: ``b*A*A + ctx*A + sym`` per tile of at most ``TILE``
  blocks, below 2^31 at A = 96, and fewer where a tile's (blocks, N)
  int32 tensors would pass ``_TILE_BYTES``; order 0: ``b*256 +
  byte``), not with a one-hot matrix product.  Counts are integers, so the order in which
  the card's atomics land does not matter;
- **presence** is a scatter of ones (byte 0 is always present: the
  reference forces it, ``rANS_static4x16pr.c:731``);
- **normalisation** replays ``normalise_freq``
  (``rANS_static4x16pr.c:116-161``) directly in int64 lanes:
  ``tr = (tot<<31)//size + (1<<30)//size``, ``F*tr >> 31``, the retry
  pass and the hard path as the reference has them.  The JAX package's
  two-limb int32 emulation of the 64-bit product is not needed.

The 10-vs-12-bit shift heuristic (``rANS_static4x16pr.c:629-691``
``compute_shift``) accumulates f64 entropy estimates; its decision is
taken here in float32 with exact integer ``x`` terms, and every block
whose ratio ``e10/e12`` lies within ``SHIFT_BAND`` of 1.01 is flagged.
PyTorch sums the float32 terms in another order than XLA does, so the
two packages' float32 ratios differ in the last bits and the flags may
differ inside the band; the band is wide enough (measured f32 error
< 1e-5 relative on 64 KiB blocks) that a float32 decision that differs
from the f64 one is always flagged.  ``resolve_band_flags`` replays the
f64 heuristic exactly on the host for flagged blocks
(``_pick_shift_exact``); a block whose decision really flips is rebuilt
by the host coder, so streams stay byte-exact.

Serialised headers come from one batched native call
(``native.serialize_o1_dense_batch`` / ``serialize_o0_batch``) on the
pre-shift normalised frequencies (``fhdr``), which are held as int16
on the device (values <= 4096) and become uint16 numpy on the host.

The 12-bit header transport (``pack_freqs12``, ``pack_freqs_sparse12``)
packs the header frequencies on the device before they are copied to
the host (the stream encoder's ``hdr="s12"``), in PyTorch operations as
the JAX package's are plain ``jax.jit`` functions; the host unpackers
are numpy.
"""

from __future__ import annotations

import functools
import math
import struct

import numpy as np
import torch

from . import convert, rans_v2

TOT0 = 4096
PACK_SHIFT = 13
MAX_DENSE_A = 96
# most blocks per histogram pass (keeps the order-1 flat index
# b*A*A + ctx*A + sym below 2^31 at A = 96)
TILE = 2048
# bytes of each (tile, N) int32 tensor of a pass (the dense indices and
# the histogram index): large blocks get fewer blocks per pass
_TILE_BYTES = 1 << 30
# f32 margin band around the e10/e12 threshold inside which the f64
# decision could differ; such blocks are replayed on the host
SHIFT_BAND = 1e-3
_SCATTER_CHUNK = 1 << 26     # bytes per presence scatter (bounds the i64 index)


# ---------------------------------------------------------------------------
# host-precomputed log tables (exact C doubles, rounded to f32)

def _logbits64(x: float) -> float:
    """Bit-hack log from the reference (rANS_static4x16pr.c:619-622),
    replayed on exact f64 host arithmetic."""
    bits = struct.unpack("<q", struct.pack("<d", float(x)))[0]
    return (bits - 4606921278410026770) * 1.539095918623324e-16


@functools.lru_cache(maxsize=1)
def _log_consts():
    """(l10 (257,), l12 (257,), A_e (13,), B_e (13,)) f32 tables.

    flog(x) for integer x in [1, 4096] decomposes exactly as
    ``(K_e + x * 2^(52-e)) * k`` with e = floor(log2 x); A_e/B_e are
    those per-exponent constants, so the device evaluates
    ``A[e] + x * B[e]``."""
    l10 = np.array([math.log(1024 + s) for s in range(257)], np.float32)
    l12 = np.array([math.log(4096 + s) for s in range(257)], np.float32)
    k = 1.539095918623324e-16
    C = 4606921278410026770
    A_e = np.array([((1022 + e) * (1 << 52) - C) * k for e in range(13)],
                   np.float64).astype(np.float32)
    B_e = np.array([float(1 << (52 - e)) * k for e in range(13)],
                   np.float64).astype(np.float32)
    return l10, l12, A_e, B_e


@functools.lru_cache(maxsize=None)
def _consts_on(dev):
    """The log tables on ``dev``, copied there once: a copy from
    pageable memory waits for the work queued on the stream, so a copy
    per build would hold the host until the build's own histogram is
    done.  The first copy is waited for, so any stream may read them."""
    out = tuple(torch.from_numpy(c).to(dev) for c in _log_consts())
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    return out


# ---------------------------------------------------------------------------
# exact integer helpers (int64 lanes)

def _pow2_ceil(v: torch.Tensor) -> torch.Tensor:
    """Reference round2 (rANS_static4x16pr.c:104-114); v == 0 -> 0."""
    x = v - 1
    for s in (1, 2, 4, 8, 16):
        x = x | (x >> s)
    return torch.where(v == 0, torch.zeros_like(v), x + 1)


def _norm_pass(F, size, tot):
    """One scaling pass of normalise_freq.  F (R, A) int64 with row sums
    == size; returns (scaled F, new sums, first argmax of the input)."""
    szc = size.clamp(min=1)
    tr = (tot << 31) // szc + (1 << 30) // szc
    imax = F.argmax(dim=1)
    P = (F * tr[:, None]) >> 31
    P = torch.where(F > 0, P.clamp(min=1), torch.zeros_like(P))
    return P, P.sum(dim=1), imax


def _norm_freq_rows(F, size, tot):
    """Vectorised bit-exact normalise_freq (reference
    rANS_static4x16pr.c:116-161) over (R, A) int64 rows.

    size: raw row totals; tot: per-row normalisation target.  Rows with
    size == 0 pass through unchanged (all-zero)."""
    A = F.shape[1]
    cols = torch.arange(A, device=F.device)[None, :]

    F1, acc1, imax1 = _norm_pass(F, size, tot)
    Fs1 = F1.gather(1, imax1[:, None])[:, 0]
    adj1 = tot - acc1
    done1 = (adj1 >= 0) | ((Fs1 > -adj1) & (Fs1 // 2 >= -adj1))
    out1 = torch.where((cols == imax1[:, None]) & done1[:, None],
                       F1 + adj1[:, None], F1)

    # retry pass on the pass-1 output, renormalising acc1 -> tot
    F2, acc2, imax2 = _norm_pass(F1, acc1, tot)
    Fs2 = F2.gather(1, imax2[:, None])[:, 0]
    adj2 = tot - acc2
    done2 = (adj2 >= 0) | (Fs2 > -adj2)
    at_max2 = cols == imax2[:, None]
    out2e = torch.where(at_max2 & done2[:, None], F2 + adj2[:, None], F2)
    # hard path: peg the max symbol to 1 and absorb the remaining
    # deficit left to right, each symbol giving up to F[j]-1
    F2r = torch.where(at_max2, torch.ones_like(F2), F2)
    D = -adj2 - (Fs2 - 1)
    cap = (F2r - 1).clamp(min=0)
    cum = cap.cumsum(dim=1) - cap
    absorbed = torch.minimum((D[:, None] - cum).clamp(min=0), cap)
    out2h = F2r - absorbed
    out2 = torch.where(done2[:, None], out2e, out2h)

    out = torch.where(done1[:, None], out1, out2)
    return torch.where((size > 0)[:, None], out, F)


def _log2_pow2(v: torch.Tensor) -> torch.Tensor:
    """Exact log2 of a power of two (0 -> 0)."""
    k = torch.zeros_like(v)
    for i in range(1, 13):
        k = k + (v >= (1 << i)).to(v.dtype)
    return k


def _flog32(x: torch.Tensor, A_e: torch.Tensor, B_e: torch.Tensor):
    """f32 evaluation of the reference fast_log for integer x in
    [1, 4096]."""
    e = torch.zeros_like(x)
    for i in range(1, 13):
        e = e + (x >= (1 << i)).to(x.dtype)
    return A_e[e] + x.to(torch.float32) * B_e[e]


def _alphabet(pres: torch.Tensor, A: int) -> torch.Tensor:
    """(B, 256) bool presence -> (B, A) int64 sorted alphabet, padded by
    repeating the last present byte."""
    B = pres.shape[0]
    dev = pres.device
    rank = pres.to(torch.int64).cumsum(dim=1) - 1
    # absent bytes go to a spill column A, which is dropped
    col = torch.where(pres, rank, torch.full_like(rank, A))
    vals = torch.arange(256, device=dev).expand(B, 256)
    raw = torch.zeros((B, A + 1), dtype=torch.int64, device=dev)
    raw.scatter_(1, col, vals)
    return torch.cummax(raw[:, :A], dim=1).values


# ---------------------------------------------------------------------------
# order-1 device build

def _tile_rows(tile: int, N: int) -> int:
    """Blocks per pass: at most ``tile``, and at most ``_TILE_BYTES`` in
    each (rows, N) int32 tensor of the pass."""
    return max(1, min(tile, _TILE_BYTES // (4 * max(N, 1))))


def _presence(jb: torch.Tensor) -> torch.Tensor:
    """Per-block byte presence (B, 256) bool by a scatter of ones; byte
    0 is always present."""
    B, N = jb.shape
    pres = torch.zeros((B, 256), dtype=torch.bool, device=jb.device)
    rows = max(1, _SCATTER_CHUNK // max(N, 1))
    for r0 in range(0, B, rows):
        pres[r0:r0 + rows].scatter_(1, jb[r0:r0 + rows].to(torch.int64), True)
    pres[:, 0] = True
    return pres


def _build_o1_tile(blocks: torch.Tensor, pres: torch.Tensor, A: int, N: int):
    """Order-1 table build of one tile of blocks.

    blocks (B, N) uint8, pres (B, 256) bool.  Returns
      alpha  (B, A) uint8  sorted alphabet, last-symbol padded
      packed (B, A, A) int32  (base<<13|freq) post-shift tables
      fhdr   (B, A, A) int16  pre-shift normalised freqs (header payload)
      meta   (B, 3) int32  [asz, shift, flag]; flag -> replay on host
      H      (B, A, A) int32  the bigram histogram
    """
    B = blocks.shape[0]
    dev = blocks.device
    i64 = torch.int64

    # ---- alphabet ----
    asz = pres.sum(dim=1)
    alpha = _alphabet(pres, A)

    # ---- dense remap + bigram histogram ----
    dense = rans_v2._densify(blocks, alpha.to(torch.uint8))       # (B,N) i32
    idx = dense.clone()
    idx[:, 1:] += dense[:, :-1] * A
    idx += (torch.arange(B, device=dev, dtype=torch.int32) * (A * A))[:, None]
    H = torch.bincount(idx.view(-1), minlength=B * A * A).view(B, A, A)
    del idx
    # quarter-start fixups charged to context 0
    # (rANS_static4x16pr.c:736-739)
    q = N >> 2
    bio = torch.arange(B, device=dev)
    zero = torch.zeros_like(bio)
    one = torch.ones((B,), dtype=H.dtype, device=dev)
    for pos in (q, 2 * q, 3 * q):
        H.index_put_((bio, zero, dense[:, pos].to(i64)), one, accumulate=True)
    del dense
    T = H.sum(dim=2)                                              # (B,A)

    # ---- shift heuristic (compute_shift) ----
    l10t, l12t, A_e, B_e = _consts_on(dev)
    cap = _pow2_ceil(T)
    Fpos = H > 0
    ns = Fpos.sum(dim=2)
    div = cap[:, :, None] // H.clamp(min=1)
    sm10 = (Fpos & (div > 1024)).sum(dim=2)
    sm12 = (Fpos & (div > 4096)).sum(dim=2)
    l10 = l10t[sm10]
    l12 = l12t[sm12]
    Tc = T.clamp(min=1)[:, :, None]
    x10 = ((1024 * H) // Tc).clamp(1, 1024)
    x12 = ((4096 * H) // Tc).clamp(1, 4096)
    Hf = H.to(torch.float32)
    t10 = Hf * (l10[:, :, None] - _flog32(x10, A_e, B_e)) + 4.0
    t12 = Hf * (l12[:, :, None] - _flog32(x12, A_e, B_e)) + 6.0
    fz = torch.zeros((), dtype=torch.float32, device=dev)
    e10 = torch.where(Fpos, t10, fz).sum(dim=(1, 2))
    e12 = torch.where(Fpos, t12, fz).sum(dim=(1, 2))
    S = cap
    S = torch.where((ns < 64) & (S > 128), S // 2, S)
    S = torch.where(S > 1024, S // 2, S)
    S = S.clamp(max=4096)
    max_tot = S.max(dim=1).values
    small = max_tot <= 1024
    # the C comparison is on the ratio (e10, e12 can both be negative:
    # the bit-hack log overestimates); IEEE inf/nan semantics match
    ratio = e10 / e12
    shift = torch.where((ratio < 1.01) | small, 10, 12).to(i64)
    band = torch.isfinite(ratio) & ((ratio - 1.01).abs() < SHIFT_BAND)
    flag = band & ~small

    # ---- per-row normalisation ----
    tot = torch.where((shift[:, None] == 10) & (S > 1024),
                      torch.full_like(S, 1024), S)                # (B,A)
    Fn = _norm_freq_rows(H.reshape(B * A, A), T.reshape(B * A),
                         tot.reshape(B * A)).reshape(B, A, A)
    # scale the power-of-two row totals up to 1<<shift (norm_shift)
    sh = shift[:, None] - _log2_pow2(tot)
    sh = torch.where(T > 0, sh, torch.zeros_like(sh))
    Fs = Fn << sh[:, :, None]
    base = Fs.cumsum(dim=2) - Fs
    packed = (base << PACK_SHIFT) | Fs
    kio = torch.arange(A, device=dev)
    padr = kio[None, :] >= asz[:, None]                           # (B,A)
    pad = padr[:, None, :] | padr[:, :, None]
    packed = torch.where(pad, torch.zeros_like(packed), packed)

    meta = torch.stack([asz, shift, flag.to(i64)], dim=1).to(torch.int32)
    return (alpha.to(torch.uint8), packed.to(torch.int32),
            Fn.to(torch.int16), meta, H.to(torch.int32))


# ---------------------------------------------------------------------------
# order-0 device build

def _build_o0_tile(blocks: torch.Tensor, A: int, N: int):
    """Order-0 table build of one tile.  Returns alpha (B, A) uint8,
    packed (B, A) int32, fhdr (B, 256) int16 pre-shift normalised
    freqs, asz (B,) int32."""
    B = blocks.shape[0]
    dev = blocks.device
    idx = blocks.to(torch.int32) + \
        (torch.arange(B, device=dev, dtype=torch.int32) * 256)[:, None]
    F = torch.bincount(idx.view(-1), minlength=B * 256).view(B, 256)
    del idx

    cap = min(1 << max(int(N - 1).bit_length(), 0), TOT0) if N > 0 else 0
    Fn = _norm_freq_rows(F, torch.full((B,), N, dtype=torch.int64, device=dev),
                         torch.full((B,), cap, dtype=torch.int64, device=dev))
    sh = 12 - int(math.log2(cap)) if cap else 0
    Fs = Fn << sh

    pres = F > 0
    pres[:, 0] = True
    asz = pres.sum(dim=1)
    alpha = _alphabet(pres, A)
    base_full = Fs.cumsum(dim=1) - Fs                             # (B,256)
    pk_full = (base_full << PACK_SHIFT) | Fs
    pk = pk_full.gather(1, alpha)
    padr = torch.arange(A, device=dev)[None, :] >= asz[:, None]
    packed = torch.where(padr, torch.zeros_like(pk), pk)
    return (alpha.to(torch.uint8), packed.to(torch.int32),
            Fn.to(torch.int16), asz.to(torch.int32))


# ---------------------------------------------------------------------------
# exact host replay of the shift decision for banded blocks

def _pow2_ceil_int(v: int) -> int:
    if not v:
        return 0
    v -= 1
    for s in (1, 2, 4, 8, 16):
        v |= v >> s
    return v + 1


def _pick_shift_exact(H: np.ndarray, a: int) -> int:
    """Bit-exact sequential f64 replay of compute_shift
    (rANS_static4x16pr.c:629-691) on one block's dense histogram.

    Python floats are IEEE f64 with the same rounding as C, and the
    accumulation order (ctx rows ascending, symbols ascending) matches
    the reference loop, so the returned 10/12 decision is exact."""
    e10 = 0.0
    e12 = 0.0
    max_tot = 0
    for i in range(a):
        row = H[i]
        T = int(row.sum())
        cap = _pow2_ceil_int(T)
        ns = 0
        sm10 = sm12 = 0
        for j in range(a):
            f = int(row[j])
            if f and cap // f > 1024:
                sm10 += 1
            if f and cap // f > 4096:
                sm12 += 1
        l10 = math.log(1024 + sm10)
        l12 = math.log(4096 + sm12)
        for j in range(a):
            f = int(row[j])
            if not f:
                continue
            ns += 1
            x = int(1024.0 * f / T)
            e10 -= f * (_logbits64(x if x > 1 else 1) - l10)
            x = int(4096.0 * f / T)
            e12 -= f * (_logbits64(x if x > 1 else 1) - l12)
            e10 += 4
            e12 += 6
        if ns < 64 and cap > 128:
            cap //= 2
        if cap > 1024:
            cap //= 2
        if cap > 4096:
            cap = 4096
        if max_tot < cap:
            max_tot = cap
    if e12 != 0:
        ratio_lt = (e10 / e12) < 1.01
    else:
        # IEEE division by zero: +-inf is not below 1.01 unless -inf,
        # 0/0 is NaN (never below)
        ratio_lt = e10 < 0
    return 10 if (ratio_lt or max_tot <= 1024) else 12


# ---------------------------------------------------------------------------
# public batched builders

def build_o1_device_async(blocks, tile: int = TILE, device="cuda"):
    """Device-side order-1 table build with no bulk host transfer.

    blocks (B, N) uint8, a numpy array or a tensor (moved to ``device``
    if it is not there; the batch layer hands in the tensor that its
    encode reads too).  Returns (alpha (B,A) uint8, packed (B,A,A)
    int32, fhdr (B,A,A) int16, meta (B,3) int32 [asz, shift,
    band-flag], H (B,A,A) int32, A), all tensors on the device, or None
    when the batch needs the host path: an alphabet wider than 96, a
    block under 4 bytes, or N >= 2^23 (the JAX package's limit, kept so
    both packages take the same route).  Only the alphabet size comes
    back to the host here.  Callers launch dependent device work (the
    encode) before they wait for fhdr and meta."""
    B, N = blocks.shape
    if B == 0 or N >= (1 << 23) or N < 4:
        return None
    dev = rans_v2.check_device(device)
    jb = convert.as_tensor(blocks, torch.uint8, dev)
    pres = _presence(jb)
    amax = int(pres.sum(dim=1).max())
    if amax > MAX_DENSE_A:
        return None
    A = rans_v2._round_a(amax)
    tile = _tile_rows(tile, N)
    outs = [_build_o1_tile(jb[t0:t0 + tile], pres[t0:t0 + tile], A, N)
            for t0 in range(0, B, tile)]
    cat = outs[0] if len(outs) == 1 else [torch.cat(o) for o in zip(*outs)]
    return cat[0], cat[1], cat[2], cat[3], cat[4], A


def resolve_band_flags(meta: np.ndarray, H_d: torch.Tensor) -> np.ndarray:
    """Resolve shift-band flags by replaying the f64 heuristic exactly
    on the device histograms; returns the final flag vector where 1
    means the decision really flips (host rebuild needed)."""
    asz, shift, flag = meta[:, 0], meta[:, 1], meta[:, 2].copy()
    if flag.any():
        flat = np.flatnonzero(flag)
        Hsel = H_d[torch.from_numpy(flat).to(H_d.device)].cpu().numpy()
        for k, b in enumerate(flat):
            if _pick_shift_exact(Hsel[k], int(asz[b])) == shift[b]:
                flag[b] = 0
    return flag


def fhdr_to_host(fhdr: torch.Tensor) -> np.ndarray:
    """int16 header frequencies (values <= 4096) -> uint16 numpy, as
    ``native.serialize_*`` takes them."""
    return fhdr.cpu().numpy().view(np.uint16)


def build_o1_device(blocks, tile: int = TILE, device="cuda"):
    """Device order-1 table build over a (B, N) uint8 batch.

    Returns (alpha (B,A) uint8 tensor, packed (B,A,A) int32 tensor, asz
    (B,) np, fhdr (B,A,A) uint16 np, shift (B,) np, flag (B,) np, A) or
    None when the batch needs the host path (wide alphabet, tiny or
    giant blocks)."""
    r = build_o1_device_async(blocks, tile, device)
    if r is None:
        return None
    alpha_d, packed_d, fhdr_d, meta_d, H_d, A = r
    fhdr = fhdr_to_host(fhdr_d)
    meta = meta_d.cpu().numpy()
    flag = resolve_band_flags(meta, H_d)
    return (alpha_d, packed_d, meta[:, 0], fhdr, meta[:, 1], flag, A)


def build_o0_device(blocks, tile: int = TILE, device="cuda"):
    """Device order-0 table build.  Returns (alpha (B,A) uint8 tensor,
    packed (B,A) int32 tensor, asz (B,) np, fhdr (B,256) uint16 np, A)
    or None (alphabet wider than 96, empty blocks, N >= 2^23)."""
    B, N = blocks.shape
    if B == 0 or N >= (1 << 23) or N < 1:
        return None
    dev = rans_v2.check_device(device)
    jb = convert.as_tensor(blocks, torch.uint8, dev)
    amax = int(_presence(jb).sum(dim=1).max())
    if amax > MAX_DENSE_A:
        return None
    A = rans_v2._round_a(amax)
    tile = _tile_rows(tile, N)
    outs = [_build_o0_tile(jb[t0:t0 + tile], A, N)
            for t0 in range(0, B, tile)]
    alpha_d, packed, fhdr, asz = (
        outs[0] if len(outs) == 1 else [torch.cat(o) for o in zip(*outs)])
    return alpha_d, packed, asz.cpu().numpy(), fhdr_to_host(fhdr), A


# ---------------------------------------------------------------------------
# 12-bit header-frequency transport (a smaller device -> host copy for the
# header serialiser)
#
# The order-1 header serialiser needs only the normalised per-context
# frequency values on the host; the (B, A, A) copy is transport.  Values
# are <= 1 << shift <= 4096, so 12 bits per entry (3 bytes per pair) move
# 25 % less than 16.  The one 13-bit value, 4096 (a one-symbol context
# row normalised to the full 1 << 12), is stored as 4095: every context
# row is normalised to a power-of-two total <= 1 << shift, so a row that
# sums to exactly 4095 cannot occur, and the host restores its largest
# entry to 4096.  The sparse form ships a presence bitmap and only the
# nonzero values, compacted to the front of each row, so the host can
# copy a prefix as wide as the batch's largest nonzero count.

def _pack12(v: torch.Tensor) -> torch.Tensor:
    """(B, E) int32 values < 4096 -> (B, 3*ceil(E/2)) uint8, two values
    per three bytes (low byte, low nibble of the high part beside the
    second value's low nibble, the second value's high byte)."""
    if v.shape[1] % 2:
        v = torch.nn.functional.pad(v, (0, 1))
    v0 = v[:, 0::2]
    v1 = v[:, 1::2]
    b0 = v0 & 0xFF
    b1 = (v0 >> 8) | ((v1 & 0xF) << 4)
    b2 = v1 >> 4
    return torch.stack([b0, b1, b2], dim=2).reshape(v.shape[0], -1) \
        .to(torch.uint8)


def _wrap12(fhdr: torch.Tensor) -> torch.Tensor:
    """(B, A, A) header frequencies -> (B, A*A) int32 with 4096 -> 4095."""
    v = fhdr.reshape(fhdr.shape[0], -1).to(torch.int32)
    return v - (v == 4096).to(torch.int32)


def pack_freqs12(fhdr: torch.Tensor) -> torch.Tensor:
    """(B, A, A) normalised header frequencies (any integer type, e.g.
    the table build's int16) -> (B, 3*ceil(A*A/2)) uint8 on their device."""
    return _pack12(_wrap12(fhdr))


def pack_freqs_sparse12(fhdr: torch.Tensor):
    """(B, A, A) header frequencies -> (bitmap (B, ceil(E/8)) uint8,
    vals12 (B, 3*ceil(E/2)) uint8 with each row's nonzero values packed
    first, counts (B,) int32, maxnz () int32), E = A*A, all on the
    device.  The bitmap is LSB-first within each byte.  The nonzeros
    move to the front of their row by one stable sort on the int32 key
    ``where(nz, position, E) * 8192 + value`` (E <= 96^2, so the key
    fits)."""
    B = fhdr.shape[0]
    v = _wrap12(fhdr)
    E = v.shape[1]
    nz = v > 0
    E8 = -(-E // 8) * 8
    bits = torch.nn.functional.pad(nz.to(torch.int32), (0, E8 - E))
    w = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                     device=v.device)
    bitmap = (bits.view(B, E8 // 8, 8) * w).sum(dim=2).to(torch.uint8)
    iota = torch.arange(E, dtype=torch.int32, device=v.device)[None, :]
    key = torch.where(nz, iota, torch.full_like(iota, E)) * 8192 + v
    svals = torch.sort(key, dim=1, stable=True).values & 8191
    counts = nz.sum(dim=1, dtype=torch.int32)
    return bitmap, _pack12(svals), counts, counts.max()


def _unpack12(pk: np.ndarray) -> np.ndarray:
    p = pk.reshape(pk.shape[0], -1, 3).astype(np.uint16)
    v0 = p[:, :, 0] | ((p[:, :, 1] & 0xF) << 8)
    v1 = (p[:, :, 1] >> 4) | (p[:, :, 2] << 4)
    return np.stack([v0, v1], axis=2).reshape(pk.shape[0], -1)


def _restore_rows(v: np.ndarray, name: str) -> np.ndarray:
    """Restore each wrapped 4096 (a row summing to 4095) and check that
    every row is normalised: all zero, or a power-of-two total <= 4096.
    A non-normalised input would otherwise corrupt silently through the
    wrap."""
    rs = v.sum(axis=2, dtype=np.int64)
    fix = rs == 4095
    if fix.any():
        bi, ri = np.nonzero(fix)
        idx = v[bi, ri].argmax(axis=1)
        v[bi, ri, idx] += 1
        rs[fix] += 1
    bad = (rs != 0) & ((rs & (rs - 1)) != 0) | (rs > 4096)
    if bad.any():
        b0, r0 = np.argwhere(bad)[0]
        raise ValueError(
            f"{name}: context row sum is not a power of two <= 4096 "
            f"(block {b0}, row {r0}, sum {int(rs[b0, r0])})")
    return v


def unpack_freqs12_host(pk: np.ndarray, A: int) -> np.ndarray:
    """Invert pack_freqs12 on the host: (B, 3*ceil(A*A/2)) u8 -> (B, A,
    A) u16, restoring any 4096 entry from the row-sum deficit."""
    B = pk.shape[0]
    v = _unpack12(pk)[:, :A * A]
    v = np.ascontiguousarray(v.reshape(B, A, A))
    return _restore_rows(v, "unpack_freqs12")


def unpack_freqs_sparse12_host(bitmap: np.ndarray, vals12: np.ndarray,
                               A: int) -> np.ndarray:
    """Invert pack_freqs_sparse12 on the host: vals12 may be any prefix
    of the packed value rows wide enough for the batch's max count."""
    B = bitmap.shape[0]
    E = A * A
    bits = np.unpackbits(bitmap, axis=1, bitorder="little")[:, :E]
    counts = bits.sum(axis=1).astype(np.int64)
    sv = _unpack12(vals12)
    if int(counts.max(initial=0)) > sv.shape[1]:
        raise ValueError("unpack_freqs_sparse12: prefix narrower than "
                         "the batch's max nonzero count")
    # position e holds its row's (rank of e among the nonzeros)'th value
    ranks = bits.cumsum(axis=1, dtype=np.int32) - 1
    np.maximum(ranks, 0, out=ranks)
    v = np.take_along_axis(sv, ranks, axis=1)
    v[bits == 0] = 0
    v = np.ascontiguousarray(v.reshape(B, A, A))
    return _restore_rows(v, "unpack_freqs_sparse12")
