"""The batched rANS 4x16 engine: one encode kernel, one decode kernel
with two table readers, and what surrounds them.

Counterpart of ``htscodecs_tpu/ops/rans_vmem.py`` (the Pallas engine of
the JAX package) and of the kernels of ``htscodecs_tpu/ops/rans_pallas.py``
(its first-generation engine), whose four encode kernels and two decode
kernels share one contract each.  Each kernel has, in this module, its
wrapper (which checks its arguments, launches on the current stream and
counts the launch), its plain PyTorch version (a loop over steps,
vectorised over blocks, integer-exact in int64 with explicit masks) and
a source note.  A wrapper uses the plain version only for tensors that
lie on the CPU; for CUDA tensors it launches the kernel or raises.

``rans16_enc_packed``  csrc/rans16_enc_packed.cu
    replaces ``_build_fetch_kernel`` (the per-symbol table fetch),
    ``_build_enc_kernel_pf`` and ``_build_enc_kernel`` with the stitch
    sort of ``_enc_vmem`` (rans_vmem) and ``_enc_kernel_body`` /
    ``_enc_tile`` with the ``_enc_pallas`` prologue and ``_compact``
    (rans_pallas).  Reads the raw block bytes and the packed
    ``base << 13 | freq`` rows as the table builders make them, one
    shift per block.  The CTA's entries sit in shared memory beside the
    reciprocals of their freqs (``enc_tables_in_smem``), the bytes are
    staged in reverse by ``cp.async``, the next step's lookup runs
    beside the current step's chain, the divide is a multiply by the
    reciprocal, and words are written in forward order at the END of
    each block's row (its last ``counts[b]`` words).
``rans16_dec`` / ``rans16_dec_packed``  csrc/rans16_dec.cu
    replace ``_build_kernel`` / ``_dec_vmem`` (rans_vmem: monotone base
    rows, ``Tables``) and ``_dec_kernel_body`` / ``_dec_tile`` with
    ``_dec_pallas_to_bytes`` (rans_pallas: packed rows).  One kernel
    body: the packed reader converts its rows to base rows as
    ``rans_v2._b16_fill`` does; the rows, alphabets and a slot index per
    row sit in shared memory when they fit (``dec_tables_in_smem``), the
    words are staged by ``cp.async``, CTAs of ``threads`` threads (32,
    64 or 128; 4 per block).  The readers differ only for a context row
    with no entry at or below the slot: freq 0 on the packed route (the
    TPU kernel's masked max of nothing), freq = row[1] on the base-row
    route (``_slot_lookup``).  The base-row entry has two routes, one
    result: that kernel (the bisection route, counted as
    ``"rans16_dec"``), and for batches of up to a few blocks an SM (e.g.
    a reader's 16 slices) the direct route (``direct_route``; counted as
    ``"rans16_dec_direct"``): one block a CTA and a fused word per slot
    of each context row in shared memory (``_direct_table16_plain``), so
    that a step resolves its slot with one load and no branch.

Tensor conventions are those of ``ops/convert.py``: states int32 and
words int16 hold the bits of the u32 / u16 values.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda_build
from . import rans_v2
from .convert import Tables

RANS_L = 1 << 15
_M32 = 0xFFFFFFFF

# launches per kernel: each wrapper adds one where it launches its
# kernel and nowhere else (the 4x8 engine in ops/rans8_vmem.py, the
# range-coder engines in ops/arith_vmem.py and ops/rc_vmem.py and the
# order-1 table build's counting kernels in ops/tables_v2.py count in
# the same table)
LAUNCHES = {"rans16_dec": 0, "rans16_dec_direct": 0, "rans16_dec_packed": 0,
            "rans16_enc_packed": 0, "rans8_enc": 0, "rans8_dec": 0,
            "rans8_dec_direct": 0, "arith_enc": 0, "arith_dec": 0,
            "rc_enc": 0, "tables_o1_presence": 0, "tables_o1_count": 0}


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it whose data starts on 16 bytes: the kernels
    stage rows in aligned 16-byte segments."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _shift_vector(shift, B: int, dev: torch.device, name: str):
    """An int in [1, 15] -> (B,) int32 on ``dev``; a (B,) integer tensor
    -> int32 on ``dev`` (its values are the caller's to keep in [1,
    15]: the table builders make 10 and 12)."""
    if isinstance(shift, torch.Tensor):
        sv = shift.to(device=dev, dtype=torch.int32).contiguous()
        if tuple(sv.shape) != (B,):
            raise ValueError(f"{name}: shift vector must have shape ({B},)")
        return sv
    if not 1 <= int(shift) <= 15:
        raise ValueError(f"{name}: shift must be in [1, 15], got {shift}")
    return torch.full((B,), int(shift), dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# the decoder: rans16_dec (base rows) and rans16_dec_packed (packed rows)

DEC_THREADS = 32     # threads per decode CTA (8 blocks)
# ring space per block (csrc/rans16_dec.cu: RING_STRIDE, the SB = 256
# staged bytes padded by 16 against bank conflicts)
STAGE = 272
IDX_N = 65           # slot index entries per row (csrc/rans16_dec.cu: IDX_N)
# shared memory of one decode CTA up to which its tables go there: two
# such CTAs fit an H100 SM
TABLES_SMEM_MAX = 96 * 1024


def _part(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _dec_smem(bpc: int, A: int, order: int, tables: bool,
              stage: int = STAGE) -> int:
    """Shared memory of one decode CTA of ``bpc`` blocks, 4x16 and 4x8
    alike (csrc/rans16_dec.cu: rans16_dec_smem; csrc/rans8_dec.cu:
    rans8_dec_smem, with its own ``stage``): the stream rings of
    ``stage`` bytes per block, then with ``tables`` the base rows, the
    alphabets and the slot index, each part rounded up to 16 bytes."""
    s = bpc * stage
    if tables:
        nrows = A if order == 1 else 1
        s += (_part(bpc * nrows * (A + 1) * 2) + _part(bpc * A)
              + _part(bpc * nrows * IDX_N))
    return s


def dec_tables_in_smem(threads: int, A: int, order: int,
                       stage: int = STAGE) -> bool:
    """Whether a 4x16 (or, with its ``stage``, 4x8) decode launch of
    ``threads`` per CTA copies its tables into shared memory: when the
    CTA's shared memory stays within ``TABLES_SMEM_MAX`` (and A < 256, so
    that the index's counts fit a byte).  Wider tables are read from
    global memory."""
    return A < 256 and _dec_smem(threads // 4, A, order, True,
                                 stage) <= TABLES_SMEM_MAX


def slot_index(bases: torch.Tensor, ss=6) -> torch.Tensor:
    """The decode kernels' slot index of monotone base rows (..., A+1)
    int: (..., IDX_N) int64, entry j = the number of the first A bases
    that are <= j << ss.  ``ss`` is an int or an integer tensor that
    broadcasts against the rows' leading dimensions (the 4x16 decoder:
    max(shift - 6, 0) per block; the 4x8 decoder: 6)."""
    A = bases.shape[-1] - 1
    ss = torch.as_tensor(ss, dtype=torch.int64, device=bases.device)
    x = torch.arange(IDX_N, device=bases.device) << ss[..., None]
    return (bases[..., :A, None].to(torch.int64) <= x[..., None, :]).sum(dim=-2)


def slot_lookup_indexed(bases: torch.Tensor, index: torch.Tensor,
                        m: torch.Tensor, ss=6):
    """``_slot_lookup`` through the slot index, as the kernels bisect:
    rows (..., A+1), index (..., IDX_N), slots m (...) -> (sym, base,
    freq), each (...) int64.  The count of bases <= m lies between the
    index entries m >> ss and (m >> ss) + 1."""
    j = (m.to(torch.int64) >> torch.as_tensor(ss, device=m.device))
    lo = index.gather(-1, j[..., None])[..., 0]
    hi = index.gather(-1, j[..., None] + 1)[..., 0]
    rows = bases.to(torch.int64)
    while bool((lo < hi).any()):
        open_ = lo < hi
        mid = (lo + hi) >> 1
        le = rows.gather(-1, mid.clamp(max=rows.shape[-1] - 1)[..., None])[..., 0] <= m
        lo = torch.where(open_ & le, mid + 1, lo)
        hi = torch.where(open_ & ~le, mid, hi)
    sym = (lo - 1).clamp(min=0)
    bs = torch.where(lo > 0, rows.gather(-1, sym[..., None])[..., 0],
                     torch.zeros_like(lo))
    f = rows.gather(-1, (sym + 1)[..., None])[..., 0] - bs
    return sym, bs, f


def _dec_geometry(N: int, order: int):
    if order == 1:
        q = N >> 2
        return q, q + (N - 4 * q)
    q = -(-N // 4)
    return q, q


def _dec_launch_args(threads: int, global_tables: bool, A: int, order: int,
                     name: str):
    if threads not in (0, 32, 64, 128):
        raise ValueError(f"{name}: threads must be 0, 32, 64 or 128")
    threads = threads or DEC_THREADS
    return threads, not global_tables and dec_tables_in_smem(threads, A, order)


# the direct route of the base-row entry (csrc/rans16_dec.cu:
# rans16_dec_direct_kernel): one block a CTA, one 32-bit word per slot of
# each context row, freq << DIRECT_F_SHIFT | symbol << DIRECT_S_SHIFT |
# (slot - base)
DIRECT_STAGE = 512           # ring bytes (DSB)
DIRECT_S_SHIFT = 12
DIRECT_F_SHIFT = 19
DIRECT_MAX_A = 128           # symbols the word's 7-bit field holds
DIRECT_MAX_SHIFT = 12        # slots the word's 12-bit slot - base field holds
# the narrowest shift the route takes: what the format gives (order 0:
# 12; order 1: 10 or 12), so that a launch past the rule at this shift is
# refused before its shifts and rows are read
DIRECT_MIN_SHIFT = 10
DIRECT_ROW_MAX = 4096        # the largest row entry a word holds
SMEM_UNIT = 128              # bytes: an SM's shared memory goes out in these
# CTAs an SM at most (csrc/rans16_dec.cu: DMIN_CTAS, what the kernel's
# registers allow)
DIRECT_MAX_CTAS = 12
# blocks an SM may take in turns where fewer CTAs fit on it at once: at
# 16 x 1 510 000 bytes, order 1, a round of one CTA an SM takes 26 ms
# where the bisection route takes 90 ms at any B up to thousands, so
# three rounds gain and four lose (PERF.md, the direct route's sweep)
DIRECT_BLOCKS_PER_SM = 3


def _direct_smem(A: int, order: int, shift: int) -> int:
    """Shared memory of one direct-route CTA (csrc/rans16_dec.cu:
    rans16_dec_direct_smem): the fused rows at ``shift``, the ring, the
    base rows and the alphabet, each part rounded up to 16 bytes."""
    nrows = A if order == 1 else 1
    return (_part((nrows << shift) * 4) + DIRECT_STAGE
            + _part(nrows * (A + 1) * 2) + _part(A))


def direct_ctas_per_sm(A: int, order: int, shift: int, optin: int,
                       per_sm: int) -> int:
    """Direct-route CTAs that one SM holds at once at the launch's largest
    ``shift``: ``per_sm`` bytes an SM over the CTA's bytes plus the
    per-CTA reserve (``per_sm - optin``), in units of SMEM_UNIT, as the
    CUDA occupancy calculator counts them, and at most DIRECT_MAX_CTAS;
    0 where the CTA does not fit ``optin``, or the alphabet or the shift
    the word's fields."""
    if not (1 <= A <= DIRECT_MAX_A and 1 <= shift <= DIRECT_MAX_SHIFT):
        return 0
    smem = _direct_smem(A, order, shift)
    if smem > optin:
        return 0
    unit = -(-(smem + per_sm - optin) // SMEM_UNIT) * SMEM_UNIT
    return min(per_sm // unit, DIRECT_MAX_CTAS)


def direct_route(B: int, A: int, order: int, shift: int, sms: int,
                 optin: int, per_sm: int, threads: int = 0,
                 global_tables: bool = False) -> bool:
    """Whether a ``rans16_dec`` launch of these shapes, ``shift`` its
    largest, takes the direct route on a device of ``sms`` SMs with
    ``optin`` bytes of shared memory a CTA may opt into and ``per_sm``
    bytes an SM: the default launch (``threads`` 0, tables in shared
    memory) of a batch that leaves each SM at most DIRECT_BLOCKS_PER_SM
    blocks, or one wave of direct-route CTAs (``direct_ctas_per_sm`` on
    every SM) where more fit at once, at a shift from DIRECT_MIN_SHIFT
    up.  The wrapper also needs the rows packable (``_rows_packable``)
    and every shift at least DIRECT_MIN_SHIFT."""
    cps = direct_ctas_per_sm(A, order, shift, optin, per_sm)
    return (not threads and not global_tables and cps > 0
            and shift >= DIRECT_MIN_SHIFT
            and 1 <= B <= sms * max(cps, DIRECT_BLOCKS_PER_SM))


def _device_limits(dev: torch.device):
    """(SMs, opt-in shared memory a CTA, shared memory an SM) of ``dev``
    (``rans8_vmem._device_limits``, which imports this module)."""
    p = torch.cuda.get_device_properties(dev)
    return (p.multi_processor_count, p.shared_memory_per_block_optin,
            p.shared_memory_per_multiprocessor)


def _rows_packable(bases: torch.Tensor) -> bool:
    """Whether every base row (..., A+1) is non-decreasing and within
    [0, DIRECT_ROW_MAX]: then each slot's freq (0 to 4096) and slot -
    base (0 to 4095) fit their fields (``rans8_vmem._rows_packable``).
    Table parses of valid streams give only such rows; a corrupt one
    may not.  Checked on a host copy, in int16: with the rows widened
    first, the route choice took 0.48 ms of host time at a tok3
    descriptor group's 23 x 48 x 49 entries on the card's machine."""
    r = bases.cpu().numpy()
    return bool((r[..., 1:] >= r[..., :-1]).all() and (r[..., 0] >= 0).all()
                and (r[..., -1] <= DIRECT_ROW_MAX).all())


def _direct_shift(tables: Tables, order: int, threads: int,
                  global_tables: bool):
    """The largest shift of a ``rans16_dec`` launch that takes the direct
    route, or None where it keeps the bisection route.  The rule at
    DIRECT_MIN_SHIFT (the narrowest rows it takes) admits every launch
    that a wider shift would, so only launches that pass it copy their
    shifts and rows to the host."""
    B, A = tables.alpha.shape
    lim = _device_limits(tables.alpha.device)
    if not direct_route(B, A, order, DIRECT_MIN_SHIFT, *lim, threads,
                        global_tables):
        return None
    sv = tables.shift.cpu()
    hi = int(sv.max())
    if (int(sv.min()) >= DIRECT_MIN_SHIFT
            and direct_route(B, A, order, hi, *lim, threads, global_tables)
            and _rows_packable(tables.bases)):
        return hi
    return None


def _direct_table16_plain(bases: torch.Tensor, shift: int):
    """Plain version of the direct route's prologue: base rows (..., A+1)
    -> (..., 1 << shift) int64 fused words, each slot's (symbol, base,
    freq) as ``_rans16_dec_plain``'s lookup (``_slot_lookup``, base-row
    answers) gives them; None where the rows are not packable, A >
    DIRECT_MAX_A or the shift is outside [1, DIRECT_MAX_SHIFT] (the
    launch takes the bisection route)."""
    A = bases.shape[-1] - 1
    if (A > DIRECT_MAX_A or not 1 <= shift <= DIRECT_MAX_SHIFT
            or not _rows_packable(bases)):
        return None
    n = 1 << shift
    rows = bases.reshape(-1, 1, A + 1).to(torch.int64).expand(-1, n, A + 1)
    m = torch.arange(n, device=bases.device).expand(rows.shape[0], -1)
    sym, bs, f = _slot_lookup(rows, m)
    words = f << DIRECT_F_SHIFT | sym << DIRECT_S_SHIFT | (m - bs)
    return words.reshape(*bases.shape[:-1], n)


def rans16_dec(states, words, counts, tables: Tables, N: int, order: int,
               threads: int = 0, global_tables: bool = False):
    """Decode B blocks of N bytes from base rows.

    states (B,4) int32, words (B,W) int16, counts (B,) int32 (words that
    belong to each block: a read past them gives 0), tables with bases
    (B, A if order else 1, A+1) int16.  Launch arguments, which do not
    change the result: ``threads`` per CTA (32, 64 or 128; 0 takes
    ``DEC_THREADS``), ``global_tables`` reads the tables from global
    memory even where ``dec_tables_in_smem`` would copy them.  Either one
    keeps the bisection route; with neither, a batch that
    ``direct_route`` admits, with packable rows and shifts from
    DIRECT_MIN_SHIFT to DIRECT_MAX_SHIFT, takes the direct route.  Returns (B,N) uint8.
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
    cta, smem = _dec_launch_args(threads, global_tables, A, order,
                                 "rans16_dec")
    if dev.type == "cpu":
        return _rans16_dec_plain(states, words, counts, tables, N, order)
    shift = _direct_shift(tables, order, threads, global_tables)
    words = _aligned(words)
    out = torch.empty((B, N), dtype=torch.uint8, device=dev)
    args = (states.data_ptr(), words.data_ptr(), counts.data_ptr(),
            tables.bases.data_ptr(), tables.alpha.data_ptr(),
            tables.shift.data_ptr(), out.data_ptr(), B, W, A, N, order)
    with torch.cuda.device(dev):
        lib = cuda_build.get_lib()
        if shift is None:
            err = lib.rans16_dec_launch(*args, cta, int(smem), _stream(words))
        else:
            err = lib.rans16_dec_direct_launch(*args, shift, _stream(words))
    cuda_build.check(err, "rans16_dec")
    LAUNCHES["rans16_dec" if shift is None else "rans16_dec_direct"] += 1
    return out


def rans16_dec_packed(states, words, packed, alpha, shift, N: int,
                      order: int, threads: int = 0,
                      global_tables: bool = False):
    """Decode B blocks of N bytes from packed rows.

    states (B,4) int32 and words (B,W) int16 (reads past W give 0),
    packed (B, A*A if order else A) int32 ``base << 13 | freq``, alpha
    (B,A) uint8, shift an int or a (B,) integer tensor.  Launch
    arguments as for ``rans16_dec``.  Returns (B,N) uint8."""
    B, W = words.shape
    A = alpha.shape[1]
    dev = words.device
    _require(states, "states", torch.int32, (B, 4), dev)
    _require(words, "words", torch.int16, (B, W), dev)
    _require(packed, "packed", torch.int32, (B, A * A if order else A), dev)
    _require(alpha, "alpha", torch.uint8, (B, A), dev)
    sv = _shift_vector(shift, B, dev, "rans16_dec_packed")
    if order not in (0, 1) or N <= 0 or W < 1 or A < 1:
        raise ValueError("rans16_dec_packed: bad geometry")
    threads, smem = _dec_launch_args(threads, global_tables, A, order,
                                     "rans16_dec_packed")
    if dev.type == "cpu":
        return _rans16_dec_packed_plain(states, words, packed, alpha, sv, N,
                                        order)
    words = _aligned(words)
    conv = None if smem else torch.empty(
        (B, A if order else 1, A + 1), dtype=torch.int16, device=dev)
    out = torch.empty((B, N), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.get_lib().rans16_dec_packed_launch(
            states.data_ptr(), words.data_ptr(), packed.data_ptr(),
            alpha.data_ptr(), sv.data_ptr(),
            None if conv is None else conv.data_ptr(), out.data_ptr(),
            B, W, A, N, order, threads, int(smem), _stream(words))
    cuda_build.check(err, "rans16_dec_packed")
    LAUNCHES["rans16_dec_packed"] += 1
    return out


def _rans16_dec_plain(states, words, counts, tables: Tables, N: int,
                      order: int):
    """Plain PyTorch version of rans16_dec (same arguments)."""
    return _dec16_rows(states, words, counts, tables.bases, tables.alpha,
                       tables.shift, N, order, packed=False)


def _rans16_dec_packed_plain(states, words, packed, alpha, shift, N: int,
                             order: int):
    """Plain PyTorch version of rans16_dec_packed (shift a (B,) int32
    tensor): the packed rows converted as the kernel converts them
    (``rans_v2._b16_fill``, then int16)."""
    B, A = alpha.shape
    pk = packed.view(B, A if order else 1, A)
    bases = rans_v2._b16_fill(pk, shift).to(torch.int16)
    return _dec16_rows(states, words, None, bases, alpha, shift, N, order,
                       packed=True)


def _dec16_rows(states, words, counts, bases, alpha, shift, N: int,
                order: int, packed: bool):
    """The decode over base rows (B, Ac, A+1) int16 of both plain
    versions; ``packed`` gives a slot with no entry <= it freq 0."""
    B = words.shape[0]
    A = alpha.shape[1]
    rows_all = bases.to(torch.int64)                        # (B,Ac,A+1)
    bidx = torch.arange(B, device=words.device)[:, None]

    def lookup(ctx, m):
        if order == 1:
            rows = rows_all[bidx, ctx]                      # (B,4,A+1)
        else:
            rows = rows_all[:, 0][:, None, :].expand(B, 4, A + 1)
        return _slot_lookup(rows, m, packed)
    return _dec16_scan(states, words, counts, lookup, alpha, shift, N, order)


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


def _slot_lookup(rows, m, packed: bool = False):
    """Slot -> symbol over monotone base rows.  rows (B,4,A+1) int64, m
    (B,4): the symbol is the last of the first A entries that is <= m,
    freq = its successor's base minus its own.  No such entry: symbol 0
    with base 0 and freq = row[1] (base rows) or 0 (``packed``).
    Returns (sym, base, freq)."""
    A = rows.shape[2] - 1
    c = (rows[:, :, :A] <= m[:, :, None]).sum(dim=2)
    sym = (c - 1).clamp(min=0)
    bs = torch.where(c > 0, rows.gather(2, sym[:, :, None])[:, :, 0],
                     torch.zeros_like(c))
    f = rows.gather(2, (sym + 1)[:, :, None])[:, :, 0] - bs
    if packed:
        f = torch.where(c > 0, f, torch.zeros_like(f))
    return sym, bs, f


# ---------------------------------------------------------------------------
# the encoder: rans16_enc_packed

ENC_THREADS = 32     # threads per encode CTA (csrc/rans_group.cuh)
# ring and byte-table space per block (csrc/rans_group.cuh: RING_BLK,
# LUT_STRIDE: the rings and tables padded against bank conflicts), the
# same for both encoders (rans16_enc_packed and rans8_vmem.rans8_enc)
ENC_RING_BLK = 4 * (128 + 16)
ENC_LUT_STRIDE = 260
# shared memory of one encode CTA up to which its entries go there (an
# order-1 alphabet of 48, wide41's bucket, fits; 64 does not)
ENC_TABLES_SMEM_MAX = 160 * 1024


def _enc_smem(A2: int, tables: bool) -> int:
    """Shared memory of one encode CTA (csrc/rans_group.cuh: enc_smem):
    the byte rings and byte tables, then with
    ``tables`` the A2 + 1 entries of 8 bytes per block."""
    bpc = ENC_THREADS // 4
    return (bpc * (ENC_RING_BLK + ENC_LUT_STRIDE)
            + (bpc * (A2 + 1) * 8 if tables else 0))


def enc_tables_in_smem(A: int, order: int) -> bool:
    """Whether an encoder (this module's and ``rans8_vmem.rans8_enc``)
    keeps its entries in shared memory (always at order 0); wider tables
    are read from global memory."""
    return order == 0 or _enc_smem(A * A, True) <= ENC_TABLES_SMEM_MAX


def _enc_geometry(N: int, order: int):
    """(K, geom): steps and the order-1 state-3 tail length or the
    order-0 first-step pad."""
    if order == 1:
        q = N >> 2
        return q + (N - 4 * q), N - 4 * q
    K = -(-N // 4)
    return K, 4 * K - N


def rans16_enc_packed(blocks, alpha, packed, shift, order: int):
    """Encode B blocks of N bytes with packed rows.

    blocks (B,N) uint8 raw bytes, alpha (B,A) uint8 (A <= 255), packed
    (B, A*A if order else A) int32 ``base << 13 | freq``, shift an int
    or a (B,) integer tensor (one per block).  A byte maps to the number
    of alphabet entries below it (``rans_v2._densify``); entry
    ``ctx * A + sym`` past the table reads 0.  Returns (states (B,4)
    int32 in state order, words (B,4K) int16, counts (B,) int32): block
    b's stream in forward order is the LAST counts[b] words of its row
    (``convert.streams_to_host`` / ``words_forward`` read it); the words
    before them are unspecified."""
    B, N = blocks.shape
    A = alpha.shape[1]
    dev = blocks.device
    _require(blocks, "blocks", torch.uint8, (B, N), dev)
    _require(alpha, "alpha", torch.uint8, (B, A), dev)
    _require(packed, "packed", torch.int32, (B, A * A if order else A), dev)
    sv = _shift_vector(shift, B, dev, "rans16_enc_packed")
    if order not in (0, 1) or N < (4 if order else 1) or not 1 <= A <= 255:
        raise ValueError("rans16_enc_packed: bad geometry")
    if dev.type == "cpu":
        return _rans16_enc_packed_plain(blocks, alpha, packed, sv, order)
    K, _geom = _enc_geometry(N, order)
    cap = 4 * K
    blocks = _aligned(blocks)
    states = torch.empty((B, 4), dtype=torch.int32, device=dev)
    words = torch.empty((B, cap), dtype=torch.int16, device=dev)
    counts = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.get_lib().rans16_enc_packed_launch(
            blocks.data_ptr(), alpha.data_ptr(), packed.data_ptr(),
            sv.data_ptr(), states.data_ptr(), words.data_ptr(),
            counts.data_ptr(), B, N, A, order, cap,
            int(enc_tables_in_smem(A, order)), _stream(blocks))
    cuda_build.check(err, "rans16_enc_packed")
    LAUNCHES["rans16_enc_packed"] += 1
    return states, words, counts


def _rans16_enc_packed_plain(blocks, alpha, packed, shift, order: int):
    """Plain PyTorch version of rans16_enc_packed (shift a (B,) int32
    tensor)."""
    B, N = blocks.shape
    A = alpha.shape[1]
    A2 = packed.shape[1]
    dense = rans_v2._densify(blocks, alpha)
    sym_p, ctx_p, _valid, K, geom = rans_v2._enc_proc_inputs(dense, N, order)
    sym = sym_p.permute(2, 0, 1).to(torch.int64)            # (B,K,4)
    ctx = ctx_p.permute(2, 0, 1).to(torch.int64)
    pk = packed.to(torch.int64)

    def fetch(s):
        key = sym[:, s, :] + (ctx[:, s, :] * A if order else 0)
        e = torch.where(key < A2, pk.gather(1, key.clamp(max=A2 - 1)),
                        torch.zeros_like(key))
        return (e >> rans_v2.PACK_SHIFT) & _M32, e & rans_v2.PACK_MASK
    return _enc16_scan(fetch, shift, K, geom, order)


def _enc16_scan(fetch, shift, K: int, geom: int, order: int):
    """The 4x16 encode scan of the plain version.  ``fetch(s)`` gives
    step s's (start, freq), each (B,4) int64 in [0, 2^32), processing
    lane minor.  Words land at cap - 1 - (emission rank), as the kernel
    writes them."""
    B = shift.shape[0]
    dev = shift.device
    i64 = torch.int64
    cap = 4 * K
    sh = shift.to(i64)[:, None]
    xmult = (RANS_L >> sh) << 16
    lanes = torch.arange(4, device=dev)
    X = torch.full((B, 4), RANS_L, dtype=i64, device=dev)
    # forward-order buffer with one spill column for non-emitting lanes
    buf = torch.zeros((B, cap + 1), dtype=i64, device=dev)
    n = torch.zeros((B,), dtype=i64, device=dev)
    for s in range(K):
        ok = _enc_active(lanes, s, geom, order)
        start, f = fetch(s)
        emit = ok & (X >= ((xmult * f) & _M32))
        ei = emit.to(i64)
        rank = n[:, None] + ei.cumsum(dim=1) - ei
        buf.scatter_(1, torch.where(emit, cap - 1 - rank,
                                    torch.full_like(rank, cap)), X & 0xFFFF)
        x2 = torch.where(emit, X >> 16, X)
        fs = torch.where(f > 0, f, torch.ones_like(f))
        qq = x2 // fs
        xn = ((qq << sh) + (x2 - qq * fs) + start) & _M32
        X = torch.where(ok, xn, X)
        n = n + ei.sum(dim=1)
    return (_to_i32_bits(X.flip(1)), _to_i16_bits(buf[:, :cap]),
            n.to(torch.int32))


def _udiv_plain(n, d):
    """The encoder's divide-free quotient (csrc/rc_core.cuh: rc_udiv_recip,
    rc_udiv) on numpy uint64 arrays of 32-bit n and 1 <= d < 2^32: the
    high word of n * floor((2^32 - 1) / d), corrected once.  Equals
    n // d; the plain encoder divides directly."""
    m = np.uint64(0xFFFFFFFF) // d
    q = (n * m) >> np.uint64(32)
    return q + (n - q * d >= d)


def _enc_active(lanes, s: int, geom: int, order: int):
    """(1,4) bool: the processing lanes that code a symbol at step s.
    Order 1: the first geom steps are the state-3 tail (lane 0 alone);
    order 0: the first step skips the geom padded lanes."""
    if order == 1:
        ok = (lanes == 0) if s < geom else lanes >= 0
    else:
        ok = (lanes >= geom) if s == 0 else lanes >= 0
    return ok[None, :]


def _to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _to_i16_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^16) -> int16 with the same low 16 bits."""
    return torch.where(x >= (1 << 15), x - (1 << 16), x).to(torch.int16)
