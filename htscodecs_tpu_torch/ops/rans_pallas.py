"""The first-generation batched rANS 4x16 engine: two CUDA kernels that
work straight from the packed ``base << 13 | freq`` rows.

Counterpart of ``htscodecs_tpu/ops/rans_pallas.py`` (the name is kept
so that a reader finds it).  In the JAX package that module is an
alternative engine with ``rans_v2``'s contract, fed by the device table
build (``ops/tables_v2.py``); its kernels read the packed rows as the
builder makes them, where ``rans_v2``'s engines first turn them into
monotone base rows (``rans_v2._b16_fill``).  The public entries keep the
JAX signatures and numpy in / numpy out contract, plus ``device``:

    dec_o1_batch(states, words, out_sz, alpha, packed, shift, tile=512)
    dec_o0_batch(states, words, out_sz, alpha, packed, shift=12, tile=512)
    enc_o1_batch(blocks, alpha, packed, shift, tile=1024)
    enc_o0_batch(blocks, alpha, packed, shift=12, tile=1024)

``alpha`` and ``packed`` may also be tensors (what
``tables_v2.build_o*_device`` returns); ``shift`` is one int per call.
``tile`` is accepted and changes no result: in the JAX package it only
keeps a tile of blocks inside the TPU's on-chip memory; here each call
is one launch of the kernel over the whole batch.  Neither is there a
word-width cap: the JAX decode's word buckets (up to 12288 words, wider
streams go to the v2 engine) answer the same memory limit, and the CUDA
kernel takes any width.  As in the JAX function, a decode of fewer than
4 bytes goes to ``rans_v2``'s engine (``rans16_dec``).

``rans16_dec_packed``  csrc/rans16_dec_packed.cu
    replaces ``_dec_kernel_body`` / ``_dec_tile`` (with the prologue and
    byte reassembly of ``_dec_pallas_to_bytes``).  Bound by operations
    (the state step and a bisection of the row, as for ``rans16_dec``).
    The slot search scans the context's A packed entries for the last
    one with freq > 0 and base <= slot (holes hold their successor's
    base); a bisection over the row's first asz entries would find the
    same one, but the kernel is not told asz.  One 4-thread group per
    block; bytes written in final order.
``rans16_enc_packed``  csrc/rans16_enc_packed.cu
    replaces ``_enc_kernel_body`` / ``_enc_tile`` (with the
    ``_enc_pallas`` prologue and the ``_compact`` compaction).  Bound
    by operations (the step with its divide; one byte per symbol in).
    Reads the raw block bytes, maps them to dense indices through a
    per-block 256-entry table in shared memory and takes contexts from
    the previous byte of the same quarter; words ranked by ballot and
    reversed in place, as in ``rans16_enc``.

Each wrapper checks its arguments, uses the plain PyTorch version below
it only for tensors on the CPU (a loop over steps, vectorised over
blocks, exact in int64), and for CUDA tensors launches its kernel or
raises, counting the launch in ``rans_vmem.LAUNCHES``.  Both kernels
give the same bits as ``rans_v2``'s engines on the same tables.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda_build
from . import convert, rans_v2
from .rans_vmem import (LAUNCHES, _M32, _dec16_scan, _enc16_scan,
                        _require, _stream)

PACK_SHIFT = 13
PACK_MASK = (1 << PACK_SHIFT) - 1


def _check_shift(shift: int, name: str) -> None:
    if not 1 <= shift <= 15:
        raise ValueError(f"{name}: shift must be in [1, 15], got {shift}")


def _enc_geometry(N: int, order: int):
    """(K, geom): steps and the order-1 state-3 tail length or the
    order-0 first-step pad."""
    if order == 1:
        q = N >> 2
        return q + (N - 4 * q), N - 4 * q
    K = -(-N // 4)
    return K, 4 * K - N


# ---------------------------------------------------------------------------
# rans16_dec_packed

def rans16_dec_packed(states, words, packed, alpha, shift: int, N: int,
                      order: int):
    """Decode B blocks of N bytes from packed rows.

    states (B,4) int32 and words (B,W) int16 (the bits of the u32 / u16
    values; reads past W give 0), packed (B, A*A if order else A) int32
    ``base << 13 | freq``, alpha (B,A) uint8, one shift.  Returns (B,N)
    uint8."""
    B, W = words.shape
    A = alpha.shape[1]
    dev = words.device
    _require(states, "states", torch.int32, (B, 4), dev)
    _require(words, "words", torch.int16, (B, W), dev)
    _require(packed, "packed", torch.int32, (B, A * A if order else A), dev)
    _require(alpha, "alpha", torch.uint8, (B, A), dev)
    _check_shift(shift, "rans16_dec_packed")
    if order not in (0, 1) or N <= 0 or W < 1 or A < 1:
        raise ValueError("rans16_dec_packed: bad geometry")
    if dev.type == "cpu":
        return _rans16_dec_packed_plain(states, words, packed, alpha, shift,
                                        N, order)
    out = torch.empty((B, N), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.get_lib().rans16_dec_packed_launch(
            states.data_ptr(), words.data_ptr(), packed.data_ptr(),
            alpha.data_ptr(), out.data_ptr(), B, W, A, N, order, shift,
            _stream(words))
    cuda_build.check(err, "rans16_dec_packed")
    LAUNCHES["rans16_dec_packed"] += 1
    return out


def _rans16_dec_packed_plain(states, words, packed, alpha, shift: int,
                             N: int, order: int):
    """Plain PyTorch version of rans16_dec_packed (same arguments)."""
    B = words.shape[0]
    A = alpha.shape[1]
    dev = words.device
    rows_all = packed.to(torch.int64).view(B, A if order else 1, A)
    bidx = torch.arange(B, device=dev)[:, None]
    kio = torch.arange(A, device=dev)

    def lookup(ctx, m):
        if order == 1:
            rows = rows_all[bidx, ctx]                      # (B,4,A)
        else:
            rows = rows_all[:, 0][:, None, :].expand(B, 4, A)
        # the last entry with freq > 0 and base <= m; none -> entry 0
        # read as 0 (sym 0, base 0, freq 0)
        match = ((rows & PACK_MASK) > 0) & ((rows >> PACK_SHIFT) <= m[:, :, None])
        last = torch.where(match, kio, torch.full_like(kio, -1)).amax(dim=2)
        sym = last.clamp(min=0)
        e = torch.where(last >= 0, rows.gather(2, sym[:, :, None])[:, :, 0],
                        torch.zeros_like(last))
        return sym, (e >> PACK_SHIFT) & _M32, e & PACK_MASK
    sv = torch.full((B,), shift, dtype=torch.int32, device=dev)
    return _dec16_scan(states, words, None, lookup, alpha, sv, N, order)


# ---------------------------------------------------------------------------
# rans16_enc_packed

def rans16_enc_packed(blocks, alpha, packed, shift: int, order: int):
    """Encode B blocks of N bytes with packed rows.

    blocks (B,N) uint8 raw bytes, alpha (B,A) uint8 (A <= 255), packed
    (B, A*A if order else A) int32 ``base << 13 | freq``, one shift.
    A byte maps to the number of alphabet entries below it
    (``rans_v2._densify``); entry ``ctx * A + sym`` past the table reads
    0.  Returns (states (B,4) int32 in state order, words (B,4K) int16
    in forward order, counts (B,) int32); words past a block's count
    are unspecified."""
    B, N = blocks.shape
    A = alpha.shape[1]
    dev = blocks.device
    _require(blocks, "blocks", torch.uint8, (B, N), dev)
    _require(alpha, "alpha", torch.uint8, (B, A), dev)
    _require(packed, "packed", torch.int32, (B, A * A if order else A), dev)
    _check_shift(shift, "rans16_enc_packed")
    if order not in (0, 1) or N < (4 if order else 1) or not 1 <= A <= 255:
        raise ValueError("rans16_enc_packed: bad geometry")
    if dev.type == "cpu":
        return _rans16_enc_packed_plain(blocks, alpha, packed, shift, order)
    K, _geom = _enc_geometry(N, order)
    cap = 4 * K
    states = torch.empty((B, 4), dtype=torch.int32, device=dev)
    words = torch.empty((B, cap), dtype=torch.int16, device=dev)
    counts = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.get_lib().rans16_enc_packed_launch(
            blocks.data_ptr(), alpha.data_ptr(), packed.data_ptr(),
            states.data_ptr(), words.data_ptr(), counts.data_ptr(),
            B, N, A, order, shift, cap, _stream(blocks))
    cuda_build.check(err, "rans16_enc_packed")
    LAUNCHES["rans16_enc_packed"] += 1
    return states, words, counts


def _rans16_enc_packed_plain(blocks, alpha, packed, shift: int, order: int):
    """Plain PyTorch version of rans16_enc_packed (same arguments)."""
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
        return (e >> PACK_SHIFT) & _M32, e & PACK_MASK
    sv = torch.full((B,), shift, dtype=torch.int32, device=blocks.device)
    return _enc16_scan(fetch, sv, K, geom, order)


# ---------------------------------------------------------------------------
# batch entries (numpy in, numpy out)

def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _dec_batch(states, words, out_sz: int, alpha, packed, shift: int,
               order: int, device):
    dev = rans_v2.check_device(device)
    shift = int(shift)
    if out_sz < 4:
        # as the JAX function does: rans_v2's engine (rans16_dec)
        f = rans_v2.dec_o1_batch if order else rans_v2.dec_o0_batch
        return f(states, words, out_sz, _host(alpha), _host(packed), shift,
                 device=dev)
    B = len(states)
    words = np.asarray(words, dtype=np.uint16)
    if words.shape[1] == 0:
        words = np.zeros((B, 1), np.uint16)
    st, wd, _cn = convert.streams_from_reference(states, words, dev)
    al = convert.as_tensor(alpha, torch.uint8, dev)
    pk = convert.as_tensor(packed, torch.int32, dev).reshape(B, -1)
    return rans16_dec_packed(st, wd, pk, al, shift, out_sz, order).cpu().numpy()


def dec_o1_batch(states, words, out_sz: int, alpha, packed, shift: int,
                 tile: int = 512, device="cuda"):
    """Batched order-1 decode from packed rows.  Same contract as
    ``rans_v2.dec_o1_batch`` with one shift: states (B,4) u32, words
    (B,w) u16, alpha (B,A) u8, packed (B,A,A) i32.  Returns (B, out_sz)
    u8.  ``tile`` changes no result (see the module docstring)."""
    return _dec_batch(states, words, out_sz, alpha, packed, shift, 1, device)


def dec_o0_batch(states, words, out_sz: int, alpha, packed, shift: int = 12,
                 tile: int = 512, device="cuda"):
    return _dec_batch(states, words, out_sz, alpha, packed, shift, 0, device)


def _enc_batch(blocks, alpha, packed, shift: int, order: int, device):
    dev = rans_v2.check_device(device)
    bt = convert.as_tensor(blocks, torch.uint8, dev)
    al = convert.as_tensor(alpha, torch.uint8, dev)
    pk = convert.as_tensor(packed, torch.int32, dev).reshape(bt.shape[0], -1)
    return convert.streams_to_reference(
        *rans16_enc_packed(bt, al, pk, int(shift), order))


def enc_o1_batch(blocks, alpha, packed, shift: int, tile: int = 1024,
                 device="cuda"):
    """Batched order-1 encode with packed rows.  Same contract as
    ``rans_v2.enc_o1_batch`` with one shift: returns (states (B,4) u32,
    words (B,cap) u16 forward order, counts (B,) i32); only
    ``words[b, :counts[b]]`` is meaningful.  ``tile`` changes no
    result."""
    return _enc_batch(blocks, alpha, packed, shift, 1, device)


def enc_o0_batch(blocks, alpha, packed, shift: int = 12, tile: int = 1024,
                 device="cuda"):
    return _enc_batch(blocks, alpha, packed, shift, 0, device)
