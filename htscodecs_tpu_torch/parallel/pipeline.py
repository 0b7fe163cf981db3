"""Device round-trip steps and the row split over several devices.

Counterpart of ``htscodecs_tpu/parallel/pipeline.py``.  CRAM blocks are
independent of each other, so the scaling axis is block-level data
parallelism: the rows of a batch split over a list of devices, each
part runs on its own device, and only the verdicts are summed.  The
JAX package's mesh (``make_mesh``) becomes a list of local
``torch.device``s and its sharded placement (``shard_batch``) a split
of the rows over that list.

``roundtrip_o1_v2`` is the codec's one-call step: the one 4x16 encoder
(``rans_vmem.rans16_enc_packed``), the decoder's packed entry
(``rans16_dec_packed``) and the comparison with the input, all queued
on the device; only the two scalars (mismatches, compressed payload
bytes) come back.  The JAX step also counts a compaction overflow as a
mismatch; the CUDA encoder has no compaction capacity to overflow.
``roundtrip_o1`` is the same step on the first-generation engine
(``ops/rans_jax.py``, plain PyTorch operations), a test oracle.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import native
from ..ops import convert, rans_jax, rans_v2
from ..ops.rans_vmem import rans16_dec_packed, rans16_enc_packed


def make_mesh(devices=None) -> list[torch.device]:
    """The devices that blocks split over: the given ones, or every
    local CUDA device (without a card that default raises)."""
    if devices is None:
        rans_v2.check_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def shard_batch(mesh, arr, batch_axis: int = 0) -> list[torch.Tensor]:
    """``arr`` (numpy or tensor) split along ``batch_axis`` into
    len(mesh) contiguous parts (sizes differ by at most one), part i a
    tensor on mesh[i]."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(arr))
    parts = torch.tensor_split(t, len(mesh), dim=batch_axis)
    return [p.to(torch.device(d)).contiguous() for p, d in zip(parts, mesh)]


# ---------------------------------------------------------------------------
# the v2 step: the one encoder and the decoder's packed entry

def _roundtrip_o1_v2(blocks, alpha, packed, shift: int, N: int):
    """The step on tensors of one device; returns (mismatches, bytes) as
    0-dim int64 tensors there, queued on its current stream."""
    B = blocks.shape[0]
    pk = packed.reshape(B, -1)
    states, words, counts = rans16_enc_packed(blocks, alpha, pk, shift, 1)
    # each stream moved to the start of its row at the row's full width,
    # so that no count has to come back first
    fwd = convert.words_forward(words, counts, width=words.shape[1])
    out = rans16_dec_packed(states, fwd, pk, alpha, shift, N, 1)
    mism = (out != blocks).sum()
    nbytes = 16 * B + 2 * counts.to(torch.int64).sum()
    return mism, nbytes


def _on(dev, blocks, alpha, packed):
    return (convert.as_tensor(blocks, torch.uint8, dev),
            convert.as_tensor(alpha, torch.uint8, dev),
            convert.as_tensor(packed, torch.int32, dev))


def roundtrip_o1_v2(blocks, alpha, packed, shift: int, N: int,
                    device="cuda"):
    """Order-1 round trip in one call: encode, decode and compare on the
    device.  blocks (B,N) u8, alpha (B,A) u8, packed (B,A,A) i32
    (``base << 13 | freq``), one table precision ``shift``; numpy arrays
    or tensors, moved to ``device`` (a tensor already there is used as it
    is).  Returns (mismatched bytes, compressed payload bytes
    16·B + 2·Σ words) as ints."""
    dev = rans_v2.check_device(device)
    mism, nbytes = _roundtrip_o1_v2(*_on(dev, blocks, alpha, packed),
                                    shift, N)
    return int(mism), int(nbytes)


def sharded_roundtrip_o1_v2(devices, blocks, alpha, packed, shift: int,
                            N: int):
    """roundtrip_o1_v2 with the rows split over ``devices``: every part
    is queued on its device before any verdict is read, and the
    verdicts are summed (the codec has no cross-block dataflow).
    Returns (mismatches, compressed bytes) as ints."""
    mesh = make_mesh(devices)
    parts = [shard_batch(mesh, a) for a in (blocks, alpha, packed)]
    verdicts = [_roundtrip_o1_v2(*_on(d, b, a, p), shift, N)
                for d, b, a, p in zip(mesh, *parts) if len(b)]
    return (sum(int(m) for m, _n in verdicts),
            sum(int(n) for _m, n in verdicts))


# ---------------------------------------------------------------------------
# host tables

def build_o1_tables_dense(blocks: np.ndarray, threads: bool = True):
    """Per-block order-1 dense tables from the native table build (over a
    thread pool: ctypes releases the GIL).  Returns (alpha, packed,
    shift, headers), or None without the native library, for an
    alphabet wider than 96 or for blocks of mixed shift."""
    if not native.available():
        return None
    if threads and len(blocks) > 2 and (os.cpu_count() or 1) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(min(16, os.cpu_count() or 4)) as pool:
            res = list(pool.map(native.build_tables_o1_dense, list(blocks)))
    else:
        res = [native.build_tables_o1_dense(b) for b in blocks]
    if any(r is None for r in res):
        return None
    shifts = np.array([r[3] for r in res], np.int32)
    if not (shifts == shifts[0]).all():
        return None
    alpha, packed, _ = rans_v2.densify_builds((r[1], r[2]) for r in res)
    return alpha, packed, int(shifts[0]), [r[0] for r in res]


def build_o1_tables(blocks: np.ndarray):
    """Per-block order-1 tables over all 256 contexts (the native
    table build, or the pure-numpy path when the native library is off).
    Returns (start2d, freq2d (B,256,256) u32, shifts (B,) i32,
    headers)."""
    B = blocks.shape[0]
    st = np.zeros((B, 256, 256), np.uint32)
    fr = np.zeros((B, 256, 256), np.uint32)
    shifts = np.zeros(B, np.int32)
    headers = []
    if native.available():
        for b in range(B):
            hdr, s, f, sh = native.build_tables_o1(blocks[b])
            st[b], fr[b], shifts[b] = s, f, sh
            headers.append(hdr)
        return st, fr, shifts, headers
    from ..ops import freq as fq
    for b in range(B):
        data = blocks[b]
        Fnp, Tnp = fq.hist1_4(data)
        F = Fnp.astype(np.int64)
        T = Tnp.astype(np.int64)
        q = len(data) >> 2
        for k in (1, 2, 3):
            F[0][data[k * q]] += 1
        T[0] += 3
        A = fq.present8(data).astype(np.int64)
        A[0] = 1
        shift, S = fq.compute_shift(A, F, T)
        shifts[b] = shift
        hdr = bytearray([0])
        fq.encode_alphabet(hdr, A)
        for i in range(256):
            if not A[i]:
                continue
            mv = S[i]
            if shift == fq.TF_SHIFT_O1_FAST and mv > fq.TOTFREQ_O1_FAST:
                mv = fq.TOTFREQ_O1_FAST
            Fi = [int(v) for v in F[i]]
            fq.normalise_freq(Fi, int(T[i]), mv)
            fq.encode_freq_d(hdr, A, Fi)
            fq.normalise_freq_shift(Fi, mv, 1 << shift)
            x = 0
            for j in range(256):
                st[b, i, j] = x
                x += Fi[j]
                fr[b, i, j] = Fi[j]
        hdr[0] = shift << 4
        headers.append(bytes(hdr))
    return st, fr, shifts, headers


def build_o1_batch_inputs(blocks: np.ndarray, start2d: np.ndarray,
                          freq2d: np.ndarray, shift: int):
    """Host preparation of roundtrip_o1's inputs: per-step coding
    parameters in processing order (u32, state 3 first within a step)
    and the valid mask.  Returns (st_p, fr_p, va_p, K, q)."""
    B = blocks.shape[0]
    ctx, sym, valid, K, q = rans_jax.o1_params(blocks)
    b_idx = np.arange(B)[None, :, None]
    st = start2d[b_idx, ctx, sym].astype(np.uint32)
    fr = freq2d[b_idx, ctx, sym].astype(np.uint32)
    return (np.ascontiguousarray(st[:, :, ::-1]),
            np.ascontiguousarray(fr[:, :, ::-1]),
            np.ascontiguousarray(valid[:, :, ::-1]), K, q)


# ---------------------------------------------------------------------------
# the v1 step (ops/rans_jax.py)

def _build_sfb(f2d: torch.Tensor, b2d: torch.Tensor, shift: int):
    """Slot -> symbol tables: sfb[b, ctx, slot] = the number of symbols
    whose cumulative frequency (inclusive, by byte value) is <= slot, as
    uint8 (an empty context's 256 wraps to 0, as the JAX count does).
    (B, 256, 1 << shift) uint8, one block at a time."""
    B = f2d.shape[0]
    tot = 1 << shift
    slots = torch.arange(tot, dtype=torch.int64, device=f2d.device) \
        .expand(256, tot).contiguous()
    out = torch.empty((B, 256, tot), dtype=torch.uint8, device=f2d.device)
    for b in range(B):
        cum = f2d[b].to(torch.int64).cumsum(dim=1)
        out[b] = torch.searchsorted(cum, slots, right=True).to(torch.uint8)
    return out


def roundtrip_o1(st_p, fr_p, va_p, f2d, b2d, ref_syms, shift: int, K: int,
                 q: int, N: int, device="cuda"):
    """The full v1 step: encode scan, compaction, slot tables, decode
    scan and comparison with ``ref_syms`` (B,N), on ``device``.  Inputs
    as ``build_o1_batch_inputs`` and ``build_o1_tables`` give them.
    Returns (mismatches, compressed payload bytes) as ints."""
    dev = rans_v2.check_device(device)
    t = rans_jax._t
    B = ref_syms.shape[0]
    xf, words, emits = rans_jax._enc_scan(
        t(st_p, dev), t(fr_p, dev), torch.as_tensor(va_p).to(dev), shift)
    out, n = rans_jax._enc_compact(xf, words, emits, shift, N + 16)
    f2 = t(f2d, dev)
    sfb = _build_sfb(f2, None, shift).reshape(B, -1)
    fbb = ((f2 << 16) | t(b2d, dev)).reshape(B, -1)
    syms, _, _ = rans_jax._dec_o1_scan(
        xf.flip(1), out, torch.zeros((B,), dtype=torch.int64, device=dev),
        sfb, fbb, shift, K, q)
    got = rans_jax.syms_to_bytes(syms, N, q)
    mism = int((got != t(ref_syms, dev)).sum())
    return mism, int(16 * B + 2 * n.sum())
