"""The range-coder chain over host-replayed triples: one CUDA kernel and
what surrounds it.

Counterpart of ``htscodecs_tpu/ops/rc_vmem.py``.  An adaptive codec
whose models do not fit on chip (fqzcomp_qual: 65536 contexts per job)
splits its encode in two: the model walk replays on the host and emits
one ``(acc, f, tot)`` u16 triple per coded event
(``native.fqz_enc_replay``), and the carry-counting byte range coder
(c_range_coder.h: RC_Encode, RC_ShiftLow) runs over the triples of all
jobs at once on the card.

``rc_enc``  csrc/rc_enc.cu
    replaces ``_build_rc_kernel`` / ``_rc_vmem`` with its event
    compaction, capacity tiers, stitch sorts, packed byte plane and
    exception planes.  One CTA per job, three warps in a pipeline: one
    stages the job's triples in chunks of ``chunk`` events into shared
    memory (bulk asynchronous copies of the aligned body, two buffers
    deep) and packs each event with the exact reciprocal of its total
    into a 16-byte record; one thread runs the range chain, with two
    wide multiplies in place of the divide (``_udiv_recip_plain`` is that
    arithmetic in numpy) and no branch on its data, and queues (acc * r,
    shifts) per event; one thread runs low, the carry and the bytes,
    which gather in a shared-memory ring of ``ring`` bytes that goes out
    in 16-byte stores (``csrc/rc_core.cuh`` holds the coder, shared with
    ``ops/arith_vmem.py``).  Bound by memory traffic on paper (6 bytes
    per event in, the emitted bytes out), by the one serial range chain
    per job in fact.

The kernel is codec-agnostic: any model whose encode order can be
replayed on the host feeds it.  The wrapper uses its plain PyTorch
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.  The triples travel as int16 bit patterns of the u16
values (``ops/convert.py``).  Decode has no such split (the context of
symbol i depends on the decoded symbols before it) and stays on the
host.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda_build
from . import convert
from .arith_vmem import _PlainCoder
from .rans_v2 import check_device
from .rans_vmem import LAUNCHES, _require, _stream

CHUNK = 1024    # events staged per buffer (two buffers)
RING = 4096     # bytes of the output ring


def _udiv_recip_plain(n, d):
    """floor(n / max(d, 1)) as the kernel computes it (``rc_core.cuh``:
    rc_udiv64_recip, rc_udiv64): m = ceil(2^64 / d) in two 32-bit halves
    (m = 0 and one = 1 for d = 1), q = floor(n * m / 2^64) + n * one,
    the high half through two 32 x 32 -> 64-bit products.  n < 2^32,
    d < 2^16; numpy arrays of any integer type broadcast together."""
    u64 = np.uint64
    n = np.asarray(n, u64)
    d = np.maximum(np.asarray(d, u64), u64(1))
    one = (d == 1).astype(u64)
    m = np.where(one == 1, u64(0), u64(0xFFFFFFFFFFFFFFFF) // d + u64(1))
    t = n * (m & u64(0xFFFFFFFF))
    u = n * (m >> u64(32)) + (t >> u64(32))
    return (u >> u64(32)) + n * one


def rc_enc(acc, f, tot, counts, chunk: int = 0, ring: int = 0):
    """Encode B blocks of triples.

    acc, f, tot (B, Kp) int16 (bits of u16: cumulative frequency,
    frequency and total of each coded event), counts (B,) int32 (events
    of each block).  ``chunk`` (a multiple of 8) and ``ring`` (a power
    of two, at least 16) are the kernel's staging and output-ring sizes;
    0 takes ``CHUNK`` / ``RING``.  They do not change the result.
    Returns (bytes (B, 2 Kp + 8) uint8 in stream order, counts (B,)
    int32); bytes past a block's count are unspecified."""
    B, Kp = acc.shape
    dev = acc.device
    for name, t in (("acc", acc), ("f", f), ("tot", tot)):
        _require(t, name, torch.int16, (B, Kp), dev)
    _require(counts, "counts", torch.int32, (B,), dev)
    if Kp > (1 << 29):
        raise ValueError("rc_enc: more than 2^29 events per block")
    chunk, ring = chunk or CHUNK, ring or RING
    if chunk < 8 or chunk % 8 or ring < 16 or ring & (ring - 1):
        raise ValueError("rc_enc: chunk must be a multiple of 8 and ring a "
                         "power of two >= 16")
    if dev.type == "cpu":
        return _rc_enc_plain(acc, f, tot, counts)
    cap = 2 * Kp + 8
    out = torch.empty((B, cap), dtype=torch.uint8, device=dev)
    nbytes = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.get_lib().rc_enc_launch(
            acc.data_ptr(), f.data_ptr(), tot.data_ptr(), counts.data_ptr(),
            out.data_ptr(), nbytes.data_ptr(), B, Kp, cap, chunk, ring,
            _stream(acc))
    cuda_build.check(err, "rc_enc")
    LAUNCHES["rc_enc"] += 1
    return out, nbytes


def _rc_enc_plain(acc, f, tot, counts):
    """Plain PyTorch version of rc_enc (same arguments)."""
    B, Kp = acc.shape
    i64 = torch.int64
    coder = _PlainCoder(B, Kp, acc.device)
    n = counts.to(i64)
    for k in range(Kp):
        coder.encode(acc[:, k].to(i64) & 0xFFFF, f[:, k].to(i64) & 0xFFFF,
                     tot[:, k].to(i64) & 0xFFFF, k < n)
    return coder.finish()


def enc_triples_batch(triples: list, device="cuda") -> list[bytes]:
    """Encode B blocks' ``(acc, f, tot)`` u16 triple arrays into
    reference range-coder payloads: a list of B byte strings."""
    dev = check_device(device)
    if not triples:
        return []
    acc, f, tot, counts = convert.triples_from_reference(triples, dev)
    out, nbytes = rc_enc(acc, f, tot, counts)
    return convert.payloads_to_reference(out, nbytes)
