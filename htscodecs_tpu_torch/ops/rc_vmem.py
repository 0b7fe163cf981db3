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
    exception planes.  One thread per job runs the job's chain and
    writes stream bytes and the five finishing shifts directly
    (``csrc/rc_core.cuh``, shared with ``ops/arith_vmem.py``).  Bound by
    memory traffic on paper (6 bytes per event in, the emitted bytes
    out), by the latency of one serial chain per job in fact.

The kernel is codec-agnostic: any model whose encode order can be
replayed on the host feeds it.  The wrapper uses its plain PyTorch
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.  The triples travel as int16 bit patterns of the u16
values (``ops/convert.py``).  Decode has no such split (the context of
symbol i depends on the decoded symbols before it) and stays on the
host.
"""

from __future__ import annotations

import torch

from .. import cuda_build
from . import convert
from .arith_vmem import _PlainCoder, threads_per_cta
from .rans_v2 import check_device
from .rans_vmem import LAUNCHES, _require, _stream


def rc_enc(acc, f, tot, counts):
    """Encode B blocks of triples.

    acc, f, tot (B, Kp) int16 (bits of u16: cumulative frequency,
    frequency and total of each coded event), counts (B,) int32 (events
    of each block).  Returns (bytes (B, 2 Kp + 8) uint8 in stream order, counts (B,)
    int32); bytes past a block's count are unspecified."""
    B, Kp = acc.shape
    dev = acc.device
    for name, t in (("acc", acc), ("f", f), ("tot", tot)):
        _require(t, name, torch.int16, (B, Kp), dev)
    _require(counts, "counts", torch.int32, (B,), dev)
    if Kp > (1 << 29):
        raise ValueError("rc_enc: more than 2^29 events per block")
    if dev.type == "cpu":
        return _rc_enc_plain(acc, f, tot, counts)
    cap = 2 * Kp + 8
    out = torch.empty((B, cap), dtype=torch.uint8, device=dev)
    nbytes = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.get_lib().rc_enc_launch(
            acc.data_ptr(), f.data_ptr(), tot.data_ptr(), counts.data_ptr(),
            out.data_ptr(), nbytes.data_ptr(), B, Kp, cap,
            threads_per_cta(B, dev), _stream(acc))
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
