"""Batched rANS 4x8 (CRAM 3.0): the batch entry points.

Counterpart of ``htscodecs_tpu/ops/rans8_v2.py``: ``enc_o0_batch /
enc_o1_batch / dec_o0_batch / dec_o1_batch`` with the same numpy
argument and return contract plus an explicit ``device``.  The dense
tables are those of ``ops/rans_v2.py`` (``alpha (B,A) u8``, ``packed``
i32 as ``base << 13 | freq``).  The parameters are ``rANS_byte.h``'s:
L = 1 << 23, precision fixed at 12 bits, up to two bytes per symbol.
Order 0 codes symbol i in state ``i & 3`` and the decoder reads the
last ``N & 3`` symbols from the final states without advancing them;
order 1 uses the four-quarter layout of the 4x16 codec.

The JAX package's scan engines and window variants are not carried
over: the entries always run the CUDA engine in ``ops/rans8_vmem.py``
(its plain PyTorch versions when ``device`` is the CPU).
"""

from __future__ import annotations

import numpy as np

from .rans_v2 import check_device

RANS8_L = 1 << 23
SHIFT = 12


def _enc8_tensors(blocks, alpha, packed, order: int, dev):
    """The batch encode's (states, bytes, counts) tensors on ``dev``
    (``rans8_vmem.rans8_enc``'s layout), queued on its current stream and
    not yet copied back."""
    from . import convert, rans8_vmem
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    return rans8_vmem.enc_batch(convert._tensor(blocks, dev), alpha, packed,
                                order)


def _enc8(blocks, alpha, packed, order: int, device):
    from . import convert
    dev = check_device(device)
    return convert.streams8_to_reference(
        *_enc8_tensors(blocks, alpha, packed, order, dev))


def enc_o0_batch(blocks: np.ndarray, alpha, packed, device="cuda"):
    """Batched order-0 encode.  Returns (states (B,4) u32, byte stream
    (B,cap) u8 forward order, counts (B,) i32); only
    ``stream[b, :counts[b]]`` is meaningful."""
    return _enc8(blocks, alpha, packed, 0, device)


def enc_o1_batch(blocks: np.ndarray, alpha, packed, device="cuda"):
    return _enc8(blocks, alpha, packed, 1, device)


def _dec8_tensor(states, stream, out_sz: int, alpha, packed, order: int,
                dev, counts=None):
    """The batch decode as a (B, out_sz) uint8 tensor on ``dev``, queued
    on its current stream and not yet copied back."""
    from . import convert, rans8_vmem
    tables = convert.tables8_from_reference(alpha, packed, dev)
    st, by, cnt = convert.streams8_from_reference(states, stream, dev, counts)
    return rans8_vmem.dec_batch(st, by, cnt, tables, out_sz, order)


def _dec8(states, stream, out_sz: int, alpha, packed, order: int, device,
          counts):
    dev = check_device(device)
    return _dec8_tensor(states, stream, out_sz, alpha, packed, order, dev,
                        counts).cpu().numpy()


def dec_o0_batch(states, stream, out_sz: int, alpha, packed, device="cuda",
                 counts=None):
    """states (B,4) u32; stream (B,W) u8 (the bytes after the 16 state
    bytes); counts (B,) optional per-block byte counts (default W).
    Returns (B, out_sz) u8.

    out_sz < 4 would run a full 4-state step before the no-advance tail
    symbols are read; such blocks belong on the host decoder."""
    if out_sz < 4:
        raise ValueError("dec_o0_batch requires out_sz >= 4; "
                         "route short blocks to the host decoder")
    return _dec8(states, stream, out_sz, alpha, packed, 0, device, counts)


def dec_o1_batch(states, stream, out_sz: int, alpha, packed, device="cuda",
                 counts=None):
    return _dec8(states, stream, out_sz, alpha, packed, 1, device, counts)
