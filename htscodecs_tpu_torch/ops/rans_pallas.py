"""The first-generation batched rANS 4x16 engine of the JAX package,
with its contract: numpy in, numpy out, the packed rows as the device
table build makes them, one shift per call.

Counterpart of ``htscodecs_tpu/ops/rans_pallas.py`` (the name is kept
so that a reader finds it).  In the JAX package that module is an
alternative engine with ``rans_v2``'s contract, fed by the device table
build (``ops/tables_v2.py``); its kernels read the packed rows as the
builder makes them.  Here it runs the port's one 4x16 encoder and one
4x16 decoder (``ops/rans_vmem.py``): ``rans16_enc_packed`` reads packed
rows on every route, and ``rans16_dec_packed`` is the decoder's
packed-row entry.  The public entries keep the JAX signatures, plus
``device``:

    dec_o1_batch(states, words, out_sz, alpha, packed, shift, tile=512)
    dec_o0_batch(states, words, out_sz, alpha, packed, shift=12, tile=512)
    enc_o1_batch(blocks, alpha, packed, shift, tile=1024)
    enc_o0_batch(blocks, alpha, packed, shift=12, tile=1024)

``alpha`` and ``packed`` may also be tensors (what
``tables_v2.build_o*_device`` returns); ``shift`` is one int per call.
``tile`` is accepted and changes no result: in the JAX package it only
keeps a tile of blocks inside the TPU's on-chip memory; here each call
is one launch of a kernel over the whole batch.  Neither is there a
word-width cap: the JAX decode's word buckets (up to 12288 words, wider
streams go to the v2 engine) answer the same memory limit, and the CUDA
kernel takes any width.  As in the JAX function, a decode of fewer than
4 bytes goes to ``rans_v2``'s engine (``rans16_dec``).  Both engines
give the same bits on the same tables.
"""

from __future__ import annotations

import numpy as np
import torch

from . import convert, rans_v2
# the kernels this engine runs (csrc/rans16_enc_packed.cu and the packed
# reader of csrc/rans16_dec.cu)
from .rans_vmem import rans16_dec_packed, rans16_enc_packed  # noqa: F401


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
