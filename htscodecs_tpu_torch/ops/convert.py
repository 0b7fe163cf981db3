"""State carried between the JAX package's numpy layouts and the
port's tensors.

The JAX package hands its engines numpy arrays: ``alpha (B,A) u8``,
``packed (B,A,A)`` (order 0: ``(B,A)``) i32 as ``base << 13 | freq``,
``states (B,4) u32``, ``words (B,W) u16`` and a shift that is an int
or a ``(B,)`` vector.  The port's CUDA kernels read:

- ``Tables.alpha``  (B, A) uint8      dense index -> byte
- ``Tables.bases``  (B, Ac, A+1) int16  monotone cumulative-base rows
  (``rans_v2._b16_fill``; Ac = A for order 1, 1 for order 0).  Entries
  are <= 4096, so the int16 bits are the kernel's uint16 values.
- ``Tables.shift``  (B,) int32
- states (B, 4) int32 and words (B, W) int16: the BITS of the u32 /
  u16 values (PyTorch's unsigned 16/32-bit types have too few CPU
  operators to compute with; the plain versions widen to int64 and
  mask, the kernels reinterpret the pointers as unsigned)
- counts (B,) int32: words that belong to each block

The rANS 4x8 engine (``ops/rans8_vmem.py``) reads the same ``Tables``
with two differences: the successor column of ``bases`` holds each
row's own total (4x8 rows normalise to 4095 slots), and ``shift`` is
filled with 12, the codec's fixed precision.  Its stream is plain
``(B, W) uint8`` (the bytes after the 16 state bytes), its counts are
bytes per block.

The tests feed both packages through these functions, so the same
numpy arrays drive the JAX engines and the port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import rans_v2


class Tables(NamedTuple):
    alpha: torch.Tensor     # (B, A) uint8
    bases: torch.Tensor     # (B, Ac, A+1) int16
    shift: torch.Tensor     # (B,) int32


def _tensor(arr: np.ndarray, device) -> torch.Tensor:
    """numpy -> tensor on ``device`` (a read-only array is copied first:
    PyTorch has no read-only tensors)."""
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def shift_vector(shift, B: int) -> np.ndarray:
    """int or (B,) -> (B,) int32."""
    if isinstance(shift, (int, np.integer)):
        return np.full((B,), int(shift), np.int32)
    sv = np.ascontiguousarray(shift, dtype=np.int32)
    if sv.shape != (B,):
        raise ValueError(f"shift vector must have shape ({B},)")
    return sv


def tables_from_reference(alpha, packed, shift, device) -> Tables:
    """Reference numpy tables -> the port's ``Tables`` on ``device``."""
    alpha = np.ascontiguousarray(alpha, dtype=np.uint8)
    packed = np.ascontiguousarray(packed, dtype=np.int32)
    B = alpha.shape[0]
    sv = _tensor(shift_vector(shift, B), device)
    pk = _tensor(packed, device)
    if pk.dim() == 2:                      # order 0: one row per block
        pk = pk[:, None, :]
    bases = rans_v2._b16_fill(pk, sv).to(torch.int16).contiguous()
    return Tables(_tensor(alpha, device), bases, sv)


def tables_to_reference(tables: Tables, order: int):
    """Inverse of tables_from_reference: (alpha, packed, shift (B,)).

    ``packed`` is (B,A,A) for order 1 and (B,A) for order 0.  Entries
    with freq 0 come back as 0: their base is not recoverable from the
    filled rows, and no coder reads it."""
    rows = tables.bases.cpu().numpy().astype(np.int32)
    base = rows[:, :, :-1]
    freq = rows[:, :, 1:] - base
    packed = np.where(freq > 0, (base << rans_v2.PACK_SHIFT) | freq, 0)
    if order == 0:
        packed = packed[:, 0, :]
    return (tables.alpha.cpu().numpy(), packed.astype(np.int32),
            tables.shift.cpu().numpy())


def streams_from_reference(states, words, device, counts=None):
    """(B,4) u32 states + (B,W) u16 words [+ (B,) counts] -> the port's
    (states int32, words int16, counts int32) tensors on ``device``."""
    st = np.ascontiguousarray(states, dtype=np.uint32).view(np.int32)
    wd = np.ascontiguousarray(words, dtype=np.uint16).view(np.int16)
    B, W = wd.shape
    if counts is None:
        cn = np.full((B,), W, np.int32)
    else:
        cn = np.ascontiguousarray(counts, dtype=np.int32)
    return _tensor(st, device), _tensor(wd, device), _tensor(cn, device)


def streams_to_reference(states: torch.Tensor, words: torch.Tensor,
                         counts: torch.Tensor):
    """The port's encode outputs -> (states (B,4) u32, words (B,cap')
    u16, counts (B,) i32) numpy arrays.  Only the columns some block
    uses are copied off the device (cap' = max count, at least 1)."""
    cn = counts.cpu().numpy().astype(np.int32)
    cap = max(int(cn.max()) if len(cn) else 0, 1)
    wd = words[:, :cap].contiguous().cpu().numpy().view(np.uint16)
    st = states.contiguous().cpu().numpy().view(np.uint32)
    return st, wd, cn


# ---------------------------------------------------------------------------
# rANS 4x8

def tables8_from_reference(alpha, packed, device) -> Tables:
    """Reference numpy 4x8 tables (``native.r8_build_tables_dense`` or
    ``rans_v2.densify_*`` output) -> ``Tables`` on ``device`` with
    per-row totals in the successor column and shift 12."""
    from .rans8_vmem import SHIFT, _b16_fill_rowtot
    alpha = np.ascontiguousarray(alpha, dtype=np.uint8)
    pk = _tensor(np.ascontiguousarray(packed, dtype=np.int32), device)
    if pk.dim() == 2:                      # order 0: one row per block
        pk = pk[:, None, :]
    bases = _b16_fill_rowtot(pk).to(torch.int16).contiguous()
    sv = torch.full((alpha.shape[0],), SHIFT, dtype=torch.int32,
                    device=device)
    return Tables(_tensor(alpha, device), bases, sv)


def tables8_to_reference(tables: Tables, order: int):
    """Inverse of tables8_from_reference: (alpha, packed); entries with
    freq 0 come back as 0, as in tables_to_reference."""
    alpha, packed, _shift = tables_to_reference(tables, order)
    return alpha, packed


def streams8_from_reference(states, stream, device, counts=None):
    """(B,4) u32 states + (B,W) u8 stream [+ (B,) byte counts] -> the
    port's (states int32, stream uint8, counts int32) tensors."""
    st = np.ascontiguousarray(states, dtype=np.uint32).view(np.int32)
    by = np.ascontiguousarray(stream, dtype=np.uint8)
    B, W = by.shape
    if counts is None:
        cn = np.full((B,), W, np.int32)
    else:
        cn = np.ascontiguousarray(counts, dtype=np.int32)
    return _tensor(st, device), _tensor(by, device), _tensor(cn, device)


def streams8_to_reference(states: torch.Tensor, stream: torch.Tensor,
                          counts: torch.Tensor):
    """The 4x8 encoder's outputs -> (states (B,4) u32, bytes (B,cap')
    u8, counts (B,) i32) numpy arrays; only the columns some block uses
    are copied off the device (cap' = max count, at least 1)."""
    cn = counts.cpu().numpy().astype(np.int32)
    cap = max(int(cn.max()) if len(cn) else 0, 1)
    by = stream[:, :cap].contiguous().cpu().numpy()
    st = states.contiguous().cpu().numpy().view(np.uint32)
    return st, by, cn
