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

The rANS 4x8 decoder (``ops/rans8_vmem.py``) reads the same ``Tables``
with two differences: the successor column of ``bases`` holds each
row's own total (4x8 rows normalise to 4095 slots), and ``shift`` is
filled with 12, the codec's fixed precision; the 4x8 encoder reads the
packed rows.  Its stream is plain ``(B, W) uint8`` (the bytes after the
16 state bytes), its counts are bytes per block.

The adaptive range-coder engines (``ops/arith_vmem.py``,
``ops/rc_vmem.py``) take what the JAX package's batch functions take
(numpy blocks, lengths and max-symbol counts; lists of payload byte
strings; lists of ``(acc, f, tot)`` u16 triples) and read:

- ``model_bank``: the adaptive models' initial state, ``(B, Mc, M+1)``
  int32 (Mc = M at order 1, 1 at order 0): entry j of a row holds
  ``symbol << 16 | frequency`` (symbol j, frequency 1 below the block's
  max-symbol count, else 0), entry M the row's total.  Every context's
  model starts alike;
- payloads as a zero-padded ``(B, W)`` uint8 tensor and byte counts;
- triples as three ``(B, Kp)`` int16 tensors (the bits of the u16
  values) and event counts;
- an encoder's ``(bytes (B, cap) uint8, counts (B,) int32)`` come back
  as the reference's list of payload byte strings.

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


def as_tensor(x, dtype, device) -> torch.Tensor:
    """A numpy array or a tensor -> a contiguous ``dtype`` tensor on
    ``device`` (a tensor already there, of that type, is used as it
    is)."""
    if not isinstance(x, torch.Tensor):
        x = _tensor(np.ascontiguousarray(x), device)
    return x.to(device=device, dtype=dtype).contiguous()


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
    return tables_from_packed(_tensor(alpha, device),
                              _tensor(packed, device), shift)


def tables_from_packed(alpha: torch.Tensor, packed: torch.Tensor,
                       shift) -> Tables:
    """Packed rows already on the device -> ``Tables`` there, tensor in,
    tensor out (the device table build's outputs need no host round
    trip).  alpha (B, A) uint8; packed (B, A, A) int32 for order 1,
    (B, A) for order 0, as ``base << 13 | freq``; shift an int, a (B,)
    numpy vector or a (B,) integer tensor.  The same bits as
    ``tables_from_reference`` on the same values."""
    dev = packed.device
    B = packed.shape[0]
    if isinstance(shift, torch.Tensor):
        sv = shift.to(device=dev, dtype=torch.int32).contiguous()
        if tuple(sv.shape) != (B,):
            raise ValueError(f"shift vector must have shape ({B},)")
    else:
        sv = _tensor(shift_vector(shift, B), dev)
    pk = packed.to(torch.int32)
    if pk.dim() == 2:                      # order 0: one row per block
        pk = pk[:, None, :]
    bases = rans_v2._b16_fill(pk, sv).to(torch.int16).contiguous()
    return Tables(alpha.to(device=dev, dtype=torch.uint8).contiguous(),
                  bases, sv)


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


def streams_to_host(states: torch.Tensor, words: torch.Tensor,
                    counts: torch.Tensor):
    """The 4x16 encoder's outputs (each block's stream in forward order
    at the END of its row, ``rans_vmem.rans16_enc_packed``) -> numpy
    (states (B,4) u32, words (B,W') u16, counts (B,) i32), the words
    still at the end of each row: block b's stream is
    ``words[b, W' - counts[b]:]``.  Only the last W' = max count (at
    least 1) columns are copied off the device."""
    cn = counts.cpu().numpy().astype(np.int32)
    W = max(int(cn.max()) if len(cn) else 0, 1)
    wd = words[:, words.shape[1] - W:].contiguous().cpu().numpy()
    wd = wd.view(np.uint16)
    st = states.contiguous().cpu().numpy().view(np.uint32)
    return st, wd, cn


def streams_to_reference(states: torch.Tensor, words: torch.Tensor,
                         counts: torch.Tensor):
    """The 4x16 encoder's outputs -> the reference's (states (B,4) u32,
    words (B,W') u16, counts (B,) i32), each block's stream at the START
    of its row: ``words[b, :counts[b]]``, zeros past it."""
    st, wd, cn = streams_to_host(states, words, counts)
    W = wd.shape[1]
    out = np.zeros_like(wd)
    for b, n in enumerate(cn):
        out[b, :n] = wd[b, W - n:]
    return st, out, cn


def words_forward(words: torch.Tensor, counts: torch.Tensor,
                  width: int | None = None) -> torch.Tensor:
    """The 4x16 encoder's words (each block's stream at the end of its
    row) -> (B, W') int16 on the same device with each stream at the
    start of its row and zeros past it, W' = max count (at least 1):
    what the decoders read.  ``width`` sets W' instead (the row width
    keeps every stream and needs no copy of the counts to the host)."""
    B, cap = words.shape
    W = width if width is not None else max(
        int(counts.max()) if B else 0, 1)
    i = torch.arange(W, device=words.device)[None, :]
    n = counts.to(torch.int64)[:, None]
    src = (cap - n + i).clamp(max=cap - 1)
    return torch.where(i < n, words.gather(1, src),
                       torch.zeros((), dtype=words.dtype, device=words.device))


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
    """The 4x8 encoder's outputs (each block's stream in forward order
    at the END of its row, ``rans8_vmem.rans8_enc``) -> the reference's
    (states (B,4) u32, bytes (B,cap') u8, counts (B,) i32) numpy arrays,
    each block's stream at the START of its row, zeros past it.  Only
    the last cap' = max count (at least 1) columns are copied off the
    device."""
    cn = counts.cpu().numpy().astype(np.int32)
    cap = max(int(cn.max()) if len(cn) else 0, 1)
    W = stream.shape[1]
    tail = stream[:, W - cap:].contiguous().cpu().numpy()
    i = np.arange(cap)[None, :]
    src = np.minimum(cap - cn[:, None] + i, cap - 1)
    by = np.where(i < cn[:, None], np.take_along_axis(tail, src, axis=1),
                  np.uint8(0))
    st = states.contiguous().cpu().numpy().view(np.uint32)
    return st, by, cn


# ---------------------------------------------------------------------------
# adaptive range coders (arith_dynamic, fqzcomp_qual)

def model_bank(max_syms: torch.Tensor, M: int, order: int) -> torch.Tensor:
    """Initial SIMPLE_MODEL state of a batch on ``max_syms``'s device.

    max_syms (B,) int32 (1..M each).  Returns (B, M if order else 1,
    M+1) int32: ``symbol << 16 | frequency`` per entry, the total in the
    last column."""
    iota = torch.arange(M, dtype=torch.int32, device=max_syms.device)
    row = (iota[None, :] < max_syms[:, None]).to(torch.int32) \
        | (iota << 16)[None, :]
    row = torch.cat([row, max_syms[:, None].to(torch.int32)], dim=1)
    Mc = M if order == 1 else 1
    return row[:, None, :].expand(-1, Mc, -1).contiguous()


def payloads_from_reference(streams, device):
    """List of B payload byte strings -> (stream (B, W) uint8 zero
    padded, counts (B,) int32) on ``device``; W is at least 1."""
    B = len(streams)
    cn = np.array([len(s) for s in streams], np.int32)
    buf = np.zeros((B, max(int(cn.max()) if B else 0, 1)), np.uint8)
    for b, s in enumerate(streams):
        buf[b, :cn[b]] = np.frombuffer(s, np.uint8)
    return _tensor(buf, device), _tensor(cn, device)


def payloads_to_reference(out: torch.Tensor, counts: torch.Tensor):
    """An encoder's (bytes (B, cap) uint8, counts (B,) int32) -> list of
    B payload byte strings.  The counts come back first, then only the
    columns some block uses."""
    cn = counts.cpu().numpy()
    cap = int(cn.max()) if len(cn) else 0
    by = out[:, :cap].contiguous().cpu().numpy()
    return [by[b, :cn[b]].tobytes() for b in range(len(cn))]


def triples_from_reference(triples, device):
    """List of B ``(acc, f, tot)`` u16 array triples (one entry per
    coded event) -> (acc, f, tot (B, Kp) int16, counts (B,) int32) on
    ``device``; rows are zero padded, Kp is at least 1."""
    B = len(triples)
    cn = np.array([len(t[0]) for t in triples], np.int32)
    Kp = max(int(cn.max()) if B else 0, 1)
    planes = np.zeros((3, B, Kp), np.uint16)
    for b, tri in enumerate(triples):
        for k in range(3):
            planes[k, b, :cn[b]] = tri[k]
    t = _tensor(planes.view(np.int16), device)
    return t[0], t[1], t[2], _tensor(cn, device)
