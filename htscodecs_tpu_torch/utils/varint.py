"""Big-endian 7-bit variable-length integers (CRAM 3.1 flavour).

Semantics match the reference codec's varint layer
(``htscodecs/varint.h:64-160``, the ``BIG_END`` variant):
values are emitted most-significant 7-bit group first, with bit 7 set on
every byte except the last.  This is *not* LEB128 — the byte order is
reversed relative to protobuf varints.

These run host-side only (stream framing is never device work); the
device kernels receive fixed-shape buffers with explicit lengths.
"""

from __future__ import annotations

__all__ = [
    "put_uint",
    "get_uint",
    "size_uint",
    "put_sint",
    "get_sint",
]


def size_uint(v: int) -> int:
    """Number of bytes var-encoding ``v`` occupies (>=1)."""
    if v < 0:
        raise ValueError("varint value must be unsigned")
    n = 1
    v >>= 7
    while v:
        n += 1
        v >>= 7
    return n


def put_uint(out: bytearray, v: int) -> int:
    """Append the big-endian varint encoding of ``v`` to ``out``.

    Returns the number of bytes written.
    """
    if v < 0:
        raise ValueError("varint value must be unsigned")
    s = 0
    x = v
    while True:
        s += 7
        x >>= 7
        if not x:
            break
    n = 0
    while s:
        s -= 7
        out.append(((v >> s) & 0x7F) | (0x80 if s else 0))
        n += 1
    return n


def get_uint(buf, pos: int, end: int | None = None) -> tuple[int, int]:
    """Decode a big-endian varint from ``buf`` at ``pos``.

    Returns ``(value, new_pos)``.  ``end`` bounds the read (defaults to
    ``len(buf)``); like the reference's safe variant, a truncated varint
    consumes what is available rather than reading out of bounds.
    """
    if end is None:
        end = len(buf)
    if pos >= end:
        return 0, pos
    j = 0
    while True:
        c = buf[pos]
        pos += 1
        j = ((j << 7) | (c & 0x7F)) & 0xFFFFFFFFFFFFFFFF
        if not (c & 0x80) or pos >= end:
            break
    return j, pos


def put_sint(out: bytearray, v: int) -> int:
    """Zig-zag signed variant (0,-1,+1,-2,... ordering)."""
    return put_uint(out, (v << 1) ^ (v >> 63) if v < 0 else (v << 1))


def get_sint(buf, pos: int, end: int | None = None) -> tuple[int, int]:
    u, pos = get_uint(buf, pos, end)
    return (u >> 1) ^ -(u & 1), pos
