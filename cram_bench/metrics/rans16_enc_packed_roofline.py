"""rans16_enc_packed_roofline: the 4x16 encoder's share of its roofline.

Work per block of n bytes with a data alphabet of a symbols (A = a + 1
table rows and columns, context 0 included), a frozen copy of the
kernel table's count: bytes = n in, A + 4 A^2 of tables, 4 of shift,
the stream out and 20 of states and count; operations = 38 n (the step
with its divide counted as 20, and the lookup) + 256 (the byte-to-index
table).  The least time is the larger of bytes / peak bandwidth and
operations / peak 32-bit integer rate; the share is that time over the
kernel's device time in the window."""

KERNEL = "rans16_enc_packed"


def work(n, alphabet, stream):
    A = alphabet + 1
    return n + A + 4 * A * A + 4 + stream + 20, 38 * n + 256


def read(rec):
    return rec.roofline("write", KERNEL, work)
