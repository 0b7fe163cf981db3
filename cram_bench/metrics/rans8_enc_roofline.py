"""rans8_enc_roofline: the 4x8 encoder's share of its roofline.

Work per block of n bytes with a data alphabet of a symbols (A = a + 1,
context 0 included), a frozen copy of the kernel table's count: bytes =
n in, A + 4 A^2 of tables, the stream out and 20 of states and count;
operations = 40 n (the 4x16 step with its divide counted as 20, the
lookup, the second emission test and store) + 256.  Share = the larger
of bytes / peak bandwidth and operations / peak integer rate, over the
kernel's device time in the window."""

KERNEL = "rans8_enc"


def work(n, alphabet, stream):
    A = alphabet + 1
    return n + A + 4 * A * A + stream + 20, 40 * n + 256


def read(rec):
    return rec.roofline("write", KERNEL, work)
