"""rans8_dec_roofline: the 4x8 decoder's share of its roofline.

Work per order-1 block of n bytes with a data alphabet of a symbols (A =
a + 1, context 0 included), a frozen copy of the kernel table's count:
bytes = the stream in, 2 A (A + 1) of int16 base rows (what
``convert.tables8_from_reference`` allocates at order 1), A of
alphabet, 20 of states and count, n out; operations = (16 + 3
ceil(log2(A + 1))) 4 K, K = n // 4 + n % 4 steps of each of the four
states (the step, its second byte test and a bisection of the
context's row).  Share = the larger of bytes / peak bandwidth and
operations / peak integer rate, over the kernel's device time in the
window."""

import math

KERNEL = "rans8_dec"


def work(n, alphabet, stream):
    A = alphabet + 1
    K = n // 4 + n % 4
    return (stream + 2 * A * (A + 1) + A + 20 + n,
            (16 + 3 * math.ceil(math.log2(A + 1))) * 4 * K)


def read(rec):
    return rec.roofline("read", KERNEL, work)
