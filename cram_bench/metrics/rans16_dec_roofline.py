"""rans16_dec_roofline: the 4x16 decoder's share of its roofline.

Work per block of n bytes with a data alphabet of a symbols (A = a + 1,
context 0 included), a frozen copy of the kernel table's count: bytes
= the stream in, 2 A (A + 1) of base rows, A of alphabet, 24 of states,
count and shift, n out; operations = (12 + 3 ceil(log2(A + 1))) n (the
step and a bisection of the context's row).  Share = the larger of
bytes / peak bandwidth and operations / peak integer rate, over the
kernel's device time in the window."""

import math

KERNEL = "rans16_dec"


def work(n, alphabet, stream):
    A = alphabet + 1
    return (stream + 2 * A * (A + 1) + A + 24 + n,
            (12 + 3 * math.ceil(math.log2(A + 1))) * n)


def read(rec):
    return rec.roofline("read", KERNEL, work)
