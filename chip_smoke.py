#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (htscodecs_tpu_torch) on one GPU.

    python3 chip_smoke.py [--blocks B] [--quick] [--ab DIR] [--fuzz-only]

Needs one CUDA device, ``nvcc`` and a host C compiler; no network.
What it does, in order (any failure exits non-zero):

1. prints the device and builds the host C library and the CUDA kernel
   library from the sources in this checkout;
2. holds each CUDA kernel (rans16_enc_packed, the one rANS 4x16
   encoder; rans16_dec, the one 4x16 decoder, through both its entries,
   rans16_dec on base rows and rans16_dec_packed on packed rows;
   rans8_enc, rans8_dec, arith_enc, arith_dec, rc_enc) against its plain
   PyTorch version on the card — integer codecs, so the tolerance is 0 —
   over ragged batch sizes, block lengths with every tail, four alphabet
   buckets, both orders, 10/12/mixed table precision (4x16, holes and
   empty rows included) and truncated and garbage streams; the 4x16
   decoder's entries and rans8_dec at 32, 64 and 128 threads per CTA
   and through their global-table routes, the default launches of
   rans16_dec and rans8_dec too, each launch of either checked to take
   the route (bisection or direct) that ``rans_vmem.direct_route`` /
   ``rans8_vmem.direct_route`` gives it; rans16_dec's direct route also
   at shifts 10 and 12 (a mixed batch too), alphabets up to and one past
   the widest whose CTA fits, B from 1 to 264, every N & 3 tail,
   truncated counts and arbitrary states, against the bisection route
   and the plain version, with its CTAs an SM held to the CUDA
   occupancy calculator's; rans8_dec's direct route also at every
   alphabet from 2 to the largest whose CTA fits (order 1: 14, order 0:
   128), B from 1 to 264, every N & 3 tail, truncated counts and
   arbitrary states, with its CTAs an SM held to the CUDA occupancy
   calculator's; rans8_dec also on 4x8
   alphabets of 128 to 256 symbols (rans8_enc on those up to 255, its
   order-1 global-table route), rans8_enc also on bytes past the
   block's alphabet and on one-symbol rows of 4095 and 4096 slots; the
   range-coder kernels run over
   model widths 2..256,
   ragged lengths, a normalising input, truncated and garbage streams,
   deferred-byte runs (one of 5000 bytes; 64 that end at every address
   modulo the small ring), totals of 0/1/2/65535 and frequencies of 0,
   B up to 193 and triples replayed from fqz jobs; rc_enc at its default
   chunk and ring sizes and at (32, 64) and (8, 16), arith_enc at its
   default launch, at 1 block per warp with 1 pool row, 1-symbol buffers
   and a 16-byte ring, and at 32 blocks per warp with 16-symbol buffers,
   arith_dec at order
   1 with its default pool and pools of 1 and 2 rows (the global-bank
   route), and at M = 256 with every context in use; blocks holding
   byte 255
   (max-symbol byte 0) and blocks whose range-coder payload is 5 bytes
   (they decode to zeros, as in the reference) go through the arith
   batch entries; the order-1 table build's counting kernels
   (tables_o1_presence, tables_o1_count) over every alphabet bucket 4 to
   96, block lengths 32 to 2^23 - 1 (unequal quarters), B from 1 to 4096,
   rows at every alignment, runs and uniform bytes, one-symbol blocks and
   blocks of byte 0 only, and later at the order-9 stripe lanes' and
   tok3's descriptor groups' shapes;
3. ``fuzz_paths``: corrupt streams through every decoder entry on the
   card (``engine="device"``, ``device="cuda"``): seeded batches of 64
   and 130 blocks from the port's own encoders (rANS 4x16 orders 0, 1,
   9 and 193 and rANS 4x8 orders 0 and 1 on 4 KiB blocks, one 4x8
   batch over 150 symbols, arith orders 0 and 1 on 1 KiB blocks, one of
   them over 256 symbols; the 4x16 orders 0/1 also through the
   decoder's packed entry by ``dec_fn``), every third member bit-flipped
   past its size field, overwritten in its first 32 bytes, cut, or
   claiming 2 or 4 times its size; one Illumina tok3 block cut, flipped
   and overwritten 48 ways; one 4x8 member claiming 2**31 bytes, which
   must be refused.  Each call must return or raise ValueError, intact
   members must equal their blocks (decoded alone, and with the corrupt
   members the host coder accepts, where the call raised), every launch
   of rans16_dec (both entries), rans8_dec and arith_dec must equal its
   plain version on the same inputs (tolerance 0) and its reruns with
   random bytes around every input (rans16_dec's and rans8_dec's also
   through their bisection routes, where the batch took the direct
   one), and each of the three kernels, rans16_dec and rans8_dec on both
   routes, must have run on a batch with corrupt members.  A memcheck pass runs the
   phase at a quarter of its size under ``compute-sanitizer --tool
   memcheck`` (beside ``nvcc``) first: a missing sanitizer fails the
   run, a device it refuses is recorded (``fuzz_paths`` line;
   ``--fuzz-only`` runs this phase alone);
4. drives the main paths at full width through the entry points a user
   calls, the launch counts set to 0 just before each and read just
   after: ``batch.compress_blocks`` then ``batch.uncompress_blocks``
   (rANS 4x16) on B = 4096 blocks of 64 KiB of 4-symbol quality data at
   order 1, the same at order 0, and a wide-alphabet batch, each taking
   the device-table route (``batch.TABLE_ROUTES`` shows it; the number
   of order-1 blocks in the shift band and of host rebuilds is
   printed); the synth4 batches four more times, through the device-
   and the host-table route in turns (``TABLES_DEVICE_MIN`` above B for
   the host route), each launching the one encoder (the order-1 device
   route also the two counting kernels, once each) and nothing else,
   whose streams must equal the main path's; the
   ``rans_pallas`` path (``tables_v2.build_o*_device``,
   one ``enc_o*_batch`` / ``dec_o*_batch`` call per shift group, equal
   to ``rans_v2``'s encode block for block, one launch of the encoder,
   or of the decoder's packed entry, per call and none of any other) at
   both orders; the transform-flagged orders 9 (STRIPE, 4 lanes, order-1
   and order-0 candidates: the lanes form device groups, and both 4x16
   kernels must launch) and 193 (PACK|RLE|order 1: most entropy jobs
   take the host coder) through ``compress_blocks`` /
   ``uncompress_blocks`` on the quality batch, with 64 sampled streams
   and the entropy jobs by route (``batch.ENTROPY_JOBS``); then
   ``batch.r4x8_compress_blocks`` /
   ``r4x8_uncompress_blocks`` (rANS 4x8) on the same three batches; then
   ``batch.arith_compress_blocks`` / ``arith_uncompress_blocks`` on the
   quality batch at order 0 and 1 and on the wide batch at order 1; then
   ``batch.fqz_compress_blocks(engine="device")`` on 192 jobs of 10000
   records x 150 quality values, decoded back through
   ``fqz_decompress_blocks``; then the name codec,
   ``tok3.encode_names`` / ``decode_names``, on 64 blocks of 10000
   names (the CRAM default slice) per style, Illumina and SRA
   (``testdata.synth_names``), at level 9 with the descriptor encode on
   engine "host" and on engine "device" (every (descriptor, candidate
   method) payload an entropy job of the batch layer's groups, so the
   one 4x16 encoder runs; its streams must equal the host engine's)
   and at level 19 (arith descriptors, the host loop: no kernel may
   launch), and every rANS descriptor stream of the Illumina blocks
   through ``uncompress_blocks(engine="device")``, equal to the host
   decode; then the ``parallel/`` layer: ``streaming.StreamEncoder``
   on the 4x16 batches cut into slices of 512 blocks (wide41: 256) at
   depth 1 to 3, with the dense u16 and the sparse 12-bit header
   transports, at order 0 and on slices already on the card
   (``assemble=False``), each stream equal to ``compress_blocks``' and
   one encoder launch per slice, beside a serial loop of
   ``compress_blocks`` over the same slices; ``pipeline.roundtrip_o1_v2``
   per shift group of the order-1 batch with host-built tables (no
   mismatch, the payload bytes of ``compress_blocks``' streams, one
   encoder and one packed-decoder launch, device ms by CUDA events),
   ``sharded_roundtrip_o1_v2`` over [cuda:0, cuda:0] and the v1 oracle
   step ``roundtrip_o1`` at 64 x 4 KiB; two ranks of this script in one
   gloo group (``--dist-worker``), both on cuda:0, each running every
   entry of ``parallel/distributed`` on its own B/2 blocks against the
   single-process entry, and ``archive_offsets`` consistent across
   them.  Every block must round-trip, a spread
   sample of streams must be byte-identical to the host coder's,
   and exactly the kernels of each path must have been launched;
5. profiles one more pass of each order-1 main path, of the order-9
   transform path and of one "device" tok3 encode (host seconds by
   function), then, at the shapes the
   main path gave each kernel,
   holds it against its plain version once more and times it (CUDA
   events, warm, median of 5) beside its roofline bound, its plain
   version (one run; the range-coder kernels' plain versions at a
   length cut to 8192), and the whole 4x8 encode (``rans8_vmem.enc_batch``);
   the 4x16 encoder and the decoder's packed entry
   also on the rans_pallas path's largest shift group and its second
   one, the 4x16 encoder and decoder at the stripe lanes of order 9 and
   at the three descriptor groups with the most bytes of one Illumina
   name block (the ``kernels`` line's ``transform_shapes`` and
   ``tok3_shapes``), the two counting kernels at the write cell's
   shape (256 x 1 510 000 quality bytes) and the main path's,
   rans16_dec at the 4x16 read cell's shape (16 x 1 510 000 quality
   bytes, the device-table route's tables: shift 10, A = 8; both routes
   equal to the blocks and to each other, the first 1000 steps of every
   chain to the plain version), and
   rans8_dec at the read cell's shape (16 x 1 510 000 quality bytes,
   A = 8: both routes equal to the blocks and to each other, the first
   1000 steps of every chain to the plain version) with the direct
   route's crossover sweeps (order 1 at A = 5, B = 16 to 4096, and at
   A = 8; order 0 at A = 5; each route's ms a launch, the direct one
   past its rule too); times the
   device table build, arith_dec at each arith main-path
   shape (with
   its default pool and the blocks whose contexts overflow it),
   arith_enc at 1 to 32 blocks per warp at each arith main-path shape,
   arith_dec at 1 to 32 threads per CTA and its pool sizes, and
   rans16_dec and rans8_dec at 32 to 128 threads per CTA and through
   their wide-table routes at each main-path shape; prints the compress
   wall of both
   table routes, at B and at group sizes 4 to 1024 around
   ``TABLES_DEVICE_MIN``.

``--ab DIR`` runs none of that: it times arith_enc, arith_dec,
rans8_enc (against the parent's kernel and its whole
``rans8_vmem.enc_batch``), rans8_dec (also at the read cell's shape),
rc_enc, the 4x16 encoder (against
the parent's whole ``rans_vmem.enc_batch`` where it has one, and its
rans16_enc_packed) and
both 4x16 decoder entries (the 4x16 kernels also at the order-9 stripe
lanes, the base-row entry also at the 4x16 read cell's shape) of this
checkout against those of the
checkout at DIR (the parent commit, unpacked with ``git archive``), in
turns, on the main paths' inputs, and fails if any output differs.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device available", file=sys.stderr)
    sys.exit(2)

from htscodecs_tpu_torch import cuda_build, native  # noqa: E402
from htscodecs_tpu_torch.models import (arith, batch, fqz,  # noqa: E402
                                        rans4x8, rans4x16, tok3)
from htscodecs_tpu_torch.ops import (arith_vmem, convert,  # noqa: E402
                                     rans8_vmem, rans_pallas, rans_v2,
                                     rans_vmem, rc_vmem, tables_v2)
from htscodecs_tpu_torch.parallel import (distributed,  # noqa: E402
                                          pipeline, streaming)
from htscodecs_tpu_torch.utils import testdata, varint  # noqa: E402

DEV = torch.device("cuda", 0)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_OPS_PER_S = 67e12        # non-tensor-core rate; the integer ALU
#                               work of these kernels is held against it
T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 5, warm: int = 1) -> float:
    """Median device time of fn() in milliseconds (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return statistics.median(ts)


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions

def same_live(w1, w2, counts) -> bool:
    """Equality of the first counts[b] elements of each row."""
    cap = w1.shape[1]
    live = torch.arange(cap, device=w1.device)[None, :] < counts[:, None]
    return bool(((w1 == w2) | ~live).all())


def garbage_states(B, N):
    """Arbitrary states, bit 31 set in half of them."""
    g = torch.Generator(device="cpu").manual_seed(B * 7919 + N)
    return torch.randint(-2**31, 2**31 - 1, (B, 4), generator=g,
                         dtype=torch.int64).to(torch.int32).to(DEV)


def same_suffix(w1, w2, counts) -> bool:
    """Equality of the last counts[b] elements of each row (where the
    4x16 encoder leaves each block's stream)."""
    cap = w1.shape[1]
    live = torch.arange(cap, device=w1.device)[None, :] >= cap - counts[:, None]
    return bool(((w1 == w2) | ~live).all())


# the 4x16 decoder's launches (threads, global_tables): the default (the
# base-row entry's direct route where direct_route admits the batch), the
# bisection route at its default CTA and larger ones, and the global-table
# route at the smallest CTA
DEC16_SHAPES = ((0, False), (32, False), (64, False), (128, False),
                (32, True))
# the launch counters of the base-row entry's two routes
DEC16 = ("rans16_dec", "rans16_dec_direct")


def dec16_key(tables, order, threads=0, glob=False) -> str:
    """The counter a rans16_dec launch on ``tables`` adds to: the direct
    route where the rule admits the batch at its largest shift, every
    shift is at least DIRECT_MIN_SHIFT and the rows are packable."""
    B, A = tables.alpha.shape
    sv = tables.shift.cpu()
    direct = (int(sv.min()) >= rans_vmem.DIRECT_MIN_SHIFT
              and rans_vmem.direct_route(
        B, A, order, int(sv.max()), *rans_vmem._device_limits(DEV),
        threads, glob) and rans_vmem._rows_packable(tables.bases))
    return DEC16[direct]


def rans16_dec_routed(label, st, wd, cn, tables, N, order, **kw):
    """rans16_dec with launch arguments ``kw``, and a check that it took
    the route the rule gives these inputs."""
    want = dec16_key(tables, order, kw.get("threads", 0),
                     kw.get("global_tables", False))
    before = {k: rans_vmem.LAUNCHES[k] for k in DEC16}
    out = rans_vmem.rans16_dec(st, wd, cn, tables, N, order, **kw)
    got = [k for k in DEC16 if rans_vmem.LAUNCHES[k] != before[k]]
    if got != [want]:
        fail(f"rans16_dec at {label} {kw}: launched {got}, the rule gives "
             f"{want}")
    return out


class Routes16:
    """While active, every rans16_dec launch (its callers look the
    wrapper up in rans_vmem at call time) is recorded: its inputs and the
    counters it added to, and nothing more, so that a timed window holds
    no host copy of its own.  On leaving, each launch is checked to have
    taken the route the rule gives its inputs; ``keys`` then holds the
    counters the rule gave the launches."""

    def __enter__(self):
        self.keys = set()
        self._calls = []
        orig = self._orig = rans_vmem.rans16_dec

        def recorded(st, wd, cn, tables, N, order, **kw):
            before = [rans_vmem.LAUNCHES[k] for k in DEC16]
            out = orig(st, wd, cn, tables, N, order, **kw)
            got = [k for k, n in zip(DEC16, before)
                   if rans_vmem.LAUNCHES[k] != n]
            self._calls.append((tables, order, kw, got))
            return out
        rans_vmem.rans16_dec = recorded
        return self

    def __exit__(self, *exc):
        rans_vmem.rans16_dec = self._orig
        if exc[0] is None:
            for tables, order, kw, got in self._calls:
                want = dec16_key(tables, order, kw.get("threads", 0),
                                 kw.get("global_tables", False))
                if got != [want]:
                    fail(f"rans16_dec on a path {kw}: launched {got}, the "
                         f"rule gives {want}")
                self.keys.add(want)
        self._calls = []
        return False


def check_case(blocks, sv, order, label, garbage=False) -> None:
    """The 4x16 kernels on one case: the one encoder (per-block shift)
    and both entries of the one decoder (base rows with the block's word
    counts; packed rows, reads bounded by the row) at each of
    DEC16_SHAPES, each against its plain version; the decoders must
    return the input and agree with each other on the encoder's
    streams.  synth_tables leaves a hole (freq 0) for every pair a block
    does not contain and an empty row for every unused context."""
    B, N = blocks.shape
    alpha, packed, _A = testdata.synth_tables(blocks, sv, order)
    bt = torch.from_numpy(blocks).to(DEV)
    al = torch.from_numpy(alpha).to(DEV)
    pk = torch.from_numpy(packed.reshape(B, -1)).to(DEV)
    svt = torch.from_numpy(np.ascontiguousarray(sv, np.int32)).to(DEV)
    tables = convert.tables_from_packed(al, pk.view(packed.shape), svt)

    enc_k = rans_vmem.rans16_enc_packed(bt, al, pk, svt, order)
    enc_p = rans_vmem._rans16_enc_packed_plain(bt, al, pk, svt, order)
    torch.cuda.synchronize()
    st_k, wd_k, cn_k = enc_k
    if not (torch.equal(st_k, enc_p[0]) and torch.equal(cn_k, enc_p[2])
            and same_suffix(wd_k, enc_p[1], cn_k)):
        fail(f"rans16_enc_packed != plain at {label}")

    words = convert.words_forward(wd_k, cn_k).contiguous()
    W = words.shape[1]
    variants = [("", st_k, words, cn_k)]
    if garbage:
        # a truncated stream (reads bounded by the block's own count, or
        # by the row on the packed route) and arbitrary states with bit
        # 31 set: kernels and plain versions must still agree bit for bit
        variants += [(" truncated", st_k, words[:, :max(W // 2, 1)].contiguous(),
                      cn_k // 2),
                     (" garbage", garbage_states(B, N), words, cn_k)]
    for tag, st, wd, cn in variants:
        out_p = rans_vmem._rans16_dec_plain(st, wd, cn, tables, N, order)
        pkd_p = rans_vmem._rans16_dec_packed_plain(st, wd, pk, al, svt, N, order)
        for threads, glob in DEC16_SHAPES:
            out_k = rans16_dec_routed(label + tag, st, wd, cn, tables, N,
                                      order, threads=threads,
                                      global_tables=glob)
            pkd_k = rans_vmem.rans16_dec_packed(st, wd, pk, al, svt, N, order,
                                                threads=threads,
                                                global_tables=glob)
            torch.cuda.synchronize()
            if not torch.equal(out_k, out_p):
                fail(f"rans16_dec != plain at {label}{tag} threads={threads} "
                     f"global_tables={glob}")
            if not torch.equal(pkd_k, pkd_p):
                fail(f"rans16_dec_packed != plain at {label}{tag} "
                     f"threads={threads} global_tables={glob}")
        if not tag and not (torch.equal(out_p, bt) and torch.equal(pkd_p, bt)):
            fail(f"the 4x16 decoders did not return the input at {label}")


def tables16_at(blocks, sv, order, A):
    """``testdata.synth_tables`` of a batch at exactly A symbols: its
    alphabet bucket cut to A, or padded to it (the alphabet repeats its
    last entry; the added rows and columns are holes): numpy (alpha
    (B,A) u8, packed (B,A,A) or (B,A) i32)."""
    alpha, packed, A0 = testdata.synth_tables(blocks, sv, order)
    if A0 > A:
        cut = packed[:, A:] if order == 0 else np.concatenate(
            [packed[:, A:].ravel(), packed[:, :, A:].ravel()])
        if cut.any():
            fail(f"tables16_at: a block has more than A = {A} symbols")
        return (np.ascontiguousarray(alpha[:, :A]),
                np.ascontiguousarray(packed[:, :A, :A] if order
                                     else packed[:, :A]))
    B = len(blocks)
    al = np.empty((B, A), np.uint8)
    al[:, :A0], al[:, A0:] = alpha, alpha[:, -1:]
    pk = np.zeros((B, A, A) if order else (B, A), np.int32)
    if order:
        pk[:, :A0, :A0] = packed
    else:
        pk[:, :A0] = packed.reshape(B, A0)
    return al, pk


def case16(blocks, sv, order, A):
    """The rans16_dec inputs of a batch at A symbols and shifts ``sv``,
    written by the one encoder: (states, words, counts, tables)."""
    alpha, packed = tables16_at(blocks, sv, order, A)
    B = len(blocks)
    bt = torch.from_numpy(np.ascontiguousarray(blocks)).to(DEV)
    al = torch.from_numpy(alpha).to(DEV)
    pk = torch.from_numpy(packed).to(DEV)
    svt = torch.from_numpy(np.array(np.broadcast_to(sv, (B,)),
                                    np.int32)).to(DEV)
    st, wd, cn = rans_vmem.rans16_enc_packed(bt, al, pk.reshape(B, -1), svt,
                                             order)
    return (st, convert.words_forward(wd, cn).contiguous(), cn,
            convert.tables_from_packed(al, pk, svt))


def check_direct16_grid(quick: bool) -> int:
    """rans16_dec's default launch against its bisection route and the
    plain version (tolerance 0) at shifts 10 and 12 and a mixed batch,
    alphabets from 2 to the widest whose direct-route CTA fits and one
    past it (that launch keeps the bisection route), B from 1 to 264,
    every N & 3 tail, truncated counts and arbitrary states; each launch
    must take the route the rule gives it, and the rule's CTAs an SM
    must be the CUDA occupancy calculator's (capped at DIRECT_MAX_CTAS,
    as the rule caps it)."""
    lib = cuda_build.get_lib()
    _sms, optin, per_sm = rans_vmem._device_limits(DEV)
    # (order, shift): alphabets; "mix": shifts 10 and 12 in one batch
    widths = {(1, 10): (2, 5, 8, 24, 55, 56), (1, 12): (2, 8, 14, 15),
              (1, "mix"): (8,), (0, 12): (2, 40, 128, 129),
              (0, 10): (5, 128)}
    if quick:
        widths = {(1, 10): (5, 56), (1, 12): (14,), (1, "mix"): (8,),
                  (0, 12): (128, 129)}
    Ns = (33, 514, 4099, 512)             # N & 3 = 1, 2, 3, 0
    n = 0
    for (order, shift), As in widths.items():
        for A in As:
            if shift != "mix" and A <= rans_vmem.DIRECT_MAX_A:
                per = rans_vmem.direct_ctas_per_sm(A, order, shift, optin,
                                                   per_sm)
                # the calculator's count, capped as the rule caps it
                cuda = min(max(lib.rans16_dec_direct_ctas_per_sm(
                    A, order, shift), 0), rans_vmem.DIRECT_MAX_CTAS)
                if per != cuda:
                    fail(f"rans16_dec direct route at A={A} order={order} "
                         f"shift={shift}: the rule counts {per} CTAs an SM, "
                         f"the occupancy calculator {cuda}")
            for k, B in enumerate((1, 5, 130, 264)):
                N = Ns[(k + A) % 4]
                blocks = testdata.synth_wide(B, N, max(A - 1, 1),
                                             seed=B * 7 + A * 131 + N)
                sv = (np.resize(np.array([10, 12], np.int32), B)
                      if shift == "mix" else np.int32(shift))
                st, wd, cn, tables = case16(blocks, sv, order, A)
                bt = torch.from_numpy(blocks).to(DEV)
                label = (f"rans16_dec B={B} N={N} A={A} order={order} "
                         f"shift={shift}")
                variants = [("", st, cn), (" truncated", st, cn // 2 + 1),
                            (" garbage", garbage_states(B, N), cn)]
                for tag, S, C in variants:
                    out = rans16_dec_routed(label + tag, S, wd, C, tables, N,
                                            order)
                    bis = rans_vmem.rans16_dec(S, wd, C, tables, N, order,
                                               threads=32)
                    torch.cuda.synchronize()
                    want = rans_vmem._rans16_dec_plain(S, wd, C, tables, N,
                                                       order)
                    if not (torch.equal(out, want) and torch.equal(bis, want)):
                        fail(f"{label}{tag}: the default launch, the "
                             "bisection route and the plain version differ")
                    if not tag and not torch.equal(out, bt):
                        fail(f"{label}: rans16_dec did not return the input")
                    n += 1
    return n


def cell16_inputs(seed=2147485003):
    """16 quality-series blocks of 1 510 000 bytes (a CRAM 3.1 reader's
    16 slices: the benchmark's qs31-read-k16 shape) on the card, with the
    device-table route's order-1 tables and the one encoder's streams:
    (blocks, states, words, counts, alpha, packed (B,A,A), shift, A)."""
    bt = qs_runs_on_card(16, 1510000, seed)
    alpha, packed, shift, A = device_tables(bt.cpu().numpy(), 1)
    st, wd, cn = rans_vmem.rans16_enc_packed(bt, alpha, packed, shift, 1)
    words = convert.words_forward(wd, cn).contiguous()
    return bt, st, words, cn, alpha, packed.view(16, A, A), shift, A


def check_direct16_cell():
    """rans16_dec at the 4x16 read cell's shape: the default launch must
    take the direct route, decode the blocks, equal the bisection route
    at its default CTA and equal the plain version on the first 1000
    steps of every chain; returns both routes' ms."""
    bt, st, words, cn, alpha, packed, shift, A = cell16_inputs()
    tables = convert.tables_from_packed(alpha, packed, shift)
    N = bt.shape[1]
    q = N >> 2
    if dec16_key(tables, 1) != "rans16_dec_direct":
        fail("rans16_dec at the read cell's shape: the rule keeps the "
             "bisection route")
    out = rans16_dec_routed("the read cell", st, words, cn, tables, N, 1)
    bis = rans_vmem.rans16_dec(st, words, cn, tables, N, 1, threads=32)
    if not (torch.equal(out, bt) and torch.equal(bis, bt)):
        fail("rans16_dec at the read cell's shape did not decode its blocks")
    head = rans_vmem._rans16_dec_plain(st, words, cn, tables, 4000, 1)
    for lane in range(4):
        if not torch.equal(head[:, lane * 1000:(lane + 1) * 1000],
                           out[:, lane * q:lane * q + 1000]):
            fail(f"rans16_dec != plain on the first 1000 steps of state "
                 f"{lane} at the read cell's shape")
    shifts = sorted(set(shift.cpu().tolist()))
    t_b, t_o = (x / r * 1e3 for x, r in zip(
        dec16_work(16, N, A, tables.bases.numel() * 2, int(cn.sum())),
        (HBM_BYTES_PER_S, FP32_OPS_PER_S)))
    return {"shape": f"B=16 N={N} A={A} order=1 shift={shifts}",
            "direct_ms": cuda_ms(lambda: rans_vmem.rans16_dec(
                st, words, cn, tables, N, 1), reps=3),
            "bisection_ms": cuda_ms(lambda: rans_vmem.rans16_dec(
                st, words, cn, tables, N, 1, threads=32), reps=3),
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}


# rans8_dec (threads, global_tables): the default (the direct route where
# direct_route admits the batch), the bisection route at its default CTA
# and larger ones, and the wide-table route (tables read from global
# memory) at the smallest CTA
RANS8_SHAPES = ((0, False), (32, False), (64, False), (128, False),
                (32, True))
# the launch counters of rans8_dec's two routes
DEC8 = ("rans8_dec", "rans8_dec_direct")


def dec8_key(B, A, order, threads=0, glob=False) -> str:
    """The counter a rans8_dec launch of these shapes adds to, on packable
    rows (every table these phases build)."""
    return DEC8[rans8_vmem.direct_route(
        B, A, order, *rans8_vmem._device_limits(DEV), threads, glob)]


def rans8_dec_routed(label, st, stream, cn, tables, N, order, **kw):
    """rans8_dec with launch arguments ``kw``, and a check that it took
    the route the rule gives these shapes."""
    B, A = tables.alpha.shape
    want = dec8_key(B, A, order, kw.get("threads", 0),
                    kw.get("global_tables", False))
    before = {k: rans_vmem.LAUNCHES[k] for k in DEC8}
    out = rans8_vmem.rans8_dec(st, stream, cn, tables, N, order, **kw)
    got = [k for k in DEC8 if rans_vmem.LAUNCHES[k] != before[k]]
    if got != [want]:
        fail(f"rans8_dec at {label} {kw}: launched {got}, the rule gives "
             f"{want}")
    return out


def same_streams_suffix(got, want) -> bool:
    """Equality of two encoders' (states, elements, counts), the elements
    compared over each row's last counts[b] (where the encoders of this
    checkout leave each block's stream)."""
    (st, wd, cn), (st2, wd2, cn2) = got, want
    return (torch.equal(st, st2) and torch.equal(cn, cn2)
            and same_suffix(wd, wd2, cn))


def r8_packed(packed):
    """4x8 packed rows (numpy (B,A,A) or (B,A)) -> the (B, A or 1, A)
    int32 tensor rans8_enc reads, on the card."""
    B, A = packed.shape[0], packed.shape[-1]
    return torch.from_numpy(np.ascontiguousarray(packed, np.int32)).to(DEV) \
        .view(B, -1, A)


def check_case8(blocks, order, label, garbage=False, max_a=96) -> None:
    """The two rANS 4x8 kernels on one case; tables from the native
    4x8 table build (rows of 4095 slots; alphabets up to ``max_a``);
    rans8_dec at each of RANS8_SHAPES.  rans8_enc takes alphabets up to
    255 (the order-1 tables past 48 symbols from global memory); a
    256-symbol case is encoded by the plain version for the decoder.
    With ``garbage``, also bytes past the block's alphabet (the zero
    entry) through rans8_enc, and a truncated stream and arbitrary
    states through rans8_dec."""
    B, N = blocks.shape
    alpha, packed = testdata.r8_tables(blocks, order, max_a)
    tables = convert.tables8_from_reference(alpha, packed, DEV)
    bt = torch.from_numpy(blocks).to(DEV)
    pk = r8_packed(packed)
    A = alpha.shape[1]
    enc_p = rans8_vmem._rans8_enc_plain(bt, tables.alpha, pk, order)
    enc_k = enc_p
    if A <= 255:
        enc_k = rans8_vmem.rans8_enc(bt, tables.alpha, pk, order)
        torch.cuda.synchronize()
        if not same_streams_suffix(enc_k, enc_p):
            fail(f"rans8_enc != plain at {label}")
    if garbage and int(alpha.max()) < 255:
        g = torch.Generator(device="cpu").manual_seed(B * 31 + N)
        above = torch.randint(int(alpha.max()) + 1, 256, (B, N), generator=g,
                              dtype=torch.uint8).to(DEV)
        hit = torch.rand((B, N), generator=g).to(DEV) < 0.02
        bg = torch.where(hit, above, bt).contiguous()
        if not same_streams_suffix(
                rans8_vmem.rans8_enc(bg, tables.alpha, pk, order),
                rans8_vmem._rans8_enc_plain(bg, tables.alpha, pk, order)):
            fail(f"rans8_enc != plain at {label} with bytes past the "
                 "alphabet")

    st_k, by_k, cn_k = enc_k
    stream = convert.words_forward(by_k, cn_k).contiguous()
    variants = [("", st_k, cn_k)]
    if garbage:
        variants += [(" truncated", st_k, cn_k // 2),
                     (" garbage", garbage_states(B, N), cn_k)]
    for tag, st, cn in variants:
        out_p = rans8_vmem._rans8_dec_plain(st, stream, cn, tables, N, order)
        for threads, glob in RANS8_SHAPES:
            out_k = rans8_dec_routed(label + tag, st, stream, cn, tables, N,
                                     order, threads=threads,
                                     global_tables=glob)
            torch.cuda.synchronize()
            if not torch.equal(out_k, out_p):
                fail(f"rans8_dec != plain at {label}{tag} threads={threads} "
                     f"global_tables={glob}")
        if not tag and not torch.equal(out_p, bt):
            fail(f"rans8_dec did not return the input at {label}")


def check_one_symbol_rows8() -> int:
    """rans8_enc on constant blocks, whose one symbol owns its row: 4095
    slots as the native build gives it and 4096 (a stored frequency of 0
    in a parsed table; x_max = 2^31), both orders, against its plain
    version; each round-trips through rans8_dec."""
    n = 0
    for B, N in ((5, 514), (130, 33)):
        blocks = np.full((B, N), 70, np.uint8)
        blocks[::2] = 3
        for order in (0, 1):
            alpha, packed = testdata.r8_tables(blocks, order)
            for total in (4095, 4096):
                pkn = np.where(packed & 0x1FFF,
                               (packed >> 13 << 13) | total, 0)
                bt = torch.from_numpy(blocks).to(DEV)
                al = torch.from_numpy(alpha).to(DEV)
                pk = r8_packed(pkn)
                enc_k = rans8_vmem.rans8_enc(bt, al, pk, order)
                if not same_streams_suffix(
                        enc_k, rans8_vmem._rans8_enc_plain(bt, al, pk, order)):
                    fail(f"rans8_enc != plain on one-symbol rows of {total} "
                         f"B={B} N={N} order={order}")
                t = convert.tables8_from_reference(alpha, pkn, DEV)
                st, by, cn = enc_k
                out = rans8_vmem.rans8_dec(
                    st, convert.words_forward(by, cn).contiguous(), cn, t, N,
                    order)
                if not torch.equal(out, bt):
                    fail(f"one-symbol rows of {total} B={B} N={N} "
                         f"order={order} did not round-trip")
                n += 1
    return n


def r8_tables_at(blocks, order, A):
    """Dense 4x8 tables of a batch (native build, rows of 4095 slots)
    padded to exactly A symbols: numpy (alpha (B,A), packed (B,A,A) or
    (B,A))."""
    res = [native.r8_build_tables_dense(b, order, 256) for b in blocks]
    alpha = np.zeros((len(res), A), np.uint8)
    packed = np.zeros((len(res), A, A) if order else (len(res), A), np.int32)
    for k, (_t, al, pk) in enumerate(res):
        a = len(al)
        if a > A:
            fail(f"r8_tables_at: a block has {a} symbols, over A = {A}")
        alpha[k, :a], alpha[k, a:] = al, al[-1]
        if order:
            packed[k, :a, :a] = pk
        else:
            packed[k, :a] = pk
    return alpha, packed


def r8_case(blocks, order, A):
    """The rans8_dec inputs of a batch at A symbols, written by
    rans8_enc: (states, stream, counts, tables)."""
    alpha, packed = r8_tables_at(blocks, order, A)
    tables = convert.tables8_from_reference(alpha, packed, DEV)
    bt = torch.as_tensor(blocks).to(DEV)
    st, by, cn = rans8_vmem.rans8_enc(bt, tables.alpha, r8_packed(packed),
                                      order)
    return st, convert.words_forward(by, cn).contiguous(), cn, tables


def direct_wave(A, order) -> int:
    """The blocks one wave of direct-route CTAs holds at A symbols."""
    sms, optin, per_sm = rans8_vmem._device_limits(DEV)
    return sms * rans8_vmem.direct_ctas_per_sm(A, order, optin, per_sm)


def check_direct_grid(quick: bool) -> int:
    """rans8_dec's direct route against the plain version (tolerance 0)
    at every alphabet from 2 to the largest whose CTA fits (order 1: 14;
    order 0: the symbol field's 128), B from 1 to 264, every N & 3
    tail, truncated counts and arbitrary states; each default launch
    must take the direct route, and its CTAs an SM must be the CUDA
    occupancy calculator's."""
    lib = cuda_build.get_lib()
    _sms, optin, per_sm = rans8_vmem._device_limits(DEV)
    widths = {1: (2, 3, 5, 8, 14), 0: (2, 5, 40, 128)}
    if quick:
        widths = {1: (2, 5, 14), 0: (5, 128)}
    n = 0
    for order, As in widths.items():
        for A in As:
            per = rans8_vmem.direct_ctas_per_sm(A, order, optin, per_sm)
            cuda = lib.rans8_dec_direct_ctas_per_sm(A, order)
            if per != cuda:
                fail(f"direct route at A={A} order={order}: the rule counts "
                     f"{per} CTAs an SM, the occupancy calculator {cuda}")
            Ns = (33, 514, 4099, 512)             # N & 3 = 1, 2, 3, 0
            for k, B in enumerate((1, 5, 130, 264)):
                N = Ns[(k + A) % 4]
                blocks = testdata.synth_wide(B, N, max(A - 1, 1),
                                             seed=B * 7 + A * 131 + N)
                st, stream, cn, tables = r8_case(blocks, order, A)
                bt = torch.from_numpy(blocks).to(DEV)
                label = f"direct B={B} N={N} A={A} order={order}"
                variants = [("", st, cn), (" truncated", st, cn // 2 + 1),
                            (" garbage", garbage_states(B, N), cn)]
                for tag, S, C in variants:
                    out = rans8_dec_routed(label + tag, S, stream, C, tables,
                                           N, order)
                    torch.cuda.synchronize()
                    want = rans8_vmem._rans8_dec_plain(S, stream, C, tables,
                                                       N, order)
                    if not torch.equal(out, want):
                        fail(f"rans8_dec != plain at {label}{tag}")
                    if not tag and not torch.equal(out, bt):
                        fail(f"rans8_dec did not return the input at {label}")
                    n += 1
    return n


def cell_inputs(A, order=1, seed=2147485003):
    """16 quality-series blocks of 1 510 000 bytes (a CRAM 3.0 reader's
    16 slices: the benchmark's qs30-read-k16 shape) and their rans8_dec
    inputs at A symbols: (blocks on the card, states, stream, counts,
    tables)."""
    bt = qs_runs_on_card(16, 1510000, seed)
    return (bt, *r8_case(bt.cpu().numpy(), order, A))


def check_direct_cell():
    """rans8_dec at the cell's shape (A = 8, the batch layer's bucket):
    the direct route must decode the blocks, equal the bisection route,
    and equal the plain version on the first 1000 steps of every chain
    (the whole chain would take the plain version ~400 s); returns the
    two routes' ms."""
    bt, st, stream, cn, tables = cell_inputs(8)
    N = bt.shape[1]
    q = N >> 2
    out = rans8_dec_routed("the cell", st, stream, cn, tables, N, 1)
    bis = rans8_vmem.rans8_dec(st, stream, cn, tables, N, 1, threads=32)
    if not (torch.equal(out, bt) and torch.equal(bis, bt)):
        fail("rans8_dec at the cell's shape did not decode its blocks")
    head = rans8_vmem._rans8_dec_plain(st, stream, cn, tables, 4000, 1)
    for lane in range(4):
        if not torch.equal(head[:, lane * 1000:(lane + 1) * 1000],
                           out[:, lane * q:lane * q + 1000]):
            fail(f"rans8_dec != plain on the first 1000 steps of state "
                 f"{lane} at the cell's shape")
    return {"shape": f"B=16 N={N} A=8 order=1",
            "direct_ms": cuda_ms(lambda: rans8_vmem.rans8_dec(
                st, stream, cn, tables, N, 1), reps=3),
            "bisection_ms": cuda_ms(lambda: rans8_vmem.rans8_dec(
                st, stream, cn, tables, N, 1, threads=32), reps=3),
            "nbytes": int(cn.sum())}


# B of the sweep at A = 5 and 8 (order 1) and of the one at order 0:
# one wave, one past it, the rule's last B, one past that
DIRECT_SWEEP_B = (16, 64, 128, 264, 265, 512, 528, 529, 4096)
DIRECT_SWEEP_B8 = (16, 132, 133, 528, 529)
DIRECT_SWEEP_B0 = (16, 1584, 1585, 3168)


def direct_sweep(A=5, order=1, Bs=DIRECT_SWEEP_B):
    """Where the direct route stops paying: N = 1 510 000 (the cell's 16
    blocks repeated), ms a launch of each route (the direct route
    launched past its rule too) and the rule's choice, at each B of
    ``Bs``."""
    bt, st, stream, cn, tables = cell_inputs(A, order)
    N = bt.shape[1]
    res = {"shape": f"A={A} N={N} order={order}",
           "wave": direct_wave(A, order)}
    for B in Bs:
        ix = torch.arange(B, device=DEV) % 16
        tb = convert.Tables(*(t[ix].contiguous() for t in tables))
        args = (st[ix].contiguous(), stream[ix].contiguous(),
                cn[ix].contiguous(), tb, N, order)
        want = bt[ix]
        direct = rans8_vmem._launch(*args, True)
        bis = rans8_vmem.rans8_dec(*args, threads=32)
        if not (torch.equal(direct, want) and torch.equal(bis, want)):
            fail(f"direct sweep: a route did not decode B={B}")
        del direct, bis, want
        res[f"B={B}"] = {
            "rule": dec8_key(B, A, order),
            "direct_ms": cuda_ms(lambda: rans8_vmem._launch(*args, True),
                                 reps=3),
            "bisection_ms": cuda_ms(lambda: rans8_vmem.rans8_dec(
                *args, threads=32), reps=3)}
        del args, tb
    return res


def same_bytes(got, want) -> bool:
    """Equality of two coders' (bytes, counts) on each row's live
    prefix."""
    (by, cn), (by2, cn2) = got, want
    return torch.equal(cn, cn2) and same_live(by, by2, cn)


POOLS = (0, 1, 2)    # arith_dec's order-1 pool: the default, then 1 and 2 rows
# arith_enc (per_warp, pool, chunk, ring): the defaults, the smallest
# settings (symbols staged byte by byte), and 32 blocks per warp with
# small buffers (symbols staged by cp.async)
ENC_SHAPES = ((0, 0, 0, 0), (1, 1, 1, 16), (32, 2, 16, 32))


def check_arith_case(blocks, lens, ms, order, label, garbage=False) -> None:
    """arith_enc and arith_dec on one ragged batch; the encoder runs at
    each of ENC_SHAPES; at order 1 the decoder runs with its default pool
    and with pools of 1 and 2 rows, so that contexts past the pool take
    the global bank (the encoder's pools of 1 and 2 do the same)."""
    B, N = blocks.shape
    M = int(ms.max())
    bt, lt, mt = (torch.from_numpy(x).to(DEV) for x in (blocks, lens, ms))
    enc_p = arith_vmem._arith_enc_plain(bt, lt, mt, M, order)
    for per_warp, pool, chunk, ring in ENC_SHAPES:
        enc_k = arith_vmem.arith_enc(bt, lt, mt, M, order, per_warp=per_warp,
                                     pool=min(pool, M), chunk=chunk, ring=ring)
        torch.cuda.synchronize()
        if not same_bytes(enc_k, enc_p):
            fail(f"arith_enc != plain at {label} per_warp={per_warp} "
                 f"pool={pool} chunk={chunk} ring={ring}")
    by_k, cn_k = enc_k
    stream = by_k[:, :max(int(cn_k.max()), 1)].contiguous()
    variants = [("", stream, cn_k)]
    if garbage:
        g = torch.Generator(device="cpu").manual_seed(B * 7919 + N)
        noise = torch.randint(0, 256, stream.shape, generator=g,
                              dtype=torch.uint8).to(DEV)
        variants += [(" truncated", stream, cn_k // 2),
                     (" garbage", noise, cn_k)]
    for tag, st, cn in variants:
        out_p = arith_vmem._arith_dec_plain(st, cn, lt, mt, M, N, order)
        for pool in (POOLS if order else (0,)):
            out_k = arith_vmem.arith_dec(st, cn, lt, mt, M, N, order,
                                         pool=min(pool, M))
            torch.cuda.synchronize()
            if not torch.equal(out_k, out_p):
                fail(f"arith_dec != plain at {label}{tag} pool={pool}")
        # a few bytes may code to under 6, which decodes nothing
        if not tag and N >= 33 and not same_live(out_k, bt, lt):
            fail(f"arith_dec did not return the input at {label}")


# rc_enc (chunk, ring): the defaults, then two small pairs
RC_SHAPES = ((0, 0), (32, 64), (8, 16))


def check_rc_case(triples, label) -> None:
    """rc_enc on one ragged batch of (acc, f, tot) triples, at the
    default chunk and ring sizes and at small ones that put every
    boundary inside the batch."""
    acc, f, tot, cn = convert.triples_from_reference(triples, DEV)
    enc_p = rc_vmem._rc_enc_plain(acc, f, tot, cn)
    for chunk, ring in RC_SHAPES:
        enc_k = rc_vmem.rc_enc(acc, f, tot, cn, chunk=chunk, ring=ring)
        torch.cuda.synchronize()
        if not same_bytes(enc_k, enc_p):
            fail(f"rc_enc != plain at {label} chunk={chunk} ring={ring}")
    return enc_k, enc_p


def rc_edge_triples():
    """Two blocks of valid random events with totals of 0, 1, 2 and
    65535 and frequencies of 0 between them (a 0 is taken as 1)."""
    out = []
    for b, special in enumerate([(0, 0, 0), (0, 1, 1), (1, 1, 2),
                                 (65534, 1, 65535), (0, 0, 2),
                                 (7, 0, 65535)]):
        a, f, t = testdata.random_triples(1, 60 + b, seed=70 + b)[0]
        a, f, t = a.copy(), f.copy(), t.copy()
        a[::7], f[::7], t[::7] = special
        out.append((a, f, t))
    return out


def check_ring_flush_runs() -> None:
    """Deferred runs of 100..163 bytes, longer than the small ring of 64:
    the runs end at every address modulo 64, so one of them ends where a
    ring window does."""
    tris = [testdata.ff_run_triples(100 + b) for b in range(64)]
    enc_k, enc_p = check_rc_case(tris, "deferred runs 100..163")
    by, cn = (x.cpu() for x in enc_p)
    ends = []
    for b in range(64):
        row = by[b, :int(cn[b])].tolist()
        j = max(i for i in range(len(row)) if row[i] == 0xFF) + 1
        ends.append((enc_k[0][b].data_ptr() + j) % 64)
    if 0 not in ends:
        fail(f"no deferred run ends at a ring flush: {sorted(set(ends))}")


def phase_kernels_rc(quick: bool) -> int:
    """The comparison grid of the three range-coder kernels.  The plain
    versions take about a millisecond of host time per byte (event)
    index, whatever B, so length 1000 runs at two widths only and the
    normalising input (one symbol repeated past 4096 times, so the
    total reaches 65519 and every entry is halved) once per order."""
    Bs, Ns, widths = (1, 5, 130), (1, 8, 33, 100, 1000), (2, 6, 40, 97, 256)
    if quick:
        Bs, Ns, widths = (5, 130), (8, 100), (6, 256)
    n = 0
    for order in (0, 1):
        for B in Bs:
            for N in Ns:
                for width in widths:
                    if N == 1000 and (width not in (40, 256) or B == 1):
                        continue
                    blocks, lens, ms = testdata.arith_blocks(
                        B, N, width, seed=B * 100003 + N * 13 + width)
                    check_arith_case(
                        blocks, lens, ms, order,
                        f"arith B={B} N={N} width={width} order={order}",
                        garbage=N == 100)
                    n += 1
        N = 1200 if quick else 4500
        blocks = np.full((2, N), 7, np.uint8)
        blocks[:, ::97] = 3
        check_arith_case(blocks, np.array([N, N - 7], np.int32),
                         np.full(2, 8, np.int32), order,
                         f"arith normalising N={N} order={order}")
        n += 1
    # order 1 at M = 256 with every context in use: past the default
    # pool of a small batch too
    rng = np.random.default_rng(256)
    blocks = rng.integers(0, 256, (2, 3000)).astype(np.uint8)
    blocks[:, :256] = np.arange(256, dtype=np.uint8)
    check_arith_case(blocks, np.array([3000, 2990], np.int32),
                     np.full(2, 256, np.int32), 1,
                     "arith M=256 all contexts order=1", garbage=True)
    n += 1
    # blocks that hold byte 255 through the batch entries (the stream's
    # max-symbol byte is 0, read as 256)
    blocks = np.random.default_rng(255).choice(
        np.array([3, 7, 255], np.uint8), size=(5, 600), p=[0.7, 0.2, 0.1])
    head = bytearray([0])
    varint.put_uint(head, blocks.shape[1])
    for order in (0, 1):
        streams = batch.arith_compress_blocks(blocks, order=order,
                                              engine="device")
        if any(s[len(head)] != 0 for s in streams):
            fail("arith: a block holding byte 255 has a max-symbol byte != 0")
        if streams != [arith.compress(b, order) for b in blocks]:
            fail(f"arith: byte-255 streams differ from the host coder's "
                 f"(order {order})")
        outs = batch.arith_uncompress_blocks(streams, engine="device")
        if outs != [b.tobytes() for b in blocks]:
            fail(f"arith: byte-255 blocks did not round-trip (order {order})")
        n += 1
    # a 5-byte range-coder payload decodes to zeros (a reference quirk
    # that both packages keep): np.full(8, 3) gives one at both orders
    for order in (0, 1):
        blocks = [np.full(8, 3, np.uint8)] * 3
        streams = batch.arith_compress_blocks(blocks, order=order,
                                              engine="device")
        if streams != [arith.compress(blocks[0], order)] * 3 \
                or len(streams[0]) != 8:
            fail(f"arith: the 5-byte payload stream changed (order {order})")
        if batch.arith_uncompress_blocks(streams, engine="device") \
                != [bytes(8)] * 3:
            fail(f"arith: a 5-byte payload did not decode to zeros "
                 f"(order {order})")
        n += 1
    jobs = testdata.synth_fqz_jobs(5, 30, 50, seed=3)
    parts = [fqz._replay_job(j, 4) for j in jobs]
    if any(p is None for p in parts):
        fail("fqz_enc_replay refused a job of the comparison grid")
    cases = [("fqz replay 5 x 30 x 50", [p[1] for p in parts]),
             ("deferred runs", [testdata.ff_run_triples(r)
                                for r in (300, 1, 40)]),
             ("deferred run of 5000", [testdata.ff_run_triples(5000)]),
             ("random B=130 n=100", testdata.random_triples(130, 100, 1)),
             ("totals 0/1/2/65535, frequencies 0", rc_edge_triples())]
    # event counts at chunk - 1, chunk, chunk + 1 of the small chunks
    cases += [(f"random n={k}", testdata.random_triples(1, k, k))
              for k in (7, 8, 9, 31, 32, 33, 63, 64, 65)]
    cases += [(f"random B={B} n=70", testdata.random_triples(B, 70, B))
              for B in (1, 5, 192, 193)]
    if not quick:
        cases.append(("random B=5 n=1000", testdata.random_triples(5, 1000, 2)))
    for label, triples in cases:
        check_rc_case(triples, label)
        n += 1
    check_ring_flush_runs()
    return n + 1


def phase_kernels(quick: bool) -> int:
    """The comparison grid.  The plain versions are bound by the host's
    launch rate (time ~ steps, whatever B), so the longest length runs
    at one alphabet only."""
    rng = np.random.default_rng(2024)
    Bs = (1, 5, 130, 512)
    Ns = (33, 511, 512, 514, 4096)     # N & 3 = 1, 3, 0, 2, 0
    nsyms = (3, 14, 40, 90)            # -> alphabet buckets 4, 16, 48, 96
    if quick:
        Bs, Ns, nsyms = (5, 130), (33, 514), (3, 40)
    n = 0
    for B in Bs:
        for N in Ns:
            for nsym in nsyms:
                if N == 4096 and nsym != 40:
                    continue
                blocks = testdata.synth_wide(B, N, nsym, seed=B * 100003 + N * 13 + nsym)
                for order in (0, 1):
                    for mode in ("10", "12", "mixed"):
                        sv = (rng.choice([10, 12], size=B).astype(np.int32)
                              if mode == "mixed" else np.full(B, int(mode), np.int32))
                        label = f"B={B} N={N} nsym={nsym} order={order} shift={mode}"
                        check_case(blocks, sv, order, label,
                                   garbage=(N == 514))
                        n += 1
                    check_case8(blocks, order,
                                f"4x8 B={B} N={N} nsym={nsym} order={order}",
                                garbage=(N == 514))
                    n += 1
    # 4x8 alphabets past the batch layer's widest bucket, up to 256 (the
    # order-1 tables then stay in global memory)
    for B, nsym in ((5, 128), (130, 200), (5, 256)):
        blocks = testdata.synth_wide(B, 4096, nsym, seed=B + nsym, lo=0)
        for order in (0, 1):
            check_case8(blocks, order,
                        f"4x8 wide B={B} N=4096 nsym={nsym} order={order}",
                        garbage=True, max_a=256)
            n += 1
    return (n + check_direct16_grid(quick) + check_one_symbol_rows8()
            + check_direct_grid(quick))


# ---------------------------------------------------------------------------
# the order-1 table build's counting kernels

# the kernels the order-1 device-table route launches before the encoder
TABLES_O1 = ("tables_o1_presence", "tables_o1_count")
A_BUCKETS = (4, 8, 16, 24, 32, 48, 64, 72, 80, 96)    # rans_v2._round_a
COUNT_BS = (1, 63, 64, 256, 4096)
COUNT_NS = (32, 33, 37, 1237, 65536, 1510000, (1 << 23) - 1)
COUNT_MAX_BYTES = 1 << 29


def on_card(blocks, offset=0):
    """(B, N) uint8 numpy array or tensor -> a contiguous copy on the
    card whose data starts ``offset`` bytes past an allocation's start."""
    t = torch.as_tensor(blocks)
    B, N = t.shape
    buf = torch.empty(B * N + offset, dtype=torch.uint8, device=DEV)
    bt = buf[offset:].view(B, N)
    bt.copy_(t)
    return bt


def count_batch(B, N, d, kind, gen, offset=0):
    """(B, N) uint8 on the card, made there: block b draws from its own
    n_b <= d distinct bytes (block 0 from all d, each present), in
    geometric runs (p = 0.25, cut at 60) of nonzero bytes skewed to the
    first (byte 0 absent: the build forces it) or uniform over bytes
    that include 0.  The data starts ``offset`` bytes past an
    allocation's start."""
    K = d - 1 if kind == "runs" else d
    perm = torch.rand(B, 255, generator=gen, device=DEV).argsort(dim=1) + 1
    syms = perm[:, :K]
    if kind != "runs":
        syms = torch.cat([torch.zeros_like(syms[:, :1]), syms[:, :K - 1]], 1)
    nb = torch.randint(1, K + 1, (B, 1), generator=gen, device=DEV)
    nb[0] = K
    if kind == "runs":
        M = B * N // 3 + 64
        lens = (torch.log(torch.rand(M, generator=gen, device=DEV))
                / math.log(0.75)).floor().clamp(0, 59).long() + 1
        v = (torch.rand(M, generator=gen, device=DEV) ** 3 * 65536).long()
        v = v.repeat_interleave(lens)
        while v.numel() < B * N:
            v = torch.cat([v, v])
        v = v[:B * N].view(B, N)
    else:
        v = torch.randint(0, 65536, (B, N), generator=gen, device=DEV)
    blk = syms.gather(1, (v * nb) >> 16).to(torch.uint8)
    del v
    n0 = min(K, N)
    blk[0, :n0] = syms[0, :n0].to(torch.uint8)
    return on_card(blk, offset)


def check_count(bt, label, want_a=None):
    """tables_o1_presence and tables_o1_count on one batch on the card
    against their plain versions (tolerance 0); returns the batch's
    alphabet bucket A."""
    pres_k = tables_v2.tables_o1_presence(bt)
    pres_p = tables_v2._presence(bt)
    torch.cuda.synchronize()
    if not torch.equal(pres_k, pres_p):
        fail(f"tables_o1_presence != plain at {label}")
    A = rans_v2._round_a(int(pres_p.sum(dim=1).max()))
    if want_a is not None and A != want_a:
        fail(f"count grid {label}: the batch's alphabet bucket is {A}, "
             f"not {want_a}")
    alpha = tables_v2._alphabet(pres_p, A).to(torch.uint8)
    H_k = tables_v2.tables_o1_count(bt, alpha)
    H_p = tables_v2._tables_o1_count_plain(bt, alpha)
    torch.cuda.synchronize()
    err = max_abs_diff(H_k, H_p)
    if err:
        fail(f"tables_o1_count != plain at {label} A={A} (max abs err {err})")
    return A


def phase_tables_count(quick: bool) -> int:
    """The counting kernels against their plain versions over every
    alphabet bucket, block lengths from 32 to 2^23 - 1 (unequal quarters
    at N & 3 != 0), B from 1 to 4096 (up to COUNT_MAX_BYTES a batch),
    rows that start at every alignment, runs and uniform bytes, and per
    shape a batch of a one-symbol block and a block of byte 0 only."""
    gen = torch.Generator(device=DEV).manual_seed(15)
    Bs, Ns, cap = COUNT_BS, COUNT_NS, COUNT_MAX_BYTES
    if quick:
        Bs, Ns, cap = (1, 63, 256), (33, 1237, 65536, 1510000), 1 << 27
    n = 0
    for N in Ns:
        for B in Bs:
            if B * N > cap:
                continue
            for i, bucket in enumerate(A_BUCKETS):
                d = min(bucket, N)
                if d <= (A_BUCKETS[i - 1] if i else 0):
                    continue
                kind = "runs" if (i + n) % 2 else "uniform"
                bt = count_batch(B, N, d, kind, gen, offset=n % 16)
                check_count(bt, f"B={B} N={N} d={d} {kind} offset={n % 16}",
                            want_a=bucket)
                n += 1
                del bt
            special = np.full((B, N), 37, np.uint8)
            special[0] = 77                       # one symbol
            if B > 1:
                special[1] = 0                    # byte 0 only
            else:
                check_count(on_card(np.zeros((1, N), np.uint8), 3),
                            f"B=1 N={N} byte 0 only")
                n += 1
            check_count(on_card(special, 5), f"B={B} N={N} one-symbol rows")
            n += 1
    return n


def qs_runs_on_card(B, N, seed):
    """A quality-series batch as the benchmark's write cell has it, made
    on the card: RTA3 bins 2/12/23/37 at 0.05/0.10/0.15/0.70 in geometric
    runs (p = 0.25, cut at 60) that fill each block."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    M = B * N // 3 + 64
    lens = (torch.log(torch.rand(M, generator=gen, device=DEV))
            / math.log(0.75)).floor().clamp(0, 59).long() + 1
    p = torch.tensor([0.05, 0.10, 0.15, 0.70], device=DEV)
    vals = torch.multinomial(p, M, replacement=True, generator=gen)
    bins = torch.tensor([2, 12, 23, 37], dtype=torch.uint8, device=DEV)
    seq = bins[vals].repeat_interleave(lens)
    while seq.numel() < B * N:
        seq = torch.cat([seq, seq])
    return seq[:B * N].reshape(B, N).contiguous()


def count_entries(q4, launches):
    """The counting kernels at the write cell's shape (256 x 1 510 000
    quality bytes, A = 8), with the main path's batch ``q4`` second:
    held against their plain versions once more and timed beside their
    byte bounds."""
    res = {}
    for tag, bt in (("cell", qs_runs_on_card(256, 1510000, 16)),
                    ("main", torch.from_numpy(q4).to(DEV))):
        B, N = bt.shape
        pres = tables_v2.tables_o1_presence(bt)
        plain = {}
        pl_p = once(lambda: plain.update(pres=tables_v2._presence(bt)))
        ms_p = cuda_ms(lambda: tables_v2.tables_o1_presence(bt))
        err_p = max_abs_diff(pres, plain.pop("pres"))
        A = rans_v2._round_a(int(pres.sum(dim=1).max()))
        alpha = tables_v2._alphabet(pres, A).to(torch.uint8)
        H = tables_v2.tables_o1_count(bt, alpha)
        pl_c = once(lambda: plain.update(H=tables_v2._tables_o1_count_plain(
            bt, alpha)))
        ms_c = cuda_ms(lambda: tables_v2.tables_o1_count(bt, alpha))
        err_c = max_abs_diff(H, plain.pop("H"))
        shape = f"B={B} N={N} A={A}"
        res[tag] = [
            entry("tables_o1_presence", "tables_o1_count.cu",
                  "none: a torch scatter in ops/tables_v2.py", shape,
                  launches, ms_p, pl_p, err_p, B * N + B * 256, 2 * B * N,
                  None),
            entry("tables_o1_count", "tables_o1_count.cu",
                  "none: torch.bincount in ops/tables_v2.py", shape,
                  launches, ms_c, pl_c, err_c, B * N + B * A + 4 * B * A * A,
                  6 * B * N, None)]
        del bt, pres, alpha, H
    for e, m in zip(res["cell"], res["main"]):
        e["second_ms"], e["second_shape"] = m["ms"], m["shape"]
        e["max_abs_err"] = max(e["max_abs_err"], m["max_abs_err"])
    return res["cell"]


# ---------------------------------------------------------------------------
# phase 3: the main path

class Codec(NamedTuple):
    """The entry points of one codec's main path."""
    name: str
    compress: Callable
    uncompress: Callable
    host_compress: Callable
    kernels: tuple          # the kernels its main path runs


R4X16 = Codec("rans4x16", batch.compress_blocks, batch.uncompress_blocks,
              rans4x16.compress, ("rans16_dec", "rans16_enc_packed"))
R4X8 = Codec("rans4x8", batch.r4x8_compress_blocks,
             batch.r4x8_uncompress_blocks, rans4x8.compress,
             ("rans8_enc", "rans8_dec"))
ARITH = Codec("arith", batch.arith_compress_blocks,
              batch.arith_uncompress_blocks, arith.compress,
              ("arith_enc", "arith_dec"))


def dec16_need(kernels, keys):
    """``kernels`` with "rans16_dec" replaced by ``keys``, the counters
    the rule gave a path's rans16_dec launches (``Routes16.keys``): the
    path must launch the decoder, on those routes only."""
    if "rans16_dec" not in kernels:
        return kernels
    if not keys:
        fail(f"rans16_dec was not launched (kernels due: {kernels})")
    return tuple(k for k in kernels if k != "rans16_dec") + tuple(sorted(keys))


def reset_routes() -> None:
    for k in batch.TABLE_ROUTES:
        batch.TABLE_ROUTES[k] = 0


def run_main_path(codec, name, blocks, order, sample):
    """compress -> uncompress with the defaults; returns the launch
    counts of the run and the streams, prints wall seconds and MB/s.
    For the rANS 4x16 codec, checks that the batch took the table
    route its size calls for (device tables from TABLES_DEVICE_MIN
    blocks up)."""
    B, N = blocks.shape
    mb = B * N / 1e6
    name = f"{codec.name} {name}"
    rans_vmem.reset_launches()
    reset_routes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = codec.compress(blocks, order=order)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with Routes16() as r16:
        outs = codec.uncompress(streams)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches = dict(rans_vmem.LAUNCHES)
    routes = dict(batch.TABLE_ROUTES)

    csize = sum(len(s) for s in streams)
    log(f"main path {name}: B={B} N={N} order={order} "
        f"compress {t1 - t0:.3f} s ({mb / (t1 - t0):.1f} MB/s) "
        f"uncompress {t2 - t1:.3f} s ({mb / (t2 - t1):.1f} MB/s) "
        f"ratio {csize / (B * N):.4f} launches {launches} "
        f"table routes {routes}")
    if codec is R4X16:
        want = "device" if B >= batch.TABLES_DEVICE_MIN else "host"
        other = "host" if want == "device" else "device"
        if routes[want] < 1 or routes[other]:
            fail(f"{name}: expected the {want}-table route, got {routes}")
    for b in range(B):
        if outs[b] != blocks[b].tobytes():
            fail(f"{name}: block {b} did not round-trip")
    if codec is not R4X8:
        cat = sum(1 for s in streams if s[0] & rans4x16.X_CAT)
        if cat:
            fail(f"{name}: {cat} streams fell back to CAT framing")
    t = time.perf_counter()
    for b in np.linspace(0, B - 1, min(sample, B)).astype(int):
        if streams[b] != codec.host_compress(blocks[b], order):
            fail(f"{name}: stream {b} differs from the host coder's")
    # the 4x16 order-1 device-table route counts its bigrams on the card
    need = codec.kernels + (TABLES_O1 if codec is R4X16 and order == 1
                            and routes["device"] else ())
    if codec is R4X16:
        # the 4x16 decoder counts under the key of the route the rule gave
        # each launch (Routes16 checked every one of them)
        need = dec16_need(need, r16.keys)
    if codec is R4X8:
        # the 4x8 decoder counts under the key of the route its group took
        # (direct_route of the group's B and alphabet bucket): one of the
        # two, and nothing under the other
        used = [k for k in DEC8 if launches[k]]
        if len(used) != 1:
            fail(f"{name}: rans8_dec launched on routes {used}")
        need = ("rans8_enc", used[0])
    for k, v in launches.items():
        if k in need and v < 1:
            fail(f"{name}: kernel {k} was not launched on the main path")
        if k not in need and v:
            fail(f"{name}: kernel {k} is not of this path but was launched")
        if codec is ARITH and k in codec.kernels and v != 1:
            fail(f"{name}: kernel {k} launched {v} times for one batch")
    log(f"main path {name}: {B} blocks round-trip, {min(sample, B)} sampled "
        f"streams byte-identical to the host coder "
        f"({time.perf_counter() - t:.1f} s of host coding)")
    return launches, streams


def run_fqz_path(jobs, sample):
    """fqz_compress_blocks(engine="device") -> fqz_decompress_blocks;
    returns the launch counts of the run.  A job that the native replay
    refuses would send the whole batch to the host coder: the rc_enc
    count shows that this batch did not take that route."""
    nbytes = sum(len(j[0]) for j in jobs)
    mb = nbytes / 1e6
    rans_vmem.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = batch.fqz_compress_blocks(jobs, engine="device")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    outs = batch.fqz_decompress_blocks(streams)
    t2 = time.perf_counter()
    launches = dict(rans_vmem.LAUNCHES)
    csize = sum(len(s) for s in streams)
    log(f"main path fqz: {len(jobs)} jobs x {len(jobs[0][1])} records x "
        f"{jobs[0][1][0]} values, compress {t1 - t0:.3f} s "
        f"({mb / (t1 - t0):.1f} MB/s) decompress on the host {t2 - t1:.3f} s "
        f"({mb / (t2 - t1):.1f} MB/s) ratio {csize / nbytes:.4f} "
        f"launches {launches}")
    for j, (job, out) in enumerate(zip(jobs, outs)):
        if out != job[0].tobytes():
            fail(f"fqz: job {j} did not round-trip")
    t = time.perf_counter()
    for j in np.linspace(0, len(jobs) - 1, min(sample, len(jobs))).astype(int):
        if streams[j] != fqz.compress(*jobs[j]):
            fail(f"fqz: stream {j} differs from the host coder's")
    for k, v in launches.items():
        if v != (1 if k == "rc_enc" else 0):
            fail(f"fqz: kernel {k} launched {v} times for one batch")
    log(f"main path fqz: {len(jobs)} jobs round-trip, {min(sample, len(jobs))} "
        f"sampled streams byte-identical to the host coder "
        f"({time.perf_counter() - t:.1f} s of host coding)")
    return launches


def run_table_routes(blocks, order, streams_want, name, engine="auto",
                     quiet=False):
    """compress_blocks on a batch through both table routes in turns
    (device, host, host, device; TABLES_DEVICE_MIN set to B for the
    device route and above B for the host route), warm: each run must
    take its route, launch the one 4x16 encoder (and on the order-1
    device route the two counting kernels) once and no other kernel,
    and give ``streams_want`` (the first run's streams when None), block
    for block.  Returns the compress walls by route."""
    B, N = blocks.shape
    keep = batch.TABLES_DEVICE_MIN
    walls = {"device": [], "host": []}
    for route in ("device", "host", "host", "device"):
        batch.TABLES_DEVICE_MIN = B if route == "device" else B + 1
        reset_routes()
        rans_vmem.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams = batch.compress_blocks(blocks, order=order, engine=engine)
        torch.cuda.synchronize()
        walls[route].append(time.perf_counter() - t0)
        batch.TABLES_DEVICE_MIN = keep
        routes = dict(batch.TABLE_ROUTES)
        expect_only(f"{name} {route}-table route", rans_vmem.LAUNCHES,
                    ("rans16_enc_packed",)
                    + (TABLES_O1 if route == "device" and order == 1
                       else ()))
        other = "host" if route == "device" else "device"
        if routes[route] < 1 or routes[other]:
            fail(f"{name}: expected the {route}-table route, got {routes}")
        if streams_want is None:
            streams_want = streams
        if streams != streams_want:
            fail(f"{name}: the {route}-table route's streams differ")
    if not quiet:
        log(f"table routes {name}, compress wall in turns (device, host, "
            f"host, device), s: {walls}; all {B} streams byte-identical "
            "each time")
    return walls


def reset_entropy_jobs() -> None:
    for side in batch.ENTROPY_JOBS.values():
        for k in side:
            side[k] = 0


# the transform main path's orders and the kernels each must launch:
# STRIPE with 4 lanes and order-1 and order-0 candidates, whose lanes of
# equal blocks form device groups; PACK|RLE|order 1, whose RLE literals
# and metas differ in length from block to block, so that most groups
# stay under DEVICE_MIN_GROUP and take the host coder
TRANSFORM_ORDERS = {9: ("rans16_enc_packed", "rans16_dec"), 193: ()}


def run_transform_path(blocks, order, sample):
    """compress_blocks -> uncompress_blocks with the defaults on a
    transform-flagged order: every block round-trips, ``sample`` spread
    streams equal the host coder's, only the 4x16 kernels run and those
    that TRANSFORM_ORDERS names ran.  Prints wall seconds, MB/s, the
    entropy jobs by route (``batch.ENTROPY_JOBS``) and the table routes;
    returns them with the launch counts."""
    B, N = blocks.shape
    mb = B * N / 1e6
    name = f"rans4x16 transform synth4 order {order}"
    rans_vmem.reset_launches()
    reset_routes()
    reset_entropy_jobs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = batch.compress_blocks(blocks, order=order)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with Routes16() as r16:
        outs = batch.uncompress_blocks(streams)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    res = {"B": B, "N": N, "compress_s": t1 - t0, "uncompress_s": t2 - t1,
           "compress_MBps": mb / (t1 - t0), "uncompress_MBps": mb / (t2 - t1),
           "ratio": sum(len(s) for s in streams) / (B * N),
           "entropy_jobs": {k: dict(v) for k, v in batch.ENTROPY_JOBS.items()},
           "table_routes": dict(batch.TABLE_ROUTES),
           "launches": dict(rans_vmem.LAUNCHES)}
    log(f"main path {name}: {res}")
    for b in range(B):
        if outs[b] != blocks[b].tobytes():
            fail(f"{name}: block {b} did not round-trip")
    for b in np.linspace(0, B - 1, min(sample, B)).astype(int):
        if streams[b] != rans4x16.compress(blocks[b], order):
            fail(f"{name}: stream {b} differs from the host coder's")
    need = dec16_need(TRANSFORM_ORDERS[order], r16.keys)
    for k, v in res["launches"].items():
        if k in need and v < 1:
            fail(f"{name}: kernel {k} was not launched on the path")
        if k not in R4X16.kernels + TABLES_O1 + tuple(r16.keys) and v:
            fail(f"{name}: kernel {k} is not of this path but was launched")
    log(f"main path {name}: {B} blocks round-trip, {min(sample, B)} sampled "
        "streams byte-identical to the host coder")
    return res


def stripe_lanes(blocks, nlanes=4):
    """The stripe lanes of order 9 as _peel_encode cuts them: lane j of
    block b is blocks[b, j::nlanes], row b * nlanes + j."""
    B, N = blocks.shape
    return np.ascontiguousarray(
        blocks.reshape(B, N // nlanes, nlanes).transpose(0, 2, 1)
    ).reshape(B * nlanes, N // nlanes)


def transform_kernel_checks(blocks, launches):
    """The 4x16 encoder and decoder at the shapes the order-9 path gives
    them: the stripe lanes of the batch, one group per candidate order on
    the device-table route, each kernel against its plain version
    (tolerance 0) and timed.  Returns the entries of kernel_times, with
    the transform phase's launch counts."""
    lanes = stripe_lanes(blocks)
    res = []
    for order in (1, 0):
        t = time.perf_counter()
        es = kernel_times(lanes, order, {"rans4x16": launches})
        log(f"transform order 9 lanes, candidate order {order}: "
            + "; ".join(f"{e['name']} {e['ms']:.3f} ms == plain "
                        f"({e['plain_ms']:.0f} ms) at {e['shape']}"
                        for e in es)
            + f" ({time.perf_counter() - t:.1f} s)")
        res += es
    return res


# the name codec: blocks of the CRAM default slice of 10000 names, in
# two styles, and the kernels its descriptor encode may reach
TOK3_STYLES = ("illumina", "sra")
TOK3_NAMES = 10000
TOK3_PAIR = ("rans16_enc_packed", "rans16_dec")


def tok3_blocks(nblk):
    return {style: [testdata.synth_names(TOK3_NAMES, style,
                                         seed=1000 * k + b)
                    for b in range(nblk)]
            for k, style in enumerate(TOK3_STYLES)}


def counted(fn, items):
    """fn over every item, the launch counts and entropy jobs set to 0
    just before and read just after: (outputs, wall s, launches,
    entropy jobs by route)."""
    rans_vmem.reset_launches()
    reset_entropy_jobs()
    reset_routes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [fn(x) for x in items]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (outs, wall, dict(rans_vmem.LAUNCHES),
            {k: dict(v) for k, v in batch.ENTROPY_JOBS.items()})


def only_kernels(name, launches, allowed, need=()):
    for k, v in launches.items():
        if v and k not in allowed:
            fail(f"{name}: kernel {k} launched {v} times outside {allowed}")
    for k in need:
        if launches[k] < 1:
            fail(f"{name}: kernel {k} was not launched")


def tok3_rates(wall, nbytes, nnames):
    return {"s": wall, "names_per_s": nnames / wall,
            "MBps": nbytes / wall / 1e6}


def run_tok3_paths(blocks):
    """tok3.encode_names -> decode_names with the defaults but the
    engine, per style: level 9 (rANS descriptors) with engine "host" and
    "device", level 19 (arith descriptors, level 9 of the arith backend)
    with the default engine.  Every block round-trips, the "device"
    streams equal the "host" streams byte for byte, "device" launches
    the one 4x16 encoder, no run launches a kernel outside the 4x16
    pair, and neither the "host" encode nor anything at level 19
    launches one.  Returns the rates, ratios, entropy jobs and launches
    by run, and the level-9 streams."""
    res = {}
    streams9 = {}
    for style, blks in blocks.items():
        nbytes = sum(len(b) for b in blks)
        nnames = len(blks) * TOK3_NAMES
        want = [b.replace(b"\n", b"\x00") for b in blks]
        for level, use_arith, engines in ((9, False, ("host", "device")),
                                          (19, True, (None,))):
            first = None
            for engine in engines:
                run = f"{style} level {level} encode {engine or 'default'}"
                name = f"tok3 {run}"
                streams, wall, launches, jobs = counted(functools.partial(
                    tok3.encode_names, level=9, use_arith=use_arith,
                    engine=engine), blks)
                if engine == "device":
                    only_kernels(name, launches, TOK3_PAIR[:1] + TABLES_O1,
                                 TOK3_PAIR[:1])
                else:
                    only_kernels(name, launches, ())
                if first is None:
                    first = streams
                elif streams != first:
                    bad = next(k for k in range(len(blks))
                               if streams[k] != first[k])
                    fail(f"{name}: block {bad}'s stream differs from the "
                         "host engine's")
                res[run] = dict(tok3_rates(wall, nbytes, nnames),
                                ratio=sum(len(x) for x in streams) / nbytes,
                                entropy_jobs=jobs["encode"], launches=launches)
                log(f"main path {name}: {res[run]}")
            run = f"{style} level {level} decode"
            name = f"tok3 {run}"
            with Routes16() as r16:
                outs, wall, launches, jobs = counted(tok3.decode_names, first)
            # the level-9 decoder may launch (on the routes the rule gave
            # it); nothing at level 19 may
            only_kernels(name, launches, () if use_arith else tuple(r16.keys))
            for k, (o, w) in enumerate(zip(outs, want)):
                if o != w:
                    fail(f"{name}: block {k} did not round-trip")
            res[run] = dict(tok3_rates(wall, nbytes, nnames),
                            entropy_jobs=jobs["decode"], launches=launches)
            log(f"main path {name}: {res[run]}; {len(blks)} blocks of "
                f"{TOK3_NAMES} names round-trip")
            if not use_arith:
                streams9[style] = first
    return res, streams9


def descriptor_groups(blk, level=9):
    """The (length, order) groups of one block's descriptor entropy
    jobs, as ``_encode_entropy_jobs`` forms them, that reach the 4x16
    encoder (jobs of 32 bytes or more, alphabets of at most 96 symbols
    with byte 0), most bytes first: ([((B, N) uint8, order)], the
    block's number of jobs, its number of groups)."""
    desc, order, _n, _ls = tok3._descriptors(blk)
    jobs, _cands = tok3._descriptor_jobs(desc, order, level)
    groups = {}
    for data, o in jobs:
        groups.setdefault((len(data), o), []).append(data)
    out = []
    for (n, o), rows in groups.items():
        arr = np.stack(rows)
        if n >= 32 and max(len(np.union1d(r, [0])) for r in arr) <= 96:
            out.append((arr, o))
    out.sort(key=lambda g: -g[0].size)
    return out, len(jobs), len(groups)


def tok3_kernel_checks(blk, streams, enc_launches):
    """The 4x16 encoder and decoder at the shapes tok3 gives them: the
    three descriptor groups of one Illumina block with the most bytes,
    each kernel against its plain version (tolerance 0) and timed; then
    every rANS descriptor stream of the level-9 blocks through
    ``uncompress_blocks(engine="device")``, the counts set to 0 just
    before, equal to the host decode.  Returns the entries of
    kernel_times and the decode's summary."""
    parts = [tok3._parse_container(memoryview(s)) for s in streams]
    descs = [bytes(s[p2:p2 + clen]) for s, part in zip(streams, parts)
             for _i, p2, clen in part[0]]
    with Routes16() as r16:
        outs, wall, launches, jobs = counted(
            lambda d: batch.uncompress_blocks(d, engine="device"), [descs])
    due = dec16_need(TOK3_PAIR[1:], r16.keys)
    only_kernels("tok3 descriptor decode engine device", launches, due, due)
    if outs[0] != batch.uncompress_blocks(descs, engine="host"):
        fail("tok3 descriptor streams: the device decode differs from the "
             "host decode")
    dec = {"streams": len(descs), "bytes_out": sum(len(o) for o in outs[0]),
           "s": wall, "entropy_jobs": jobs["decode"], "launches": launches}
    log(f"tok3 descriptor streams of {len(streams)} Illumina blocks, "
        f"uncompress_blocks(engine='device') == host decode: {dec}")
    groups, njobs, ngroups = descriptor_groups(blk)
    log(f"tok3 Illumina block 0: {njobs} entropy jobs in {ngroups} (length, "
        f"order) groups, {len(groups)} of them reach the encoder: "
        f"{[(g.shape, o) for g, o in groups]}")
    counts = {"rans16_enc_packed": enc_launches,
              "rans16_dec": sum(launches[k] for k in DEC16)}
    res = []
    for arr, o in groups[:3]:
        t = time.perf_counter()
        es = kernel_times(arr, o, {"rans4x16": counts})
        log("tok3 descriptor group: "
            + "; ".join(f"{e['name']} {e['ms']:.3f} ms == plain "
                        f"({e['plain_ms']:.0f} ms) at {e['shape']}"
                        for e in es)
            + f" ({time.perf_counter() - t:.1f} s)")
        res += es
    return res, dec


SWEEP_B = (4, 16, 64, 128, 256, 512, 1024)


def table_route_sweep(blocks):
    """The two table routes' compress wall at group sizes around
    TABLES_DEVICE_MIN (the first B blocks of the main path's batch;
    engine="device", so that groups under DEVICE_MIN_BYTES reach the
    card too), both orders, medians of two runs each in turns; each run
    must take its route and both routes give the same streams.  Host
    wall times spread, so a size at which the route that
    TABLES_DEVICE_MIN picks is the slower one is printed, not failed."""
    res = {}
    for order in (1, 0):
        row = {}
        for b in SWEEP_B:
            if b > len(blocks):
                break
            walls = run_table_routes(blocks[:b], order, None,
                                     f"sweep order {order} B={b}",
                                     engine="device", quiet=True)
            row[b] = {k: statistics.median(v) for k, v in walls.items()}
            picked = "device" if b >= batch.TABLES_DEVICE_MIN else "host"
            if row[b][picked] > min(row[b].values()):
                log(f"note: sweep order {order} B={b}: TABLES_DEVICE_MIN "
                    f"picks the slower table route here: {row[b]}")
        res[f"order{order}"] = row
    res["N"] = blocks.shape[1]
    res["TABLES_DEVICE_MIN"] = batch.TABLES_DEVICE_MIN
    return res


def table_build_ms(blocks):
    """Device time of the table build on the main path's batch, and at
    order 1 on a batch of the write cell's shape, the batch already on
    the card (CUDA events; order 1 without, order 0 with its small copies
    to the host)."""
    bt = torch.from_numpy(blocks).to(DEV)
    cell = qs_runs_on_card(256, 1510000, 17)
    return {"order1": cuda_ms(lambda: tables_v2.build_o1_device_async(
                bt, device=DEV), reps=3),
            "order0": cuda_ms(lambda: tables_v2.build_o0_device(
                bt, device=DEV), reps=3),
            "shape": f"B={blocks.shape[0]} N={blocks.shape[1]}",
            "order1_cell": cuda_ms(lambda: tables_v2.build_o1_device_async(
                cell, device=DEV), reps=3),
            "cell_shape": "B=256 N=1510000 (the write cell's quality runs)"}


def band_counts(blocks):
    """Blocks of an order-1 batch whose shift decision lies in the
    float32 band, and those whose exact f64 replay flips it (rebuilt on
    the host by the device-table route)."""
    r = tables_v2.build_o1_device_async(blocks, device=DEV)
    meta = r[3].cpu().numpy()
    flips = tables_v2.resolve_band_flags(meta, r[4])
    return int(meta[:, 2].sum()), int(flips.sum())


def expect_only(name, launches, kernels):
    """Exactly one launch of each of ``kernels`` and none of any other."""
    for k, v in launches.items():
        if v != (1 if k in kernels else 0):
            fail(f"{name}: kernel {k} launched {v} times (expected one "
                 f"of each of {kernels} only)")


def run_pallas_path(blocks, order):
    """The rans_pallas path: tables_v2.build_o*_device -> group by shift
    -> rans_pallas.enc_o*_batch (states, counts and live words equal to
    rans_v2.enc_o*_batch's for every block) -> rans_pallas.dec_o*_batch
    (every block round-trips).  The launch counts are set to 0 just
    before each rans_pallas call and read just after: one launch of the
    packed kernel, none of any other.  Returns the launches summed over
    the batch's calls and the shift groups ((indices, shift), largest
    first) with the device tables."""
    B, N = blocks.shape
    name = f"rans_pallas synth4 order {order}"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if order:
        alpha_d, packed_d, _asz, _fh, shift, _flag, A = \
            tables_v2.build_o1_device(blocks, device=DEV)
    else:
        alpha_d, packed_d, _asz, _fh, A = tables_v2.build_o0_device(
            blocks, device=DEV)
        shift = np.full(B, 12, np.int32)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    enc = rans_pallas.enc_o1_batch if order else rans_pallas.enc_o0_batch
    dec = rans_pallas.dec_o1_batch if order else rans_pallas.dec_o0_batch
    enc_v2 = rans_v2.enc_o1_batch if order else rans_v2.enc_o0_batch
    total = {"rans16_enc_packed": 0, "rans16_dec_packed": 0}
    groups = []
    t_enc = t_dec = 0.0
    for sv in np.unique(shift):
        sel = np.flatnonzero(shift == sv)
        sub = blocks[sel]
        selt = torch.from_numpy(sel).to(DEV)
        al, pk = alpha_d[selt], packed_d[selt]
        rans_vmem.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, wd, cn = enc(sub, al, pk, int(sv))
        torch.cuda.synchronize()
        t_enc += time.perf_counter() - t
        expect_only(f"{name} encode shift={sv}", rans_vmem.LAUNCHES,
                    ("rans16_enc_packed",))
        st2, wd2, cn2 = enc_v2(sub, al.cpu().numpy(), pk.cpu().numpy(),
                               int(sv))
        live = np.arange(wd.shape[1])[None, :] < cn[:, None]
        if (not np.array_equal(st, st2) or not np.array_equal(cn, cn2)
                or wd.shape != wd2.shape
                or not np.array_equal(np.where(live, wd, 0),
                                      np.where(live, wd2, 0))):
            fail(f"{name}: encode differs from rans_v2's at shift {sv}")
        rans_vmem.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = dec(st, wd, N, al, pk, int(sv))
        torch.cuda.synchronize()
        t_dec += time.perf_counter() - t
        expect_only(f"{name} decode shift={sv}", rans_vmem.LAUNCHES,
                    ("rans16_dec_packed",))
        if not np.array_equal(out, sub):
            fail(f"{name}: a block of shift {sv} did not round-trip")
        total["rans16_enc_packed"] += 1
        total["rans16_dec_packed"] += 1
        groups.append((len(sel), int(sv), sel))
    log(f"path {name}: B={B} N={N} A={A} table build {t_build:.3f} s, "
        f"shift groups {[(g[1], g[0]) for g in groups]}, encode "
        f"{t_enc:.3f} s, decode {t_dec:.3f} s (host wall, transfers "
        f"included); every block's encode equals rans_v2's and every "
        f"block round-trips; launches {total}")
    groups.sort(key=lambda g: -g[0])
    return total, ([(sel, sv) for _n, sv, sel in groups], alpha_d, packed_d)


def profile_call(label, fn, *args):
    """One call under cProfile: cumulative host seconds of the port's
    own functions, the breakdown of the wall time.  Kernels run
    asynchronously, so their device time shows up where the host first
    waits for them (the copy back of counts or bytes)."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    res = prof.runcall(fn, *args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [(ct, nc, f"{Path(file).name}:{func}")
            for (file, _ln, func), (_cc, nc, _tt, ct, _callers)
            in pstats.Stats(prof).stats.items()
            if "htscodecs_tpu_torch" in file and ct >= 0.01 * wall]
    rows.sort(reverse=True)
    log(f"profile {label}: wall {wall:.3f} s under cProfile; "
        "cumulative seconds by function:")
    for ct, nc, name in rows[:14]:
        print(f"    {ct:8.3f} s  {nc:6d} calls  {name}", flush=True)
    return res


def profile_main_path(codec, blocks, order) -> None:
    """One more pass of a main path under cProfile."""
    streams = profile_call(f"{codec.compress.__name__} order={order}",
                           codec.compress, blocks, order)
    profile_call(f"{codec.uncompress.__name__} order={order}",
                 codec.uncompress, streams)


def max_abs_diff(a, b, live=None) -> int:
    d = (a.to(torch.int64) - b.to(torch.int64)).abs()
    if live is not None:
        d = d * live
    return int(d.max())


def streams_err_suffix(got, want) -> int:
    """Max abs difference of two encoders' (states, elements, counts),
    the elements compared over each row's last counts[b] (where the
    encoders leave each block's stream)."""
    (st, wd, cn), (st2, wd2, cn2) = got, want
    cap = wd.shape[1]
    live = torch.arange(cap, device=DEV)[None, :] >= cap - cn[:, None]
    return max(max_abs_diff(st, st2), max_abs_diff(cn, cn2),
               max_abs_diff(wd, wd2, live))


def once(fn):
    return cuda_ms(fn, reps=1, warm=0)


def entry(name, src, replaces, shape, launches, ms, plain_ms, err, nbytes,
          ops, library_ms):
    """One entry of the ``kernels`` line; the bound from the run's own
    bytes and operations."""
    if err != 0:
        fail(f"{name} != plain at the main path's shape (max abs err {err})")
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / FP32_OPS_PER_S * 1e3
    return {"name": name, "route": "cuda",
            "source": f"htscodecs_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": library_ms, "shape": shape}


def device_tables(blocks, order):
    """The 4x16 tables that the device-table route builds for a batch:
    (alpha (B,A) uint8, packed (B, A*A or A) int32, shift (B,) int32
    tensors, A)."""
    bt = torch.from_numpy(blocks).to(DEV)
    if order:
        alpha, packed, _fh, meta, _H, A = tables_v2.build_o1_device_async(
            bt, device=DEV)
        shift = meta[:, 1].to(torch.int32).contiguous()
    else:
        alpha, packed, _asz, _fh, A = tables_v2.build_o0_device(bt, device=DEV)
        shift = torch.full((len(blocks),), 12, dtype=torch.int32, device=DEV)
    return alpha, packed.reshape(len(blocks), -1).contiguous(), shift, A


def enc16_work(B, N, A, A2, nwords):
    """(bytes, operations) of the 4x16 encode of B blocks of N bytes:
    the blocks, alphabets, packed rows and shifts in, the states, counts
    and words out; per symbol the step (32, the divide counted as 20, as
    in every rANS encoder's count) and the lookup (the byte -> index
    table, the context, the entry: 6), per block the 256-entry byte ->
    index table."""
    nbytes = B * N + B * A + B * A2 * 4 + B * 4 + 2 * nwords + B * (16 + 4)
    return nbytes, 38 * B * N + 256 * B


def dec16_work(B, N, A, table_bytes, nwords):
    """(bytes, operations) of the 4x16 decode: the words, rows, alphabets,
    states and shifts in, the bytes out; per symbol the step and a
    bisection of the context's row."""
    nbytes = 2 * nwords + table_bytes + B * A + B * (16 + 4 + 4) + B * N
    return nbytes, (12 + 3 * math.ceil(math.log2(A + 1))) * B * N


def kernel_times(blocks, order, launches):
    """The 4x16 encoder and the decoder's base-row entry (its default
    launch, on the route the rule gives it) at the shapes the main path
    gave them (the device-table route's tables, per-block shifts): hold
    each against its plain version once more, time both and compute the
    roofline bound from this run's inputs.  ``launches["rans4x16"]``
    counts the decoder's launches on both routes as its own."""
    B, N = blocks.shape
    counts = dict(launches["rans4x16"])
    counts["rans16_dec"] = sum(counts.get(k, 0) for k in DEC16)
    alpha, packed, shift, A = device_tables(blocks, order)
    bt = torch.from_numpy(blocks).to(DEV)
    shape = f"B={B} N={N} A={A} order={order}"
    plain = {}

    enc = rans_vmem.rans16_enc_packed(bt, alpha, packed, shift, order)
    ms_enc = cuda_ms(lambda: rans_vmem.rans16_enc_packed(
        bt, alpha, packed, shift, order))
    pl_enc = once(lambda: plain.update(enc=rans_vmem._rans16_enc_packed_plain(
        bt, alpha, packed, shift, order)))
    err_enc = streams_err_suffix(enc, plain.pop("enc"))
    st, wd, cn = enc
    nwords = int(cn.sum())
    words = convert.words_forward(wd, cn).contiguous()
    del enc, wd

    tables = convert.tables_from_packed(alpha, packed.view(
        (B, A, A) if order else (B, A)), shift)
    out = rans_vmem.rans16_dec(st, words, cn, tables, N, order)
    ms_dec = cuda_ms(lambda: rans_vmem.rans16_dec(
        st, words, cn, tables, N, order))
    pl_dec = once(lambda: plain.update(dec=rans_vmem._rans16_dec_plain(
        st, words, cn, tables, N, order)))
    err_dec = max(max_abs_diff(out, plain.pop("dec")), max_abs_diff(out, bt))

    A2 = packed.shape[1]
    enc_b, enc_o = enc16_work(B, N, A, A2, nwords)
    dec_b, dec_o = dec16_work(B, N, A, tables.bases.numel() * 2, nwords)
    e_dec = entry("rans16_dec", "rans16_dec.cu",
                  "htscodecs_tpu/ops/rans_vmem.py:344", shape, counts,
                  ms_dec, pl_dec, err_dec, dec_b, dec_o, None)
    e_dec["route"] = dec16_key(tables, order)
    return [
        e_dec,
        entry("rans16_enc_packed", "rans16_enc_packed.cu",
              "htscodecs_tpu/ops/rans_pallas.py:485 (and "
              "htscodecs_tpu/ops/rans_vmem.py:529, :831, :855)", shape,
              counts, ms_enc, pl_enc, err_enc, enc_b, enc_o, None),
    ]


def enc8_work(B, N, A, A2, nbytes):
    """(bytes, operations) of the 4x8 encode of B blocks of N bytes: the
    blocks, alphabets and packed rows in, the states, counts and emitted
    bytes out; per symbol 40 (the 4x16 step with its divide counted as
    20, the lookup, the second emission test and store), per block the
    256-entry byte -> index table."""
    return (B * N + B * A + B * A2 * 4 + nbytes + B * (16 + 4),
            40 * B * N + 256 * B)


def kernel_times8(blocks, order, launches):
    """The same for the two rANS 4x8 kernels, and the whole 4x8 encode
    as the main path runs it (``rans8_vmem.enc_batch``: the tables moved
    to the card, the kernel)."""
    B, N = blocks.shape
    alpha, packed = rans8_tables(blocks, order)
    tables = convert.tables8_from_reference(alpha, packed, DEV)
    A = alpha.shape[1]
    bt = torch.from_numpy(blocks).to(DEV)
    pk = r8_packed(packed)
    shape = f"B={B} N={N} A={A} order={order}"
    plain = {}

    # ---- rans8_enc ----
    enc = rans8_vmem.rans8_enc(bt, tables.alpha, pk, order)
    ms_enc = cuda_ms(lambda: rans8_vmem.rans8_enc(bt, tables.alpha, pk,
                                                  order))
    ms_whole = cuda_ms(lambda: rans8_vmem.enc_batch(bt, alpha, packed, order))
    pl_enc = once(lambda: plain.update(enc=rans8_vmem._rans8_enc_plain(
        bt, tables.alpha, pk, order)))
    err_enc = streams_err_suffix(enc, plain.pop("enc"))
    st, by, cn = enc
    nbytes = int(cn.sum())
    enc_bytes, enc_ops = enc8_work(B, N, A, pk.shape[1] * A, nbytes)

    # ---- rans8_dec ----
    del enc
    stream = convert.words_forward(by, cn).contiguous()
    del by
    out = rans8_vmem.rans8_dec(st, stream, cn, tables, N, order)
    ms_dec = cuda_ms(lambda: rans8_vmem.rans8_dec(
        st, stream, cn, tables, N, order))
    pl_dec = once(lambda: plain.update(dec=rans8_vmem._rans8_dec_plain(
        st, stream, cn, tables, N, order)))
    err_dec = max(max_abs_diff(out, plain.pop("dec")), max_abs_diff(out, bt))
    dec_bytes, dec_ops = dec8_work(B, N, A, order, tables.bases.numel(),
                                   nbytes)

    ref = "htscodecs_tpu/ops/rans8_vmem.py"
    e_enc = entry("rans8_enc", "rans8_enc.cu", f"{ref}:452", shape,
                  launches["rans4x8"], ms_enc, pl_enc, err_enc, enc_bytes,
                  enc_ops, None)
    e_enc["whole_encode_ms"] = ms_whole
    e_dec = entry("rans8_dec", "rans8_dec.cu", f"{ref}:252", shape,
                  launches["rans4x8"], ms_dec, pl_dec, err_dec, dec_bytes,
                  dec_ops, None)
    e_dec["route"] = dec8_key(B, A, order)
    # the direct route at the read cell's shape, and where it stops paying
    cell = check_direct_cell()
    t_b, t_o = (x / r * 1e3 for x, r in zip(
        dec8_work(16, 1510000, 8, 1, 16 * 8 * 9, cell.pop("nbytes")),
        (HBM_BYTES_PER_S, FP32_OPS_PER_S)))
    cell.update(bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations")
    e_dec["cell_shape"] = cell
    e_dec["direct_sweep"] = [direct_sweep(), direct_sweep(8, 1,
                                                          DIRECT_SWEEP_B8),
                             direct_sweep(5, 0, DIRECT_SWEEP_B0)]
    return [e_dec, e_enc]


def dec8_work(B, N, A, order, table_numel, nbytes):
    """(bytes, operations) of the 4x8 decode: the stream, rows, alphabets,
    states and counts in, the bytes out; per symbol the step, its second
    byte test and a bisection of the context's row."""
    nq = B * 4 * rans8_vmem._dec_geometry(N, order)[1]
    return (nbytes + table_numel * 2 + B * A + B * (16 + 4) + B * N,
            (16 + 3 * math.ceil(math.log2(A + 1))) * nq)


def pallas_group(blocks, group, alpha_d, packed_d):
    """One shift group of the order-1 rans_pallas path: (blocks tensor,
    alpha, packed rows (B, A*A), shift, A)."""
    sel, sv = group
    selt = torch.from_numpy(sel).to(DEV)
    bt = torch.from_numpy(blocks[sel]).to(DEV)
    al = alpha_d[selt].contiguous()
    A = al.shape[1]
    pk = packed_d[selt].contiguous().view(len(sel), A * A)
    return bt, al, pk, sv, A


def kernel_times_packed(blocks, groups, launches, entries):
    """The 4x16 kernels at the shapes the rans_pallas path gave them: the
    decoder's packed-row entry at its largest order-1 shift group
    (tables from the device build) held against its plain version and
    timed, a new ``kernels`` entry; the encoder at the same group (one
    shift) timed beside its main-path entry in ``entries``; both on the
    second shift group, the batch's other launch."""
    shifts, alpha_d, packed_d = groups
    bt, al, pk, sv, A = pallas_group(blocks, shifts[0], alpha_d, packed_d)
    B, N = bt.shape
    shape = f"B={B} N={N} A={A} order=1 shift={sv}"
    plain = {}

    enc = rans_vmem.rans16_enc_packed(bt, al, pk, sv, 1)
    ms_enc = cuda_ms(lambda: rans_vmem.rans16_enc_packed(bt, al, pk, sv, 1))
    svt = torch.full((B,), sv, dtype=torch.int32, device=DEV)
    pl_enc = once(lambda: plain.update(enc=rans_vmem._rans16_enc_packed_plain(
        bt, al, pk, svt, 1)))
    err_enc = streams_err_suffix(enc, plain.pop("enc"))
    st, wd, cn = enc
    nwords = int(cn.sum())
    words = convert.words_forward(wd, cn).contiguous()
    del enc, wd
    out = rans_vmem.rans16_dec_packed(st, words, pk, al, sv, N, 1)
    ms_dec = cuda_ms(lambda: rans_vmem.rans16_dec_packed(
        st, words, pk, al, sv, N, 1))
    pl_dec = once(lambda: plain.update(dec=rans_vmem._rans16_dec_packed_plain(
        st, words, pk, al, svt, N, 1)))
    err_dec = max(max_abs_diff(out, plain.pop("dec")), max_abs_diff(out, bt))
    enc_b, enc_o = enc16_work(B, N, A, A * A, nwords)
    dec_b, dec_o = dec16_work(B, N, A, B * A * A * 4, nwords)
    e_dec = entry("rans16_dec_packed", "rans16_dec.cu",
                  "htscodecs_tpu/ops/rans_pallas.py:265", shape, launches,
                  ms_dec, pl_dec, err_dec, dec_b, dec_o, None)
    e_enc = next(e for e in entries if e["name"] == "rans16_enc_packed")
    if err_enc:
        fail(f"rans16_enc_packed != plain at the rans_pallas group ({err_enc})")
    t_b = enc_b / HBM_BYTES_PER_S * 1e3
    t_o = enc_o / FP32_OPS_PER_S * 1e3
    e_enc["rans_pallas"] = {"shape": shape,
                            "launches": launches["rans16_enc_packed"],
                            "ms": ms_enc,
                            "plain_ms": pl_enc, "max_abs_err": err_enc,
                            "bound_ms": max(t_b, t_o),
                            "bound_by": "bytes" if t_b >= t_o else "operations"}
    del words, st, out
    for group in shifts[1:2]:
        bt, al, pk, sv, A = pallas_group(blocks, group, alpha_d, packed_d)
        st, wd, cn = rans_vmem.rans16_enc_packed(bt, al, pk, sv, 1)
        ms2 = cuda_ms(lambda: rans_vmem.rans16_enc_packed(bt, al, pk, sv, 1))
        words = convert.words_forward(wd, cn).contiguous()
        if not torch.equal(rans_vmem.rans16_dec_packed(
                st, words, pk, al, sv, N, 1), bt):
            fail(f"rans16_dec_packed did not return the shift-{sv} group")
        shape2 = f"B={bt.shape[0]} N={N} A={A} order=1 shift={sv}"
        e_enc["rans_pallas"].update(second_shape=shape2, second_ms=ms2)
        e_dec["second_shape"] = shape2
        e_dec["second_ms"] = cuda_ms(lambda: rans_vmem.rans16_dec_packed(
            st, words, pk, al, sv, N, 1))
    return [e_dec]


PLAIN_CUT = 8192     # byte (event) indices the range-coder plain versions run


def bytes_err(got, want) -> int:
    """Max abs difference of two coders' (bytes, counts), the bytes
    compared up to each block's count."""
    (by, cn), (by2, cn2) = got, want
    live = torch.arange(by.shape[1], device=DEV)[None, :] < cn[:, None]
    return max(max_abs_diff(cn, cn2), max_abs_diff(by, by2, live))


def kernel_times_arith(blocks, order, launches):
    """arith_enc and arith_dec at the shape the main path gave them.
    The plain versions would take most of a minute each at N = 65536:
    kernel and plain version are held against each other at the main
    path's B with N cut to PLAIN_CUT, and ``plain_ms`` is the plain
    version's time at that N (``plain_shape`` says so); at the full
    shape the check is the round trip here and the host coder's bytes
    in the main path."""
    B, N = blocks.shape
    ms_np = blocks.max(axis=1).astype(np.int32) + 1
    M = int(ms_np.max())
    bt = torch.from_numpy(blocks).to(DEV)
    mt = torch.from_numpy(ms_np).to(DEV)
    lt = torch.full((B,), N, dtype=torch.int32, device=DEV)
    shape = f"B={B} N={N} M={M} order={order}"
    plain = {}

    by, cn = arith_vmem.arith_enc(bt, lt, mt, M, order)
    ms_enc = cuda_ms(lambda: arith_vmem.arith_enc(bt, lt, mt, M, order))
    nbytes = int(cn.sum())
    stream = by[:, :max(int(cn.max()), 1)].contiguous()
    del by
    out = arith_vmem.arith_dec(stream, cn, lt, mt, M, N, order)
    ms_dec = cuda_ms(lambda: arith_vmem.arith_dec(stream, cn, lt, mt, M, N,
                                                  order))
    err_dec = max_abs_diff(out, bt)
    del out, stream

    # kernel against plain version at N cut to PLAIN_CUT
    Nc = min(N, PLAIN_CUT)
    bc = bt[:, :Nc].contiguous()
    lc = torch.full((B,), Nc, dtype=torch.int32, device=DEV)
    enc_c = arith_vmem.arith_enc(bc, lc, mt, M, order)
    pl_enc = once(lambda: plain.update(enc=arith_vmem._arith_enc_plain(
        bc, lc, mt, M, order)))
    err_enc = bytes_err(enc_c, plain.pop("enc"))
    sc = enc_c[0][:, :max(int(enc_c[1].max()), 1)].contiguous()
    out_c = arith_vmem.arith_dec(sc, enc_c[1], lc, mt, M, Nc, order)
    pl_dec = once(lambda: plain.update(dec=arith_vmem._arith_dec_plain(
        sc, enc_c[1], lc, mt, M, Nc, order)))
    err_dec = max(err_dec, max_abs_diff(out_c, plain.pop("dec")),
                  max_abs_diff(out_c, bc))

    # bytes: the blocks, lengths and max-symbol counts in, the emitted
    # bytes and the counts out (decode: the reverse); the models are
    # scratch.  Integer operations per byte: a 32-bit divide (~20, as in
    # the rANS encoders' count), the multiply-add and carry test (4), the
    # first model entry (6), two shift tests and a byte store (8), the
    # model update (8); decode has a second divide.
    io = B * N + nbytes + B * 12
    ref = "htscodecs_tpu/ops/arith_vmem.py"
    entries = [
        entry("arith_enc", "arith_enc.cu", f"{ref}:310", shape, launches,
              ms_enc, pl_enc, err_enc, io, 46 * B * N, None),
        entry("arith_dec", "arith_dec.cu", f"{ref}:509", shape, launches,
              ms_dec, pl_dec, err_dec, io, 66 * B * N, None)]
    for e in entries:
        e["plain_shape"] = f"B={B} N={Nc} M={M} order={order}"
    return entries


def arith_inputs(blocks, order):
    """The arith_dec inputs of a main-path batch: (stream, counts,
    lens, max_syms, M), the stream from arith_enc."""
    B, N = blocks.shape
    ms_np = blocks.max(axis=1).astype(np.int32) + 1
    M = int(ms_np.max())
    bt = torch.from_numpy(blocks).to(DEV)
    mt = torch.from_numpy(ms_np).to(DEV)
    lt = torch.full((B,), N, dtype=torch.int32, device=DEV)
    by, cn = arith_vmem.arith_enc(bt, lt, mt, M, order)
    return by[:, :max(int(cn.max()), 1)].contiguous(), cn, lt, mt, M


def contexts_per_block(blocks):
    """Distinct order-1 contexts of each block: 0 and every byte but the
    last."""
    bt = torch.from_numpy(blocks[:, :-1]).to(DEV).to(torch.int64)
    seen = torch.zeros((bt.shape[0], 256), dtype=torch.int32, device=DEV)
    seen.scatter_(1, bt, 1)
    seen[:, 0] = 1
    return seen.sum(dim=1).cpu().numpy()


def arith_dec_report(batches):
    """arith_dec at each main-path shape: ms, the default pool and the
    blocks whose contexts overflow it (order 1)."""
    rep = {}
    for name, blocks, order in batches:
        B, N = blocks.shape
        stream, cn, lt, mt, M = arith_inputs(blocks, order)
        ms = cuda_ms(lambda: arith_vmem.arith_dec(stream, cn, lt, mt, M, N,
                                                  order))
        tpb = arith_vmem.threads_per_cta(B, DEV)
        e = {"shape": f"B={B} N={N} M={M} order={order}", "ms": ms,
             "threads": tpb}
        if order:
            pool = arith_vmem.default_pool(M, B, tpb, DEV)
            ctx = contexts_per_block(blocks)
            e.update(pool=pool, max_contexts=int(ctx.max()),
                     blocks_over_pool=int((ctx > pool).sum()))
        rep[name] = e
        log(f"arith_dec {name}: {e}")
    return rep


def arith_launch_sweep(batches):
    """The launch shapes of the arith kernels at the main paths' shapes:
    arith_enc by blocks per warp (what ``arith_vmem.blocks_per_warp``
    chooses from); on the synth4 batches, arith_dec by threads per CTA (one block per thread: what
    ``arith_vmem.threads_per_cta`` chooses from) and, at order 1, by pool
    size (the default, 5 rows: just synth4's contexts, and M: the whole
    bank in shared memory, fewer blocks per SM), where a CTA's shared
    memory allows it."""
    props = torch.cuda.get_device_properties(DEV)
    limit = props.shared_memory_per_multiprocessor - 1024
    sweep = {}
    for name, blocks, order in batches:
        B, N = blocks.shape
        stream, cn, lt, mt, M = arith_inputs(blocks, order)
        bt = torch.from_numpy(blocks).to(DEV)
        sweep[f"{name} enc chosen per_warp"] = arith_vmem.blocks_per_warp(
            B, props.multi_processor_count)
        for g in (1, 2, 4, 8, 16, 32):
            sweep[f"{name} enc per_warp{g}"] = cuda_ms(
                lambda: arith_vmem.arith_enc(bt, lt, mt, M, order,
                                             per_warp=g), reps=3)
        if not name.startswith("synth4"):
            continue
        sweep[f"{name} dec chosen threads"] = arith_vmem.threads_per_cta(
            B, DEV)
        for tpb in (1, 2, 4, 8, 16, 32):
            pools = {"default": arith_vmem.default_pool(M, B, tpb, DEV),
                     "5": 5, "M": M} if order else {"-": 0}
            for pname, pool in pools.items():
                if tpb * arith_vmem._model_words(M, order, pool) * 4 > limit:
                    continue
                sweep[f"{name} dec threads{tpb} pool{pname}"] = [
                    pool, cuda_ms(lambda: arith_vmem.arith_dec(
                        stream, cn, lt, mt, M, N, order, threads=tpb,
                        pool=pool), reps=3)]
    return sweep


def rans8_tables(blocks, order):
    """The dense 4x8 tables that the batch layer builds for a main-path
    batch: numpy (alpha (B,A) u8, packed (B,A,A) or (B,A) i32)."""
    res = batch.pool_map(lambda b: native.r8_build_tables_dense(b, order),
                      list(blocks))
    if order:
        alpha, packed, _A = rans_v2.densify_builds((r[1], r[2]) for r in res)
        return alpha, packed
    return batch._r8_dense_o0(res)


def rans8_inputs(blocks, order):
    """The rans8_dec inputs of a main-path batch: (states, stream,
    counts, tables), the stream from rans8_enc."""
    alpha, packed = rans8_tables(blocks, order)
    bt = torch.from_numpy(blocks).to(DEV)
    st, by, cn = rans8_vmem.enc_batch(bt, alpha, packed, order)
    return (st, convert.words_forward(by, cn).contiguous(), cn,
            convert.tables8_from_reference(alpha, packed, DEV))


def dec_sweep(batches):
    """The 4x16 decoder's base-row entry (on the encoder's streams and
    the device-table route's tables) and rans8_dec, at the main paths'
    shapes, by threads per CTA (32, 64, 128: what ``DEC_THREADS`` of
    ops/rans_vmem.py and ops/rans8_vmem.py is chosen from; with whether
    the tables go to shared memory) and, at the default CTA, through the
    global-table route: ms."""
    sweep = {"rans16_dec chosen threads": rans_vmem.DEC_THREADS,
             "rans8_dec chosen threads": rans8_vmem.DEC_THREADS}
    for name, blocks, order in batches:
        B, N = blocks.shape
        alpha, packed, shift, A = device_tables(blocks, order)
        bt = torch.from_numpy(blocks).to(DEV)
        st, wd, cn = rans_vmem.rans16_enc_packed(bt, alpha, packed, shift,
                                                 order)
        words = convert.words_forward(wd, cn).contiguous()
        del wd
        tables = convert.tables_from_packed(alpha, packed.view(
            (B, A, A) if order else (B, A)), shift)
        for t in (32, 64, 128):
            sweep[f"rans16_dec {name} A={A} threads{t}"] = [
                rans_vmem.dec_tables_in_smem(t, A, order),
                cuda_ms(lambda: rans_vmem.rans16_dec(
                    st, words, cn, tables, N, order, threads=t), reps=3)]
        sweep[f"rans16_dec {name} A={A} global tables"] = cuda_ms(
            lambda: rans_vmem.rans16_dec(st, words, cn, tables, N, order,
                                         global_tables=True), reps=3)
        del st, words, cn, tables, bt
        st, stream, cn, tables = rans8_inputs(blocks, order)
        A = tables.alpha.shape[1]
        for t in (32, 64, 128):
            sweep[f"rans8_dec {name} A={A} threads{t}"] = [
                rans8_vmem.tables_in_smem(t, A, order),
                cuda_ms(lambda: rans8_vmem.rans8_dec(
                    st, stream, cn, tables, N, order, threads=t), reps=3)]
        sweep[f"rans8_dec {name} A={A} global tables"] = cuda_ms(
            lambda: rans8_vmem.rans8_dec(st, stream, cn, tables, N, order,
                                         global_tables=True), reps=3)
        del st, stream, cn, tables
    return sweep


def kernel_times_rc(jobs, launches):
    """rc_enc at the shape the fqz main path gave it: the triples of
    all jobs, replayed once more on the host.  Kernel and plain version
    are held against each other on the first PLAIN_CUT events of each
    job; at the full shape the check is the host coder's bytes in the
    main path."""
    parts = batch.pool_map(lambda j: fqz._replay_job(j, 4), jobs)
    if any(p is None for p in parts):
        fail("fqz_enc_replay refused a job of the main path")
    acc, f, tot, cn = convert.triples_from_reference(
        [p[1] for p in parts], DEV)
    del parts
    B, Kp = acc.shape
    plain = {}
    _by, nb = rc_vmem.rc_enc(acc, f, tot, cn)
    ms_rc = cuda_ms(lambda: rc_vmem.rc_enc(acc, f, tot, cn))
    nev, nbytes = int(cn.sum()), int(nb.sum())
    del _by

    Kc = min(Kp, PLAIN_CUT)
    ac, fc, tc = (x[:, :Kc].contiguous() for x in (acc, f, tot))
    cc = cn.clamp(max=Kc)
    enc_c = rc_vmem.rc_enc(ac, fc, tc, cc)
    pl_rc = once(lambda: plain.update(rc=rc_vmem._rc_enc_plain(ac, fc, tc, cc)))
    err = bytes_err(enc_c, plain.pop("rc"))
    # 6 bytes per event and the counts in, the emitted bytes and counts
    # out; per event a divide (~20), multiply-add and carry test (4), two
    # shift tests and a byte store (8)
    e = entry("rc_enc", "rc_enc.cu", "htscodecs_tpu/ops/rc_vmem.py:202",
              f"B={B} events={Kp}", launches, ms_rc, pl_rc, err,
              6 * nev + nbytes + 8 * B, 32 * nev, None)
    e["plain_shape"] = f"B={B} events={Kc}"
    return [e]


def load_parent(path):
    """The port's package of another checkout (the parent commit's,
    unpacked with ``git archive``), imported as ``parent_port`` with its
    own kernel library: (its arith_vmem, its rc_vmem, its rans8_vmem,
    its rans_vmem, its rans_pallas, its convert)."""
    import importlib
    import importlib.util
    root = Path(path).resolve() / "htscodecs_tpu_torch"
    if not (root / "__init__.py").exists():
        fail(f"--ab: no htscodecs_tpu_torch package under {path}")
    spec = importlib.util.spec_from_file_location(
        "parent_port", root / "__init__.py",
        submodule_search_locations=[str(root)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"parent_port.ops.{m}") for m in (
        "arith_vmem", "rc_vmem", "rans8_vmem", "rans_vmem", "rans_pallas",
        "convert"))


def in_turns(runs, reps=5):
    """Median ms of each of two runs, timed parent, change, change,
    parent."""
    ts = {k: [] for k in runs}
    for k in ("parent", "change", "change", "parent"):
        ts[k].append(cuda_ms(runs[k], reps=reps))
    return {k: statistics.median(v) for k, v in ts.items()}


def ab_4x16(par, name, blocks, order, res) -> None:
    """The 4x16 encoder and both decoder entries of this checkout against
    the parent's 4x16 encoders (its whole ``rans_vmem.enc_batch``, where
    it has one, and its ``rans16_enc_packed``) and decoders
    (``rans16_dec``, ``rans16_dec_packed``) on the largest shift group of
    the device-table route's tables for ``blocks``: outputs equal, times
    in turns."""
    par_vmem, par_pallas, par_convert = par
    alpha, packed, shift, A = device_tables(blocks, order)
    sh = shift.cpu().numpy()
    vals, cnts = np.unique(sh, return_counts=True)
    sv = int(vals[cnts.argmax()])
    selt = torch.from_numpy(np.flatnonzero(sh == sv)).to(DEV)
    bt = torch.from_numpy(blocks).to(DEV)[selt].contiguous()
    al, pk = alpha[selt].contiguous(), packed[selt].contiguous()
    B, N = bt.shape
    svt = torch.full((B,), sv, dtype=torch.int32, device=DEV)
    pk3 = pk.view((B, A, A) if order else (B, A))
    tables = convert.tables_from_packed(al, pk3, svt)
    par_tables = par_convert.tables_from_packed(al, pk3, svt)
    tag = f"{name} B={B} A={A} shift={sv}"
    st, wd, cn = rans_vmem.rans16_enc_packed(bt, al, pk, svt, order)
    words = convert.words_forward(wd, cn).contiguous()
    enc_runs = {"packed": lambda: par_pallas.rans16_enc_packed(bt, al, pk, sv,
                                                               order)}
    if hasattr(par_vmem, "enc_batch"):
        enc_runs["pfv"] = lambda: par_vmem.enc_batch(bt, par_tables, order)
    for k, fn in enc_runs.items():
        # the parent's words start each row (before this PR) or end it
        pst, pwd, pcn = fn()
        W = words.shape[1]
        left = pwd.shape[1] >= W and same_live(pwd[:, :W], words, cn)
        right = pwd.shape == wd.shape and same_suffix(pwd, wd, cn)
        ok = torch.equal(pst, st) and torch.equal(pcn, cn) and (left or right)
        if not ok:
            fail(f"--ab: the parent's 4x16 encoder ({k}) and the change's "
                 f"differ on {tag}")
        res[f"rans16_enc_packed vs parent {k} {tag}"] = in_turns({
            "parent": fn,
            "change": lambda: rans_vmem.rans16_enc_packed(bt, al, pk, svt,
                                                          order)})
    dec_runs = {
        "rans16_dec": (lambda: par_vmem.rans16_dec(st, words, cn, par_tables,
                                                   N, order),
                       lambda: rans_vmem.rans16_dec(st, words, cn, tables, N,
                                                    order)),
        "rans16_dec_packed": (
            lambda: par_pallas.rans16_dec_packed(st, words, pk, al, sv, N,
                                                 order),
            lambda: rans_vmem.rans16_dec_packed(st, words, pk, al, sv, N,
                                                order))}
    for k, (pfn, cfn) in dec_runs.items():
        if not (torch.equal(pfn(), bt) and torch.equal(cfn(), bt)):
            fail(f"--ab: {k} of the parent or of the change did not decode "
                 f"{tag}")
        res[f"{k} {tag}"] = in_turns({"parent": pfn, "change": cfn})
    log(f"A/B 4x16 {tag}: " + "; ".join(
        f"{k} {v}" for k, v in res.items() if tag in k))


def same_enc8(par_out, out) -> bool:
    """The parent's 4x8 encoder output (each stream at the start of its
    row, before this layout changed, or at the end) equals this
    checkout's (at the end)."""
    (pst, pby, pcn), (st, by, cn) = par_out, out
    if not (torch.equal(pst, st) and torch.equal(pcn, cn)):
        return False
    fwd = convert.words_forward(by, cn)
    W = fwd.shape[1]
    return ((pby.shape == by.shape and same_suffix(pby, by, cn))
            or (pby.shape[1] >= W and same_live(pby[:, :W], fwd, cn)))


def ab_rans8_enc(par, name, blocks, order, res) -> None:
    """rans8_enc of this checkout against the parent's rans8_enc kernel
    (on the inputs its contract takes, made once) and against the
    parent's whole ``rans8_vmem.enc_batch`` (tables conversion, inputs,
    kernel), on the tables the 4x8 main path builds: outputs equal,
    times in turns."""
    par_r8, par_vmem, par_convert = par
    alpha, packed = rans8_tables(blocks, order)
    B, N = blocks.shape
    A = alpha.shape[1]
    bt = torch.from_numpy(blocks).to(DEV)
    al = torch.from_numpy(alpha).to(DEV)
    pk = r8_packed(packed)
    out = rans8_vmem.rans8_enc(bt, al, pk, order)
    if hasattr(par_vmem, "enc_inputs"):       # the parent's old contract
        ptab = par_convert.tables8_from_reference(alpha, packed, DEV)
        sym, ctx, K, geom = par_vmem.enc_inputs(bt, ptab, order)
        runs = {"kernel": lambda: par_r8.rans8_enc(sym, ctx, ptab, K, geom,
                                                   order),
                "enc_batch": lambda: par_r8.enc_batch(
                    bt, par_convert.tables8_from_reference(alpha, packed,
                                                           DEV), order)}
    else:
        runs = {"kernel": lambda: par_r8.rans8_enc(bt, al, pk, order),
                "enc_batch": lambda: par_r8.enc_batch(bt, alpha, packed,
                                                      order)}
    mine = {"kernel": lambda: rans8_vmem.rans8_enc(bt, al, pk, order),
            "enc_batch": lambda: rans8_vmem.enc_batch(bt, alpha, packed,
                                                      order)}
    tag = f"{name} B={B} A={A}"
    for k, fn in runs.items():
        if not same_enc8(fn(), out):
            fail(f"--ab: the parent's rans8_enc ({k}) and the change's "
                 f"differ on {tag}")
        res[f"rans8_enc vs parent {k} {tag}"] = in_turns(
            {"parent": fn, "change": mine[k]})
    log(f"A/B rans8_enc {tag}: " + "; ".join(
        f"{k} {v}" for k, v in res.items() if k.startswith("rans8_enc")
        and tag in k))


def ab_run(parent: str, B: int) -> None:
    """arith_enc, arith_dec, rans8_enc, rans8_dec, rc_enc and the 4x16
    encoder and decoder of this checkout against those of the checkout at
    ``parent``, on the main paths' inputs, in one process on one card:
    outputs must be equal, times in turns."""
    par_arith, par_rc, par_r8, *par_4x16 = load_parent(parent)
    N = 65536
    q4 = testdata.synth_quality(B, N, seed=42)
    wide = testdata.synth_wide(max(B // 4, 1), N, 40, seed=9)
    res = {}
    for name, blocks, order in (("synth4 order 1", q4, 1),
                                ("synth4 order 0", q4, 0),
                                ("wide41 order 1", wide, 1)):
        Bb = blocks.shape[0]
        want = torch.from_numpy(blocks).to(DEV)
        ms_np = blocks.max(axis=1).astype(np.int32) + 1
        M = int(ms_np.max())
        mt = torch.from_numpy(ms_np).to(DEV)
        lt = torch.full((Bb,), N, dtype=torch.int32, device=DEV)
        runs = {"parent": lambda: par_arith.arith_enc(want, lt, mt, M, order),
                "change": lambda: arith_vmem.arith_enc(want, lt, mt, M, order)}
        if not same_bytes(runs["parent"](), runs["change"]()):
            fail(f"--ab: arith_enc of the parent and of the change differ "
                 f"on {name}")
        res[f"arith_enc {name}"] = in_turns(runs)

        stream, cn, lt, mt, M = arith_inputs(blocks, order)
        runs = {"parent": lambda: par_arith.arith_dec(stream, cn, lt, mt, M,
                                                      N, order),
                "change": lambda: arith_vmem.arith_dec(stream, cn, lt, mt, M,
                                                       N, order)}
        for k, fn in runs.items():
            if not torch.equal(fn(), want):
                fail(f"--ab: arith_dec of the {k} did not decode {name}")
        res[f"arith_dec {name}"] = in_turns(runs)
        del stream

        st, s8, cn8, tables = rans8_inputs(blocks, order)
        runs = {"parent": lambda: par_r8.rans8_dec(st, s8, cn8, tables, N,
                                                   order),
                "change": lambda: rans8_vmem.rans8_dec(st, s8, cn8, tables, N,
                                                       order)}
        for k, fn in runs.items():
            if not torch.equal(fn(), want):
                fail(f"--ab: rans8_dec of the {k} did not decode {name}")
        res[f"rans8_dec {name}"] = in_turns(runs)
        del st, s8, cn8, tables, want
        ab_rans8_enc((par_r8, par_4x16[0], par_4x16[2]), name, blocks, order,
                     res)
        ab_4x16(par_4x16, name, blocks, order, res)
        log(f"A/B {name} B={Bb}: " + "; ".join(
            f"{k} {res[f'{k} {name}']}"
            for k in ("arith_enc", "arith_dec", "rans8_dec")))
    # the 4x16 kernels at the order-9 stripe lanes (16384 x 16 KiB at
    # --blocks 4096), the decoder's largest launches
    lanes = stripe_lanes(q4)
    for order in (1, 0):
        ab_4x16(par_4x16, f"stripe lanes order {order}", lanes, order, res)
    del q4, wide, lanes
    # the read cell's shape, each tree's default launch
    bt, st, s8, cn8, tables = cell_inputs(8)
    runs = {"parent": lambda: par_r8.rans8_dec(st, s8, cn8, tables,
                                               bt.shape[1], 1),
            "change": lambda: rans8_vmem.rans8_dec(st, s8, cn8, tables,
                                                   bt.shape[1], 1)}
    for k, fn in runs.items():
        if not torch.equal(fn(), bt):
            fail(f"--ab: rans8_dec of the {k} did not decode the read cell's "
                 "blocks")
    res["rans8_dec read cell 16 x 1510000"] = in_turns(runs, reps=3)
    log(f"A/B rans8_dec read cell: {res['rans8_dec read cell 16 x 1510000']}")
    del bt, st, s8, cn8, tables
    # the 4x16 read cell's shape, each tree's default launch of rans16_dec
    par_vmem, _par_pallas, par_convert = par_4x16
    bt, st, words, cn, alpha, packed, shift, _A = cell16_inputs()
    N16 = bt.shape[1]
    tables = convert.tables_from_packed(alpha, packed, shift)
    par_tables = par_convert.tables_from_packed(alpha, packed, shift)
    runs = {"parent": lambda: par_vmem.rans16_dec(st, words, cn, par_tables,
                                                  N16, 1),
            "change": lambda: rans_vmem.rans16_dec(st, words, cn, tables,
                                                   N16, 1)}
    for k, fn in runs.items():
        if not torch.equal(fn(), bt):
            fail(f"--ab: rans16_dec of the {k} did not decode the 4x16 read "
                 "cell's blocks")
    res["rans16_dec read cell 16 x 1510000"] = in_turns(runs, reps=3)
    log(f"A/B rans16_dec read cell: "
        f"{res['rans16_dec read cell 16 x 1510000']}")
    del bt, st, words, cn, tables, par_tables
    jobs = testdata.synth_fqz_jobs(max(B * 3 // 64, 2), 10000, 150, seed=42)
    parts = batch.pool_map(lambda j: fqz._replay_job(j, 4), jobs)
    acc, f, tot, cn = convert.triples_from_reference([p[1] for p in parts],
                                                     DEV)
    del parts, jobs
    runs = {"parent": lambda: par_rc.rc_enc(acc, f, tot, cn),
            "change": lambda: rc_vmem.rc_enc(acc, f, tot, cn)}
    if bytes_err(runs["parent"](), runs["change"]()):
        fail("--ab: rc_enc of the parent and of the change differ")
    res["rc_enc fqz"] = in_turns(runs)
    log(f"A/B rc_enc fqz B={acc.shape[0]} events={acc.shape[1]}: "
        f"{res['rc_enc fqz']}")
    print(json.dumps({"ab_ms": res}), flush=True)


# ---------------------------------------------------------------------------
# the parallel/ layer: the stream encoder, the round-trip step and the
# block-sharded codecs

STREAM_B = 512          # blocks per submitted slice of synth4
WIDE_STREAM_B = 256     # blocks per slice of wide41


def slices(blocks, per):
    return [blocks[i:i + per] for i in range(0, len(blocks), per)]


def run_stream(batches, order, depth, hdr="auto", assemble=True):
    """One StreamEncoder over the batches, the launch counts set to 0
    just before and read just after: (outputs per batch, host wall s
    ending in a synchronise, launches, header-transport bytes)."""
    rans_vmem.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = streaming.StreamEncoder(order=order, depth=depth, hdr=hdr,
                                  assemble=assemble, device=DEV)
    outs = []
    for bt in batches:
        enc.submit(bt)
        outs += enc.drain_ready()
    outs += enc.finish()
    torch.cuda.synchronize()
    return (outs, time.perf_counter() - t0, dict(rans_vmem.LAUNCHES),
            dict(enc.hdr_bytes))


def streams_from_tuple(res, blocks):
    """An ``assemble=False`` result -> framed streams, as the stream
    encoder assembles them (flagged blocks through the host coder)."""
    hdrs, states, words, counts, flag, _shift = res
    st = states.cpu().numpy().view(np.uint32)
    wd = words.cpu().numpy().view(np.uint16)
    bodies = batch._join_bodies(hdrs, st, wd, counts)
    N = blocks.shape[1]
    return [batch.frame(
        1, N, rans4x16._compress_o1(blocks[b]) if flag[b] else bodies[b],
        blocks[b]) for b in range(len(bodies))]


def stream_case(name, batches, want, order, depth, hdr="auto", staged=None):
    """Drive one stream configuration; every stream must equal
    ``want`` (the batch entry's), the one 4x16 encoder (at order 1 with
    the two counting kernels) must launch once per batch and no other
    kernel.  Returns its report row."""
    B = sum(len(b) for b in batches)
    N = batches[0].shape[1]
    outs, wall, launches, hdr_bytes = run_stream(
        staged if staged is not None else batches, order, depth, hdr,
        assemble=staged is None)
    if staged is not None:
        outs = [streams_from_tuple(r, b) for r, b in zip(outs, batches)]
    got = [s for out in outs for s in out]
    if len(got) != B or got != want:
        bad = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                   len(got))
        fail(f"stream {name}: stream {bad} differs from compress_blocks'")
    per_batch = ("rans16_enc_packed",) + (TABLES_O1 if order == 1 else ())
    for k, v in launches.items():
        if v != (len(batches) if k in per_batch else 0):
            fail(f"stream {name}: kernel {k} launched {v} times for "
                 f"{len(batches)} batches")
    row = {"B": B, "N": N, "batch": len(batches[0]), "order": order,
           "depth": depth, "hdr": hdr, "prestaged": staged is not None,
           "wall_s": wall, "MBps": B * N / 1e6 / wall, "launches": launches,
           "hdr_d2h_bytes_per_batch": {
               k: v / len(batches) for k, v in hdr_bytes.items() if v}}
    log(f"stream {name}: {row}")
    return row


def serial_loop(batches, want, order):
    """The same batches through a serial loop of compress_blocks."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = [s for bt in batches
           for s in batch.compress_blocks(bt, order=order)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if got != want:
        fail("serial compress_blocks loop: streams differ")
    B, N = sum(len(b) for b in batches), batches[0].shape[1]
    return {"wall_s": wall, "MBps": B * N / 1e6 / wall}


def run_stream_paths(q4, streams1, streams0, wide, streams_w):
    """The stream encoder on synth4 (order 1 at depths 1-3, both header
    transports, order 0, pre-staged CUDA input) and wide41 (s12 by
    "auto", and u16), each against the batch entry's streams, and the
    serial loop of compress_blocks over the same slices."""
    res = {}
    q4b = slices(q4, STREAM_B)
    for depth in (1, 2, 3):
        res[f"synth4 o1 depth{depth}"] = stream_case(
            f"synth4 order 1 depth {depth}", q4b, streams1, 1, depth)
    t = time.perf_counter()
    for b in np.linspace(0, len(q4) - 1, min(256, len(q4))).astype(int):
        if streams1[b] != rans4x16.compress(q4[b], 1):
            fail(f"stream synth4: stream {b} differs from the host coder's")
    log(f"stream synth4: 256 sampled streams equal rans4x16.compress "
        f"({time.perf_counter() - t:.1f} s)")
    for hdr in ("u16", "s12"):
        res[f"synth4 o1 depth2 {hdr}"] = stream_case(
            f"synth4 order 1 depth 2 hdr={hdr}", q4b, streams1, 1, 2, hdr)
    res["synth4 o0 depth2"] = stream_case(
        "synth4 order 0 depth 2", q4b, streams0, 0, 2)
    q4_d = torch.from_numpy(q4).to(DEV)
    res["synth4 o1 depth2 prestaged"] = stream_case(
        "synth4 order 1 depth 2 pre-staged", q4b, streams1, 1, 2,
        staged=slices(q4_d, STREAM_B))
    del q4_d
    res["synth4 o1 serial compress_blocks"] = serial_loop(q4b, streams1, 1)
    wb = slices(wide, WIDE_STREAM_B)
    for hdr in ("auto", "u16"):
        row = stream_case(f"wide41 order 1 depth 2 hdr={hdr}", wb, streams_w,
                          1, 2, hdr)
        if hdr == "auto" and set(row["hdr_d2h_bytes_per_batch"]) != {"s12"}:
            fail("stream wide41: hdr='auto' did not pick s12")
        res[f"wide41 o1 depth2 {hdr}"] = row
    res["wide41 o1 serial compress_blocks"] = serial_loop(wb, streams_w, 1)
    # where a slice's host time goes (the encoder's own functions)
    profile_call("stream encoder synth4 order 1 depth 2", run_stream, q4b,
                 1, 2)
    return res


def payload_bytes(streams, headers, N):
    """Bytes after the wrapper framing and the table header."""
    head = 1 + len(varint_bytes(N))
    return sum(len(s) - head - len(h) for s, h in zip(streams, headers))


def varint_bytes(n):
    b = bytearray()
    varint.put_uint(b, n)
    return bytes(b)


def run_roundtrip_step(q4, streams1):
    """pipeline.roundtrip_o1_v2 on synth4 order 1 with host-built dense
    tables, one call per shift group (the step takes one shift):
    mismatches 0, payload bytes equal to compress_blocks' streams', one
    encoder and one packed-decoder launch per call; device ms of the
    largest group by CUDA events; the same group split over
    [cuda:0, cuda:0]; the v1 oracle step at 64 x 4 KiB."""
    B, N = q4.shape
    t = time.perf_counter()
    res = batch.pool_map(native.build_tables_o1_dense, list(q4))
    shifts = np.array([r[3] for r in res])
    log(f"roundtrip step: host tables of {B} blocks in "
        f"{time.perf_counter() - t:.1f} s, shifts {np.unique(shifts).tolist()}")
    out = {"B": B, "N": N, "groups": []}
    for sh in np.unique(shifts):
        idx = np.flatnonzero(shifts == sh)
        alpha, packed, _A = rans_v2.densify_builds(
            (res[i][1], res[i][2]) for i in idx)
        want = payload_bytes([streams1[i] for i in idx],
                             [res[i][0] for i in idx], N)
        bt, al, pk = pipeline._on(DEV, q4[idx], alpha, packed)
        rans_vmem.reset_launches()
        mism, nbytes = pipeline.roundtrip_o1_v2(bt, al, pk, int(sh), N,
                                                device=DEV)
        launches = dict(rans_vmem.LAUNCHES)
        if mism or nbytes != want:
            fail(f"roundtrip_o1_v2 shift {sh}: {mism} mismatches, {nbytes} "
                 f"bytes against {want}")
        for k, v in launches.items():
            if v != (1 if k in ("rans16_enc_packed", "rans16_dec_packed")
                     else 0):
                fail(f"roundtrip_o1_v2: kernel {k} launched {v} times")
        ms = cuda_ms(lambda: pipeline._roundtrip_o1_v2(bt, al, pk, int(sh), N),
                     reps=3)
        two = pipeline.sharded_roundtrip_o1_v2([DEV, DEV], q4[idx], alpha,
                                               packed, int(sh), N)
        if two != (0, want):
            fail(f"sharded_roundtrip_o1_v2 shift {sh}: {two}, want (0, {want})")
        out["groups"].append({"shift": int(sh), "blocks": len(idx),
                              "mismatches": mism, "payload_bytes": nbytes,
                              "device_ms": ms, "launches": launches,
                              "sharded_2x_cuda0": list(two)})
        del bt, al, pk
    log(f"roundtrip_o1_v2: {out}")
    v1 = testdata.synth_quality(64, 4096, seed=7)
    st, fr, sh1, hdrs = pipeline.build_o1_tables(v1)
    keep = np.flatnonzero(sh1 == np.bincount(sh1).argmax())
    v1, st, fr, hdrs = v1[keep], st[keep], fr[keep], [hdrs[i] for i in keep]
    shift = int(sh1[keep[0]])
    st_p, fr_p, va_p, K, q = pipeline.build_o1_batch_inputs(v1, st, fr, shift)
    torch.cuda.synchronize()
    t = time.perf_counter()
    mism, nbytes = pipeline.roundtrip_o1(st_p, fr_p, va_p, fr, st, v1, shift,
                                         K, q, v1.shape[1], device=DEV)
    wall = time.perf_counter() - t
    want = sum(len(native.enc_o1(b)) - len(h) for b, h in zip(v1, hdrs))
    if mism or nbytes != want:
        fail(f"roundtrip_o1 (v1): {mism} mismatches, {nbytes} bytes against "
             f"{want}")
    out["v1"] = {"B": len(v1), "N": v1.shape[1], "shift": shift,
                 "mismatches": mism, "payload_bytes": nbytes, "wall_s": wall}
    log(f"roundtrip_o1 (v1 oracle): {out['v1']}")
    return out


DIST_RANKS = 2


def dist_blocks(rank, B):
    return testdata.synth_quality(B, 65536, seed=1000 + rank)


def dist_worker(rank, rdv, B) -> None:
    """One rank of the distributed phase: every entry of
    parallel/distributed on its own synth4 blocks, each against the
    single-process batch entry (streams byte for byte, every block
    round-trips), launches counted per entry; prints one DIST_RESULT
    line."""
    if not distributed.init_distributed(
            f"file://{Path(rdv) / 'rendezvous'}", DIST_RANKS, rank):
        fail("init_distributed did not start a group")
    mesh = distributed.local_mesh()
    blocks = dist_blocks(rank, B)
    rep = {"rank": rank, "mesh": [str(d) for d in mesh], "B": B}

    def entry(name, enc, dec, want_enc, data):
        rans_vmem.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams = enc(data)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        back = dec(streams)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = {k: v for k, v in rans_vmem.LAUNCHES.items() if v}
        if streams != want_enc(data):
            fail(f"rank {rank} {name}: streams differ from the "
                 "single-process entry's")
        if back != [b.tobytes() for b in data]:
            fail(f"rank {rank} {name}: a block did not round-trip")
        rep[name] = {"blocks": len(data), "compress_s": t1 - t0,
                     "uncompress_s": t2 - t1, "launches": launches}
        return streams

    s1 = entry("compress_blocks_o1", distributed.compress_blocks_o1,
               distributed.uncompress_blocks_o1,
               lambda d: batch.compress_blocks(d, order=1), blocks)
    for order, n in ((1, B), (9, B), (193, 256)):
        entry(f"compress_blocks order {order}",
              lambda d, o=order: distributed.compress_blocks(d, o),
              distributed.uncompress_blocks,
              lambda d, o=order: batch.compress_blocks(d, order=o),
              blocks[:n])
    entry("r4x8 order 1", lambda d: distributed.r4x8_compress_blocks(d, 1),
          distributed.r4x8_uncompress_blocks,
          lambda d: batch.r4x8_compress_blocks(d, order=1), blocks)
    entry("arith order 0", lambda d: distributed.arith_compress_blocks(d, 0),
          distributed.arith_uncompress_blocks,
          lambda d: batch.arith_compress_blocks(d, order=0), blocks[:512])
    mine = sum(map(len, s1))
    offs, total = distributed.archive_offsets([len(s) for s in s1])
    rep.update(off0=int(offs[0]), total=total, mine=mine)
    print("DIST_RESULT " + json.dumps(rep), flush=True)


def run_distributed_paths(B):
    """Two worker processes of this script in one gloo group (file://
    rendezvous in a temporary directory), both on cuda:0; the libraries
    are built before they start.  Fails if a worker fails, or if the
    archive offsets disagree across the ranks."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dist-worker",
             str(r), "--dist-dir", tmp, "--blocks", str(B)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(DIST_RANKS)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=420)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"distributed rank {r} exited {p.returncode}:\n{out[-3000:]}")
    reps = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("DIST_RESULT "):
                rep = json.loads(line[len("DIST_RESULT "):])
                reps[rep["rank"]] = rep
    if set(reps) != set(range(DIST_RANKS)):
        fail(f"distributed: results from ranks {sorted(reps)}")
    r0, r1 = reps[0], reps[1]
    if not (r0["off0"] == 0 and r1["off0"] == r0["mine"]
            and r0["total"] == r1["total"] == r0["mine"] + r1["mine"]):
        fail(f"archive_offsets disagree: {r0} / {r1}")
    res = {"ranks": reps, "wall_s": time.perf_counter() - t0}
    log(f"distributed paths: {res}")
    return res


# ---------------------------------------------------------------------------
# fuzz_paths: corrupt streams through every decoder kernel

class Taps:
    """While active, every launch of a decoder kernel is recorded: its
    inputs and its output.  The wrappers are replaced where their callers
    look them up at call time (``rans_v2`` calls ``rans_vmem.rans16_dec``,
    ``rans_pallas`` imported ``rans16_dec_packed`` by name, the 4x8 and
    arith batch functions call their module's own wrapper)."""

    SITES = (("rans16_dec", rans_vmem), ("rans16_dec_packed", rans_pallas),
             ("rans8_dec", rans8_vmem), ("arith_dec", arith_vmem))

    def __enter__(self):
        self.calls = []
        self._orig = {}
        for name, mod in self.SITES:
            orig = getattr(mod, name)
            self._orig[name] = (mod, orig)
            setattr(mod, name, functools.partial(self._call, name, orig))
        return self

    def _call(self, name, orig, *args, **kw):
        out = orig(*args, **kw)
        self.calls.append((name, args, out))
        return out

    def __exit__(self, *exc):
        for name, (mod, orig) in self._orig.items():
            setattr(mod, name, orig)
        return False


def plain_of(name, args):
    """The plain version's output on a recorded launch's inputs (the
    launch arguments that change no result dropped)."""
    if name == "rans16_dec":
        return rans_vmem._rans16_dec_plain(*args[:6])
    if name == "rans16_dec_packed":
        st, wd, pk, al, shift, N, order = args[:7]
        sv = rans_vmem._shift_vector(shift, st.shape[0], st.device, name)
        return rans_vmem._rans16_dec_packed_plain(st, wd, pk, al, sv, N,
                                                  order)
    if name == "rans8_dec":
        return rans8_vmem._rans8_dec_plain(*args[:6])
    return arith_vmem._arith_dec_plain(*args[:7])


POISON_PAD = 4096       # bytes of random fill on each side of an input


def poisoned(x, gen):
    """A copy of tensor x (or of each tensor of a Tables) placed in the
    middle of a buffer whose margins hold random bytes: a read past the
    input's allocation that reaches the output then shows as a change."""
    if isinstance(x, convert.Tables):
        return convert.Tables(*(poisoned(t, gen) for t in x))
    if not isinstance(x, torch.Tensor):
        return x
    es = x.element_size()
    pad = POISON_PAD // es
    n = x.numel()
    raw = torch.randint(0, 256, ((n + 2 * pad) * es,), generator=gen,
                        dtype=torch.uint8).to(x.device)
    buf = raw.view(x.dtype)
    buf[pad:pad + n].copy_(x.reshape(-1))
    return buf[pad:pad + n].view(x.shape)


def check_taps(label, taps, gen, stats, corrupt):
    """(c): each recorded launch equals its plain version (tolerance 0)
    and two reruns with poisoned margins around every input; a rans16_dec
    or rans8_dec launch also through the bisection route (at its default
    CTA), which a batch of these sizes otherwise leaves to the direct
    route."""
    torch.cuda.synchronize()
    for name, args, out in taps.calls:
        want = plain_of(name, args)
        if not torch.equal(out, want):
            err = int((out.int() - want.int()).abs().max())
            fail(f"fuzz {label}: {name} != plain (max abs err {err}) at "
                 f"B={out.shape[0]} N={out.shape[1]}")
        fn = getattr(dict(Taps.SITES)[name], name)     # the wrapper itself
        reruns = [{}, {}]
        if name == "rans8_dec":
            reruns.append(dict(threads=rans8_vmem.DEC_THREADS))
        if name == "rans16_dec":
            reruns.append(dict(threads=rans_vmem.DEC_THREADS))
        for kw in reruns:
            again = fn(*(poisoned(a, gen) for a in args), **kw)
            torch.cuda.synchronize()
            if not torch.equal(again, out):
                fail(f"fuzz {label}: {name} {kw} changed with random bytes "
                     f"around its inputs (a read past an input), or by "
                     f"route")
            stats["poisoned_reruns"] += 1
        if name in ("rans16_dec", "rans8_dec") and corrupt:
            stats[f"{name}_bisection_with_corrupt"] += 1
        stats["kernel_vs_plain_groups"][name] += 1


def _size_field_end(codec, s):
    return 9 if codec is R4X8 else varint.get_uint(s, 1, len(s))[1]


def with_claim(codec, s, osz):
    """Stream s with its size field rewritten to claim osz bytes."""
    if codec is R4X8:
        return s[:5] + int(osz).to_bytes(4, "little") + s[9:]
    head = bytearray(s[:1])
    varint.put_uint(head, int(osz))
    return bytes(head) + s[_size_field_end(codec, s):]


FUZZ_KINDS = ("flip", "store", "cut", "claim")


def corrupt_members(codec, streams, rng, claim):
    """Every third member: bit flips anywhere past the order byte and the
    size field (table headers included), a byte stored in the 32 bytes
    after the size field, a cut, or the size claim raised to ``claim``
    (the same for the batch, so that those members form one group).
    Returns (streams, {member: kind})."""
    bad, hit = list(streams), {}
    for k in range(0, len(streams), 3):
        s = bytearray(streams[k])
        h = _size_field_end(codec, s)
        kind = FUZZ_KINDS[k // 3 % len(FUZZ_KINDS)]
        if len(s) <= h + 2:
            continue
        if kind == "flip":
            for _ in range(int(rng.integers(1, 4))):
                s[int(rng.integers(h, len(s)))] ^= 1 << int(rng.integers(0, 8))
        elif kind == "store":
            s[int(rng.integers(h, min(len(s), h + 32)))] = \
                int(rng.integers(0, 256))
        elif kind == "cut":
            s = s[:int(rng.integers(h + 1, len(s)))]
        else:
            s = bytearray(with_claim(codec, bytes(s), claim))
        bad[k] = bytes(s)
        hit[k] = kind
    return bad, hit


def fuzz_batches(rnd, B, seed):
    """(label, codec, order, blocks) of one round: B blocks of 4 KiB
    (rANS) or 1 KiB (arith: its plain version steps one byte at a
    time)."""
    q = testdata.synth_quality(B, 4096, seed=seed)
    qa = testdata.synth_quality(B, 1024, seed=seed + 1)
    w = testdata.arith_blocks(B, 1024, 256, seed=seed + 2)[0]
    out = [(f"rans4x16 o{o}", R4X16, o, q) for o in (0, 1, 9, 193)]
    out += [(f"rans4x8 o{o}", R4X8, o, q) for o in (0, 1)]
    if rnd == 0:
        # an alphabet above 128: the 4x8 batch layer's dense tables stop
        # at 96, so these blocks take the host coder both ways
        out.append(("rans4x8 o1 wide150", R4X8, 1,
                    testdata.synth_wide(max(B // 8, 4), 4096, 150,
                                        seed=seed + 3)))
    out += [(f"arith o{o}", ARITH, o, qa) for o in (0, 1)]
    out.append(("arith o1 width256" if rnd == 0 else "arith o0 width256",
                ARITH, 1 - rnd, w))
    return out


HOST_DECODE = {"rans4x16": rans4x16.uncompress, "rans4x8": rans4x8.uncompress,
               "arith": arith.uncompress}


def host_accepts(codec, s) -> bool:
    try:
        HOST_DECODE[codec.name](s)
    except ValueError:
        return False
    return True


def fuzz_call(label, decode, streams, corrupt, gen, stats):
    """One entry-point call, the launch counts set to 0 before it and
    read after: (a) it returns or raises ValueError, nothing else; (c)
    every launch it made equals its plain version.  Returns the output,
    or None where it raised."""
    rans_vmem.reset_launches()
    with Taps() as taps:
        try:
            out = decode(streams)
        except ValueError:
            out = None
        except Exception as e:          # noqa: BLE001 (the contract)
            fail(f"fuzz {label}: {type(e).__name__} where a ValueError or "
                 f"bytes were due: {e}")
    launches = {k: v for k, v in rans_vmem.LAUNCHES.items() if v}
    check_taps(label, taps, gen, stats, corrupt)
    for k, v in launches.items():
        stats["launches"][k] += v
        if corrupt:
            stats["launches_with_corrupt"][k] += v
    stats["raised" if out is None else "decoded"] += 1
    return out


def fuzz_decode(label, codec, decode, bad, blocks, hit, gen, stats):
    """A batch with corrupt members through one entry point.  (b) intact
    members equal their blocks.  Where the call raised (a member the
    host coder refuses aborts it), the intact members decode alone, and
    then together with the corrupt members the host coder accepts
    (payload flips, raised claims), which so reach the kernels."""
    N = blocks.shape[1]
    stats["corrupt_members"] += len(hit)
    members = list(range(len(bad)))
    out = fuzz_call(label, decode, bad, True, gen, stats)
    if out is None:
        intact = [k for k in range(len(bad)) if k not in hit]
        alone = fuzz_call(label + " (intact alone)", decode,
                          [bad[k] for k in intact], False, gen, stats)
        if alone != [blocks[k].tobytes() for k in intact]:
            fail(f"fuzz {label}: intact members did not decode alone")
        members = sorted(intact + [k for k in hit
                                   if host_accepts(codec, bad[k])])
        out = fuzz_call(label + " (host-accepted)", decode,
                        [bad[k] for k in members], len(members) > len(intact),
                        gen, stats)
        if out is None:
            return
    for pos, k in enumerate(members):
        if k not in hit and out[pos] != blocks[k].tobytes():
            fail(f"fuzz {label}: intact member {k} differs from its block")
        if k in hit and len(out[pos]) > 4 * N:
            fail(f"fuzz {label}: member {k} decoded to {len(out[pos])} "
                 f"bytes, more than it claims")


def packed_route(o, osz, states, words, alpha, packed, shift):
    """dec_fn of uncompress_blocks: every 4x16 group through the
    rans_pallas engine, the decoder's packed entry."""
    f = rans_pallas.dec_o1_batch if o else rans_pallas.dec_o0_batch
    return f(states, words, osz, alpha, packed, shift, device=DEV)


def fuzz_tok3(rng, stats):
    """One Illumina block of 10000 names at level 9, cut, flipped and
    overwritten 48 ways, through ``tok3.decode_names`` on the card."""
    blk = testdata.synth_names(10000, "illumina", seed=5)
    s = tok3.encode_names(blk, 9, False, device=DEV)
    res = {"variants": 0, "raised": 0, "decoded": 0}
    for v in range(48):
        m = bytearray(s)
        if v % 3 == 0:
            m = m[:int(rng.integers(1, len(m)))]
        elif v % 3 == 1:
            for _ in range(int(rng.integers(1, 4))):
                m[int(rng.integers(0, len(m)))] ^= 1 << int(rng.integers(0, 8))
        else:
            m[int(rng.integers(0, min(len(m), 32)))] = int(rng.integers(0, 256))
        try:
            tok3.decode_names(bytes(m), device=DEV)
            res["decoded"] += 1
        except ValueError:
            res["raised"] += 1
        except Exception as e:          # noqa: BLE001 (the contract)
            fail(f"fuzz tok3: {type(e).__name__}: {e}")
        res["variants"] += 1
    stats["tok3"] = res


def run_fuzz_paths(scale: int = 1) -> dict:
    """Corrupt streams from the port's own encoders through every
    decoder entry on the card.  ``scale`` divides the batch sizes (the
    memcheck pass runs at a quarter)."""
    from collections import Counter
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(11)
    stats = {"rounds": 0, "batches": 0, "corrupt_members": 0, "raised": 0,
             "decoded": 0, "launches": Counter(),
             "launches_with_corrupt": Counter(),
             "kernel_vs_plain_groups": Counter(), "poisoned_reruns": 0,
             "rans16_dec_bisection_with_corrupt": 0,
             "rans8_dec_bisection_with_corrupt": 0}
    for rnd, (B, claim_x) in enumerate(((130, 4), (64, 2))):
        B = max(B // scale, 8)
        rng = np.random.default_rng(100 + rnd)
        for label, codec, order, blocks in fuzz_batches(rnd, B, 200 + rnd):
            N = blocks.shape[1]
            streams = codec.compress(blocks, order=order, engine="device",
                                     device=DEV)
            bad, hit = corrupt_members(codec, streams, rng, claim_x * N)
            label = f"round {rnd} {label} B={B}"
            fuzz_decode(label, codec, lambda x: codec.uncompress(
                x, engine="device", device=DEV), bad, blocks, hit, gen, stats)
            if codec is R4X16 and order in (0, 1):
                fuzz_decode(label + " packed entry", codec,
                            lambda x: batch.uncompress_blocks(
                                x, engine="device", device=DEV,
                                dec_fn=packed_route),
                            bad, blocks, hit, gen, stats)
            stats["batches"] += 1
        stats["rounds"] += 1
    # a 4x8 claim of 2**31 bytes on a single-member group: refused
    one = batch.r4x8_compress_blocks(testdata.synth_quality(1, 4096, seed=7),
                                     order=1, engine="device", device=DEV)
    try:
        batch.r4x8_uncompress_blocks([with_claim(R4X8, one[0], 2**31)],
                                     engine="device", device=DEV)
        fail("fuzz: a 4x8 claim of 2**31 bytes was not refused")
    except ValueError:
        stats["claim_2_31_r4x8"] = "refused (ValueError, as the host coder)"
    fuzz_tok3(np.random.default_rng(300), stats)
    torch.cuda.synchronize()            # no sticky error left behind
    for k in ("rans16_dec_direct", "rans8_dec_direct", "arith_dec"):
        if stats["launches_with_corrupt"][k] < 1:
            fail(f"fuzz: {k} never ran on a batch with corrupt members")
    for k in ("rans16_dec", "rans8_dec"):
        if (stats["launches_with_corrupt"][k]
                + stats[f"{k}_bisection_with_corrupt"]) < 1:
            fail(f"fuzz: {k}'s bisection route never ran on a batch with "
                 "corrupt members")
    stats["seconds"] = time.perf_counter() - t0
    return {k: dict(v) if isinstance(v, Counter) else v
            for k, v in stats.items()}


def sanitizer_path() -> Path:
    """compute-sanitizer beside the nvcc that cuda_build uses."""
    return Path(cuda_build._nvcc()).resolve().parent / "compute-sanitizer"


def run_memcheck_pass() -> dict:
    """The fuzz phase again at a quarter of its size, in a subprocess
    under ``compute-sanitizer --tool memcheck``: it sees reads out of
    bounds that return no error.  The sanitizer missing fails the run; a
    machine whose device it refuses ("Device not supported") is
    recorded as such."""
    cs = sanitizer_path()
    if not cs.exists():
        fail(f"fuzz: compute-sanitizer not found at {cs}")
    t0 = time.perf_counter()
    r = subprocess.run(
        [str(cs), "--tool", "memcheck", "--error-exitcode", "1",
         sys.executable, str(Path(__file__).resolve()), "--fuzz-only",
         "--fuzz-scale", "4", "--no-memcheck"],
        capture_output=True, text=True, timeout=900)
    text = r.stdout + r.stderr
    res = {"sanitizer": str(cs), "rc": r.returncode,
           "seconds": time.perf_counter() - t0}
    if "Device not supported" in text:
        res["status"] = "device not supported by compute-sanitizer"
        res["errors"] = None
        return res
    import re
    m = re.search(r"ERROR SUMMARY: (\d+) error", text)
    res["errors"] = int(m.group(1)) if m else None
    res["status"] = "ran"
    if r.returncode != 0 or res["errors"] != 0:
        print(text[-6000:], flush=True)
        fail(f"fuzz: the memcheck pass failed: {res}")
    return res


def fuzz_paths(memcheck: bool = True, scale: int = 1) -> dict:
    """The memcheck pass first (the slow one), then the phase at full
    size; prints the ``fuzz_paths`` line."""
    mc = run_memcheck_pass() if memcheck else None
    res = run_fuzz_paths(scale)
    res["memcheck"] = mc
    log(f"fuzz paths: {res}")
    print(json.dumps({"fuzz_paths": res}), flush=True)
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=4096,
                    help="blocks of 64 KiB in the main path's batches")
    ap.add_argument("--quick", action="store_true",
                    help="a thin slice of the kernel comparison grid")
    ap.add_argument("--dist-worker", type=int, metavar="RANK",
                    help="run one rank of the distributed phase (the "
                         "script starts these itself)")
    ap.add_argument("--dist-dir", metavar="DIR",
                    help="the distributed phase's rendezvous directory")
    ap.add_argument("--fuzz-only", action="store_true",
                    help="run only the fuzz_paths phase (corrupt streams "
                         "through every decoder kernel)")
    ap.add_argument("--fuzz-scale", type=int, default=1,
                    help="divide the fuzz_paths phase's batch sizes")
    ap.add_argument("--no-memcheck", action="store_true",
                    help="skip the fuzz_paths phase's memcheck pass (the "
                         "pass itself runs the phase so)")
    ap.add_argument("--ab", metavar="DIR",
                    help="only time arith_enc, arith_dec, rans8_enc, "
                         "rans8_dec, rc_enc and the 4x16 encoder and "
                         "decoder against those of "
                         "the checkout at DIR (e.g. the parent commit "
                         "unpacked with git archive), in turns")
    args = ap.parse_args()
    if args.dist_worker is not None:
        dist_worker(args.dist_worker, args.dist_dir, args.blocks)
        return

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0] if smi else f"{kind}, power limit unknown"
    log(f"device: {kind} x{torch.cuda.device_count()} | {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    prebuilt = sorted(p.name for p in cuda_build.BUILD_DIR.glob("lib*.so"))
    if prebuilt:
        log(f"note: libraries found in {cuda_build.BUILD_DIR.name}/ are "
            f"reused when their source hash matches: {prebuilt}")
    if not native.available():
        fail("host C library did not build")
    if args.ab:
        ab_run(args.ab, args.blocks)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return
    log(f"host C library built in {native.build_seconds:.1f} s")
    cuda_build.get_lib()
    log(f"CUDA kernel library built in {cuda_build.build_seconds:.1f} s")
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "error" in line or "warning" in line:
            print("    " + line.strip())
    if args.fuzz_only:
        fuzz_paths(not args.no_memcheck, args.fuzz_scale)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return

    t = time.perf_counter()
    rans_vmem.reset_launches()
    ncases = phase_kernels(args.quick)
    log(f"rANS kernels == plain versions (tolerance 0) on {ncases} cases in "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    ncases = phase_kernels_rc(args.quick)
    log(f"range-coder kernels == plain versions (tolerance 0) on {ncases} "
        f"cases in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    ncases = phase_tables_count(args.quick)
    log(f"order-1 counting kernels == plain versions (tolerance 0) on "
        f"{ncases} cases in {time.perf_counter() - t:.1f} s")
    print(json.dumps({"kernels_vs_plain": [
        {"name": k, "launches": v, "ok": True}
        for k, v in rans_vmem.LAUNCHES.items()]}), flush=True)

    # corrupt streams through every decoder entry, and its memcheck pass
    fuzz = fuzz_paths(not args.no_memcheck)

    # ---- the main paths, full width ----
    B, N = args.blocks, 65536
    t = time.perf_counter()
    q4 = testdata.synth_quality(B, N, seed=42)
    wide = testdata.synth_wide(max(B // 4, 1), N, 40, seed=9)
    log(f"generated {B} x {N} quality bytes and {len(wide)} x {N} wide "
        f"bytes in {time.perf_counter() - t:.1f} s")
    launches = {}
    launches["rans4x16"], streams1 = run_main_path(
        R4X16, "synth4 order 1", q4, 1, 256)
    nband, nflip = band_counts(q4)
    log(f"synth4 order 1: {nband} blocks in the shift band, {nflip} rebuilt "
        "on the host")
    _l, streams0 = run_main_path(R4X16, "synth4 order 0", q4, 0, 256)
    _l, streams_w = run_main_path(R4X16, "wide41 order 1", wide, 1, 256)
    # both table routes of the synth4 batches, each launching the one
    # encoder (and the order-1 device route the counting kernels) alone,
    # give the main path's streams
    routes_s = {f"order{o}": run_table_routes(q4, o, st, f"synth4 order {o}")
                for o, st in ((1, streams1), (0, streams0))}
    routes_s["shape"] = f"B={B} N={N}"

    # the parallel/ layer: the stream encoder on slices of the same
    # batches, the one-call round-trip step, two ranks of a gloo group
    t = time.perf_counter()
    stream_paths = run_stream_paths(q4, streams1, streams0, wide, streams_w)
    log(f"stream phase: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    roundtrip = run_roundtrip_step(q4, streams1)
    log(f"roundtrip phase: {time.perf_counter() - t:.1f} s")
    del streams0, streams1, streams_w
    dist_paths = run_distributed_paths(max(B // 2, 2))
    route_sweep = table_route_sweep(q4)

    # the first-generation engine on device-built tables
    launches["packed"], groups = run_pallas_path(q4, 1)
    run_pallas_path(q4, 0)

    # transform-flagged orders: the stripe lanes and transformed bodies
    # through the same batched groups
    transform = {o: run_transform_path(q4, o, 64) for o in TRANSFORM_ORDERS}
    transform_entries = transform_kernel_checks(q4, transform[9]["launches"])
    lanes = stripe_lanes(q4)
    A9 = check_count(on_card(lanes), "order-9 stripe lanes")
    log(f"order-1 counting kernels == plain versions at the order-9 stripe "
        f"lanes, B={lanes.shape[0]} N={lanes.shape[1]} A={A9}")
    del lanes

    # rANS 4x8: its host coder is pure Python, so the sample is 16
    launches["rans4x8"], _ = run_main_path(R4X8, "synth4 order 1", q4, 1, 16)
    run_main_path(R4X8, "synth4 order 0", q4, 0, 16)
    run_main_path(R4X8, "wide41 order 1", wide, 1, 16)

    # arith_dynamic: the adaptive range coder, both orders
    launches["arith"], _ = run_main_path(ARITH, "synth4 order 1", q4, 1, 256)
    run_main_path(ARITH, "synth4 order 0", q4, 0, 256)
    run_main_path(ARITH, "wide41 order 1", wide, 1, 256)

    # fqzcomp_qual: host model replay + the rc_enc kernel.  192 jobs of
    # 10000 records x 150 values (the CRAM default slice of 10000 reads
    # at a 150-base read length), scaled with --blocks
    t = time.perf_counter()
    jobs = testdata.synth_fqz_jobs(max(B * 3 // 64, 2), 10000, 150, seed=42)
    log(f"generated {len(jobs)} fqz jobs in {time.perf_counter() - t:.1f} s")
    launches["fqz"] = run_fqz_path(jobs, 16)

    # tokenise_name3: 64 blocks of 10000 names per style (fewer with a
    # smaller --blocks), the descriptor encode on both engines
    t = time.perf_counter()
    names = tok3_blocks(max(2, min(64, B // 64)))
    log(f"generated {sum(map(len, names.values()))} name blocks of "
        f"{TOK3_NAMES} names in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    tok3_paths, tok3_streams = run_tok3_paths(names)
    tok3_entries, tok3_dec = tok3_kernel_checks(
        names["illumina"][0], tok3_streams["illumina"],
        tok3_paths["illumina level 9 encode device"]["launches"][
            "rans16_enc_packed"])
    tok3_paths["descriptor_decode_engine_device"] = tok3_dec
    groups3 = descriptor_groups(names["illumina"][0])[0]
    for arr, _o in groups3:
        check_count(on_card(arr), f"tok3 descriptor group {arr.shape}")
    log(f"order-1 counting kernels == plain versions at the {len(groups3)} "
        f"descriptor groups of one Illumina block: "
        f"{[g.shape for g, _o in groups3]}")
    del groups3
    del tok3_streams
    log(f"tok3 phase: {time.perf_counter() - t:.1f} s")

    profile_main_path(R4X16, q4, 1)
    profile_main_path(R4X8, q4, 1)
    profile_main_path(ARITH, q4, 1)
    streams9 = profile_call("compress_blocks order=9", batch.compress_blocks,
                            q4, 9)
    profile_call("uncompress_blocks order=9", batch.uncompress_blocks,
                 streams9)
    del streams9
    profile_call("fqz_compress_blocks", batch.fqz_compress_blocks, jobs,
                 "device")
    profile_call("tok3.encode_names level 9 engine=device",
                 tok3.encode_names, names["illumina"][0], 9, False, False,
                 "device")
    del names
    entries = kernel_times(q4, 1, launches)
    # rans16_dec's direct route at the 4x16 read cell's shape
    entries[0]["cell_shape"] = check_direct16_cell()
    entries += kernel_times_packed(q4, groups, launches["packed"], entries)
    del groups
    build_ms = table_build_ms(q4)
    entries += count_entries(q4, launches["rans4x16"])
    entries += kernel_times8(q4, 1, launches)
    entries += kernel_times_arith(q4, 1, launches["arith"])
    shapes = [("synth4 order 1", q4, 1), ("synth4 order 0", q4, 0),
              ("wide41 order 1", wide, 1)]
    dec_rep = arith_dec_report(shapes)
    sweep = arith_launch_sweep(shapes)
    dsweep = dec_sweep(shapes)
    del wide, q4, shapes
    entries += kernel_times_rc(jobs, launches["fqz"])
    del jobs
    # the transform path's and tok3's shapes go beside the plain 4x16 shape
    for e in entries:
        for key, more in (("transform_shapes", transform_entries),
                          ("tok3_shapes", tok3_entries)):
            extra = [{k: t[k] for k in ("shape", "launches", "max_abs_err",
                                        "ms", "plain_ms", "bound_ms",
                                        "bound_by", "route") if k in t}
                     for t in more if t["name"] == e["name"]]
            if extra:
                e[key] = extra
                e["max_abs_err"] = max([e["max_abs_err"]]
                                       + [t["max_abs_err"] for t in extra])
    for e in entries:
        log(f"kernel {e['name']}: {e['ms']:.3f} ms at {e['shape']} "
            f"(bound {e['bound_ms']:.3f} ms by {e['bound_by']}, library "
            f"{e['library_ms']}, plain version {e['plain_ms']:.1f} ms"
            f"{' at ' + e['plain_shape'] if 'plain_shape' in e else ''})"
            + (f"; second launch {e['second_ms']:.3f} ms at "
               f"{e['second_shape']}" if "second_ms" in e else "")
            + (f"; rans_pallas path {e['rans_pallas']}" if "rans_pallas" in e
               else ""))
    log(f"rANS 4x16 compress wall by table route, s: {routes_s}")
    print(json.dumps({"table_route_compress_s": routes_s}), flush=True)
    log(f"rANS 4x16 compress wall by table route and group size B, "
        f"engine='device', s: {route_sweep}")
    print(json.dumps({"table_route_sweep_s": route_sweep}), flush=True)
    log(f"device table build, ms: {build_ms}")
    print(json.dumps({"table_build_ms": build_ms}), flush=True)
    print(json.dumps({"arith_dec_main_paths": dec_rep}), flush=True)
    log(f"arith enc ms by blocks per warp, dec [pool, ms] by threads per "
        f"CTA and pool: {sweep}")
    print(json.dumps({"arith_launch_sweep_ms": sweep}), flush=True)
    log(f"rans16_dec and rans8_dec [tables in shared memory, ms] by threads "
        f"per CTA: {dsweep}")
    print(json.dumps({"dec_sweep_ms": dsweep}), flush=True)
    print(json.dumps({"transform_paths": transform}), flush=True)
    print(json.dumps({"tok3_paths": tok3_paths}), flush=True)
    print(json.dumps({"stream_paths": stream_paths}), flush=True)
    print(json.dumps({"roundtrip_step": roundtrip}), flush=True)
    print(json.dumps({"distributed_paths": dist_paths}), flush=True)
    print(json.dumps({"fuzz_paths": fuzz}), flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
