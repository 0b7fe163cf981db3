"""Shared CLI plumbing for the codec tools.

Framing parity with the reference test tools: framed mode prefixes each
block with u32-LE lengths; raw mode emits one naked block
(tests/rANS_static4x16pr_test.c style)."""

from __future__ import annotations

import argparse
import contextlib
import sys
import time


@contextlib.contextmanager
def stdio(args):
    """(input, output) binary files: the named paths, closed on exit, or
    standard input and output."""
    with contextlib.ExitStack() as stack:
        inf = (stack.enter_context(open(args.input, "rb")) if args.input
               else sys.stdin.buffer)
        outf = (stack.enter_context(open(args.output, "wb")) if args.output
                else sys.stdout.buffer)
        yield inf, outf


def add_common(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("-d", action="store_true", help="decompress")
    ap.add_argument("-r", action="store_true", help="raw single block")
    ap.add_argument("-t", action="store_true", help="benchmark (NTRIALS enc+dec)")
    ap.add_argument("-b", type=int, default=1039 * 251 * 4, help="block size")
    ap.add_argument("input", nargs="?", default=None)
    ap.add_argument("output", nargs="?", default=None)


def run_block_tool(compress, uncompress, args, order_byte=None) -> int:
    """Generic framed/raw block loop shared by the rANS/arith tools.

    order_byte: rANS_static_test.c's framed mode alone prepends a
    per-block order flag byte (tests/rANS_static_test.c:244,272);
    pass a callable(block bytes) -> int to reproduce it."""
    with stdio(args) as (inf, outf):
        data = inf.read()
        if args.t:
            ntrials = 10
            best_e = best_d = 1e9
            blob = compress(data)
            for _ in range(ntrials):
                t0 = time.time()
                blob = compress(data)
                best_e = min(best_e, time.time() - t0)
                t0 = time.time()
                out = uncompress(blob, len(data))
                best_d = min(best_d, time.time() - t0)
            if out != data:
                raise RuntimeError("the benchmark's round trip failed")
            print(f"{len(data)/best_e/1e6:.1f} MB/s enc, "
                  f"{len(data)/best_d/1e6:.1f} MB/s dec\t"
                  f"{len(data)} bytes -> {len(blob)} bytes", file=sys.stderr)
            return 0

        if args.d:
            if args.r:
                outf.write(uncompress(data, None))
            else:
                pos = 0
                skip = 1 if order_byte is not None else 0
                while pos + 4 + skip <= len(data):
                    pos += skip                      # per-block order flag
                    ln = int.from_bytes(data[pos:pos + 4], "little")
                    pos += 4
                    outf.write(uncompress(data[pos:pos + ln], None))
                    pos += ln
        else:
            if args.r:
                outf.write(compress(data))
            else:
                for i in range(0, len(data), args.b):
                    block = data[i:i + args.b]
                    blob = compress(block)
                    if order_byte is not None:
                        outf.write(bytes([order_byte(block)]))
                    outf.write(len(blob).to_bytes(4, "little"))
                    outf.write(blob)
        outf.flush()
        return 0
