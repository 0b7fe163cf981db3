"""CLI for fqzcomp_qual (reference fqzcomp_qual tool parity).

Input: one quality string per line, `QUAL [is_read2 [selector]]`,
ASCII-33 shifted.  Raw mode emits the naked fqz stream; framed mode
prefixes u32-LE (uncompressed, compressed) sizes."""
import argparse
import sys
import numpy as np
from ._common import stdio
from ..models import fqz


def parse_lines(raw: bytes):
    lens, flags, qual = [], [], bytearray()
    for line in raw.split(b"\n"):
        if not line:
            continue
        parts = line.replace(b"\t", b" ").split(b" ")
        q = parts[0]
        lens.append(len(q))
        r2 = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        sel = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        flags.append(r2 * fqz.FQZ_FREAD2 | (sel << 16))
        qual += bytes(b - 33 for b in q)
    return bytes(qual), lens, flags


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fqz")
    ap.add_argument("-d", action="store_true")
    ap.add_argument("-r", action="store_true")
    ap.add_argument("-s", type=int, default=0, help="strategy 0-4")
    ap.add_argument("-x", action="append", default=[],
                    help="manual 12-nibble hex params (repeatable)")
    ap.add_argument("-D", action="store_true",
                    help="dump the parameter block to stderr "
                         "(reference dump_params equivalent)")
    ap.add_argument("input", nargs="?", default=None)
    ap.add_argument("output", nargs="?", default=None)
    args = ap.parse_args(argv)
    with stdio(args) as (inf, outf):
        data = inf.read()

        if args.d:
            if not args.r:
                data = data[8:]
            if args.D:
                _sz, pos = fqz.varint.get_uint(data, 0, len(data))
                gp, _ = fqz.read_parameters(data, pos, len(data))
                if gp is not None:
                    fqz.dump_params(gp)
            out, lengths = fqz.decompress(data, with_lengths=True)
            pos = 0
            for ln in lengths:
                outf.write(bytes(b + 33 for b in out[pos:pos + ln]) + b"\n")
                pos += ln
            outf.flush()
            return 0

        qual, lens, flags = parse_lines(data)
        gp = None
        if args.x:
            hexes = [int(x, 0) for x in args.x]
            gp = fqz.manual_parameters(hexes, lens, flags,
                                       np.frombuffer(qual, np.uint8).copy())
        elif args.D:
            # pre-pick so the block can be dumped; compress() skips its own
            # pick when gp is given (same code path -> identical stream)
            gp = fqz.pick_parameters(4, args.s, lens, flags,
                                     np.frombuffer(qual, np.uint8).copy())
        if args.D and gp is not None:
            fqz.dump_params(gp)
        blob = fqz.compress(qual, lens, flags, vers=4, strat=args.s, gp=gp)
        if not args.r:
            outf.write(len(qual).to_bytes(4, "little"))
            outf.write(len(blob).to_bytes(4, "little"))
        outf.write(blob)
        outf.flush()
        print(f"Total output = {len(blob) + (0 if args.r else 8)}",
              file=sys.stderr)
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
