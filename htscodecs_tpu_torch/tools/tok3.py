"""CLI for tokenise_name3 (reference tokenise_name3 tool parity).

-N sets the level; N>10 selects the arith backend (level N-10).
--device is the batch layer's (default cuda; cpu runs the plain
PyTorch versions)."""
import argparse
import sys
from ._common import stdio
from ..models import tok3

BLK = 1024 * 1024


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    # reference tool style: a bare -<digits> flag IS the level
    # (tests/tokenise_name3_test.c:99-100, tok3.test drives `-$i`)
    argv = sum((["-N", a[1:]] if a[:1] == "-" and a[1:].isdigit()
                else [a] for a in argv), [])
    ap = argparse.ArgumentParser(prog="tok3")
    ap.add_argument("-d", action="store_true")
    ap.add_argument("-r", action="store_true")
    ap.add_argument("-N", "--level", type=int, default=9)
    ap.add_argument("--device", default="cuda",
                    help="device of the batch layer (cuda or cpu)")
    ap.add_argument("input", nargs="?", default=None)
    ap.add_argument("output", nargs="?", default=None)
    args = ap.parse_args(argv)
    with stdio(args) as (inf, outf):
        data = inf.read()

        if args.d:
            if args.r:
                outf.write(tok3.decode_names(data, device=args.device))
            else:
                pos = 0
                while pos + 4 <= len(data):
                    ln = int.from_bytes(data[pos:pos + 4], "little")
                    pos += 4
                    outf.write(tok3.decode_names(data[pos:pos + ln],
                                                 device=args.device))
                    pos += ln
            outf.flush()
            return 0

        level = args.level
        use_arith = level > 10
        if use_arith:
            level -= 10
        if args.r:
            outf.write(tok3.encode_names(data, level, use_arith,
                                         device=args.device))
        else:
            off = 0
            while off < len(data):
                chunk = data[off:off + BLK]
                blob, last_start = tok3.encode_names(chunk, level, use_arith,
                                                     return_last_start=True,
                                                     device=args.device)
                outf.write(len(blob).to_bytes(4, "little"))
                outf.write(blob)
                off += last_start if last_start else len(chunk)
        outf.flush()
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
