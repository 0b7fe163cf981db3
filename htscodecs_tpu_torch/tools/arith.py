"""CLI for the arith_dynamic codec (reference arith_dynamic tool parity)."""
import argparse
import numpy as np
from ._common import add_common, run_block_tool
from ..models import arith


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="arith")
    ap.add_argument("-o", default="0", help="order/flags (N or N.M for stripe M)")
    add_common(ap)
    args = ap.parse_args(argv)
    if "." in args.o:
        base, m = args.o.split(".")
        order = int(base) + (int(m) << 8)
    else:
        order = int(args.o)
    return run_block_tool(
        lambda d: arith.compress(np.frombuffer(d, np.uint8), order),
        lambda d, sz: arith.uncompress(d, sz),
        args)


if __name__ == "__main__":
    raise SystemExit(main())
