"""CLI for the rANS 4x16 codec (reference rans4x16pr tool parity).

-o accepts N.M for STRIPE lane counts (order += M<<8)."""
import argparse
import numpy as np
from ._common import add_common, run_block_tool
from ..models import rans4x16


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rans4x16")
    ap.add_argument("-o", default="0", help="order/flags (N or N.M for stripe M)")
    add_common(ap)
    args = ap.parse_args(argv)
    if "." in args.o:
        base, m = args.o.split(".")
        order = int(base) + (int(m) << 8)
    else:
        order = int(args.o)
    return run_block_tool(
        lambda d: rans4x16.compress(np.frombuffer(d, np.uint8), order),
        lambda d, sz: rans4x16.uncompress(d, sz),
        args)


if __name__ == "__main__":
    raise SystemExit(main())
