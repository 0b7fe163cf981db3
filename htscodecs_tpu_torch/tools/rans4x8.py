"""CLI for the rANS 4x8 codec (reference rans4x8 tool parity)."""
import argparse
import numpy as np
from ._common import add_common, run_block_tool
from ..models import rans4x8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rans4x8")
    ap.add_argument("-o", type=int, default=0)
    add_common(ap)
    args = ap.parse_args(argv)
    # framed blocks drop to order 0 below 4 bytes and carry the used
    # order in a leading flag byte (tests/rANS_static_test.c:244,270-273)
    def eff_order(d: bytes) -> int:
        return 1 if (args.o and len(d) >= 4) else 0

    return run_block_tool(
        lambda d: rans4x8.compress(np.frombuffer(d, np.uint8),
                                   eff_order(d) if not args.r else args.o),
        lambda d, sz: rans4x8.uncompress(d),
        args, order_byte=None if args.r else eff_order)


if __name__ == "__main__":
    raise SystemExit(main())
