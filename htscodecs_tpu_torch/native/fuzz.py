"""Build and run the ASan + edge-coverage fuzz harness of the port's
native host kernels (``fuzz_native.c`` over ``hostkernels.c``).

    python3 -m htscodecs_tpu_torch.native.fuzz SECONDS [MAX_LEN]

The harness is compiled with ``gcc -fsanitize=address``, and with
``-fsanitize-coverage=trace-pc`` on the harness only: the coverage
callback in ``fuzz_cov.c`` must not be instrumented, or it calls itself.
The seed corpus is written by this module from ``utils/testdata.py``
with the port's own encoders, each seed behind its selector byte (see
the selector table in ``fuzz_native.c``): rANS 4x16 orders 0/1, rANS 4x8
orders 0/1 (through the raw-decoder selectors, whose parsers they
exercise), arith orders 0/1 and their RLE variants, one fqz job (as a
stream and as a serialised parameter set), one sparse 12-bit header
batch and one tok3 block's descriptors.  Everything is built and
written in a temporary directory that is removed afterwards.

Exit code 0 means the harness ran to its time budget with no sanitizer
report; otherwise the harness's output is printed and its code
returned.  Needs ``gcc`` with AddressSanitizer; no device.
"""

from __future__ import annotations

import shutil
import struct
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent

# selectors of fuzz_native.c
SEL_R16_O0, SEL_R16_O1, SEL_ARITH = 0, 1, 6
SEL_FQZ, SEL_FQZ_PARAMS, SEL_SPARSE12, SEL_ARITH_CAPPED, SEL_TOK3 = \
    10, 13, 14, 15, 16


def _body(stream: bytes) -> bytes:
    """The entropy body of a 4x16 or arith stream with a size field:
    what the native decoders read after the order byte and the size."""
    from ..utils import varint
    _osz, pos = varint.get_uint(stream, 1, len(stream))
    return stream[pos:]


def _fqz_params_seed(stream: bytes) -> bytes:
    """An fqz stream's parameters as fuzz_native.c's selector 13 reads
    them (the arrays ``models.fqz._pack_gp`` gives ``fqz_dec``), then
    its range-coded payload."""
    from ..models import fqz
    from ..utils import varint
    total, pos = varint.get_uint(stream, 0, len(stream))
    gp, pos = fqz.read_parameters(memoryview(stream), pos, len(stream))
    pm_ints, qmaps, qtabs, ptabs, dtabs, stab = fqz._pack_gp(gp)
    nset = min(len(pm_ints), 2)
    out = bytearray([gp.gflags & 7, nset - 1, gp.max_sel & 255,
                     gp.max_sym & 255])
    out += struct.pack("<I", total)
    out += np.asarray(stab, np.uint8).tobytes()
    for x in range(nset):
        out += (pm_ints[x] & 0xFFFF).astype("<u2").tobytes()
        out += (qmaps[x] & 0xFF).astype(np.uint8).tobytes()
        for tab in (qtabs, ptabs, dtabs):
            out += (tab[x] & 0xFFFF).astype("<u2").tobytes()
    return bytes(out) + stream[pos:]


def _sparse12_seed() -> bytes:
    """Two blocks' order-1 header frequencies in the sparse 12-bit
    transport, as fuzz_native.c's selector 14 reads them."""
    import torch

    from ..ops import tables_v2
    from ..utils import testdata
    blocks = testdata.synth_quality(2, 2048, seed=5)
    alpha_d, _pk, asz, fhdr, shift, _flag, A = tables_v2.build_o1_device(
        blocks, device="cpu")
    bitmap, vals, _c, _m = tables_v2.pack_freqs_sparse12(
        torch.from_numpy(fhdr.astype(np.int32)))
    vw = vals.shape[1] // 3 - 1
    out = bytearray([len(blocks) - 1, A // 8 - 1, vw & 255, vw >> 8])
    alpha = alpha_d.numpy()
    for b in range(len(blocks)):
        out += bytes([int(asz[b]), 1 if shift[b] == 12 else 0])
        out += alpha[b].tobytes() + bitmap[b].numpy().tobytes()
        out += vals[b].numpy().tobytes()
    return bytes(out)


def _tok3_seed() -> bytes:
    """One block of Illumina names tokenised, framed as fuzz_native.c's
    selector 16 reads it (descriptor ids and lengths, then the arena)."""
    from . import tok3_tokenize
    from ..utils import testdata
    blk = testdata.synth_names(64, "illumina", seed=3)
    arr = np.frombuffer(blk, np.uint8)
    seps = np.flatnonzero(arr <= 10)
    starts = np.concatenate([[0], seps[:-1] + 1]).astype(np.int64)
    desc, max_tok = tok3_tokenize(blk, starts, seps - starts)
    out = bytearray([max_tok & 255])
    out += struct.pack("<H", len(seps) - 1) + bytes([len(desc)])
    for tid, b in desc.items():
        out += struct.pack("<H", tid) + len(b).to_bytes(3, "little")
    return bytes(out) + b"".join(desc.values())


def write_seeds(dst: Path) -> int:
    """Write the seed corpus into ``dst``; returns the number of files."""
    from ..models import arith, fqz, rans4x8, rans4x16
    from ..utils import testdata
    q = testdata.synth_quality(1, 4096, seed=11)[0]
    w = testdata.synth_wide(1, 4096, 40, seed=12)[0]
    seeds: list[bytes] = []
    for data in (q, w):
        for order, sel in ((0, SEL_R16_O0), (1, SEL_R16_O1)):
            seeds.append(bytes([sel]) + _body(rans4x16.compress(data, order)))
            # the 4x8 stream's tables and states behind the 4x16 decoders
            seeds.append(bytes([sel]) + rans4x8.compress(data, order)[9:])
        for k, order in enumerate((0, 1, 0x40, 0x41)):
            body = _body(arith.compress(data, order))
            seeds.append(bytes([SEL_ARITH + k]) + body)
            seeds.append(bytes([SEL_ARITH_CAPPED, 17, k]) + body)
    data, lens, flags = testdata.synth_fqz_jobs(1, 8, 24, seed=13)[0]
    stream = fqz.compress(data, lens, flags)
    seeds.append(bytes([SEL_FQZ]) + stream)
    seeds.append(bytes([SEL_FQZ_PARAMS]) + _fqz_params_seed(stream))
    seeds.append(bytes([SEL_SPARSE12]) + _sparse12_seed())
    seeds.append(bytes([SEL_TOK3]) + _tok3_seed())
    dst.mkdir(parents=True, exist_ok=True)
    for k, s in enumerate(seeds):
        (dst / f"seed{k:03d}").write_bytes(s)
    return len(seeds)


def build(dst: Path) -> Path:
    """Compile the harness into ``dst``; returns the executable."""
    cov = dst / "fuzz_cov.o"
    exe = dst / "fuzz_native"
    subprocess.run(["gcc", "-O1", "-g", "-fsanitize=address", "-c",
                    str(_HERE / "fuzz_cov.c"), "-o", str(cov)],
                   check=True, capture_output=True, text=True)
    subprocess.run(["gcc", "-O1", "-g", "-fsanitize=address",
                    "-fsanitize-coverage=trace-pc", "-o", str(exe),
                    str(_HERE / "fuzz_native.c"), str(cov), "-lm"],
                   check=True, capture_output=True, text=True)
    return exe


def run(seconds: int, max_len: int = 16384) -> subprocess.CompletedProcess:
    """Build, seed and run the harness for ``seconds``."""
    if shutil.which("gcc") is None:
        raise RuntimeError("the fuzz harness needs gcc")
    with tempfile.TemporaryDirectory(prefix="htsfuzz_") as tmp:
        tmp = Path(tmp)
        exe = build(tmp)
        write_seeds(tmp / "seeds")
        return subprocess.run([str(exe), str(tmp / "seeds"), str(seconds),
                               str(max_len)], capture_output=True, text=True,
                              timeout=seconds + 300)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or len(argv) > 2:
        print("usage: python3 -m htscodecs_tpu_torch.native.fuzz SECONDS "
              "[MAX_LEN]", file=sys.stderr)
        return 2
    r = run(int(argv[0]), *(int(a) for a in argv[1:]))
    sys.stdout.write(r.stdout)
    sys.stderr.write(r.stderr)
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
