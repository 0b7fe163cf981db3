"""The benchmark of htscodecs_tpu_torch: one run of one cell.

    python3 cram_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds BENCHMARK.json and the port.
The run builds or loads the port's two libraries (cached under the
package's ``_build/``), makes the cell's blocks from the seed (and, for
a read cell, their streams with the plain reference), makes one warm
call, then calls the cell's entry back to back for ``--seconds`` and
checks the outputs of calls drawn from the seed against the reference.
Its earlier lines on standard output are diagnostics; the last is the
result as one JSON object.  The numbers compared, each with its limit,
are also the last lines on standard error.  Without a CUDA device, or
with fewer than the cell asks for, it prints no result and exits 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="put the reference's lossy control in the "
                         "program's place (a check of the check; the "
                         "benchmark's own runs never set it)")
    return ap.parse_args(argv)


def _fail(msg: str, code: int = 2) -> int:
    print(msg, file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    a = _args(argv)
    # the script's own folder would make its subfolders (codecs, metrics,
    # tests) importable as top-level packages: import from the root only
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != HERE]
    sys.path.insert(0, str(ROOT))
    bench_file = ROOT / "BENCHMARK.json"
    if not bench_file.is_file():
        return _fail(f"no BENCHMARK.json at {ROOT}")
    try:
        import torch
        import htscodecs_tpu_torch  # noqa: F401
    except ImportError as e:
        return _fail(f"cannot import what the benchmark runs: {e}")
    from cram_bench.harness import bench, spec

    cell = spec.load(a.workload, bench_file)
    if not torch.cuda.is_available():
        return _fail("no CUDA device: the benchmark runs only on the card")
    if torch.cuda.device_count() < cell.chips:
        return _fail(f"{a.workload} needs {cell.chips} devices, "
                     f"{torch.cuda.device_count()} visible")
    out = bench.run(a.workload, a.seed, a.seconds, bool(a.trace),
                    bench_file, t_start=T_START, control=bool(a.control),
                    log=lambda s: print(s, flush=True))
    if out["forbidden"]:
        return _fail("modules of JAX or of the JAX package were loaded: "
                     + ", ".join(out["forbidden"]), 3)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
