"""Makes blocks and runs a codec's plain reference in worker processes.

Block i of a run is (seed, i) (the configuration's generator), so a
worker is handed only the seed and its indices: it makes its blocks
and sends back their reference streams.
The reference encoder takes one NumPy step per symbol of a quarter
(377 500 steps for a 1.51 MB block) however many blocks it codes side by
side, so the work is cut into one chunk per worker.  Each worker is this
module run as a script (``python -m cram_bench.harness.refpool``): it
reads its job pickled from its standard input, imports NumPy, the
generator and the codec's reference (never torch or the program), and
writes its answer pickled to its standard output.  Every worker has
ended before a call here returns.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


@dataclass
class Job:
    codec_file: str
    generator_file: str
    cfg: dict
    seed: int
    indices: list
    lossy: bool = False        # code the control's lossy blocks


def _run(job: Job) -> dict:
    from cram_bench.harness.spec import load_module
    gen = load_module(Path(job.generator_file), "generator")
    codec = load_module(Path(job.codec_file), "codec")
    blocks = gen.blocks(job.cfg, job.seed, job.indices)
    if job.lossy:
        blocks = [gen.lossy(b, job.cfg) for b in blocks]
    return {"streams": codec.reference_encode(blocks, job.cfg)}


def workers(limit: int | None = None) -> int:
    n = max(1, (os.cpu_count() or 2) - 1)
    return min(n, limit) if limit else n


def _in_worker(job: Job) -> dict:
    p = subprocess.Popen([sys.executable, "-m", "cram_bench.harness.refpool"],
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, cwd=ROOT)
    out, err = p.communicate(pickle.dumps(job, protocol=5))
    if p.returncode != 0:
        raise RuntimeError("reference worker failed: "
                           + err.decode(errors="replace")[-2000:])
    return pickle.loads(out)


def run(job: Job, procs: int | None = None) -> list:
    """The reference streams of ``job``'s blocks, its indices cut into
    one chunk per worker (in this process when ``procs`` is 1), joined
    in index order."""
    idx = list(job.indices)
    procs = workers(procs)
    per = max(1, -(-len(idx) // procs))
    chunks = [idx[i:i + per] for i in range(0, len(idx), per)]
    jobs = [Job(**{**job.__dict__, "indices": c}) for c in chunks]
    if procs == 1 or len(jobs) <= 1:
        parts = [_run(j) for j in jobs]
    else:
        with ThreadPoolExecutor(len(jobs)) as ex:
            parts = list(ex.map(_in_worker, jobs))
    return [x for p in parts for x in p["streams"]]


if __name__ == "__main__":
    answer = _run(pickle.load(sys.stdin.buffer))
    pickle.dump(answer, sys.stdout.buffer, protocol=5)
