"""One run of one cell: set-up, the measured window, the check.

``run`` logs the diagnostic lines and returns the result line's object
with the numbers compared and any JAX module it found loaded; ``run.py``
wraps it with the command line and the look for a card.  The tests
drive ``run`` with ``device="cpu"`` at small sizes.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from . import refpool, spec, trace as tr
from .record import Call, Record, union

FORBIDDEN = ("jax", "jaxlib", "flax", "htscodecs_tpu")


def loaded_forbidden() -> list[str]:
    """Top-level names of ``sys.modules`` that belong to JAX or to the
    JAX package, compared whole (the port's name starts with the JAX
    package's)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def program_counters() -> dict:
    """The port's own counters: kernel launches, 4x16 table routes and
    entropy jobs by route."""
    from htscodecs_tpu_torch.models import batch
    from htscodecs_tpu_torch.ops import rans_vmem
    return {"launches": dict(rans_vmem.LAUNCHES),
            "table_routes": dict(batch.TABLE_ROUTES),
            "entropy_jobs": {d: dict(v)
                             for d, v in batch.ENTROPY_JOBS.items()}}


def _minus(a, b):
    if isinstance(a, dict):
        return {key: _minus(a[key], b.get(key, 0)) for key in a}
    return a - b


class Reservoir:
    """A uniform sample, drawn from the seed, of the window's calls whose
    outputs are kept for the check (the others are freed at once)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.kept: list[tuple[int, int, list]] = []
        self.seen = 0

    def offer(self, call: int, batch: int, out) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append((call, batch, out))
            return
        j = self.rng.randrange(self.seen)
        if j < self.size:
            self.kept[j] = (call, batch, out)


def _per_call(d, calls: int):
    if isinstance(d, dict):
        return {key: _per_call(v, calls) for key, v in d.items() if v}
    return d / calls


def device_info(torch, device: str) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def _sync(torch, device):
    if device == "cuda":
        torch.cuda.synchronize()


def alphabet_sizes(blocks) -> list[int]:
    """The number of distinct byte values of each block."""
    return [int(np.count_nonzero(np.bincount(b, minlength=256)))
            for b in blocks]


def _window(entry, sync, lengths, in_bytes, alphabets, seconds,
            keep: Reservoir):
    """Calls back to back, pool batch i % P for call i, until a call ends
    past ``seconds``; returns (calls, kept outputs, errors)."""
    P = len(lengths)
    calls: list[Call] = []
    errors: list[str] = []
    deadline = time.perf_counter() + seconds
    i = 0
    while True:
        p = i % P
        t0 = time.perf_counter()
        try:
            out = entry(p)
            sync()
            ok = True
        except Exception as e:        # a failed call is counted
            out, ok = None, False
            errors.append(f"call {i}: {type(e).__name__}: {e}")
        t1 = time.perf_counter()
        sizes = (in_bytes[p] if in_bytes is not None else
                 [len(s) for s in out] if out is not None else [])
        calls.append(Call(t0, t1, lengths[p], sizes, alphabets[p], ok))
        keep.offer(i, p, out)
        out = None
        i += 1
        if t1 >= deadline:
            return calls, sorted(keep.kept), errors


def _compare(outs, want) -> tuple[int, int, int]:
    """Each kept call's outputs against ``want(batch)``, the outputs it
    should have given, whole and byte for byte.  Returns (wrong,
    missing, compared): an output past the batch's end is wrong."""
    wrong = missing = checked = 0
    for p, out in outs:
        ref = want(p)
        missing += max(0, len(ref) - len(out))
        wrong += max(0, len(out) - len(ref))
        for got, exp in zip(out, ref):
            checked += 1
            wrong += bytes(got) != exp
    return wrong, missing, checked


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        bench_file: Path, here: Path = spec.HERE, device: str = "cuda",
        t_start: float | None = None, control: bool = False,
        procs: int | None = None, log=print) -> dict:
    t_start = time.perf_counter() if t_start is None else t_start
    steps = {"imports_s": time.perf_counter() - t_start}
    cell = spec.load(cell_name, bench_file, here)
    cfg, mix, codec = cell.config, cell.mix, cell.codec
    direction = mix["direction"]
    if direction not in ("write", "read"):
        raise ValueError(f"mix direction {direction!r}")
    if mix.get("loop", "closed") != "closed" or int(mix.get("callers", 1)) != 1:
        raise ValueError("the harness drives one caller in a closed loop")
    P, k = int(mix["pool_batches"]), int(mix["slices_per_call"])

    def reference(indices, lossy=False):
        return refpool.run(refpool.Job(
            str(cell.codec_file), str(cell.generator_file), cfg, seed,
            list(indices), lossy=lossy), procs)

    # the plain reference's own seconds, before the program's set-up
    # starts and left out of setup_s: a read cell's streams, and the
    # control's
    t = time.perf_counter()
    made = None
    if direction == "read" and not control:
        made = reference(range(P * k))
    elif direction == "write" and control:
        made = reference(range(P * k), lossy=True)
    reference_s = time.perf_counter() - t
    steps["reference_s"] = reference_s

    t = time.perf_counter()
    import torch
    if device == "cuda":
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    steps["torch_and_context_s"] = time.perf_counter() - t

    t = time.perf_counter()
    from htscodecs_tpu_torch import cuda_build, native
    native.get_lib()
    if device == "cuda":
        cuda_build.get_lib()
    steps["builds_s"] = time.perf_counter() - t
    steps["builds"] = {"host_c_built_s": native.build_seconds,
                       "cuda_built_s": cuda_build.build_seconds}

    t = time.perf_counter()
    blocks = cell.generator.blocks(cfg, seed, range(P * k), threads=8)
    alpha = alphabet_sizes(blocks)
    steps["blocks_s"] = time.perf_counter() - t
    pool = [blocks[p * k:(p + 1) * k] for p in range(P)]
    lengths = [[len(b) for b in batch] for batch in pool]
    alphabets = [alpha[p * k:(p + 1) * k] for p in range(P)]

    t = time.perf_counter()
    write, read = codec.entries(cfg, device)
    steps["entries_s"] = time.perf_counter() - t
    in_bytes = None
    if direction == "read":
        if control:
            lossy = [[cell.generator.lossy(b, cfg).tobytes() for b in batch]
                     for batch in pool]
            entry = lambda p: lossy[p]  # noqa: E731
            in_bytes = [[len(b) for b in batch] for batch in lossy]
        else:
            streams = [made[p * k:(p + 1) * k] for p in range(P)]
            in_bytes = [[len(s) for s in batch] for batch in streams]
            entry = lambda p: read(streams[p])  # noqa: E731
    elif control:
        ctl = [made[p * k:(p + 1) * k] for p in range(P)]
        entry = lambda p: ctl[p]  # noqa: E731
    else:
        entry = lambda p: write(pool[p])  # noqa: E731
    del made

    t = time.perf_counter()
    warm = entry(0)
    _sync(torch, device)
    steps["warm_call_s"] = time.perf_counter() - t
    del warm
    setup_s = time.perf_counter() - t_start - reference_s

    # ---- the window ---------------------------------------------------
    counters = program_counters()
    spans: list = []
    restore = None
    prof = None
    if trace:
        restore = tr.install(codec.SPANS, spans)
        prof = tr.Profiler().__enter__()
    try:
        calls, kept, errors = _window(
            entry, lambda: _sync(torch, device), lengths, in_bytes,
            alphabets, seconds,
            Reservoir(int(mix.get("checked_calls", 2)), seed))
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        if restore is not None:
            restore()
    window_counters = _minus(program_counters(), counters)
    dev = device_info(torch, device)
    forbidden = loaded_forbidden()

    # ---- what the trace says ------------------------------------------
    rec = Record(cell=cell_name, direction=direction, calls=calls,
                 setup_s=setup_s, spans=spans)
    extra = {}
    if trace:
        rec.device = prof.device_ops()
        w0, w1 = rec.window()
        dev["busy_s"] = union([(o.t0, o.t1) for o in rec.device], w0, w1)
        dev["window_s"] = w1 - w0
        extra["breakdown"] = tr.breakdown(rec.device, spans, calls,
                                          threading.get_ident())

    # ---- the check: every output of the kept calls, whole ---------------
    t = time.perf_counter()
    outs = [(p, out) for _i, p, out in kept if out is not None]
    if direction == "write":
        # the reference's streams of the kept calls' batches
        used = sorted({p for p, _o in outs})
        ref = reference([p * k + b for p in used for b in range(k)])
        want = {p: ref[j * k:(j + 1) * k] for j, p in enumerate(used)}
        wrong, missing, checked = _compare(outs, want.__getitem__)
    else:
        wrong, missing, checked = _compare(
            outs, lambda p: [b.tobytes() for b in pool[p]])
    if not kept:
        missing += k
    check_s = time.perf_counter() - t
    raised = sum(1 for c in calls if not c.ok)
    checks = {
        "outputs_wrong": {"value": wrong, "limit": 0},
        "outputs_missing": {"value": missing, "limit": 0},
        "calls_raised": {"value": raised, "limit": 0},
    }
    correct = checked > 0 and all(v["value"] <= v["limit"]
                                  for v in checks.values())

    metrics = {}
    readers = cell.per_layer if trace else cell.end_to_end
    for m, reader in readers:
        v = reader.read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # ---- the lines before the result ----------------------------------
    sizes = sorted({n for batch in lengths for n in batch})
    log(f"cell {cell_name} seed {seed} config {cell.config_name} "
        f"traffic {cell.traffic}: {k} blocks of "
        + (f"{sizes[0]}" if len(sizes) == 1 else f"{sizes[0]}-{sizes[-1]}")
        + f" bytes a call, pool of {P} batches, {len(calls)} calls in "
        f"{seconds} s, trace {int(trace)}" + (", CONTROL" if control else ""))
    if device == "cuda":
        log(f"card: {card_line()}")
    log("setup: " + json.dumps({"setup_s": setup_s, **steps}))
    if calls:
        log("per call: " + json.dumps(_per_call(window_counters,
                                                len(calls))))
    for e in errors[:5]:
        log("error: " + e)
    log(f"check: {checked} whole outputs of {len(kept)} calls compared "
        f"in {check_s:.3f} s")

    result = {"correct": bool(correct and not forbidden),
              "attempted": len(calls), "failed": raised,
              "metrics": metrics, "device": dev}
    result.update(extra)
    result["checks"] = checks
    return {"result": result, "forbidden": forbidden, "checks": checks}
