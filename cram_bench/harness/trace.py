"""Host spans around the program's layers, and the device trace.

A traced run wraps the (module, attribute) pairs a codec lists: each
call of the attribute records its host interval and thread, and opens a
``record_function`` range of the same name.  ``torch.profiler`` (CUPTI)
records the device operations of the window; the chrome trace it
exports is read back here, and its clock is moved onto
``time.perf_counter`` through one range opened at a known host time.
"""

from __future__ import annotations

import bisect
import importlib
import json
import os
import tempfile
import threading
import time
from collections import defaultdict

from .record import DeviceOp

ANCHOR = "cram_bench.anchor"
PREFIX = "htscodecs_tpu_torch."


def span_name(module: str, attr: str) -> str:
    return f"{module.removeprefix(PREFIX)}.{attr}"


def install(pairs, sink: list):
    """Wrap each (module, attribute); returns a function that puts the
    originals back."""
    import torch

    saved = []
    for module, attr in pairs:
        mod = importlib.import_module(module)
        fn = getattr(mod, attr)
        name = span_name(module, attr)

        def wrapped(*a, _fn=fn, _name=name, **k):
            with torch.profiler.record_function(_name):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    sink.append((_name, t0, time.perf_counter(),
                                 threading.get_ident()))

        setattr(mod, attr, wrapped)
        saved.append((mod, attr, fn))

    def restore():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return restore


class Profiler:
    """``torch.profiler`` over the window, with a clock anchor."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.anchor = 0.0

    def __enter__(self):
        self.prof.__enter__()
        with self._torch.profiler.record_function(ANCHOR):
            self.anchor = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._torch.cuda.is_available():
            self._torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def device_ops(self) -> list[DeviceOp]:
        """The device operations of the trace on the host clock."""
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        return shift(parse(events), self.anchor)


KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}


def parse(events) -> list[DeviceOp]:
    anchor = [e for e in events
              if e.get("name") == ANCHOR and e.get("ph") == "X"]
    if not anchor:
        raise RuntimeError("the trace has no clock anchor")
    # trace microseconds -> seconds after the anchor
    base = float(anchor[0]["ts"])
    launch = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get(
                "args", {}):
            launch[e["args"]["correlation"]] = float(e["ts"])
    ops = []
    for e in events:
        kind = KINDS.get(e.get("cat"))
        if kind is None or e.get("ph") != "X":
            continue
        t0 = float(e["ts"])
        lt = launch.get(e.get("args", {}).get("correlation"))
        ops.append(DeviceOp(
            name=e.get("name", ""), kind=kind, t0=(t0 - base) * 1e-6,
            t1=(t0 + float(e.get("dur", 0)) - base) * 1e-6,
            launch=None if lt is None else (lt - base) * 1e-6))
    return ops


def shift(ops, offset: float) -> list[DeviceOp]:
    return [DeviceOp(o.name, o.kind, o.t0 + offset, o.t1 + offset,
                     None if o.launch is None else o.launch + offset)
            for o in ops]


def gaps(ops, t0: float, t1: float) -> list[tuple[float, float]]:
    """Intervals of [t0, t1] with no device operation running."""
    out, end = [], t0
    for a, b in sorted((o.t0, o.t1) for o in ops):
        if a > end:
            out.append((end, min(a, t1)))
        end = max(end, b)
        if end >= t1:
            break
    if end < t1:
        out.append((end, t1))
    return [(a, b) for a, b in out if b > a]


def breakdown(ops, spans, calls, main_thread: int, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time of
    the window by what the host's main thread was doing: the innermost
    wrapped span open at the middle of each gap, else the entry itself
    or the time between calls."""
    t0, t1 = calls[0].t0, calls[-1].t1
    by_name: dict[str, float] = defaultdict(float)
    for o in ops:
        if o.t1 > t0 and o.t0 < t1:
            by_name[o.name] += min(o.t1, t1) - max(o.t0, t0)
    idle: dict[str, float] = defaultdict(float)
    main = sorted((a, b, n) for n, a, b, tid in spans if tid == main_thread)
    starts = [m[0] for m in main]
    call_starts = [c.t0 for c in calls]
    for a, b in gaps(ops, t0, t1):
        mid = 0.5 * (a + b)
        k = bisect.bisect_right(call_starts, mid) - 1
        if k < 0 or calls[k].t1 < mid:
            idle["between calls"] += b - a
            continue
        label = "entry (models/batch.py)"
        # the innermost span is the latest one of this call that covers mid
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if main[j][0] < calls[k].t0:
                break
            if main[j][1] >= mid:
                label = main[j][2]
                break
        idle[label] += b - a
    return {
        "device_ops": [[n, s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, s] for n, s in sorted(
            idle.items(), key=lambda kv: -kv[1])[:top]],
    }
