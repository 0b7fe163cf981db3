"""What a run hands to the metric readers.

Times are host seconds (``time.perf_counter``).  A traced run adds its
host spans (the wrapped layer functions, from every thread) and the
device operations of the profiler's trace, moved onto the same clock.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# NVIDIA's data sheet for the H100 SXM at its 700 W limit: HBM3
# bandwidth, and 32-bit integer operations at the float32 rate outside
# the tensor cores
PEAKS = {"bytes_per_s": 3.35e12, "int_ops_per_s": 67e12}


@dataclass
class Call:
    t0: float
    t1: float
    lengths: list           # uncompressed length of each block
    stream_bytes: list      # length of each block's stream
    alphabets: list         # distinct byte values of each block
    ok: bool = True

    @property
    def raw_bytes(self) -> int:
        """Uncompressed bytes of the call."""
        return sum(self.lengths)


@dataclass
class DeviceOp:
    name: str
    kind: str               # "kernel", "memcpy" or "memset"
    t0: float
    t1: float
    launch: float | None    # host time of the launch, where the trace has it


def union(intervals, lo: float = float("-inf"),
          hi: float = float("inf")) -> float:
    """Length of the union of (t0, t1) intervals clipped to [lo, hi]."""
    total, end = 0.0, float("-inf")
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


@dataclass
class Record:
    cell: str
    direction: str                  # "write" or "read"
    calls: list
    setup_s: float
    spans: list = field(default_factory=list)    # (name, t0, t1, thread)
    device: list | None = None                   # DeviceOp, traced runs
    peaks: dict = field(default_factory=lambda: dict(PEAKS))

    def window(self) -> tuple[float, float]:
        return self.calls[0].t0, self.calls[-1].t1

    def span_time(self, names, t0: float, t1: float) -> float:
        """Union of the named spans (all threads) within [t0, t1]."""
        want = set(names)
        return union([(a, b) for n, a, b, _t in self.spans if n in want],
                     t0, t1)

    def per_call(self, names) -> list[float]:
        return [self.span_time(names, c.t0, c.t1) for c in self.calls]

    def ops(self, kind: str | None = None, name_has: str | None = None):
        return [o for o in (self.device or [])
                if (kind is None or o.kind == kind)
                and (name_has is None or name_has in o.name)]

    def roofline(self, direction: str, kernel: str, work) -> float | None:
        """Percent of the least time the work of every block of the window
        needs (``work(n, alphabet, stream bytes) -> (bytes, operations)``,
        against the peaks) over the device time of the kernels whose name
        holds ``kernel``; None where there is no such kernel."""
        if self.direction != direction:
            return None
        busy = sum(o.t1 - o.t0 for o in self.ops("kernel", kernel))
        if busy <= 0:
            return None
        nbytes = ops = 0
        for c in self.calls:
            for n, a, s in zip(c.lengths, c.alphabets, c.stream_bytes):
                b, o = work(n, a, s)
                nbytes += b
                ops += o
        least = max(nbytes / self.peaks["bytes_per_s"],
                    ops / self.peaks["int_ops_per_s"])
        return 100.0 * least / busy

    def copy_ms(self, direction: str) -> float | None:
        """Device ms a call of host-to-device and device-to-host copies."""
        if self.direction != direction or self.device is None \
                or not self.calls:
            return None
        t0, t1 = self.window()
        total = sum(min(o.t1, t1) - max(o.t0, t0)
                    for o in self.ops("memcpy")
                    if ("HtoD" in o.name or "DtoH" in o.name)
                    and o.t1 > t0 and o.t0 < t1)
        return 1e3 * total / len(self.calls)

    def idle_pct(self, direction: str) -> float | None:
        """Percent of the window with no device operation running."""
        if self.direction != direction or self.device is None \
                or not self.calls:
            return None
        t0, t1 = self.window()
        busy = union([(o.t0, o.t1) for o in self.device], t0, t1)
        return 100.0 * (1.0 - busy / (t1 - t0))

    def self_ms(self, direction: str) -> float | None:
        """Host ms a call outside every wrapped span (any thread)."""
        if self.direction != direction or not self.spans or not self.calls:
            return None
        inside = self.per_call({n for n, *_r in self.spans})
        return 1e3 * sum(c.t1 - c.t0 - s
                         for c, s in zip(self.calls, inside)) / len(self.calls)
