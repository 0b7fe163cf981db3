"""The metric arithmetic on synthetic records."""

import math

import pytest

from cram_bench.harness import spec, trace
from cram_bench.harness.record import Call, DeviceOp, Record, union
from conftest import ROOT


def _reader(folder, name):
    return spec.load_module(ROOT / "cram_bench" / folder / f"{name}.py", "t")


def _calls(times, n=1000, k=4, streams=100, alphabet=4):
    return [Call(a, b, [n] * k, [streams] * k, [alphabet] * k)
            for a, b in times]


def test_rate_counts_a_stall_inside_the_window():
    # three calls of 0.1 s, and a stall of 0.7 s before the third
    calls = _calls([(0.0, 0.1), (0.1, 0.2), (0.9, 1.0)])
    rec = Record("c", "write", calls, 1.0)
    mbps = _reader("e2e", "enc_MBps").read(rec)
    assert mbps == pytest.approx(3 * 4000 / 1.0 / 1e6)
    assert _reader("e2e", "dec_MBps").read(rec) is None


def test_p95_is_taken_over_all_calls():
    # 100 calls: 94 of 10 ms, 6 of 100 ms; the nearest rank 95 is 100 ms
    times, t = [], 0.0
    for i in range(100):
        d = 0.1 if i % 17 == 3 else 0.01
        times.append((t, t + d))
        t += d
    rec = Record("c", "read", _calls(times), 1.0)
    lat = sorted(b - a for a, b in times)
    assert sum(x > 0.05 for x in lat) == 6
    p95 = _reader("e2e", "dec_call_p95_ms").read(rec)
    assert p95 == pytest.approx(100.0)
    assert p95 == pytest.approx(1e3 * lat[math.ceil(95) - 1])


def test_roofline_share_and_its_bound():
    calls = _calls([(0.0, 1.0), (1.0, 2.0)], n=1_000_000, k=2,
                   streams=200_000)
    ops = [DeviceOp("void rans16_enc_packed_kernel<1>(...)", "kernel",
                    0.1, 0.1 + 0.01, 0.05),
           DeviceOp("void rans16_enc_packed_kernel<1>(...)", "kernel",
                    1.1, 1.1 + 0.01, 1.05),
           DeviceOp("Memcpy HtoD (Pageable -> Device)", "memcpy",
                    0.0, 0.05, None)]
    rec = Record("c", "write", calls, 1.0, device=ops)
    r = _reader("metrics", "rans16_enc_packed_roofline")
    b, o = r.work(1_000_000, 4, 200_000)
    assert o == 38 * 1_000_000 + 256
    least = max(4 * b / 3.35e12, 4 * o / 67e12)
    assert least == 4 * o / 67e12            # the operations bound it
    assert r.read(rec) == pytest.approx(100 * least / 0.02)
    assert 0 < r.read(rec) < 100
    # no kernel of that name in the window: nothing to read, never 0
    rec.device = ops[2:]
    assert r.read(rec) is None


def test_copies_and_idle_share():
    calls = _calls([(0.0, 1.0)])
    ops = [DeviceOp("Memcpy HtoD (Pageable -> Device)", "memcpy",
                    0.0, 0.2, None),
           DeviceOp("Memcpy DtoH (Device -> Pageable)", "memcpy",
                    0.5, 0.6, None),
           DeviceOp("k", "kernel", 0.1, 0.3, 0.05)]
    rec = Record("c", "write", calls, 1.0, device=ops)
    assert _reader("metrics", "copy_ms.enc").read(rec) == pytest.approx(300)
    assert _reader("metrics", "copy_ms.dec").read(rec) is None
    idle = _reader("metrics", "device_idle_pct.enc").read(rec)
    assert idle == pytest.approx(100 * (1 - 0.4))


def test_spans_self_time_and_table_build():
    calls = _calls([(0.0, 1.0), (1.0, 2.0)])
    spans = [("ops.tables_v2.build_o1_device_async", 0.1, 0.3, 1),
             ("ops.rans_vmem.rans16_enc_packed", 0.2, 0.4, 1),
             ("ops.tables_v2.build_o1_device_async", 1.1, 1.2, 1)]
    ops = [DeviceOp("hist", "kernel", 0.3, 0.35, 0.15),
           DeviceOp("enc", "kernel", 0.4, 0.5, 0.35),
           DeviceOp("hist", "kernel", 1.3, 1.32, 1.15)]
    rec = Record("c", "write", calls, 1.0, spans=spans,
                 device=ops)
    # call 1: 1.0 - 0.3 (0.1..0.4); call 2: 1.0 - 0.1
    assert _reader("metrics", "entry_self_ms.enc").read(rec) == \
        pytest.approx(1e3 * (0.7 + 0.9) / 2)
    assert _reader("metrics", "table_build_ms").read(rec) == \
        pytest.approx(1e3 * (0.05 + 0.02) / 2)


def test_union_and_breakdown_labels():
    assert union([(0, 2), (1, 3), (5, 6)]) == 4
    assert union([(0, 2), (1, 3)], 1.5, 2.5) == 1.0
    calls = _calls([(0.0, 1.0), (2.0, 3.0)])
    spans = [("native.parse_tables_o1_dense", 0.0, 0.5, 7)]
    ops = [DeviceOp("k", "kernel", 0.6, 1.0, 0.55),
           DeviceOp("k", "kernel", 2.0, 2.5, 1.9)]
    bd = trace.breakdown(ops, spans, calls, main_thread=7)
    # a gap goes to what was open at its middle: 0..0.6 to the parse
    gaps = dict(bd["idle_gaps"])
    assert gaps["native.parse_tables_o1_dense"] == pytest.approx(0.6)
    assert gaps["between calls"] == pytest.approx(1.0)
    assert gaps["entry (models/batch.py)"] == pytest.approx(0.5)
    assert bd["device_ops"] == [["k", pytest.approx(0.9)]]


def test_trace_clock_anchor():
    ev = [{"name": trace.ANCHOR, "ph": "X", "ts": 1000.0, "dur": 1},
          {"cat": "cuda_runtime", "ph": "X", "ts": 1500.0, "dur": 5,
           "name": "cudaLaunchKernel", "args": {"correlation": 9}},
          {"cat": "kernel", "ph": "X", "ts": 3000.0, "dur": 500,
           "name": "k", "args": {"correlation": 9}}]
    (op,) = trace.shift(trace.parse(ev), 10.0)
    assert (op.t0, op.t1, op.launch) == pytest.approx((10.002, 10.0025,
                                                       10.0005))
