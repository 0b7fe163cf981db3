"""The check of ``correct`` against the control and against faults
planted under the timed path, on the CPU at a small size (the look for a
card is skipped: ``bench.run`` is driven with ``device="cpu"``).

On the card the control runs at the cells' own size through
``run.py --control 1``."""

import pytest

from cram_bench.harness import bench
from htscodecs_tpu_torch.models import batch

WRITE = {"qs31-write-k256": "compress_blocks",
         "qs30-write-k256": "r4x8_compress_blocks"}
READ = {"qs31-read-k16": "uncompress_blocks",
        "qs31-read-k256": "uncompress_blocks"}
CELLS = sorted(WRITE) + sorted(READ)


def _run(small_bench, cell, **kw):
    bench_file, here = small_bench
    out = bench.run(cell, 2**31 + 101, 0.2, False, bench_file, here=here,
                    device="cpu", procs=1, log=lambda s: None, **kw)
    return out["result"]


def _flip(b: bytes) -> bytes:
    m = len(b) // 2
    return b[:m] + bytes([b[m] ^ 0x01]) + b[m + 1:]


FAULTS = {
    # an answer altered where it is produced
    "altered": lambda fn: lambda x, **k: (
        lambda out: out[:1] + [_flip(out[1])] + out[2:])(fn(x, **k)),
    # half of the batch left out
    "half": lambda fn: lambda x, **k: fn(x[:len(x) // 2], **k),
    # a step that hands back its input unchanged
    "unchanged": lambda fn: lambda x, **k: [bytes(b) for b in x],
}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(small_bench, cell):
    r = _run(small_bench, cell)
    assert r["correct"] is True
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(small_bench, cell):
    r = _run(small_bench, cell, control=True)
    assert r["correct"] is False
    assert r["checks"]["outputs_wrong"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(small_bench, cell, fault, monkeypatch):
    name = WRITE.get(cell) or READ[cell]
    monkeypatch.setattr(batch, name, FAULTS[fault](getattr(batch, name)))
    r = _run(small_bench, cell)
    assert r["correct"] is False
    checks = r["checks"]
    assert (checks["outputs_wrong"]["value"]
            + checks["outputs_missing"]["value"]) > 0


def test_a_call_that_raises_is_not_correct(small_bench, monkeypatch):
    """The warm call passes; every call of the window raises."""
    orig = batch.uncompress_blocks
    seen = []

    def boom(*a, **k):
        seen.append(1)
        if len(seen) > 1:
            raise RuntimeError("planted")
        return orig(*a, **k)
    monkeypatch.setattr(batch, "uncompress_blocks", boom)
    r = _run(small_bench, "qs31-read-k16")
    assert r["correct"] is False and r["failed"] == r["attempted"] >= 1
    assert r["checks"]["calls_raised"]["value"] >= 1


@pytest.mark.parametrize("cell", sorted(WRITE))
def test_one_stream_payload_altered_at_depth(small_bench, cell,
                                             monkeypatch):
    """70 blocks a call, one stream's words altered near its end, in
    the last slot of every call: the check compares every stream of the
    kept calls whole, so it comes out not correct."""
    import json
    bench_file, here = small_bench
    mix = here / "mixes/write-k256.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()),
                                   slices_per_call=70)))
    name = WRITE[cell]
    fn = getattr(batch, name)

    def last_payload(x, **k):
        out = fn(x, **k)
        s = out[-1]
        return out[:-1] + [s[:-3] + bytes([s[-3] ^ 0x10]) + s[-2:]]
    monkeypatch.setattr(batch, name, last_payload)
    r = _run(small_bench, cell)
    assert r["correct"] is False
    assert r["checks"]["outputs_wrong"]["value"] >= 1
    assert r["checks"]["outputs_missing"]["value"] == 0
