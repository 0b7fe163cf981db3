"""The rANS 4x8 batch entries count every block by the route it took
(``batch.ENTROPY_JOBS["encode8"]`` / ``["decode8"]``), on CRAM 3.0
quality-series blocks whose streams the benchmark's plain reference
wrote; on the CPU, with the kernels' plain versions."""

import json
from pathlib import Path

import numpy as np
import pytest

from cram_bench.generators import qs_runs
from cram_bench.ref import rans4x8 as ref_r4x8
from htscodecs_tpu_torch.models import batch

ROOT = Path(__file__).resolve().parents[1]
# the benchmark's CRAM 3.0 configuration, its slices cut to 4000 bytes
CFG = dict(json.loads((ROOT / "cram_bench/configs/cram30-qs.json")
                      .read_text()), reads_per_slice=40, read_length=100)


@pytest.fixture(scope="module")
def qs():
    """16 quality-series blocks of 4000 bytes and their order-1
    streams."""
    blocks = np.stack(qs_runs.blocks(CFG, 2**31 + 17, range(16)))
    return blocks, ref_r4x8.compress_o1(blocks)


@pytest.fixture
def jobs(monkeypatch):
    """ENTROPY_JOBS zeroed for the test (and put back after it), with
    "auto"'s byte floor lifted so that the group size alone decides."""
    monkeypatch.setattr(batch, "ENTROPY_JOBS",
                        {k: {"device": 0, "host": 0}
                         for k in batch.ENTROPY_JOBS})
    monkeypatch.setattr(batch, "DEVICE_MIN_BYTES", 0)
    return batch.ENTROPY_JOBS


# (engine, blocks, route they take): "auto" keeps a group below
# DEVICE_MIN_GROUP (16) on the host coder
ROUTES = [("device", 16, "device"), ("host", 16, "host"),
          ("auto", 15, "host"), ("auto", 16, "device")]


@pytest.mark.parametrize("engine,count,route", ROUTES)
@pytest.mark.parametrize("side", ["encode8", "decode8"])
def test_every_block_is_counted_by_its_route(qs, jobs, side, engine, count,
                                             route):
    blocks, streams = qs
    assert batch.DEVICE_MIN_GROUP == 16
    kw = {"engine": engine, "device": "cpu"}
    if side == "encode8":
        got = batch.r4x8_compress_blocks(list(blocks[:count]), 1, **kw)
        assert got == streams[:count]
    else:
        got = batch.r4x8_uncompress_blocks(streams[:count], **kw)
        assert got == [b.tobytes() for b in blocks[:count]]
    want = {"device": 0, "host": 0}
    want[route] = count
    assert jobs[side] == want
    other = "encode8" if side == "decode8" else "decode8"
    assert jobs[other] == {"device": 0, "host": 0}
    assert jobs["encode"] == jobs["decode"] == {"device": 0, "host": 0}


def test_a_table_that_does_not_parse_sends_its_group_to_the_host(qs, jobs):
    """One stream of the 16 with a table byte that parses to nothing:
    the group goes to the host coder, which counts all 16 there and
    refuses the corrupt stream."""
    _blocks, streams = qs
    bad = bytearray(streams[3])
    bad[11] = 0xFF
    with pytest.raises(ValueError):
        batch.r4x8_uncompress_blocks(
            streams[:3] + [bytes(bad)] + streams[4:], engine="device",
            device="cpu")
    assert jobs["decode8"] == {"device": 0, "host": 16}
