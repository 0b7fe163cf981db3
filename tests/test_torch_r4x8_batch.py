"""The rANS 4x8 slice as a whole: htscodecs_tpu_torch.models.batch
r4x8_compress_blocks / r4x8_uncompress_blocks (device="cpu") against the
JAX package's batch layer and its single-block host codec.  Streams are
compared byte for byte."""

import numpy as np
import pytest

from htscodecs_tpu import native as ref_native
from htscodecs_tpu.models import batch as ref_batch
from htscodecs_tpu.models import rans4x8 as ref_r4x8
from htscodecs_tpu_torch.models import batch as port_batch
from htscodecs_tpu_torch.models import rans4x8 as port_r4x8
from htscodecs_tpu_torch.ops import rans_vmem as port_vmem
from htscodecs_tpu_torch.utils import testdata

pytestmark = pytest.mark.skipif(not ref_native.available(),
                                reason="native host kernels unavailable")


def _equal_len(B=20, N=600, a=7, seed=1):
    return list(testdata.synth_wide(B, N, a, seed=seed))


def _mixed():
    """Two device groups with every kind of tail between them, a group
    of 2 (forced onto the device by engine="device"), blocks under 8
    bytes (host coder) and under 4."""
    rng = np.random.default_rng(2)
    out = _equal_len(18, 303, 5, 3) + _equal_len(17, 301, 12, 4)
    out += _equal_len(2, 78, 3, 5)
    out += [rng.integers(60, 64, size=n).astype(np.uint8)
            for n in (1, 3, 5, 7, 8, 9)]
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def _wide():
    """Alphabet wider than the dense tables take: the host coder's route."""
    rng = np.random.default_rng(8)
    blks = [rng.integers(0, 120, size=1024).astype(np.uint8) for _ in range(4)]
    for b in blks:
        b[1::2] = b[0::2]
    return blks


CASES = {"equal": _equal_len, "mixed": _mixed, "wide": _wide}


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_compress_is_byte_identical(case, order):
    blocks = CASES[case]()
    port_vmem.reset_launches()
    got = port_batch.r4x8_compress_blocks(blocks, order, engine="device",
                                          device="cpu")
    assert not any(port_vmem.LAUNCHES.values())       # no kernel on the CPU
    assert got == [ref_r4x8.compress(b, order) for b in blocks]
    assert got == ref_batch.r4x8_compress_blocks(blocks, order,
                                                 engine="device")
    back = port_batch.r4x8_uncompress_blocks(got, engine="device",
                                             device="cpu")
    assert back == [b.tobytes() for b in blocks]


@pytest.mark.parametrize("order", [0, 1])
def test_uncompress_decodes_the_reference_streams(order):
    blocks = _mixed()
    streams = ref_batch.r4x8_compress_blocks(blocks, order, engine="device")
    got = port_batch.r4x8_uncompress_blocks(streams, engine="device",
                                            device="cpu")
    assert got == [b.tobytes() for b in blocks]
    assert got == ref_batch.r4x8_uncompress_blocks(streams, engine="device")


def test_mixed_orders_in_one_call_group_apart():
    blocks = _equal_len(6, 257, 6, 12)
    streams = [port_r4x8.compress(b, i & 1) for i, b in enumerate(blocks)]
    got = port_batch.r4x8_uncompress_blocks(streams, engine="device",
                                            device="cpu")
    assert got == [b.tobytes() for b in blocks]


@pytest.mark.parametrize("engine", ["auto", "host"])
def test_small_groups_and_host_engine_take_the_host_route(engine):
    blocks = _equal_len(6, 200, 7)
    got = port_batch.r4x8_compress_blocks(blocks, 1, engine=engine,
                                          device="cpu")
    assert got == [ref_r4x8.compress(b, 1) for b in blocks]
    assert port_batch.r4x8_uncompress_blocks(got, engine=engine,
                                             device="cpu") == \
        [b.tobytes() for b in blocks]


def _engine_calls(monkeypatch):
    """Count the batched decode calls of a run."""
    calls = []
    for name in ("dec_o0_batch", "dec_o1_batch"):
        real = getattr(port_batch.rans8_v2, name)

        def spy(*a, _real=real, **k):
            calls.append(a[2])                     # out size
            return _real(*a, **k)
        monkeypatch.setattr(port_batch.rans8_v2, name, spy)
    return calls


def test_guard_out_size_below_four_goes_to_the_host(monkeypatch):
    calls = _engine_calls(monkeypatch)
    blocks = [np.array([65, 66, 65][:n], np.uint8) for n in (1, 2, 3, 3)]
    streams = [port_r4x8.compress(b, 0) for b in blocks]
    got = port_batch.r4x8_uncompress_blocks(streams, engine="device",
                                            device="cpu")
    assert got == [b.tobytes() for b in blocks]
    assert calls == []


def test_guard_state_below_the_lower_bound_goes_to_the_host(monkeypatch):
    calls = _engine_calls(monkeypatch)
    blocks = _equal_len(4, 120, 5, 13)
    streams = port_batch.r4x8_compress_blocks(blocks, 0, engine="device",
                                              device="cpu")
    pos = port_r4x8.parse_tables_o0(streams[1])[0]
    bad = bytearray(streams[1])
    bad[pos:pos + 4] = (0x7FFFFF).to_bytes(4, "little")
    streams[1] = bytes(bad)
    with pytest.raises(ValueError):                # the host coder's verdict
        port_batch.r4x8_uncompress_blocks(streams, engine="device",
                                          device="cpu")
    with pytest.raises(ValueError):
        ref_batch.r4x8_uncompress_blocks(streams, engine="device")
    assert calls == []


def test_guard_order_byte_two_and_short_streams_are_rejected():
    good = port_r4x8.compress(_equal_len(1, 64, 4, 14)[0], 1)
    for bad in (b"\x02" + good[1:], good[:8], b""):
        with pytest.raises(ValueError):
            port_batch.r4x8_uncompress_blocks([good, bad], engine="device",
                                              device="cpu")


def test_guard_table_that_does_not_parse_is_rejected_not_misread():
    blocks = _equal_len(4, 120, 5, 15)
    streams = port_batch.r4x8_compress_blocks(blocks, 1, engine="device",
                                              device="cpu")
    streams[2] = streams[2][:14]
    with pytest.raises(ValueError):
        port_batch.r4x8_uncompress_blocks(streams, engine="device",
                                          device="cpu")


def test_4095_slot_tables_decode_on_the_batch_path():
    """Rows that normalise to 4095 slots (a constant block's single
    symbol gets freq 4095) reach the engine through the parsed tables
    with their own totals."""
    blocks = [np.full(300, 70, np.uint8) for _ in range(3)]
    blocks.append(np.array([70, 71] * 150, np.uint8))
    for order in (0, 1):
        streams = [ref_r4x8.compress(b, order) for b in blocks]
        got = port_batch.r4x8_uncompress_blocks(streams, engine="device",
                                                device="cpu")
        assert got == [b.tobytes() for b in blocks]
        assert port_batch.r4x8_compress_blocks(
            blocks, order, engine="device", device="cpu") == streams


def test_stored_zero_frequency_means_4096_on_the_batch_path(monkeypatch):
    """An order-1 table entry stored as 0 reads as freq 4096 (a quirk
    of the C reference's parser).  Hand-made: a constant block's table
    with both rows' freq rewritten to a stored 0."""
    calls = _engine_calls(monkeypatch)
    block = np.full(64, 70, np.uint8)
    s = ref_r4x8.compress(block, 1)
    tab = bytes([0, 70, 0x8F, 0xFF, 0, 70, 70, 0x8F, 0xFF, 0, 0])
    assert s[9:9 + len(tab)] == tab
    tab0 = bytes([0, 70, 0, 0, 70, 70, 0, 0, 0])
    body = tab0 + s[9 + len(tab):]
    quirk = s[:1] + len(body).to_bytes(4, "little") + s[5:9] + body
    pos, _sfb, f2d, _b2d = port_r4x8.parse_tables_o1(quirk)
    assert f2d[0, 70] == f2d[70, 70] == 4096
    want = ref_r4x8.uncompress(quirk)
    assert want == block.tobytes()
    got = port_batch.r4x8_uncompress_blocks([quirk, quirk], engine="device",
                                            device="cpu")
    assert got == [want, want]
    assert calls == [64]
