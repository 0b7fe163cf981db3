"""The slice as a whole: htscodecs_tpu_torch.models.batch (device="cpu")
against the JAX package's batch layer and its single-block host codec.
Streams are compared byte for byte."""

import numpy as np
import pytest

from htscodecs_tpu import native as ref_native
from htscodecs_tpu import rans4x16 as ref_r4x16
from htscodecs_tpu.models import batch as ref_batch
from htscodecs_tpu_torch.models import batch as port_batch
from htscodecs_tpu_torch.models import rans4x16 as port_r4x16
from htscodecs_tpu_torch.ops import rans_vmem as port_vmem
from htscodecs_tpu_torch.utils import testdata

pytestmark = pytest.mark.skipif(not ref_native.available(),
                                reason="native host kernels unavailable")


def _equal_len(B=20, N=600, a=7, seed=1):
    return list(testdata.synth_wide(B, N, a, seed=seed))


def _mixed():
    """Two device groups, a group of 2 (forced onto the device by
    engine="device"), tiny blocks (< 32 bytes -> host), an empty one."""
    rng = np.random.default_rng(2)
    out = _equal_len(18, 300, 5, 3) + _equal_len(17, 301, 12, 4)
    out += _equal_len(2, 77, 3, 5)
    out += [rng.integers(60, 64, size=n).astype(np.uint8)
            for n in (0, 1, 5, 20, 31)]
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def _incompressible():
    rng = np.random.default_rng(6)
    blks = _equal_len(16, 256, 4, 7)
    blks[5] = rng.integers(0, 90, size=256).astype(np.uint8)   # -> CAT
    return blks


def _wide():
    """Alphabet wider than MAX_DENSE_A: the host scalar coder's route."""
    rng = np.random.default_rng(8)
    blks = [rng.integers(0, 120, size=2048).astype(np.uint8) for _ in range(16)]
    for b in blks:
        b[1::2] = b[0::2]
    return blks


CASES = {"equal": _equal_len, "mixed": _mixed,
         "incompressible": _incompressible, "wide": _wide}


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_compress_is_byte_identical(case, order):
    blocks = CASES[case]()
    port_vmem.reset_launches()
    got = port_batch.compress_blocks(blocks, order, engine="device",
                                     device="cpu")
    assert not any(port_vmem.LAUNCHES.values())       # no kernel on the CPU
    want_host = [ref_r4x16.compress(b, order) for b in blocks]
    assert got == want_host
    assert got == ref_batch.compress_blocks(blocks, order, engine="device")
    assert got == [port_r4x16.compress(b, order) for b in blocks]
    if case == "incompressible":
        assert got[5][0] & port_r4x16.X_CAT
    back = port_batch.uncompress_blocks(got, engine="device", device="cpu")
    assert back == [b.tobytes() for b in blocks]


@pytest.mark.parametrize("order", [0, 1])
def test_uncompress_decodes_the_reference_streams(order):
    blocks = _mixed()
    streams = ref_batch.compress_blocks(blocks, order, engine="device")
    got = port_batch.uncompress_blocks(streams, engine="device", device="cpu")
    assert got == [b.tobytes() for b in blocks]
    sizes = [len(b) for b in blocks]
    got = port_batch.uncompress_blocks(streams, sizes, engine="device",
                                       device="cpu")
    assert got == ref_batch.uncompress_blocks(streams, sizes, engine="device")


@pytest.mark.parametrize("engine", ["auto", "host"])
def test_small_groups_and_host_engine_take_the_host_route(engine):
    blocks = _equal_len(20, 600, 7)
    got = port_batch.compress_blocks(blocks, 1, engine=engine, device="cpu")
    assert got == [ref_r4x16.compress(b, 1) for b in blocks]
    assert port_batch.uncompress_blocks(got, engine=engine, device="cpu") == \
        [b.tobytes() for b in blocks]


@pytest.mark.parametrize("order", [193, 64, 128 | 1, 8 | 1 | (4 << 8)])
def test_transform_orders_round_trip_through_the_host_route(order):
    rng = np.random.default_rng(order)
    blocks = _equal_len(6, 500, 4, 9)
    blocks += [np.repeat(rng.integers(65, 70, size=40), 25).astype(np.uint8)]
    got = port_batch.compress_blocks(blocks, order, engine="device",
                                     device="cpu")
    assert got == [ref_r4x16.compress(b, order) for b in blocks]
    back = port_batch.uncompress_blocks(got, [len(b) for b in blocks],
                                        engine="device", device="cpu")
    assert back == [b.tobytes() for b in blocks]


def test_thresholds_kept():
    assert port_batch.DEVICE_MIN_GROUP == ref_batch.DEVICE_MIN_GROUP == 16
    assert port_batch.DEVICE_MIN_BYTES == 4 << 20


def test_empty_stream_is_rejected():
    with pytest.raises(ValueError):
        port_batch.uncompress_blocks([b""], device="cpu")


def test_corrupt_stream_is_rejected_not_misread():
    blocks = _equal_len(16, 400, 5, 11)
    streams = port_batch.compress_blocks(blocks, 1, engine="device",
                                         device="cpu")
    bad = list(streams)
    bad[3] = bad[3][:12]
    with pytest.raises(ValueError):
        port_batch.uncompress_blocks(bad, engine="device", device="cpu")
