"""The transform/stripe batch layer of htscodecs_tpu_torch.models.batch
(device="cpu"): transform-flagged rANS 4x16 orders through
compress_blocks / uncompress_blocks, against the JAX package's host
coder and batch layer.  Streams are compared byte for byte."""

import numpy as np
import pytest

from htscodecs_tpu import native as ref_native
from htscodecs_tpu.models import batch as ref_batch
from htscodecs_tpu.models import rans4x16 as ref_r4x16
from htscodecs_tpu_torch.models import batch as port_batch
from htscodecs_tpu_torch.models import rans4x16 as port_r4x16

pytestmark = pytest.mark.skipif(not ref_native.available(),
                                reason="native host kernels unavailable")

# the make-check orders of the reference's tests/rans4x16.test:12; odd
# low-nibble values code order-0 bodies
ORDERS = [0, 1, 64, 65, 128, 129, 192, 193, 8, 9,
          9 + (2 << 8), 8 + (8 << 8), 65 + (4 << 8) + 8,
          2, 66, 130]


def _blocks():
    """4-symbol qualities (packable), RLE-friendly runs and three blocks
    of 11 bytes (20 bytes or fewer strip STRIPE)."""
    rng = np.random.default_rng(17)
    out = list((rng.integers(0, 4, (20, 1999)) * 3 + 33).astype(np.uint8))
    v = rng.choice(3, size=(10, 731), p=[.8, .1, .1]).astype(np.uint8)
    out += list(np.repeat(v, 3, axis=1)[:, :731] + 60)
    out += list(rng.integers(33, 40, (3, 11)).astype(np.uint8))
    return out


@pytest.fixture
def small_groups(monkeypatch):
    """Device groups from 4 blocks, device-built tables from 16: the
    20-block groups take the device-table route, the 10-block groups
    and the smaller ones the host-table route."""
    monkeypatch.setattr(port_batch, "DEVICE_MIN_GROUP", 4)
    monkeypatch.setattr(port_batch, "TABLES_DEVICE_MIN", 16)
    for k in port_batch.TABLE_ROUTES:
        port_batch.TABLE_ROUTES[k] = 0


@pytest.mark.parametrize("order", ORDERS)
def test_transform_encode_matches_host(order, small_groups):
    blocks = _blocks()
    got = port_batch.compress_blocks(blocks, order, engine="device",
                                     device="cpu")
    for i, b in enumerate(blocks):
        assert got[i] == ref_r4x16.compress(b, order), (order, i)
    # PACK turns 4-symbol data into bytes of every value, an alphabet
    # wider than the device table build takes: those groups build on the
    # host; 8 stripe lanes make every group 20 jobs or more
    routes = dict(port_batch.TABLE_ROUTES)
    assert routes["device"] > 0 or order & port_r4x16.X_PACK, routes
    assert routes["host"] > 0 or order == 8 + (8 << 8), routes
    back = port_batch.uncompress_blocks(got, engine="device", device="cpu")
    assert back == [b.tobytes() for b in blocks]


@pytest.mark.parametrize("order", [9, 193, 65 + (4 << 8) + 8])
def test_transform_encode_matches_the_jax_batch_layer(order, small_groups,
                                                      monkeypatch):
    monkeypatch.setattr(ref_batch, "DEVICE_MIN_GROUP", 4)
    blocks = _blocks()
    got = port_batch.compress_blocks(blocks, order, engine="device",
                                     device="cpu")
    assert got == ref_batch.compress_blocks(blocks, order, engine="device")


def test_stripe_lanes_of_equal_blocks_form_device_groups(small_groups):
    """Order 9: every candidate of every lane of the 20 equal blocks is
    a job of one of four batched groups; only the 10 run blocks' lanes
    (groups of 10) and the tiny blocks' bodies are coded elsewhere."""
    for k in ("encode", "decode"):
        for r in port_batch.ENTROPY_JOBS[k]:
            port_batch.ENTROPY_JOBS[k][r] = 0
    blocks = _blocks()[:20]
    got = port_batch.compress_blocks(blocks, 9, engine="auto", device="cpu")
    assert got == [ref_r4x16.compress(b, 9) for b in blocks]
    # 20 blocks x 4 lanes x 2 candidates, in groups of 60 (500 bytes) and
    # 20 (499 bytes) per candidate order; "auto" sends groups under
    # DEVICE_MIN_BYTES to the host
    assert port_batch.ENTROPY_JOBS["encode"] == {"device": 0, "host": 160}
    got = port_batch.compress_blocks(blocks, 9, engine="device", device="cpu")
    assert port_batch.ENTROPY_JOBS["encode"] == {"device": 160, "host": 160}
    assert port_batch.uncompress_blocks(got, engine="device", device="cpu") \
        == [b.tobytes() for b in blocks]
    assert port_batch.ENTROPY_JOBS["decode"] == {"device": 80, "host": 0}


def _reference_streams():
    """Streams of the reference's host coder for the orders of the JAX
    package's batch decode test (tests/test_batch.py)."""
    rng = np.random.default_rng(67)
    datas, streams = [], []
    for order in (0, 1, 0x40, 0x41, 0x80, 0x81, 0xC0, 0xC1,
                  0x08 | 1, 0x20, 0x10 | 1):
        for _ in range(6):
            n = int(rng.integers(64, 3000))
            d = (rng.choice(6, n) * 7 + 33).astype(np.uint8)
            o = order | (4 << 8) if order & 0x08 else order
            datas.append(d)
            streams.append(ref_r4x16.compress(d, o))
    return datas, streams


def test_uncompress_decodes_the_reference_streams():
    datas, streams = _reference_streams()
    sizes = [len(d) for d in datas]
    got = port_batch.uncompress_blocks(streams, out_sizes=sizes,
                                       engine="device", device="cpu")
    assert got == [d.tobytes() for d in datas]
    keep = [i for i, s in enumerate(streams)
            if not s[0] & port_r4x16.X_NOSZ]
    got = port_batch.uncompress_blocks([streams[i] for i in keep],
                                       engine="device", device="cpu")
    assert got == [datas[i].tobytes() for i in keep]


def _host_calls(monkeypatch):
    """The streams that the batch layer hands to the host coder."""
    calls = []
    real = port_batch.rans4x16.uncompress

    def spy(s, *a, **k):
        calls.append(bytes(s))
        return real(s, *a, **k)
    monkeypatch.setattr(port_batch.rans4x16, "uncompress", spy)
    return calls


def _corrupt_streams():
    """A STRIPE container whose lane lengths run past its end, one whose
    second lane's body is cut, and an RLE stream whose compressed meta
    does not decode."""
    rng = np.random.default_rng(3)
    d = (rng.choice(3, 4000, p=[.8, .1, .1]) * 5 + 40).astype(np.uint8)
    d = np.repeat(d, 4)[:4000]
    stripe = bytearray(ref_r4x16.compress(d, 9 | (4 << 8)))
    _ulen, pos = port_batch.varint.get_uint(stripe, 1, len(stripe))
    lane_sizes = bytearray(stripe)
    lane_sizes[pos + 1] = 0x7F                   # first lane length
    cut = bytes(stripe[:len(stripe) * 2 // 3])
    rle_s = bytearray(ref_r4x16.compress(d, 0x41))
    u_meta, p = port_batch.varint.get_uint(rle_s, 1, len(rle_s))   # size
    u_meta, p = port_batch.varint.get_uint(rle_s, p, len(rle_s))
    assert not u_meta & 1                        # the meta is compressed
    _rl, p = port_batch.varint.get_uint(rle_s, p, len(rle_s))
    _cm, p = port_batch.varint.get_uint(rle_s, p, len(rle_s))
    rle_s[p + 4:p + 12] = bytes(8)               # the meta's order-0 table
    return [bytes(lane_sizes), cut, bytes(rle_s)], d


def test_corrupt_stripe_and_rle_meta_streams_go_to_the_host_coder(
        monkeypatch):
    bad, d = _corrupt_streams()
    good = ref_r4x16.compress(d, 9 | (4 << 8))
    for s in bad:
        try:
            want = ref_r4x16.uncompress(s)
        except Exception as e:                   # the host coder's verdict
            want = type(e)
        calls = _host_calls(monkeypatch)
        if isinstance(want, type):
            with pytest.raises(want):
                port_batch.uncompress_blocks([good, s], engine="device",
                                             device="cpu")
        else:
            got = port_batch.uncompress_blocks([good, s], engine="device",
                                               device="cpu")
            assert got == [d.tobytes(), want]
        assert calls == [s]
