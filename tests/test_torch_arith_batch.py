"""The adaptive-coder batch entries of htscodecs_tpu_torch.models.batch
(device="cpu") against the JAX package's batch layer with
engine="device" and its host codecs.  Streams are compared byte for
byte."""

import numpy as np
import pytest

from htscodecs_tpu import native as ref_native
from htscodecs_tpu.models import arith as ref_arith
from htscodecs_tpu.models import batch as ref_batch
from htscodecs_tpu.models import fqz as ref_fqz
from htscodecs_tpu_torch import native as port_native
from htscodecs_tpu_torch.models import arith as port_arith
from htscodecs_tpu_torch.models import batch as port_batch
from htscodecs_tpu_torch.ops import rans_vmem
from htscodecs_tpu_torch.utils import testdata

pytestmark = pytest.mark.skipif(
    not (ref_native.available() and port_native.available()),
    reason="native host kernels unavailable")


def _runs(rng, n, a):
    v = rng.choice(a, size=n // 2 + 1)
    ln = rng.geometric(0.3, size=n // 2 + 1).clip(1, 20)
    return (np.repeat(v, ln)[:n] + 33).astype(np.uint8)


def _mixed():
    """Two groups of equal length, a 5-byte and a 4-byte block (host
    codec), an empty block, and a block of random bytes that the codec
    stores uncompressed (CAT)."""
    rng = np.random.default_rng(23)
    out = [_runs(rng, 512, 7) for _ in range(3)]
    out += [_runs(rng, 300, 7) for _ in range(2)]
    out += [_runs(rng, 5, 3), _runs(rng, 4, 3), np.zeros(0, np.uint8)]
    out += [rng.integers(0, 256, 300).astype(np.uint8)]
    return out


@pytest.mark.parametrize("order", [0, 1])
def test_arith_mixed_list_equals_the_reference(order):
    blocks = _mixed()
    rans_vmem.reset_launches()
    got = port_batch.arith_compress_blocks(blocks, order, engine="device",
                                           device="cpu")
    assert not any(rans_vmem.LAUNCHES.values())     # no kernel on the CPU
    assert got == ref_batch.arith_compress_blocks(blocks, order,
                                                  engine="device")
    assert got == [ref_arith.compress(b, order) for b in blocks]
    assert got[-1][0] & port_arith.X_CAT
    live = [(s, b) for s, b in zip(got, blocks) if len(b)]
    streams = [s for s, _b in live]
    back = port_batch.arith_uncompress_blocks(streams, engine="device",
                                              device="cpu")
    assert back == [b.tobytes() for _s, b in live]
    assert back == ref_batch.arith_uncompress_blocks(streams, engine="device")
    sizes = [len(b) for _s, b in live]
    assert port_batch.arith_uncompress_blocks(
        streams, sizes, engine="device", device="cpu") == back


@pytest.mark.parametrize("order", [64, 65, 128 | 1, 8 | 1, 4])
def test_arith_flagged_orders_take_the_host_codec(order):
    rng = np.random.default_rng(order)
    blocks = [_runs(rng, 400, 5) for _ in range(3)]
    got = port_batch.arith_compress_blocks(blocks, order, engine="device",
                                           device="cpu")
    assert got == [ref_arith.compress(b, order) for b in blocks]
    assert got == ref_batch.arith_compress_blocks(blocks, order,
                                                  engine="device")
    assert port_batch.arith_uncompress_blocks(
        got, engine="device", device="cpu") == [b.tobytes() for b in blocks]


@pytest.mark.parametrize("order", [0, 1])
def test_arith_blocks_that_hold_byte_255(order):
    """The stream stores a max symbol + 1 of 256 as 0.  The JAX
    package's arith_uncompress_blocks(engine="device") hands that 0 to
    its decoder as the model size and returns wrong bytes for such
    blocks, so it is not the yardstick here: its host codec is."""
    rng = np.random.default_rng(255)
    blocks = [np.array([0, 85, 170, 255], np.uint8)[rng.integers(0, 4, 64)]
              for _ in range(3)]
    assert all(b.max() == 255 for b in blocks)
    got = port_batch.arith_compress_blocks(blocks, order, engine="device",
                                           device="cpu")
    assert got == [ref_arith.compress(b, order) for b in blocks]
    assert all(s[:3] == bytes([order, 64, 0]) for s in got)
    back = port_batch.arith_uncompress_blocks(got, engine="device",
                                              device="cpu")
    assert back == [b.tobytes() for b in blocks]
    assert back == [ref_arith.uncompress(s) for s in got]


@pytest.mark.parametrize("engine", ["auto", "host"])
def test_arith_small_groups_and_host_engine_take_the_host_route(engine,
                                                                monkeypatch):
    rng = np.random.default_rng(1)
    blocks = [_runs(rng, 512, 7) for _ in range(20)]

    def no_batch(*a, **k):
        raise AssertionError("the batched engine was called")
    monkeypatch.setattr(port_batch.arith_vmem, "enc_batch", no_batch)
    monkeypatch.setattr(port_batch.arith_vmem, "dec_batch", no_batch)
    got = port_batch.arith_compress_blocks(blocks, 1, engine=engine,
                                           device="cpu")
    assert got == [ref_arith.compress(b, 1) for b in blocks]
    assert port_batch.arith_uncompress_blocks(got, engine=engine,
                                              device="cpu") == \
        [b.tobytes() for b in blocks]


def test_arith_auto_takes_the_batched_engine_for_a_large_group(monkeypatch):
    monkeypatch.setattr(port_batch, "DEVICE_MIN_BYTES", 1 << 12)
    rng = np.random.default_rng(2)
    blocks = [_runs(rng, 512, 7) for _ in range(16)]
    calls = []
    enc = port_batch.arith_vmem.enc_batch
    monkeypatch.setattr(port_batch.arith_vmem, "enc_batch",
                        lambda *a, **k: calls.append(1) or enc(*a, **k))
    got = port_batch.arith_compress_blocks(blocks, 0, device="cpu")
    assert calls == [1]
    assert got == [ref_arith.compress(b, 0) for b in blocks]


def test_arith_bad_streams():
    with pytest.raises(ValueError):
        port_batch.arith_uncompress_blocks([b""], device="cpu")
    rng = np.random.default_rng(3)
    blk = _runs(rng, 100, 5)
    s = port_arith.compress(blk, 0)
    # a declared size above the caller's bound is the host codec's to refuse
    with pytest.raises(ValueError):
        port_batch.arith_uncompress_blocks([s], [50], engine="device",
                                           device="cpu")


# ---------------------------------------------------------------------------
# fqzcomp_qual

def _fqz_jobs():
    jobs = testdata.synth_fqz_jobs(3, 30, 40, seed=5)
    data, lens, _flags = jobs[1]
    jobs[1] = (data, lens)                          # flags left out
    jobs[2] = jobs[2] + (1,)                        # a strategy given
    return jobs


def test_fqz_compress_blocks_equals_the_reference(monkeypatch):
    from htscodecs_tpu.ops import rans_v2 as ref_rans_v2
    monkeypatch.setattr(ref_rans_v2, "_vmem_engine_ok", lambda: True)
    jobs = testdata.synth_fqz_jobs(2, 3, 18, seed=9)
    want = ref_fqz.compress_batch_device(jobs, per_r=8, interpret=True)
    got = port_batch.fqz_compress_blocks(jobs, engine="device", device="cpu")
    assert got == want


@pytest.mark.parametrize("engine", ["device", "auto", "host"])
def test_fqz_entries_round_trip_and_equal_the_host_coder(engine):
    jobs = _fqz_jobs()
    got = port_batch.fqz_compress_blocks(jobs, engine=engine, device="cpu")
    assert got == ref_batch.fqz_compress_blocks(jobs, engine="host")
    back = port_batch.fqz_decompress_blocks(got)
    assert back == [j[0].tobytes() for j in jobs]
    assert back == ref_batch.fqz_decompress_blocks(got)


@pytest.mark.parametrize("engine", ["auto", "device", "host"])
def test_fqz_decompress_blocks_takes_the_jax_engine_keyword(engine):
    """``engine=`` is part of the JAX signature; both packages ignore
    it, as the decode is host-only."""
    jobs = _fqz_jobs()[:2]
    got = port_batch.fqz_compress_blocks(jobs, engine="host", device="cpu")
    back = port_batch.fqz_decompress_blocks(got, engine=engine)
    assert back == [j[0].tobytes() for j in jobs]
    assert back == ref_batch.fqz_decompress_blocks(got, engine=engine)


def test_fqz_a_refused_replay_sends_the_batch_to_the_host_coder(monkeypatch):
    jobs = _fqz_jobs()
    monkeypatch.setattr(port_native, "fqz_enc_replay", lambda *a, **k: None)
    got = port_batch.fqz_compress_blocks(jobs, engine="device", device="cpu")
    assert got == ref_batch.fqz_compress_blocks(jobs, engine="host")


def test_fqz_without_the_native_library_only_the_host_engine_works(
        monkeypatch):
    """The batched path needs the native replay.  Without it
    engine="device" raises instead of coding on the host unnoticed;
    engine="host" (the pure-Python coder) gives the same bytes."""
    jobs = _fqz_jobs()[:1]
    want = port_batch.fqz_compress_blocks(jobs, engine="host", device="cpu")
    monkeypatch.setenv("HTSCODECS_TORCH_NATIVE", "0")
    with pytest.raises(RuntimeError, match="native host library"):
        port_batch.fqz_compress_blocks(jobs, engine="device", device="cpu")
    assert port_batch.fqz_compress_blocks(
        jobs, engine="host", device="cpu") == want
    assert port_batch.fqz_decompress_blocks(want) == [jobs[0][0].tobytes()]


@pytest.mark.parametrize("order", [0, 1])
def test_arith_five_byte_payload_decodes_to_zeros(order):
    """A reference quirk that the port keeps: an order-0/1 stream whose
    range-coder payload is exactly 5 bytes decodes to zeros, since every
    decoder refuses to prime on fewer than 6 bytes.  np.full(8, 3) gives
    such a stream at both orders.  The host coders, the batch entries
    (a group of three, so the batched engine codes it) and the JAX
    package give the same bytes each way, so no change to the kernels
    can move the quirk without a test failing."""
    block = np.full(8, 3, np.uint8)
    want = ref_arith.compress(block, order)
    assert want[0] == order and len(want) == 3 + 5    # flags, len, max sym
    assert want.hex() == ("00080400c7e93e90", "01080400f1fa4f9d")[order]
    assert port_arith.compress(block, order) == want
    blocks = [block] * 3
    assert port_batch.arith_compress_blocks(
        blocks, order, engine="device", device="cpu") == [want] * 3
    assert ref_batch.arith_compress_blocks(
        blocks, order, engine="device") == [want] * 3
    zeros = bytes(8)
    assert port_arith.uncompress(want) == ref_arith.uncompress(want) == zeros
    assert port_batch.arith_uncompress_blocks(
        [want] * 3, engine="device", device="cpu") == [zeros] * 3
    assert ref_batch.arith_uncompress_blocks(
        [want] * 3, engine="device") == [zeros] * 3
