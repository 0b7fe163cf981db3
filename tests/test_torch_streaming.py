"""The pipelined stream encoder (htscodecs_tpu_torch.parallel.streaming,
device="cpu") against the JAX package: its single-block host coder for
the streams, and its StreamEncoder for the assemble=False tuple."""

import numpy as np
import pytest
import torch

from htscodecs_tpu import native as ref_native
from htscodecs_tpu.models import rans4x16 as ref_r4x16
from htscodecs_tpu.parallel import streaming as ref_streaming
from htscodecs_tpu_torch.ops import tables_v2
from htscodecs_tpu_torch.parallel import streaming

pytestmark = pytest.mark.skipif(not ref_native.available(),
                                reason="native host kernels unavailable")

CPU = "cpu"


def _mk_batch(B, N, a, seed):
    r = np.random.default_rng(seed)
    b = r.integers(33, 33 + a, size=(B, N)).astype(np.uint8)
    half = b[:, 0::2][:, :b[:, 1::2].shape[1]]
    b[:, 1::2] = half
    return b


def _check(batches, outs, order):
    assert len(outs) == len(batches)
    for batch, streams in zip(batches, outs):
        for b in range(batch.shape[0]):
            assert streams[b] == ref_r4x16.compress(batch[b], order), b


@pytest.mark.parametrize("order", [0, 1])
def test_stream_encoder_matches_single_block(order):
    batches = [_mk_batch(8, 512, a, s) for a, s in ((6, 1), (24, 2), (40, 3))]
    got = list(streaming.encode_batches(iter(batches), order=order, depth=2,
                                        device=CPU))
    _check(batches, got, order)


def test_stream_encoder_wide_alphabet_fallback():
    rng = np.random.default_rng(21)
    batch = rng.integers(0, 250, size=(4, 400)).astype(np.uint8)
    enc = streaming.StreamEncoder(order=1, depth=2, device=CPU)
    enc.submit(batch)
    (streams,) = enc.finish()
    _check([batch], [streams], 1)


def test_stream_encoder_depth_bounds_in_flight():
    enc = streaming.StreamEncoder(order=1, depth=2, device=CPU)
    batches = [_mk_batch(8, 256, 8, 10 + k) for k in range(4)]
    outs = []
    for bt in batches:
        enc.submit(bt)
        outs += enc.drain_ready()
        assert len(enc._q) <= 2
    outs += enc.finish()
    _check(batches, outs, 1)


def test_stream_encoder_s12_prefix_learning():
    enc = streaming.StreamEncoder(order=1, depth=2, hdr="s12", device=CPU)
    sparse = _mk_batch(8, 2048, 6, 31)
    dense = _mk_batch(8, 2048, 48, 32)
    outs = []
    for bt in (sparse, dense, sparse):
        enc.submit(bt)
        outs += enc.drain_ready()
    outs += enc.finish()
    assert enc._nzpairs is not None
    _check([sparse, dense, sparse], outs, 1)


def _max_pairs(batch):
    """The value pairs the s12 transport needs for a batch."""
    fhdr = tables_v2.build_o1_device_async(batch, device=CPU)[2]
    mx = int(tables_v2.pack_freqs_sparse12(fhdr)[3])
    return -(-mx // 2)


def test_stream_encoder_s12_repull_is_reached():
    """At depth 1 the sparse batch is collected, and its prefix width
    learned, before the dense batch is submitted: the dense batch needs
    a wider prefix and is copied again at its width."""
    sparse = _mk_batch(8, 2048, 6, 31)
    dense = _mk_batch(8, 2048, 48, 32)
    enc = streaming.StreamEncoder(order=1, depth=1, hdr="s12", device=CPU)
    enc.submit(sparse)
    outs = enc.drain_ready()
    learned = enc._nzpairs
    assert learned is not None and _max_pairs(dense) > learned
    before = enc.hdr_bytes["s12"]
    enc.submit(dense)
    outs += enc.drain_ready()
    # the bitmap and the learned prefix at submit, the full need later
    B = dense.shape[0]
    assert enc.hdr_bytes["s12"] - before > B * 3 * learned + 3 * B * (
        _max_pairs(dense) - 1)
    assert enc._nzpairs >= _max_pairs(dense)
    outs += enc.finish()
    _check([sparse, dense], outs, 1)


@pytest.mark.parametrize("hdr", ["u16", "s12", "auto"])
def test_stream_encoder_header_transports_give_the_same_streams(hdr):
    batches = [_mk_batch(8, 1024, a, 40 + a) for a in (6, 24)]
    enc = streaming.StreamEncoder(order=1, depth=2, hdr=hdr, device=CPU)
    outs = []
    for bt in batches:
        enc.submit(bt)
        outs += enc.drain_ready()
    outs += enc.finish()
    _check(batches, outs, 1)
    used = {k for k, v in enc.hdr_bytes.items() if v}
    assert used == ({"u16", "s12"} if hdr == "auto" else {hdr})


def test_prestaged_batch_whose_serialiser_refuses(monkeypatch):
    """A pre-staged tensor whose header serialiser gives None takes the
    host coder on bytes copied back from the device (the JAX encoder
    reads the missing host copy there and raises TypeError)."""
    batch = _mk_batch(8, 512, 6, 7)
    monkeypatch.setattr(streaming.native, "serialize_o1_dense_batch",
                        lambda *a: None)
    enc = streaming.StreamEncoder(order=1, depth=2, assemble=False,
                                  hdr="u16", device=CPU)
    enc.submit(torch.from_numpy(batch))
    (streams,) = enc.finish()
    _check([batch], [streams], 1)


def test_prestaged_wide_batch_takes_the_host_coder():
    rng = np.random.default_rng(22)
    batch = rng.integers(0, 250, size=(4, 400)).astype(np.uint8)
    enc = streaming.StreamEncoder(order=1, assemble=False, device=CPU)
    enc.submit(torch.from_numpy(batch))
    (streams,) = enc.finish()
    _check([batch], [streams], 1)


def test_prestaged_submit_requires_assemble_false():
    enc = streaming.StreamEncoder(order=1, device=CPU)
    with pytest.raises(ValueError, match="assemble=False"):
        enc.submit(torch.zeros((2, 64), dtype=torch.uint8))


def test_assemble_false_matches_jax():
    """hdrs, states, counts, flags and shifts equal the JAX encoder's;
    each block's words are the LAST counts[b] of its row here and the
    first in the JAX tuple."""
    batch = _mk_batch(8, 512, 24, 2)
    enc = streaming.StreamEncoder(order=1, depth=2, assemble=False,
                                  device=CPU)
    enc.submit(torch.from_numpy(batch))
    (got,) = enc.finish()
    ref = ref_streaming.StreamEncoder(order=1, depth=2, assemble=False)
    ref.submit(batch)
    (want,) = ref.finish()
    hdrs, states, words, counts, flag, shift = got
    assert hdrs == want[0]
    np.testing.assert_array_equal(states.numpy().view(np.uint32),
                                  np.asarray(want[1]))
    np.testing.assert_array_equal(counts, np.asarray(want[3]))
    np.testing.assert_array_equal(flag, np.asarray(want[4]))
    np.testing.assert_array_equal(shift, np.asarray(want[5]))
    wd = words.numpy().view(np.uint16)
    ref_words = np.asarray(want[2])
    cap = wd.shape[1]
    for b, n in enumerate(counts):
        np.testing.assert_array_equal(wd[b, cap - n:], ref_words[b, :n])


def test_hdr_and_device_are_keyword_only():
    """The JAX signature's fourth parameter is ``seg_cap``; the port has
    none, so a positional call written for it fails with TypeError
    instead of reading ``None`` as the header transport."""
    with pytest.raises(TypeError):
        streaming.StreamEncoder(1, 2, True, None)
    with pytest.raises(TypeError):
        streaming.StreamEncoder(1, 2, True, "u16", CPU)
    enc = streaming.StreamEncoder(1, 2, True, hdr="u16", device=CPU)
    batch = _mk_batch(4, 256, 6, 7)
    enc.submit(batch)
    _check([batch], list(enc.finish()), 1)


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming.StreamEncoder(order=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        list(streaming.encode_batches([np.zeros((2, 64), np.uint8)]))
