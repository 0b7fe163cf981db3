"""ops/convert.py: tables and streams between the JAX package's numpy
layouts and the port's tensors, there and back."""

import numpy as np
import pytest
import torch

from htscodecs_tpu_torch.ops import convert, rans_v2
from htscodecs_tpu_torch.utils import testdata


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("shift", [10, 12, "vector"])
def test_tables_round_trip(order, shift):
    B, N = 5, 400
    blocks = testdata.synth_wide(B, N, 9, seed=3)
    sv = np.array([10, 12, 10, 12, 12], np.int32) if shift == "vector" else shift
    alpha, packed, A = testdata.synth_tables(blocks, sv, order)
    t = convert.tables_from_reference(alpha, packed, sv, "cpu")
    assert t.alpha.dtype == torch.uint8 and t.alpha.shape == (B, A)
    assert t.bases.dtype == torch.int16
    assert t.bases.shape == (B, A if order else 1, A + 1)
    assert t.shift.dtype == torch.int32 and t.shift.shape == (B,)
    al2, pk2, sh2 = convert.tables_to_reference(t, order)
    np.testing.assert_array_equal(al2, alpha)
    np.testing.assert_array_equal(sh2, convert.shift_vector(sv, B))
    assert pk2.shape == packed.shape
    live = (packed & rans_v2.PACK_MASK) > 0
    np.testing.assert_array_equal(pk2[live], packed[live])
    assert (pk2[~live] == 0).all()
    # and the way back in gives the same kernel tables
    t2 = convert.tables_from_reference(al2, pk2, sh2, "cpu")
    assert torch.equal(t2.bases, t.bases)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("shift", [10, "vector", "tensor"])
def test_tables_from_packed_equals_tables_from_reference(order, shift):
    """The tensor-in, tensor-out conversion of the device table build's
    packed rows gives the same bits as the numpy route."""
    B, N = 5, 400
    blocks = testdata.synth_wide(B, N, 9, seed=4)
    sv = np.array([10, 12, 12, 10, 12], np.int32)
    tab_shift = 10 if shift == 10 else sv
    arg = {10: 10, "vector": sv, "tensor": torch.from_numpy(sv)}[shift]
    alpha, packed, _A = testdata.synth_tables(blocks, tab_shift, order)
    ref = convert.tables_from_reference(alpha, packed, tab_shift, "cpu")
    t = convert.tables_from_packed(torch.from_numpy(alpha),
                                   torch.from_numpy(packed), arg)
    assert torch.equal(t.alpha, ref.alpha)
    assert torch.equal(t.bases, ref.bases) and t.bases.dtype == torch.int16
    assert torch.equal(t.shift, ref.shift) and t.shift.dtype == torch.int32
    assert t.bases.is_contiguous()


def test_tables_from_packed_rejects_a_wrong_shift_vector():
    alpha = torch.zeros((3, 4), dtype=torch.uint8)
    packed = torch.zeros((3, 4, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        convert.tables_from_packed(alpha, packed, torch.tensor([10, 12]))


def test_as_tensor_takes_arrays_and_tensors():
    t = convert.as_tensor(np.arange(6).reshape(2, 3), torch.int16, "cpu")
    assert t.dtype == torch.int16 and t.tolist() == [[0, 1, 2], [3, 4, 5]]
    u = convert.as_tensor(t.t(), torch.int32, "cpu")
    assert u.is_contiguous() and u.dtype == torch.int32
    assert u.tolist() == [[0, 3], [1, 4], [2, 5]]


def test_streams_round_trip_keeps_high_bits():
    rng = np.random.default_rng(8)
    B, W = 7, 33
    states = rng.integers(0, 2**32, size=(B, 4), dtype=np.uint64).astype(np.uint32)
    states[0] = [0x80000000, 0xFFFFFFFF, 0x00008000, 0x7FFFFFFF]
    words = rng.integers(0, 2**16, size=(B, W)).astype(np.uint16)
    words[0, :3] = [0x8000, 0xFFFF, 0x7FFF]
    counts = rng.integers(1, W + 1, size=B).astype(np.int32)
    counts[3] = W
    st, wd, cn = convert.streams_from_reference(states, words, "cpu", counts)
    assert st.dtype == torch.int32 and wd.dtype == torch.int16
    assert cn.dtype == torch.int32
    assert int(st[0, 0]) < 0 and int(wd[0, 0]) < 0     # the bits, reinterpreted
    # the encoder's layout: each block's words at the end of its row
    enc = torch.zeros_like(wd)
    for b, n in enumerate(counts):
        enc[b, W - n:] = wd[b, :n]
    s2, w2, c2 = convert.streams_to_reference(st, enc, cn)
    assert s2.dtype == np.uint32 and w2.dtype == np.uint16
    np.testing.assert_array_equal(s2, states)
    np.testing.assert_array_equal(c2, counts)
    live = np.arange(counts.max())[None, :] < counts[:, None]
    np.testing.assert_array_equal(w2, np.where(live, words[:, :counts.max()], 0))
    np.testing.assert_array_equal(convert.words_forward(enc, cn).numpy(),
                                  w2.view(np.int16))


def test_streams_default_counts_cover_the_row():
    st, wd, cn = convert.streams_from_reference(
        np.zeros((3, 4), np.uint32), np.zeros((3, 9), np.uint16), "cpu")
    assert cn.tolist() == [9, 9, 9]


def test_shift_vector_rejects_wrong_length():
    with pytest.raises(ValueError):
        convert.shift_vector(np.array([10, 12]), 3)


@pytest.mark.parametrize("order", [0, 1])
def test_tables8_round_trip(order):
    B, N = 5, 400
    blocks = testdata.synth_wide(B, N, 9, seed=3)
    alpha, packed = testdata.r8_tables(blocks, order)
    A = alpha.shape[1]
    t = convert.tables8_from_reference(alpha, packed, "cpu")
    assert t.alpha.dtype == torch.uint8 and t.alpha.shape == (B, A)
    assert t.bases.dtype == torch.int16
    assert t.bases.shape == (B, A if order else 1, A + 1)
    assert t.shift.tolist() == [12] * B
    # the successor column is each row's own total
    fq = packed & rans_v2.PACK_MASK
    tot = fq.sum(axis=-1).reshape(B, -1)
    np.testing.assert_array_equal(t.bases[:, :, -1].numpy(), tot)
    assert 4095 in tot
    al2, pk2 = convert.tables8_to_reference(t, order)
    np.testing.assert_array_equal(al2, alpha)
    live = fq > 0
    np.testing.assert_array_equal(pk2[live], packed[live])
    assert (pk2[~live] == 0).all()
    t2 = convert.tables8_from_reference(al2, pk2, "cpu")
    assert torch.equal(t2.bases, t.bases)


def test_streams8_round_trip():
    """The reference layout in (streams at the start of each row), the
    4x8 encoder's layout out (streams at the end of each row, as
    rans8_vmem.rans8_enc writes them) -> the reference layout again."""
    rng = np.random.default_rng(9)
    B, W = 6, 41
    states = rng.integers(0, 2**32, size=(B, 4), dtype=np.uint64).astype(np.uint32)
    states[0] = [0x80000000, 0xFFFFFFFF, 0x00800000, 0x7FFFFFFF]
    stream = rng.integers(0, 256, size=(B, W)).astype(np.uint8)
    counts = rng.integers(1, W + 1, size=B).astype(np.int32)
    counts[2] = W
    counts[3] = 0
    st, by, cn = convert.streams8_from_reference(states, stream, "cpu", counts)
    assert st.dtype == torch.int32 and by.dtype == torch.uint8
    assert cn.dtype == torch.int32 and int(st[0, 0]) < 0
    assert torch.equal(by, torch.from_numpy(stream))
    cap = W + 7
    suffix = torch.from_numpy(rng.integers(0, 256, size=(B, cap)).astype(np.uint8))
    for b in range(B):
        suffix[b, cap - counts[b]:] = torch.from_numpy(stream[b, :counts[b]])
    s2, b2, c2 = convert.streams8_to_reference(st, suffix, cn)
    assert s2.dtype == np.uint32 and b2.dtype == np.uint8
    np.testing.assert_array_equal(s2, states)
    np.testing.assert_array_equal(c2, counts)
    live = np.arange(W)[None, :] < counts[:, None]
    np.testing.assert_array_equal(b2, np.where(live, stream, 0))
    _st, _by, cn = convert.streams8_from_reference(states, stream, "cpu")
    assert cn.tolist() == [W] * B


# ---------------------------------------------------------------------------
# adaptive range coders

@pytest.mark.parametrize("order", [0, 1])
def test_model_bank_is_the_jax_engines_initial_state(order):
    """arith_jax.enc_batch starts every model at frequencies
    ``iota < max_sym`` and symbols ``iota``; the bank packs the same
    state as symbol << 16 | frequency with the total appended."""
    ms = np.array([1, 5, 9], np.int32)
    M = 9
    bank = convert.model_bank(torch.from_numpy(ms), M, order)
    assert bank.dtype == torch.int32
    assert bank.shape == (3, M if order else 1, M + 1)
    iota = np.arange(M)
    f0 = (iota[None, :] < ms[:, None]).astype(np.int32)
    for c in range(bank.shape[1]):
        row = bank[:, c].numpy()
        np.testing.assert_array_equal(row[:, :M] & 0xFFFF, f0)
        np.testing.assert_array_equal(row[:, :M] >> 16,
                                      np.broadcast_to(iota, (3, M)))
        np.testing.assert_array_equal(row[:, M], f0.sum(axis=1))


def test_payloads_there_and_back():
    streams = [b"abc", b"", bytes(range(200, 256))]
    st, cn = convert.payloads_from_reference(streams, "cpu")
    assert st.dtype == torch.uint8 and st.shape == (3, 56)
    assert cn.tolist() == [3, 0, 56]
    assert not st[0, 3:].any()
    assert convert.payloads_to_reference(st, cn) == streams
    st, cn = convert.payloads_from_reference([b""], "cpu")
    assert st.shape == (1, 1) and cn.tolist() == [0]


def test_triples_keep_the_u16_bits():
    acc = np.array([0, 40000, 65535], np.uint16)
    f = np.array([1, 2, 3], np.uint16)
    tot = np.array([65535, 50000, 4], np.uint16)
    a, ff, t, cn = convert.triples_from_reference(
        [(acc, f, tot), (acc[:1], f[:1], tot[:1])], "cpu")
    assert a.dtype == torch.int16 and a.shape == (2, 3)
    assert cn.tolist() == [3, 1]
    np.testing.assert_array_equal(a[0].numpy().view(np.uint16), acc)
    np.testing.assert_array_equal(t[0].numpy().view(np.uint16), tot)
    assert a[1].tolist() == [0, 0, 0] and int(t[1, 0]) == -1
