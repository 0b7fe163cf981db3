"""htscodecs_tpu_torch.ops.rans_vmem (plain versions, device="cpu")
against the JAX package's engines on the same numpy inputs: the XLA
engines of rans_v2 on the CPU and, for one case per direction, the
Pallas kernels in interpret mode; and the arithmetic of the CUDA kernels
in plain form (the decoder's slot index, both table readers' answer for
a row with no valid entry, the encoder's divide-free quotient).
Integer codecs: exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from htscodecs_tpu.ops import rans_v2 as ref
from htscodecs_tpu.ops import rans_vmem as ref_vmem
from htscodecs_tpu_torch.ops import convert, rans_v2
from htscodecs_tpu_torch.ops import rans_pallas as port_pallas
from htscodecs_tpu_torch.ops import rans_v2 as port
from htscodecs_tpu_torch.ops import rans_vmem as port_vmem
from htscodecs_tpu_torch.utils import testdata

SHAPES = [(5, 33, 3), (128, 512, 40), (130, 511, 6), (64, 514, 14)]
SHIFTS = ["10", "12", "mixed"]


def _shiftv(mode, B):
    if mode == "mixed":
        return np.random.default_rng(B).choice([10, 12], size=B).astype(np.int32)
    return np.full(B, int(mode), np.int32)


def _setup(B, N, a, mode, order):
    blocks = testdata.synth_wide(B, N, a, seed=B * 31 + N)
    sv = _shiftv(mode, B)
    alpha, packed, _A = testdata.synth_tables(blocks, sv, order)
    return blocks, alpha, packed, sv


def _ref_encode(blocks, alpha, packed, sv, order):
    xf, w, n, ovf = map(np.asarray, ref._enc_scan_v2_pb(
        jnp.asarray(blocks), jnp.asarray(alpha), jnp.asarray(packed),
        jnp.asarray(sv), order, seg_cap=ref.SEG))
    assert not ovf
    return xf, w, n


def _ref_decode(states, words, N, alpha, packed, sv, order):
    """The XLA engine on the CPU: the int-shift batch entry where the
    batch has one shift, the per-block-shift scan otherwise."""
    if len(set(sv.tolist())) == 1:
        fn = ref.dec_o1_batch if order else ref.dec_o0_batch
        return fn(states, words, N, alpha, packed, int(sv[0]))
    B = states.shape[0]
    st, wd, al, pk, _ = ref._pad128(states, words, alpha, packed)
    svp = np.concatenate([sv, np.full(len(st) - B, sv[0], np.int32)])
    if order:
        q = N >> 2
        K = q + (N - 4 * q)
    else:
        q = K = -(-N // 4)
    out = ref._dec_v2_to_bytes_pb(
        jnp.asarray(st.astype(np.uint32)), jnp.asarray(ref._chunkify(wd)),
        jnp.asarray(pk), jnp.asarray(al), jnp.asarray(svp), K, q, N, order,
        row_fetch="auto", win="auto")
    return np.asarray(out)[:B]


def _assert_streams_equal(got, want):
    st, wd, cn = got
    xf, w, n = want
    np.testing.assert_array_equal(st, xf)
    np.testing.assert_array_equal(cn, n)
    for b in range(len(n)):
        np.testing.assert_array_equal(wd[b, :n[b]], w[b, :n[b]])


@pytest.mark.parametrize("mode", SHIFTS)
@pytest.mark.parametrize("B,N,a", SHAPES)
def test_encode_o1_matches_xla_engine(B, N, a, mode):
    """(b) fetch + scan + placement vs _enc_scan_v2_pb."""
    blocks, alpha, packed, sv = _setup(B, N, a, mode, 1)
    got = port.enc_o1_batch(blocks, alpha, packed, sv, device="cpu")
    _assert_streams_equal(got, _ref_encode(blocks, alpha, packed, sv, 1))


@pytest.mark.parametrize("mode", SHIFTS)
@pytest.mark.parametrize("B,N,a", SHAPES)
def test_decode_o1_matches_xla_engine(B, N, a, mode):
    """(a) decode of the reference's streams vs rans_v2.dec_o1_batch."""
    blocks, alpha, packed, sv = _setup(B, N, a, mode, 1)
    xf, w, n = _ref_encode(blocks, alpha, packed, sv, 1)
    want = _ref_decode(xf, w, N, alpha, packed, sv, 1)
    np.testing.assert_array_equal(want, blocks)
    got = port.dec_o1_batch(xf, w, N, alpha, packed, sv, device="cpu")
    np.testing.assert_array_equal(got, want)
    got = port.dec_o1_batch(xf, w, N, alpha, packed, sv, device="cpu",
                            counts=n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["10", "12"])
@pytest.mark.parametrize("B,N,a", SHAPES)
def test_order0_matches_xla_engine(B, N, a, mode):
    blocks, alpha, packed, sv = _setup(B, N, a, mode, 0)
    want_s = _ref_encode(blocks, alpha, packed, sv, 0)
    got_s = port.enc_o0_batch(blocks, alpha, packed, sv, device="cpu")
    _assert_streams_equal(got_s, want_s)
    xf, w, n = want_s
    want = _ref_decode(xf, w, N, alpha, packed, sv, 0)
    got = port.dec_o0_batch(xf, w, N, alpha, packed, sv, device="cpu",
                            counts=n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, blocks)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("mode", SHIFTS)
@pytest.mark.parametrize("B,N,a", SHAPES)
def test_one_encoder_matches_xla_engine(B, N, a, mode, order):
    """The batch entries on the one encoder (rans16_enc_packed, per-block
    shift) vs _enc_scan_v2_pb."""
    blocks, alpha, packed, sv = _setup(B, N, a, mode, order)
    enc = port.enc_o1_batch if order else port.enc_o0_batch
    got = enc(blocks, alpha, packed, sv, device="cpu")
    _assert_streams_equal(got, _ref_encode(blocks, alpha, packed, sv, order))


@pytest.mark.parametrize("order", [0, 1])
def test_per_block_shift_equals_one_shift_per_group(order):
    """rans16_enc_packed's plain version with a mixed shift vector gives,
    block for block, what one call per shift group gives (the rans_pallas
    entry, one int shift) and what the JAX rans_v2 engine gives on each
    group; its words sit at the end of each row."""
    B, N = 9, 514
    blocks, alpha, packed, sv = _setup(B, N, 14, "mixed", order)
    assert len(set(sv.tolist())) == 2
    bt, al = torch.from_numpy(blocks), torch.from_numpy(alpha)
    pk = torch.from_numpy(packed.reshape(B, -1))
    st, wd, cn = port_vmem.rans16_enc_packed(bt, al, pk, torch.from_numpy(sv),
                                             order)
    fwd = convert.words_forward(wd, cn)
    for shift in (10, 12):
        sel = np.flatnonzero(sv == shift)
        ref_enc = ref.enc_o1_batch if order else ref.enc_o0_batch
        want = ref_enc(blocks[sel], alpha[sel], packed[sel], shift)
        enc = port_pallas.enc_o1_batch if order else port_pallas.enc_o0_batch
        _assert_streams_equal(enc(blocks[sel], alpha[sel], packed[sel], shift,
                                  device="cpu"), want)
        _assert_streams_equal((st[sel].numpy().view(np.uint32),
                               fwd[sel].numpy().view(np.uint16),
                               cn[sel].numpy()), want)
        cap = wd.shape[1]
        for k, b in enumerate(sel):
            n = int(cn[b])
            np.testing.assert_array_equal(
                wd[b, cap - n:].numpy().view(np.uint16), want[1][k, :n])


@pytest.mark.parametrize("shift", [10, 12])
def test_decoder_slot_index_matches_slot_lookup(shift):
    """The 4x16 decoder's shared-memory slot index (entry j = bases <=
    j << (shift - 6): 65 entries at either precision) and the bisection
    through it give _slot_lookup's (symbol, base, freq) for every slot,
    holes and empty rows included."""
    blocks, alpha, packed, sv = _setup(7, 600, 12, str(shift), 1)
    t = convert.tables_from_reference(alpha, packed, sv, "cpu")
    bases = t.bases.to(torch.int64)                     # (B, A, A+1)
    B, A = alpha.shape
    ss = (t.shift.to(torch.int64) - 6).clamp(min=0)
    idx = port_vmem.slot_index(bases, ss[:, None])
    assert idx.shape == (B, A, port_vmem.IDX_N)
    assert int(idx.max()) <= A
    m = torch.arange(1 << shift).repeat(B * A, 1).view(B, A, -1)
    got = port_vmem.slot_lookup_indexed(
        bases[:, :, None, :].expand(B, A, 1 << shift, A + 1),
        idx[:, :, None, :].expand(B, A, 1 << shift, port_vmem.IDX_N), m,
        ss[:, None, None])
    rows = bases.reshape(B * A, 1, A + 1).expand(B * A, 1 << shift, A + 1)
    want = port_vmem._slot_lookup(rows, m.reshape(B * A, -1))
    for g, w in zip(got, want):
        assert torch.equal(g.reshape(B * A, -1), w)


@pytest.mark.parametrize("packed_route", [False, True])
def test_readers_answer_for_a_row_with_no_valid_entry(packed_route):
    """A context row with no entry at or below the slot (an unused
    context: every entry a hole) resolves to symbol 0 and base 0 with
    freq 0 on the packed route and freq = row[1] = 1 << shift on the
    base-row route; a used row resolves the same way on both."""
    shift = 12
    pk = torch.zeros((1, 2, 4), dtype=torch.int32)
    f = torch.tensor([1000, 0, 3096, 0], dtype=torch.int32)
    base = torch.cumsum(f, 0) - f
    pk[0, 1] = (base << 13) | f
    rows = rans_v2._b16_fill(pk, shift).to(torch.int16).to(torch.int64)
    m = torch.tensor([[0, 999, 1000, 4095]])
    sym, bs, fr = port_vmem._slot_lookup(rows[:, 0][:, None, :].expand(1, 4, 5),
                                         m, packed_route)
    assert sym.tolist() == [[0] * 4] and bs.tolist() == [[0] * 4]
    assert fr.tolist() == [[0 if packed_route else 1 << shift] * 4]
    sym, bs, fr = port_vmem._slot_lookup(rows[:, 1][:, None, :].expand(1, 4, 5),
                                         m, packed_route)
    assert sym.tolist() == [[0, 0, 2, 2]]
    assert bs.tolist() == [[0, 0, 1000, 1000]]
    assert fr.tolist() == [[1000, 1000, 3096, 3096]]


@pytest.mark.parametrize("lo,hi", [(1, 64), (65, 1024), (1025, 2048),
                                   (2049, 4096)])
def test_divide_free_quotient_is_exact(lo, hi):
    """rans16_enc_packed's quotient (csrc/rc_core.cuh rc_udiv: the high
    word of n * floor((2^32 - 1) / f) and one correction) equals n // f
    for every freq f in [lo, hi] over a sample of 32-bit n that holds
    the extremes and the multiples of f around them."""
    f = np.arange(lo, hi + 1, dtype=np.uint64)[:, None]
    rng = np.random.default_rng(lo)
    n = rng.integers(0, 2**32, (len(f), 64), dtype=np.uint64)
    edges = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1],
                     np.uint64)
    mult = np.minimum((np.uint64(2**32 - 1) // f) * f, np.uint64(2**32 - 1))
    n = np.concatenate([n, np.broadcast_to(edges, (len(f), 6)), mult,
                        mult - np.uint64(1), f - np.uint64(1), f], axis=1)
    got = port_vmem._udiv_plain(n, f)
    np.testing.assert_array_equal(got, n // f)


def test_decode_matches_pallas_interpret():
    """(d) one interpret-mode decode at (128, 512, 40)."""
    B, N, a = 128, 512, 40
    blocks, alpha, packed, sv = _setup(B, N, a, "mixed", 1)
    xf, w, n = _ref_encode(blocks, alpha, packed, sv, 1)
    want = ref_vmem.dec_o1_batch(xf, w, N, alpha, packed, sv, interpret=True)
    got = port.dec_o1_batch(xf, w, N, alpha, packed, sv, device="cpu",
                            counts=n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, blocks)
    # arbitrary states through rows with no valid entry: the base-row
    # route's answer there (freq = row[1]) is the JAX kernel's
    emptied = packed.copy()
    emptied[:, 1] = 0
    g = np.random.default_rng(5).integers(0, 2**32, xf.shape, dtype=np.uint64)
    g = g.astype(np.uint32)
    want = ref_vmem.dec_o1_batch(g, w, N, alpha, emptied, sv, interpret=True)
    got = port.dec_o1_batch(g, w, N, alpha, emptied, sv, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_encode_matches_pallas_interpret():
    """(d) one interpret-mode encode at the smallest shape the JAX
    package's own VMEM tests use (a ragged batch of 40 blocks)."""
    B, N, a = 40, 257, 9
    blocks, alpha, packed, sv = _setup(B, N, a, "mixed", 1)
    want = ref_vmem.enc_o1_batch(blocks, alpha, packed, sv, interpret=True)
    got = port.enc_o1_batch(blocks, alpha, packed, sv, device="cpu")
    _assert_streams_equal(got, want)


def test_truncated_stream_reads_zeros_not_neighbours():
    """A block never reads past its own word count."""
    B, N = 6, 200
    blocks, alpha, packed, sv = _setup(B, N, 5, "12", 1)
    xf, w, n = _ref_encode(blocks, alpha, packed, sv, 1)
    half = n // 2
    w_zeroed = w.copy()
    for b in range(B):
        w_zeroed[b, half[b]:] = 0
    a = port.dec_o1_batch(xf, w, N, alpha, packed, sv, device="cpu",
                          counts=half)
    b_ = port.dec_o1_batch(xf, w_zeroed, N, alpha, packed, sv, device="cpu")
    np.testing.assert_array_equal(a, b_)


def test_high_bits_survive_the_plain_arithmetic():
    """States with bit 31 and words with bit 15 set (never produced by a
    valid encoder, but a decoder must wrap like uint32): compare the
    plain decode step with a direct numpy uint32 evaluation."""
    B, N = 4, 4
    alpha = np.tile(np.array([0, 65, 66, 66], np.uint8), (B, 1))
    f = np.array([1000, 2000, 1096, 0], np.int32)
    base = np.cumsum(f) - f
    packed = np.tile(((base << 13) | f).astype(np.int32), (B, 1))
    states = np.array([[0x80000123, 0xFFFFFFFF, 0x00007FFF, 0x00008000]] * B,
                      np.uint32)
    words = np.full((B, 8), 0x8001, np.uint16)
    got = port.dec_o0_batch(states, words, N, alpha, packed, 12, device="cpu")
    x = states[0].astype(np.uint64)
    m = x & 0xFFF
    sym = (base[None, :3] <= m[:, None]).sum(axis=1) - 1
    np.testing.assert_array_equal(got[0], alpha[0][sym])


def test_wrappers_validate_their_arguments():
    t = convert.tables_from_reference(
        np.zeros((2, 4), np.uint8), np.zeros((2, 4), np.int32), 12, "cpu")
    st = torch.zeros((2, 4), dtype=torch.int32)
    wd = torch.zeros((2, 8), dtype=torch.int16)
    cn = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        port_vmem.rans16_dec(st.to(torch.int64), wd, cn, t, 16, 0)
    with pytest.raises(ValueError):
        port_vmem.rans16_dec(st, wd.t().contiguous().t(), cn, t, 16, 0)
    with pytest.raises(ValueError):
        port_vmem.rans16_dec(st, wd, cn, t, 16, 1)      # order-0 tables
    with pytest.raises(ValueError):
        port_vmem.rans16_dec(st, wd, cn, t, 16, 0, threads=96)
    blocks = torch.zeros((2, 16), dtype=torch.uint8)
    al = torch.zeros((2, 4), dtype=torch.uint8)
    pk = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        port_vmem.rans16_enc_packed(blocks, al, pk, 0, 0)             # shift
    with pytest.raises(ValueError):
        port_vmem.rans16_enc_packed(blocks, al, pk,
                                    torch.full((3,), 12), 0)          # B
    with pytest.raises(ValueError):
        port_vmem.rans16_enc_packed(blocks, al, pk, 12, 1)            # A*A
    with pytest.raises(ValueError):
        port_vmem.rans16_enc_packed(blocks.to(torch.int32), al, pk, 12, 0)
    with pytest.raises(ValueError):
        port_vmem.rans16_dec_packed(st, wd, pk, al, 12, 16, 0, threads=16)
