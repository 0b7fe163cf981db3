"""htscodecs_tpu_torch.ops.rans_vmem (plain versions, device="cpu")
against the JAX package's engines on the same numpy inputs: the XLA
engines of rans_v2 on the CPU and, for one case per direction, the
Pallas kernels in interpret mode.  Integer codecs: exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from htscodecs_tpu.ops import rans_v2 as ref
from htscodecs_tpu.ops import rans_vmem as ref_vmem
from htscodecs_tpu_torch.ops import convert
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
def test_fused_encode_matches_xla_engine_and_prefetch_variant(B, N, a, mode,
                                                              order):
    """The encode with the table lookup inside (row_fetch="vmem") vs
    _enc_scan_v2_pb and vs the port's default variant ("pfv"), through
    the batch entries."""
    blocks, alpha, packed, sv = _setup(B, N, a, mode, order)
    enc = port.enc_o1_batch if order else port.enc_o0_batch
    assert port.get_enc_variant() == {"row_fetch": "pfv"}
    pfv = enc(blocks, alpha, packed, sv, device="cpu")
    port.set_enc_variant(row_fetch="vmem")
    try:
        fused = enc(blocks, alpha, packed, sv, device="cpu")
    finally:
        port.set_enc_variant(row_fetch="pfv")
    _assert_streams_equal(fused, _ref_encode(blocks, alpha, packed, sv, order))
    _assert_streams_equal(fused, pfv)


def test_fused_plain_equals_fetch_then_encode_on_holes_and_clamped_symbols():
    """Bit for bit the sf_fetch + rans16_enc pair, also where no valid
    encoder goes: freq-0 holes and symbols outside the alphabet."""
    B, N = 7, 131
    blocks, alpha, packed, sv = _setup(B, N, 6, "mixed", 1)
    t = convert.tables_from_reference(alpha, packed, sv, "cpu")
    A = alpha.shape[1]
    rng = np.random.default_rng(3)
    K = 40
    sym = torch.from_numpy(rng.integers(0, A + 3, (B, 4 * K)).astype(np.uint8))
    ctx = torch.from_numpy(rng.integers(0, A + 3, (B, 4 * K)).astype(np.uint8))
    for order, tab in ((1, t), (0, convert.Tables(t.alpha,
                                                  t.bases[:, 1:2].contiguous(),
                                                  t.shift))):
        for geom in (0, 3):
            qidx = sym.to(torch.int32)
            if order:
                qidx = qidx + ctx.to(torch.int32) * A
            sf = port_vmem.sf_fetch(port_vmem.sf_table(tab), qidx)
            want = port_vmem.rans16_enc(sf, tab.shift, K, geom, order)
            got = port_vmem.rans16_enc_fused(sym, ctx, tab, K, geom, order)
            for g, w in zip(got, want):
                assert torch.equal(g, w)


def test_enc_variant_names():
    assert port.ENC_ROW_FETCH == ("pfv", "vmem")
    with pytest.raises(ValueError):
        port.set_enc_variant(row_fetch="onehot")
    port.set_enc_variant()                  # no argument: no change
    assert port.get_enc_variant() == {"row_fetch": "pfv"}


def test_sf_fetch_matches_pallas_interpret():
    """(c) the plain fetch vs the Pallas lane-gather kernel."""
    rng = np.random.default_rng(12)
    B, KQ, Cn = 32, 2048, 2
    tbl = rng.integers(0, 2**25, size=(B, Cn * 128)).astype(np.int32)
    idx = rng.integers(0, Cn * 128, size=(B, KQ)).astype(np.int32)
    want = np.asarray(ref_vmem._sf_fetch(jnp.asarray(tbl), jnp.asarray(idx),
                                         Cn, interpret=True))
    got = port_vmem.sf_fetch(torch.from_numpy(tbl), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sf_fetch_clamps_out_of_row_indices():
    tbl = torch.arange(12, dtype=torch.int32).reshape(2, 6)
    idx = torch.tensor([[-3, 0, 5, 6, 99], [1, 2, 3, 4, 5]], dtype=torch.int32)
    got = port_vmem.sf_fetch(tbl, idx)
    assert got.tolist() == [[0, 0, 5, 5, 5], [7, 8, 9, 10, 11]]


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
        port_vmem.sf_fetch(torch.zeros((2, 4), dtype=torch.int64),
                           torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        port_vmem.rans16_enc(torch.zeros((2, 7), dtype=torch.int32),
                             t.shift, 2, 0, 0)
    sym = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        port_vmem.rans16_enc_fused(sym.to(torch.int32), sym, t, 2, 0, 0)
    with pytest.raises(ValueError):
        port_vmem.rans16_enc_fused(sym, sym, t, 3, 0, 0)     # 4K != 8
    with pytest.raises(ValueError):
        port_vmem.rans16_enc_fused(sym, sym, t, 2, 0, 1)     # order-0 tables
    with pytest.raises(ValueError):
        port_vmem.rans16_enc_fused(
            sym, torch.zeros((2, 8), dtype=torch.uint8, device="meta"),
            t, 2, 0, 0)
