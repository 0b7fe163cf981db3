"""htscodecs_tpu_torch.ops.rans8_vmem (plain versions, device="cpu")
through the batch entries of ops.rans8_v2, against the JAX package's
XLA engines of rans8_v2 on the same numpy inputs (which the JAX
package's own tests hold equal to its Pallas kernels in interpret
mode).  Integer codecs: exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from htscodecs_tpu.ops import rans8_v2 as ref8
from htscodecs_tpu.ops import rans8_vmem as ref8_vmem
from htscodecs_tpu.ops import rans_v2 as ref
from htscodecs_tpu_torch import native
from htscodecs_tpu_torch.ops import convert
from htscodecs_tpu_torch.ops import rans8_v2 as port8
from htscodecs_tpu_torch.ops import rans8_vmem, rans_v2, rans_vmem
from htscodecs_tpu_torch.utils import testdata

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native host kernels unavailable")

# N & 3 = 1, 3, 2, 0: the order-0 no-advance tail and the order-1
# state-3 tail in every length
SHAPES = [(5, 33, 3), (128, 255, 40), (130, 258, 14), (64, 516, 6)]


def _setup(B, N, a, order):
    blocks = testdata.synth_wide(B, N, a, seed=B * 31 + N)
    alpha, packed = testdata.r8_tables(blocks, order)
    return blocks, alpha, packed


def _ref_encode(blocks, alpha, packed, order):
    xf, w, n, ovf = map(np.asarray, ref8._enc_scan8(
        jnp.asarray(blocks), jnp.asarray(alpha), jnp.asarray(packed),
        order, seg_cap=ref.SEG))
    assert not ovf
    return xf, w, n


def _stream_u8(w, n):
    out = np.zeros(w.shape, np.uint8)
    for b in range(len(n)):
        out[b, :n[b]] = w[b, :n[b]]
    return out


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("B,N,a", SHAPES)
def test_encode_matches_xla_engine(B, N, a, order):
    blocks, alpha, packed = _setup(B, N, a, order)
    xf, w, n = _ref_encode(blocks, alpha, packed, order)
    enc = port8.enc_o1_batch if order else port8.enc_o0_batch
    st, by, cn = enc(blocks, alpha, packed, device="cpu")
    assert by.dtype == np.uint8
    np.testing.assert_array_equal(st, xf)
    np.testing.assert_array_equal(cn, n)
    for b in range(B):
        np.testing.assert_array_equal(by[b, :n[b]], w[b, :n[b]])


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("B,N,a", SHAPES)
def test_decode_matches_xla_engine(B, N, a, order):
    blocks, alpha, packed = _setup(B, N, a, order)
    xf, w, n = _ref_encode(blocks, alpha, packed, order)
    stream = _stream_u8(w, n)
    ref_dec = ref8.dec_o1_batch if order else ref8.dec_o0_batch
    want = ref_dec(xf, stream, N, alpha, packed)
    np.testing.assert_array_equal(want, blocks)
    dec = port8.dec_o1_batch if order else port8.dec_o0_batch
    got = dec(xf, stream, N, alpha, packed, device="cpu")
    np.testing.assert_array_equal(got, want)
    got = dec(xf, stream, N, alpha, packed, device="cpu", counts=n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", [0, 1])
def test_rows_of_4095_slots_keep_their_own_total(order):
    """The native 4x8 table build normalises to 4095 slots: the successor
    column must hold the row total, or the last symbol's freq is off
    by one and the stream differs from the reference's."""
    blocks, alpha, packed = _setup(5, 33, 3, order)
    t = convert.tables8_from_reference(alpha, packed, "cpu")
    tot = t.bases[:, :, -1].to(torch.int64)
    assert set(tot.unique().tolist()) <= {0, 4095, 4096}
    assert (tot == 4095).any()
    assert (t.shift == 12).all()
    pk = torch.from_numpy(packed if order else packed[:, None, :])
    want = np.asarray(ref8_vmem._b16_fill_rowtot(jnp.asarray(pk.numpy())))
    np.testing.assert_array_equal(
        rans8_vmem._b16_fill_rowtot(pk).numpy(), want)


def test_truncated_stream_reads_zeros_not_neighbours():
    B, N = 6, 203
    blocks, alpha, packed = _setup(B, N, 5, 1)
    xf, w, n = _ref_encode(blocks, alpha, packed, 1)
    stream = _stream_u8(w, n)
    half = n // 2
    zeroed = stream.copy()
    for b in range(B):
        zeroed[b, half[b]:] = 0
    a = port8.dec_o1_batch(xf, stream, N, alpha, packed, device="cpu",
                           counts=half)
    b_ = port8.dec_o1_batch(xf, zeroed, N, alpha, packed, device="cpu")
    np.testing.assert_array_equal(a, b_)


def test_rare_symbols_take_two_bytes_in_one_step():
    """A symbol of freq 1 moves a state by 12 bits: x_max = 2^19, so a
    state at or above 2^27 emits twice in that step and the decoder
    claims twice."""
    rng = np.random.default_rng(5)
    blocks = np.full((4, 4000), 65, np.uint8)
    blocks[:, rng.integers(8, 3990, size=3)] = 66
    alpha, packed = testdata.r8_tables(blocks, 0)
    t = convert.tables8_from_reference(alpha, packed, "cpu")
    sym, ctx, K, geom = rans_vmem.enc_inputs(torch.from_numpy(blocks), t, 0)
    st, by, cn = rans8_vmem.rans8_enc(sym, ctx, t, K, geom, 0)
    out = rans8_vmem.rans8_dec(st, by[:, :int(cn.max())].contiguous(), cn,
                               t, 4000, 0)
    np.testing.assert_array_equal(out.numpy(), blocks)
    xf, w, n = _ref_encode(blocks, alpha, packed, 0)
    np.testing.assert_array_equal(cn.numpy(), n)
    np.testing.assert_array_equal(st.numpy().view(np.uint32), xf)


def test_order0_decode_refuses_fewer_than_four_bytes():
    z = np.zeros((2, 4), np.uint32)
    with pytest.raises(ValueError):
        port8.dec_o0_batch(z, np.zeros((2, 8), np.uint8), 3,
                           np.zeros((2, 4), np.uint8),
                           np.zeros((2, 4), np.int32), device="cpu")


def test_wrappers_validate_their_arguments():
    t = convert.tables8_from_reference(
        np.zeros((2, 4), np.uint8), np.zeros((2, 4), np.int32), "cpu")
    st = torch.zeros((2, 4), dtype=torch.int32)
    by = torch.zeros((2, 8), dtype=torch.uint8)
    cn = torch.full((2,), 8, dtype=torch.int32)
    sym = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        rans8_vmem.rans8_dec(st.to(torch.int64), by, cn, t, 16, 0)
    with pytest.raises(ValueError):
        rans8_vmem.rans8_dec(st, by.to(torch.int16), cn, t, 16, 0)
    with pytest.raises(ValueError):
        rans8_vmem.rans8_dec(st, by.t().contiguous().t(), cn, t, 16, 0)
    with pytest.raises(ValueError):
        rans8_vmem.rans8_dec(st, by, cn, t, 16, 1)       # order-0 tables
    with pytest.raises(ValueError):
        rans8_vmem.rans8_dec(st, by, cn, t, 3, 0)        # N < 4 at order 0
    with pytest.raises(ValueError):
        rans8_vmem.rans8_enc(sym.to(torch.int32), sym, t, 2, 0, 0)
    with pytest.raises(ValueError):
        rans8_vmem.rans8_enc(sym, sym[:, :7].contiguous(), t, 2, 0, 0)
    with pytest.raises(ValueError):
        rans8_vmem.rans8_enc(sym, sym, t, 2, 4, 0)       # geom out of range
    with pytest.raises(ValueError):
        rans8_vmem.rans8_enc(sym, sym, t, 2, 0, 1)       # order-0 tables
    meta = torch.zeros((2, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        rans8_vmem.rans8_enc(sym, meta, t, 2, 0, 0)      # another device


def test_densify_matches_reference_densify():
    """The dense symbols the 4x8 encoder reads are rans_v2._densify's."""
    blocks, alpha, packed = _setup(5, 33, 3, 1)
    got = rans_v2._densify(torch.from_numpy(blocks), torch.from_numpy(alpha))
    want = np.asarray(ref._densify(jnp.asarray(blocks), jnp.asarray(alpha)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_dec_table_route_rule():
    """rans8_dec copies a CTA's tables into shared memory only while the
    CTA stays within TABLES_SMEM_MAX, at every alphabet; wider tables
    take the global route, whose CTA holds only the stream rings."""
    for order in (0, 1):
        for threads in (32, 64, 128):
            prev = True
            for A in range(1, 257):
                smem = rans8_vmem.tables_in_smem(threads, A, order)
                if smem:
                    assert rans8_vmem._dec_smem(threads // 4, A, order, True) \
                        <= rans8_vmem.TABLES_SMEM_MAX
                assert prev or not smem         # one switch, at one A
                prev = smem
                assert rans8_vmem._dec_smem(threads // 4, A, order, False) \
                    <= rans8_vmem.TABLES_SMEM_MAX
    # synth4 (A = 8) and wide41 (A = 48) keep their tables in shared
    # memory at the default CTA size; order-1 tables of 256 symbols do not
    T = rans8_vmem.DEC_THREADS
    assert rans8_vmem.tables_in_smem(T, 8, 1)
    assert rans8_vmem.tables_in_smem(T, 48, 1)
    assert not rans8_vmem.tables_in_smem(T, 256, 1)


def test_dec_launch_arguments_leave_the_plain_version_alone():
    blocks, alpha, packed = _setup(5, 33, 3, 1)
    t = convert.tables8_from_reference(alpha, packed, "cpu")
    sym, ctx, K, geom = rans_vmem.enc_inputs(torch.from_numpy(blocks), t, 1)
    st, by, cn = rans8_vmem.rans8_enc(sym, ctx, t, K, geom, 1)
    stream = by[:, :int(cn.max())].contiguous()
    for kw in ({}, dict(threads=64), dict(threads=128, global_tables=True)):
        out = rans8_vmem.rans8_dec(st, stream, cn, t, 33, 1, **kw)
        np.testing.assert_array_equal(out.numpy(), blocks)
    with pytest.raises(ValueError):
        rans8_vmem.rans8_dec(st, stream, cn, t, 33, 1, threads=48)


def test_slot_index_lookup_equals_the_bisection_for_every_slot():
    """rans8_dec's slot index (entry j: the number of bases <= 64 j) and
    the lookup through it give rans_vmem._slot_lookup's (symbol, base,
    frequency) for every 12-bit slot, on random monotone rows with holes
    (repeated bases), rows of 4095 slots, a row whose first base is past
    slot 0 and the rows of a real 4x8 table build."""
    rng = np.random.default_rng(8)
    rows = []
    for A in (1, 2, 3, 8, 40, 63, 200):
        for _ in range(4):
            tot = int(rng.choice([4095, 4096]))
            cuts = np.sort(rng.integers(0, tot + 1, A - 1))
            rows.append(np.concatenate([[0], cuts, [tot]]))
        first = np.concatenate([[100], np.linspace(100, 4095, A).astype(int)[1:],
                                [4095]])
        rows.append(first)
    blocks, alpha, packed = _setup(5, 516, 6, 1)
    t = convert.tables8_from_reference(alpha, packed, "cpu")
    real = [r.astype(np.int64) for r in t.bases.numpy().reshape(-1, t.bases.shape[-1])]
    m = torch.arange(4096)[:, None]
    for r in [np.asarray(r, np.int64) for r in rows] + real:
        bases = torch.from_numpy(r)[None, None, :].expand(4096, 1, -1)
        idx = rans8_vmem.slot_index(bases)
        got = rans8_vmem.slot_lookup_indexed(bases, idx, m)
        want = rans_vmem._slot_lookup(bases, m)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
