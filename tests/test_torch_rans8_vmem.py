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


def _tensors(blocks, alpha, packed, order):
    """numpy tables -> rans8_enc's (blocks, alpha, packed (B,Ac,A))."""
    B, A = alpha.shape
    return (torch.from_numpy(np.ascontiguousarray(blocks)),
            torch.from_numpy(alpha),
            torch.from_numpy(packed).reshape(B, A if order else 1, A))


def _prefix(by, cn):
    """rans8_enc's bytes (each stream at the end of its row) -> (B, W)
    uint8 with each stream at the start of its row, zeros past it."""
    return convert.words_forward(by, cn).contiguous()


def _assert_same_stream(by, cn, w, n):
    """rans8_enc's streams (at the end of each row) equal the JAX
    engine's (at the start)."""
    np.testing.assert_array_equal(cn.numpy(), n)
    got = _prefix(by, cn).numpy()
    for b in range(len(n)):
        np.testing.assert_array_equal(got[b, :n[b]], w[b, :n[b]])


def _scalar_encode(block, alpha, packed, order, xla_div0=False):
    """One block, one symbol at a time: the rANS 4x8 encode of
    rANS_byte.h (x_max = ((L >> 12) << 8) * freq, a byte out while the
    state is at or above it) in rANS_static.c's interleave, from dense
    tables.  A symbol or context past the alphabet takes freq 0 and
    start 0: two bytes out, then a divide by 1, or with ``xla_div0``
    XLA's unsigned divide by zero (quotient all ones, remainder the
    dividend).  Returns (states in state order, the stream)."""
    N, A = len(block), len(alpha)
    dense = [int(np.sum(alpha < v)) for v in block]
    X = [1 << 23] * 4
    emitted = []
    if order:
        q = N >> 2
        tail = N - 4 * q
        steps = [[(3, N - 1 - s)] for s in range(tail)]
        steps += [[(l, l * q + k) for l in (3, 2, 1, 0)]
                  for k in range(q - 1, -1, -1)]
    else:
        K = -(-N // 4)
        steps = [[(l, 4 * k + l) for l in (3, 2, 1, 0) if 4 * k + l < N]
                 for k in range(K - 1, -1, -1)]
    for step in steps:
        for l, p in step:
            sym = dense[p]
            ctx = dense[p - 1] if order and p != l * (N >> 2) else 0
            e = 0
            if sym < A and ctx < A:
                e = int(packed[ctx, sym] if order else packed[sym])
            start, f = e >> 13, e & 0x1FFF
            x = X[l]
            for _ in range(2):
                if x >= (1 << 19) * f:
                    emitted.append(x & 0xFF)
                    x >>= 8
            if f == 0 and xla_div0:
                X[l] = ((0xFFFFFFFF << 12) + x + start) & 0xFFFFFFFF
            else:
                fs = max(f, 1)
                X[l] = ((x // fs) << 12) + x % fs + start
    return np.array(X, np.uint32), np.array(emitted[::-1], np.uint8)


def _check_against_scalar(blocks, alpha, packed, order):
    st, by, cn = rans8_vmem.rans8_enc(*_tensors(blocks, alpha, packed, order),
                                      order)
    stream = _prefix(by, cn).numpy()
    for b in range(len(blocks)):
        xs, ws = _scalar_encode(blocks[b], alpha[b], packed[b], order)
        np.testing.assert_array_equal(st[b].numpy().view(np.uint32), xs)
        assert int(cn[b]) == len(ws)
        np.testing.assert_array_equal(stream[b, :len(ws)], ws)
    return st, by, cn


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
    claims twice; the step's second byte lands one rank below its
    first."""
    rng = np.random.default_rng(5)
    blocks = np.full((4, 4000), 65, np.uint8)
    blocks[:, rng.integers(8, 3990, size=3)] = 66
    alpha, packed = testdata.r8_tables(blocks, 0)
    st, by, cn = rans8_vmem.rans8_enc(*_tensors(blocks, alpha, packed, 0), 0)
    t = convert.tables8_from_reference(alpha, packed, "cpu")
    out = rans8_vmem.rans8_dec(st, _prefix(by, cn), cn, t, 4000, 0)
    np.testing.assert_array_equal(out.numpy(), blocks)
    xf, w, n = _ref_encode(blocks, alpha, packed, 0)
    np.testing.assert_array_equal(cn.numpy(), n)
    np.testing.assert_array_equal(st.numpy().view(np.uint32), xf)
    _assert_same_stream(by, cn, w, n)
    # rows that emit two bytes in one step, checked symbol by symbol
    _check_against_scalar(blocks[:1, :600], alpha[:1], packed[:1], 0)


@pytest.mark.parametrize("order", [0, 1])
def test_bytes_above_the_alphabet_read_the_zero_entry(order):
    """A byte past the top of the block's alphabet (as symbol or, at
    order 1, as context) reads the zero entry past the table, as the JAX
    engine's one-hot row does: freq 0, so two bytes out, then a divide
    by 1.  Held against the one-symbol-at-a-time encoder; the JAX engine
    equals that encoder with XLA's divide by zero in place of the divide
    by 1, so the divide is the one place where the two differ."""
    rng = np.random.default_rng(11)
    blocks = testdata.synth_wide(6, 203, 5, seed=4)
    alpha, packed = testdata.r8_tables(blocks, order)
    top = int(alpha.max())
    for b in range(6):
        where = rng.integers(0, 203, size=4 + b)
        blocks[b, where] = rng.integers(top + 1, 256, size=len(where))
    blocks[0, 0] = blocks[0, 50] = 255           # a quarter leader, a context
    _check_against_scalar(blocks, alpha, packed, order)
    xf, w, n = _ref_encode(blocks, alpha, packed, order)
    for b in range(6):
        xs, ws = _scalar_encode(blocks[b], alpha[b], packed[b], order,
                                xla_div0=True)
        np.testing.assert_array_equal(xf[b], xs)
        np.testing.assert_array_equal(w[b, :n[b]], ws)


@pytest.mark.parametrize("order", [0, 1])
def test_bytes_between_alphabet_entries_take_the_entry_above(order):
    """The dense index counts the alphabet entries below a byte, so a
    byte between two entries takes the entry above it: a block with some
    bytes of each entry replaced by bytes of the gap below that entry
    encodes as the unchanged block, as in the JAX engine."""
    rng = np.random.default_rng(12)
    blocks = testdata.synth_wide(6, 203, 5, seed=4)
    blocks[0, 0] = blocks[0, 50] = 33            # a quarter leader, a context
    alpha, packed = testdata.r8_tables(blocks, order)
    assert 33 in alpha[0] and 20 not in alpha[0]
    moved = blocks.copy()
    for b in range(6):
        for lo, hi in zip(alpha[b][:-1], alpha[b][1:]):
            if hi - lo < 2:
                continue
            where = np.flatnonzero(blocks[b] == hi)
            where = where[rng.random(len(where)) < 0.5]
            moved[b, where] = rng.integers(lo + 1, hi, size=len(where))
    moved[0, 0] = moved[0, 50] = 20
    assert (moved != blocks).sum() > 50
    st, by, cn = _check_against_scalar(moved, alpha, packed, order)
    xf, w, n = _ref_encode(moved, alpha, packed, order)
    np.testing.assert_array_equal(st.numpy().view(np.uint32), xf)
    _assert_same_stream(by, cn, w, n)
    xf, w, n = _ref_encode(blocks, alpha, packed, order)
    np.testing.assert_array_equal(st.numpy().view(np.uint32), xf)
    _assert_same_stream(by, cn, w, n)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("total", [4095, 4096])
def test_one_symbol_row_takes_the_whole_row(order, total):
    """A constant block's symbol owns its row: 4095 slots as the native
    build gives it, or 4096 (a stored frequency of 0 in a parsed
    table), whose x_max = 2^31 still fits in 32 bits."""
    blocks = np.full((3, 97), 70, np.uint8)
    alpha, packed = testdata.r8_tables(blocks, order)
    assert set(np.unique(packed & 0x1FFF).tolist()) == {0, 4095}
    packed = np.where(packed & 0x1FFF, (packed >> 13 << 13) | total, 0) \
        .astype(np.int32)
    st, by, cn = _check_against_scalar(blocks, alpha, packed, order)
    xf, w, n = _ref_encode(blocks, alpha, packed, order)
    np.testing.assert_array_equal(st.numpy().view(np.uint32), xf)
    np.testing.assert_array_equal(cn.numpy(), n)
    _assert_same_stream(by, cn, w, n)


@pytest.mark.parametrize("order", [0, 1])
def test_rows_of_4095_slots_encode_as_the_reference(order):
    """Rows that sum to 4095 (the native build's normalisation) encode as
    the JAX engine and the one-symbol-at-a-time encoder do."""
    blocks, alpha, packed = _setup(5, 130, 9, order)
    rows = (packed & 0x1FFF).reshape(5, -1, alpha.shape[1]).sum(axis=2)
    assert (rows == 4095).any() and set(np.unique(rows).tolist()) <= {0, 4095}
    st, by, cn = _check_against_scalar(blocks, alpha, packed, order)
    xf, w, n = _ref_encode(blocks, alpha, packed, order)
    np.testing.assert_array_equal(st.numpy().view(np.uint32), xf)
    _assert_same_stream(by, cn, w, n)


@pytest.mark.parametrize("order", [0, 1])
def test_suffix_layout_reads_back_through_the_batch_entries(order):
    """rans8_enc leaves each stream at the end of its row, the bytes of
    emission rank r at cap - 1 - r; the batch entries hand back the
    reference's layout (the stream at the start, zeros past it)."""
    blocks, alpha, packed = _setup(7, 258, 14, order)
    st, by, cn = rans8_vmem.rans8_enc(*_tensors(blocks, alpha, packed, order),
                                      order)
    cap = by.shape[1]
    assert cap == 8 * rans_vmem._enc_geometry(258, order)[0]
    enc = port8.enc_o1_batch if order else port8.enc_o0_batch
    st2, by2, cn2 = enc(blocks, alpha, packed, device="cpu")
    np.testing.assert_array_equal(st2, st.numpy().view(np.uint32))
    np.testing.assert_array_equal(cn2, cn.numpy())
    assert by2.shape == (7, int(cn.max()))
    for b in range(7):
        k = int(cn[b])
        np.testing.assert_array_equal(by2[b, :k], by[b, cap - k:].numpy())
        assert not by2[b, k:].any()


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
    blk = torch.zeros((2, 8), dtype=torch.uint8)
    al = torch.zeros((2, 4), dtype=torch.uint8)
    pk = torch.zeros((2, 1, 4), dtype=torch.int32)
    rans8_vmem.rans8_enc(blk, al, pk, 0)                 # valid
    with pytest.raises(ValueError):
        rans8_vmem.rans8_enc(blk.to(torch.int32), al, pk, 0)
    with pytest.raises(ValueError):
        rans8_vmem.rans8_enc(blk, al, pk.to(torch.int16), 0)
    with pytest.raises(ValueError):
        rans8_vmem.rans8_enc(blk, al, pk, 1)             # order-0 tables
    with pytest.raises(ValueError):
        rans8_vmem.rans8_enc(blk, al, pk.reshape(2, 4), 0)
    with pytest.raises(ValueError):
        rans8_vmem.rans8_enc(blk[:, :3].contiguous(), al,
                             torch.zeros((2, 4, 4), dtype=torch.int32), 1)
    with pytest.raises(ValueError):                      # A past 255
        rans8_vmem.rans8_enc(blk, torch.zeros((2, 256), dtype=torch.uint8),
                             torch.zeros((2, 1, 256), dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        rans8_vmem.rans8_enc(blk, al, pk, 2)
    with pytest.raises(ValueError):
        rans8_vmem.rans8_enc(blk.t().contiguous().t(), al, pk, 0)
    meta = torch.zeros((2, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        rans8_vmem.rans8_enc(blk, meta, pk, 0)           # another device


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
    st, by, cn = rans8_vmem.rans8_enc(*_tensors(blocks, alpha, packed, 1), 1)
    stream = _prefix(by, cn)
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
