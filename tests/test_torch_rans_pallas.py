"""htscodecs_tpu_torch.ops.rans_pallas (plain versions, device="cpu")
against the JAX package on the same numpy inputs.

Two cases run the JAX package's rans_pallas kernels themselves, in
interpret mode (the only way its own tests run them on the CPU): the
order-1 decode at N = 253 (lane-3 tail) and both encodes at N = 255
(order-0 first-step pad).  Every other case holds the port to what
tests/test_rans_pallas.py holds the JAX rans_pallas to: the JAX
package's rans_v2 engines (XLA on the CPU).  Integer codecs: exact
equality."""

import numpy as np
import pytest
import torch

from htscodecs_tpu.ops import rans_pallas as ref_pallas
from htscodecs_tpu.ops import rans_v2 as ref_v2
from htscodecs_tpu_torch.ops import convert, rans_pallas, rans_v2, rans_vmem
from htscodecs_tpu_torch.utils import testdata


def _setup(B, N, nsym, shift, order, seed=0):
    blocks = testdata.synth_wide(B, N, nsym, seed=seed + B * 31 + N)
    alpha, packed, _A = testdata.synth_tables(blocks, shift, order)
    return blocks, alpha, packed


def _assert_streams_equal(got, want):
    st, wd, cn = got
    xf, w, n = want
    np.testing.assert_array_equal(st, xf)
    np.testing.assert_array_equal(cn, n)
    for b in range(len(n)):
        np.testing.assert_array_equal(wd[b, :n[b]], w[b, :n[b]])


def _port_enc(order):
    return rans_pallas.enc_o1_batch if order else rans_pallas.enc_o0_batch


def _port_dec(order):
    return rans_pallas.dec_o1_batch if order else rans_pallas.dec_o0_batch


# ---------------------------------------------------------------------------
# the two interpret-mode cases

def test_dec_o1_matches_pallas_kernel_lane3_tail():
    """JAX rans_pallas.dec_o1_batch (Pallas, interpret mode) at N = 253:
    the lane-3 tail steps; then arbitrary states through rows with no
    valid entry, where the packed route's answer (freq 0) is the JAX
    kernel's."""
    blocks, alpha, packed = _setup(3, 253, 6, 12, 1, seed=5)
    st, w, n = ref_v2.enc_o1_batch(blocks, alpha, packed, 12)
    words = w[:, :int(n.max())]
    want = ref_pallas.dec_o1_batch(st, words, 253, alpha, packed, 12)
    got = rans_pallas.dec_o1_batch(st, words, 253, alpha, packed, 12,
                                   device="cpu")
    np.testing.assert_array_equal(want, blocks)
    np.testing.assert_array_equal(got, want)
    emptied = packed.copy()
    emptied[:, 1] = 0
    g = np.random.default_rng(6).integers(0, 2**32, st.shape, dtype=np.uint64)
    g = g.astype(np.uint32)
    want = ref_pallas.dec_o1_batch(g, words, 253, alpha, emptied, 12)
    got = rans_pallas.dec_o1_batch(g, words, 253, alpha, emptied, 12,
                                   device="cpu")
    np.testing.assert_array_equal(got, want)


def test_encodes_match_pallas_kernel_order0_pad():
    """JAX rans_pallas.enc_o1_batch and enc_o0_batch (Pallas, interpret
    mode) at N = 255: the order-0 first-step pad (4K - N = 1) and the
    order-1 tail (3 steps)."""
    for order in (1, 0):
        blocks, alpha, packed = _setup(2, 255, 5, 12, order, seed=7)
        ref_enc = ref_pallas.enc_o1_batch if order else ref_pallas.enc_o0_batch
        want = ref_enc(blocks, alpha, packed, 12)
        got = _port_enc(order)(blocks, alpha, packed, 12, device="cpu")
        _assert_streams_equal(got, want)


# ---------------------------------------------------------------------------
# against the JAX rans_v2 engines

# (B, N, nsym, shift): ragged B, every N % 4, alphabet buckets 4 .. 96,
# both precisions (each JAX shape is a compile, so shift is not crossed
# with the rest)
SHAPES = [(1, 33, 3, 10), (5, 514, 14, 12), (33, 511, 40, 10),
          (5, 512, 90, 12), (33, 4, 2, 12), (5, 7, 24, 10)]


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("B,N,nsym,shift", SHAPES)
def test_encode_then_decode_matches_jax_rans_v2(B, N, nsym, shift, order):
    blocks, alpha, packed = _setup(B, N, nsym, shift, order)
    ref_enc = ref_v2.enc_o1_batch if order else ref_v2.enc_o0_batch
    want = ref_enc(blocks, alpha, packed, shift)
    got = _port_enc(order)(blocks, alpha, packed, shift, device="cpu")
    _assert_streams_equal(got, want)
    st, w, n = want
    words = w[:, :max(int(n.max()), 1)]
    ref_dec = ref_v2.dec_o1_batch if order else ref_v2.dec_o0_batch
    want_out = ref_dec(st, words, N, alpha, packed, shift)
    out = _port_dec(order)(st, words, N, alpha, packed, shift, device="cpu")
    np.testing.assert_array_equal(want_out, blocks)
    np.testing.assert_array_equal(out, want_out)


@pytest.mark.parametrize("order", [0, 1])
def test_rows_with_zero_frequency_holes(order):
    """A zero-frequency entry has the running base of its successor:
    the slot search must skip it.  Order 1: a symbol that never follows
    some context (pair-structured data leaves such holes inside rows);
    order 0: byte 0, which is always in the alphabet, absent from the
    block (a hole at entry 0)."""
    blocks, alpha, packed = _setup(5, 600, 12, 12, order, seed=3)
    live = (packed & rans_v2.PACK_MASK).reshape(5, -1, alpha.shape[1]) > 0
    if order:
        assert (live[..., :-2] & ~live[..., 1:-1] & live[..., 2:]).any()
    else:
        assert (~live[..., 0] & live[..., 1]).all()
    ref_enc = ref_v2.enc_o1_batch if order else ref_v2.enc_o0_batch
    st, w, n = ref_enc(blocks, alpha, packed, 12)
    _assert_streams_equal(
        _port_enc(order)(blocks, alpha, packed, 12, device="cpu"), (st, w, n))
    out = _port_dec(order)(st, w[:, :int(n.max())], 600, alpha, packed, 12,
                           device="cpu")
    np.testing.assert_array_equal(out, blocks)


def test_stream_wider_than_the_widest_jax_bucket():
    """12288 words is the JAX decode's widest bucket: it hands wider
    streams to rans_v2.  The port's kernel takes any width."""
    rng = np.random.default_rng(9)
    blocks = rng.integers(33, 123, (2, 32000)).astype(np.uint8)
    alpha, packed, _A = testdata.synth_tables(blocks, 12, 0)
    st, w, n = rans_pallas.enc_o0_batch(blocks, alpha, packed, 12,
                                        device="cpu")
    assert int(n.min()) > ref_pallas.W_BUCKETS[-1]
    _assert_streams_equal((st, w, n),
                          ref_v2.enc_o0_batch(blocks, alpha, packed, 12))
    want = ref_pallas.dec_o0_batch(st, w, 32000, alpha, packed, 12)
    got = rans_pallas.dec_o0_batch(st, w, 32000, alpha, packed, 12,
                                   device="cpu")
    np.testing.assert_array_equal(want, blocks)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("N", [1, 2, 3])
def test_short_decodes_take_the_rans_v2_route(N):
    """out_sz < 4: the JAX function and the port both hand the decode
    to rans_v2 (here: rans16_dec's plain version, no packed launch)."""
    blocks, alpha, packed = _setup(5, N, 3, 12, 0)
    st, w, n = ref_v2.enc_o0_batch(blocks, alpha, packed, 12)
    words = w[:, :max(int(n.max()), 1)]
    want = ref_pallas.dec_o0_batch(st, words, N, alpha, packed, 12)
    got = rans_pallas.dec_o0_batch(st, words, N, alpha, packed, 12,
                                   device="cpu")
    np.testing.assert_array_equal(want, blocks)
    np.testing.assert_array_equal(got, want)


def test_tile_changes_no_result():
    blocks, alpha, packed = _setup(5, 514, 14, 10, 1)
    a = rans_pallas.enc_o1_batch(blocks, alpha, packed, 10, device="cpu")
    b = rans_pallas.enc_o1_batch(blocks, alpha, packed, 10, tile=1,
                                 device="cpu")
    _assert_streams_equal(a, b)
    st, w, _n = a
    np.testing.assert_array_equal(
        rans_pallas.dec_o1_batch(st, w, 514, alpha, packed, 10, tile=1,
                                 device="cpu"),
        rans_pallas.dec_o1_batch(st, w, 514, alpha, packed, 10, device="cpu"))


@pytest.mark.parametrize("order", [0, 1])
def test_device_built_tables_feed_the_engine(order):
    """tables_v2's device build (tensors) -> rans_pallas, one call per
    shift group, as the JAX package's own test does."""
    from htscodecs_tpu_torch.ops import tables_v2
    blocks = testdata.synth_quality(6, 2048, seed=4)
    if order:
        alpha, packed, _asz, _fh, shift, _flag, _A = tables_v2.build_o1_device(
            blocks, device="cpu")
    else:
        alpha, packed, _asz, _fh, _A = tables_v2.build_o0_device(
            blocks, device="cpu")
        shift = np.full(len(blocks), 12)
    for sv in np.unique(shift):
        sel = np.flatnonzero(shift == sv)
        al, pk = alpha[sel], packed[sel]
        got = _port_enc(order)(blocks[sel], al, pk, int(sv), device="cpu")
        ref_enc = ref_v2.enc_o1_batch if order else ref_v2.enc_o0_batch
        _assert_streams_equal(got, ref_enc(blocks[sel], al.numpy(),
                                           pk.numpy(), int(sv)))
        out = _port_dec(order)(got[0], got[1], 2048, al, pk, int(sv),
                               device="cpu")
        np.testing.assert_array_equal(out, blocks[sel])


# ---------------------------------------------------------------------------
# the wrappers

def test_plain_versions_agree_with_the_rans_v2_kernels_plain_versions():
    """On the same tensors: rans16_dec_packed (the decoder's packed-row
    reader) == rans16_dec (its base-row reader, what rans_v2 runs) on
    the encoder's streams (the bar the chip run holds the CUDA kernels
    to), and the encoder gives rans_v2's entry the same streams."""
    blocks, alpha, packed = _setup(7, 514, 40, 10, 1)
    bt, al = torch.from_numpy(blocks), torch.from_numpy(alpha)
    pk = torch.from_numpy(packed.reshape(7, -1))
    before = dict(rans_vmem.LAUNCHES)
    st, wd, cn = rans_pallas.rans16_enc_packed(bt, al, pk, 10, 1)
    _assert_streams_equal(convert.streams_to_reference(st, wd, cn),
                          rans_v2.enc_o1_batch(blocks, alpha, packed, 10,
                                               device="cpu"))
    tables = convert.tables_from_packed(al, torch.from_numpy(packed), 10)
    words = convert.words_forward(wd, cn)
    out = rans_pallas.rans16_dec_packed(st, words, pk, al, 10, 514, 1)
    assert torch.equal(out, bt)
    assert torch.equal(out, rans_vmem.rans16_dec(st, words, cn, tables, 514, 1))
    assert rans_vmem.LAUNCHES == before         # plain versions count nothing


def test_garbage_states_and_truncated_words_stay_defined():
    """Arbitrary states (bit 31 set) and a stream cut short decode to
    something (reads past the words give 0), identically on both
    orders' code paths, without error."""
    blocks, alpha, packed = _setup(4, 130, 14, 12, 1)
    pk = torch.from_numpy(packed.reshape(4, -1))
    al = torch.from_numpy(alpha)
    g = np.random.default_rng(1).integers(0, 2**32, (4, 4), dtype=np.uint64)
    st = torch.from_numpy(g.astype(np.uint32).view(np.int32))
    words = torch.from_numpy(np.random.default_rng(2).integers(
        -2**15, 2**15, (4, 3)).astype(np.int16))
    for order, p in ((1, pk), (0, pk[:, :alpha.shape[1]].contiguous())):
        out = rans_pallas.rans16_dec_packed(st, words, p, al, 12, 130, order)
        assert out.shape == (4, 130) and out.dtype == torch.uint8


def test_wrappers_check_their_arguments():
    blocks, alpha, packed = _setup(2, 64, 5, 12, 1)
    bt, al = torch.from_numpy(blocks), torch.from_numpy(alpha)
    pk = torch.from_numpy(packed.reshape(2, -1))
    with pytest.raises(ValueError):
        rans_pallas.rans16_enc_packed(bt, al, pk, 16, 1)          # shift
    with pytest.raises(ValueError):
        rans_pallas.rans16_enc_packed(bt[:, :3].contiguous(), al, pk, 12, 1)
    with pytest.raises(ValueError):
        rans_pallas.rans16_enc_packed(bt, al, pk[:, :4].contiguous(), 12, 1)
    with pytest.raises(ValueError):
        rans_pallas.rans16_dec_packed(
            torch.zeros((2, 4), dtype=torch.int32),
            torch.zeros((2, 0), dtype=torch.int16), pk, al, 12, 64, 1)


@pytest.mark.parametrize("entry", ["enc", "dec"])
def test_default_device_without_a_card_raises(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    blocks, alpha, packed = _setup(2, 64, 5, 12, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "enc":
            rans_pallas.enc_o1_batch(blocks, alpha, packed, 12)
        else:
            rans_pallas.dec_o1_batch(np.zeros((2, 4), np.uint32),
                                     np.zeros((2, 8), np.uint16), 64, alpha,
                                     packed, 12)
