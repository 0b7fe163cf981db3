"""The 12-bit header transport (htscodecs_tpu_torch.ops.tables_v2) and the
four native bindings the stream encoder and the v1 pipeline need,
against the JAX package on the same numpy inputs, byte for byte."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from htscodecs_tpu import native as ref_native
from htscodecs_tpu.ops import tables_v2 as ref_tables
from htscodecs_tpu_torch import native
from htscodecs_tpu_torch.ops import tables_v2
from htscodecs_tpu_torch.utils import testdata

pytestmark = pytest.mark.skipif(
    not (ref_native.available() and native.available()),
    reason="native host kernels unavailable")


def _deterministic_rows():
    """One-symbol rows of 4096 (packed as 4095), a legitimate 4095
    entry beside a 1, a row of 4 and empty rows (the reference's own
    transport fixture)."""
    A = 5
    f = np.zeros((2, A, A), np.uint16)
    f[0, 0, 2] = 4096
    f[0, 1] = [1024, 1024, 1024, 512, 512]
    f[0, 2] = [4095, 1, 0, 0, 0]
    f[1, 3] = [2, 2, 0, 0, 0]
    return f


def _built(kind):
    """Header frequencies of the port's device table build (on the CPU)
    of the reference transport tests' blocks: 8 symbols with a
    deterministic 90 -> 91 context (A = 16), and 40 skewed symbols
    (A = 48)."""
    rng = np.random.default_rng(3 if kind == "skewed8" else 11)
    if kind == "skewed8":
        blocks = rng.choice(
            np.arange(64, 72, dtype=np.uint8), size=(8, 4096),
            p=[0.4, 0.3, 0.1, 0.1, 0.05, 0.025, 0.02, 0.005])
        blocks[:, 100:900:2] = 90
        blocks[:, 101:901:2] = 91
    else:
        p = np.exp(-np.arange(40) / 9.0)
        p /= p.sum()
        blocks = rng.choice(np.arange(33, 73, dtype=np.uint8), (16, 8192), p=p)
    r = tables_v2.build_o1_device(blocks, device="cpu")
    assert r is not None
    alpha_d, _packed, asz, fhdr, shift, _flag, _A = r
    return alpha_d.numpy(), asz, fhdr, shift


CASES = ["deterministic", "skewed8", "wide40"]


def _fhdr(kind):
    if kind == "deterministic":
        f = _deterministic_rows()
        return (np.tile(np.arange(33, 38, dtype=np.uint8), (2, 1)),
                np.full(2, 5, np.int32), f, np.full(2, 12, np.int32))
    return _built(kind)


def _t(f):
    return torch.from_numpy(f.view(np.int16))


@pytest.mark.parametrize("kind", CASES)
def test_pack_freqs12_matches_jax(kind):
    f = _fhdr(kind)[2]
    got = tables_v2.pack_freqs12(_t(f))
    want = np.asarray(ref_tables.pack_freqs12(jnp.asarray(f)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    back = tables_v2.unpack_freqs12_host(got.numpy(), f.shape[1])
    np.testing.assert_array_equal(back, f)
    np.testing.assert_array_equal(
        back, ref_tables.unpack_freqs12_host(want, f.shape[1]))


@pytest.mark.parametrize("kind", CASES)
def test_pack_freqs_sparse12_matches_jax(kind):
    f = _fhdr(kind)[2]
    got = [t.numpy() for t in tables_v2.pack_freqs_sparse12(_t(f))]
    want = [np.asarray(x) for x in ref_tables.pack_freqs_sparse12(
        jnp.asarray(f))]
    for g, w, name in zip(got, want, ("bitmap", "vals12", "counts", "maxnz")):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    bm, v12, _cnt, mx = got
    A = f.shape[1]
    np.testing.assert_array_equal(
        tables_v2.unpack_freqs_sparse12_host(bm, v12, A), f)
    # a prefix as wide as the largest nonzero count is enough ...
    tp = -(-int(mx) // 2)
    back = tables_v2.unpack_freqs_sparse12_host(bm, v12[:, :3 * tp], A)
    np.testing.assert_array_equal(back, f)
    np.testing.assert_array_equal(
        back, ref_tables.unpack_freqs_sparse12_host(bm, v12[:, :3 * tp], A))
    # ... and a narrower one fails, in both packages
    if tp > 1:
        for mod in (tables_v2, ref_tables):
            with pytest.raises(ValueError, match="prefix narrower"):
                mod.unpack_freqs_sparse12_host(bm, v12[:, :3 * (tp - 1)], A)


def test_unpackers_wrap_4096_and_keep_a_legitimate_4095():
    f = _deterministic_rows()
    pk = tables_v2.pack_freqs12(_t(f)).numpy()
    # 4096 travels as 4095: the first value of block 0, row 0 is entry 2
    assert pk.reshape(2, -1, 3)[0, 1, 0] == 0xFF
    np.testing.assert_array_equal(tables_v2.unpack_freqs12_host(pk, 5), f)
    bm, v12, _c, _m = (t.numpy() for t in tables_v2.pack_freqs_sparse12(_t(f)))
    np.testing.assert_array_equal(
        tables_v2.unpack_freqs_sparse12_host(bm, v12, 5), f)


@pytest.mark.parametrize("sparse", [False, True])
def test_unpackers_refuse_a_row_that_is_not_normalised(sparse):
    f = _deterministic_rows()
    f[1, 3] = [3, 2, 0, 0, 0]             # row total 5: not a power of two
    for mod in (tables_v2, ref_tables):
        if sparse:
            bm, v12, _c, _m = (np.asarray(x) for x in
                               ref_tables.pack_freqs_sparse12(jnp.asarray(f)))
            call = lambda: mod.unpack_freqs_sparse12_host(bm, v12, 5)  # noqa
        else:
            pk = np.asarray(ref_tables.pack_freqs12(jnp.asarray(f)))
            call = lambda: mod.unpack_freqs12_host(pk, 5)  # noqa
        with pytest.raises(ValueError, match="not a power of two"):
            call()


# ---------------------------------------------------------------------
# the four native bindings

def _blocks():
    rng = np.random.default_rng(5)
    out = [testdata.synth_quality(1, 4096, seed=2)[0],
           testdata.synth_wide(1, 2000, 60, seed=3)[0],
           rng.integers(0, 256, 1024).astype(np.uint8),
           np.full(64, 7, np.uint8)]
    return out


@pytest.mark.parametrize("k", range(4))
def test_build_and_parse_tables_o1_match_jax(k):
    blk = _blocks()[k]
    got = native.build_tables_o1(blk)
    want = ref_native.build_tables_o1(blk)
    assert got[0] == want[0] and got[3] == want[3]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    blob = got[0] + bytes(32)
    p, q = native.parse_tables_o1(blob), ref_native.parse_tables_o1(blob)
    assert p[0] == q[0] and p[4] == q[4] == got[3]
    for a, b in zip(p[1:4], q[1:4]):
        np.testing.assert_array_equal(a, b)
    assert native.parse_tables_o1(b"\x00" * 4) is None


@pytest.mark.parametrize("k", range(4))
def test_gather_params_o1_matches_jax(k):
    blk = _blocks()[k]
    _h, st, fr, _sh = native.build_tables_o1(blk)
    got = native.gather_params_o1(blk, st, fr)
    want = ref_native.gather_params_o1(blk, st, fr)
    for a, b in zip(got, want):
        assert a.dtype == np.uint16
        np.testing.assert_array_equal(a, b)
    # N % 4 != 0 and N < 8 are refused by both
    assert native.gather_params_o1(blk[:-1], st, fr) is None
    assert ref_native.gather_params_o1(blk[:-1], st, fr) is None
    assert native.gather_params_o1(blk[:4], st, fr) is None


@pytest.mark.parametrize("kind", CASES)
def test_serialize_o1_sparse12_matches_jax_and_dense(kind):
    alpha, asz, f, shift = _fhdr(kind)
    bm, v12, _c, mx = (t.numpy() for t in tables_v2.pack_freqs_sparse12(_t(f)))
    dense = native.serialize_o1_dense_batch(alpha, asz, f, shift)
    got = native.serialize_o1_sparse12_batch(alpha, asz, bm, v12, shift)
    assert got == dense
    assert got == ref_native.serialize_o1_sparse12_batch(alpha, asz, bm, v12,
                                                         shift)
    tp = -(-int(mx) // 2)
    assert native.serialize_o1_sparse12_batch(
        alpha, asz, bm, v12[:, :3 * tp], shift) == dense
    if tp > 1:
        with pytest.raises(ValueError, match="prefix narrower"):
            native.serialize_o1_sparse12_batch(
                alpha, asz, bm, v12[:, :3 * (tp - 1)], shift)


def test_serialize_o1_sparse12_names_each_fault():
    """A row that is not normalised, a prefix too narrow and a bitmap bit
    past the table each raise with their own message; the JAX binding
    reports the pad bit as a narrow prefix (its C returns one code for
    both), the port's C gives it a code of its own."""
    alpha, asz, f, shift = _fhdr("deterministic")
    bm, v12, _c, _m = (t.numpy() for t in tables_v2.pack_freqs_sparse12(_t(f)))
    bad = v12.copy()
    bad[1, 0] ^= 0x01                      # block 1's row 3: 3 + 2
    with pytest.raises(ValueError, match="not a power of two"):
        native.serialize_o1_sparse12_batch(alpha, asz, bm, bad, shift)
    with pytest.raises(ValueError, match="prefix narrower"):
        native.serialize_o1_sparse12_batch(alpha, asz, bm, v12[:, :3], shift)
    # E = 25 entries in 4 bitmap bytes: bit 30 lies past the table
    pad = bm.copy()
    pad[1, 3] |= 0x40
    with pytest.raises(ValueError, match="pad bit set"):
        native.serialize_o1_sparse12_batch(alpha, asz, pad, v12, shift)
    with pytest.raises(ValueError, match="prefix narrower"):
        ref_native.serialize_o1_sparse12_batch(alpha, asz, pad, v12, shift)
