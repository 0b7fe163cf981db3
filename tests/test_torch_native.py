"""The port's copy of the host C runtime against htscodecs_tpu.native
on the same blocks: same tables, same headers, same streams."""

import numpy as np
import pytest

from htscodecs_tpu import native as ref
from htscodecs_tpu_torch import native as port

pytestmark = pytest.mark.skipif(
    not (ref.available() and port.available()),
    reason="native host kernels unavailable")


def _blocks():
    rng = np.random.default_rng(21)
    out = []
    for n, a in [(33, 3), (512, 6), (4099, 40), (2048, 120), (65536, 4)]:
        b = rng.integers(33, 33 + a, size=n).astype(np.uint8)
        b[1::2] = b[0::2][:len(b[1::2])]
        out.append(b)
    return out


BLOCKS = _blocks()
IDS = [f"n{len(b)}" for b in BLOCKS]


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def test_library_is_the_ports_own():
    assert port.get_lib()._name != ref.get_lib()._name
    assert "htscodecs_tpu_torch" in port.get_lib()._name


@pytest.mark.parametrize("blk", BLOCKS, ids=IDS)
def test_build_tables_o1_dense(blk):
    _same(port.build_tables_o1_dense(blk), ref.build_tables_o1_dense(blk))


@pytest.mark.parametrize("blk", BLOCKS, ids=IDS)
def test_build_tables_o0(blk):
    _same(port.build_tables_o0(blk), ref.build_tables_o0(blk))


@pytest.mark.parametrize("blk", BLOCKS, ids=IDS)
@pytest.mark.parametrize("order", [0, 1])
def test_enc_dec_and_parse(blk, order):
    enc_p, enc_r = (port.enc_o1, ref.enc_o1) if order else (port.enc_o0, ref.enc_o0)
    s = enc_p(blk)
    assert s == enc_r(blk)
    dec_p, dec_r = (port.dec_o1, ref.dec_o1) if order else (port.dec_o0, ref.dec_o0)
    np.testing.assert_array_equal(dec_p(s, len(blk)), blk)
    np.testing.assert_array_equal(dec_r(s, len(blk)), blk)
    if order:
        _same(port.parse_tables_o1_dense(s), ref.parse_tables_o1_dense(s))
    else:
        _same(port.parse_tables_o0(s), ref.parse_tables_o0(s))


@pytest.mark.parametrize("order", [0, 1, 64, 128, 193])
def test_compress_wrapped(order):
    for blk in BLOCKS[:4]:
        assert port.compress_wrapped(blk, order) == \
            ref.compress_wrapped(blk, order)


def test_serialize_o0_batch():
    rng = np.random.default_rng(3)
    fr = np.zeros((6, 256), np.uint16)
    for b in range(6):
        syms = rng.choice(256, size=5 + 8 * b, replace=False)
        f = rng.integers(1, 50, size=len(syms))
        f[0] += 4096 - f.sum()
        fr[b, syms] = f
    _same(port.serialize_o0_batch(fr), ref.serialize_o0_batch(fr))


def test_serialize_o1_dense_batch():
    rng = np.random.default_rng(4)
    B, A = 5, 8
    alphas = np.tile(np.array([0, 40, 41, 42, 50, 60, 60, 60], np.uint8), (B, 1))
    asz = np.full(B, 6, np.int32)
    shifts = np.array([10, 12, 12, 10, 12], np.int32)
    fr = np.zeros((B, A, A), np.uint16)
    for b in range(B):
        for c in range(6):
            f = rng.integers(1, 30, size=6)
            f[0] += (1 << shifts[b]) - f.sum()
            fr[b, c, :6] = f
    _same(port.serialize_o1_dense_batch(alphas, asz, fr, shifts),
          ref.serialize_o1_dense_batch(alphas, asz, fr, shifts))


# ---------------------------------------------------------------------------
# the adaptive codecs' bindings

@pytest.mark.parametrize("blk", BLOCKS[:4], ids=IDS[:4])
@pytest.mark.parametrize("order1", [False, True])
@pytest.mark.parametrize("rle", [False, True])
def test_arith_enc_dec(blk, order1, rle):
    s = port.arith_enc(blk, order1, rle)
    assert s == ref.arith_enc(blk, order1, rle)
    np.testing.assert_array_equal(port.arith_dec(s, len(blk), order1, rle),
                                  blk)
    np.testing.assert_array_equal(ref.arith_dec(s, len(blk), order1, rle),
                                  blk)


def _fqz_case():
    from htscodecs_tpu.models import fqz
    rng = np.random.default_rng(31)
    lens = [40] * 24
    data = rng.integers(30, 42, 40 * 24).astype(np.uint8)
    data[40:80] = data[0:40]
    flags = [128 if i & 1 else 0 for i in range(24)]
    gp = fqz.pick_parameters(4, 0, lens, flags, data.copy())
    return (data, np.asarray(lens, np.uint32), np.asarray(flags, np.uint32),
            gp, fqz._pack_gp(gp))


def test_fqz_enc_scan_replay_and_dec_scan():
    args = _fqz_case()
    payload = port.fqz_enc_scan(*args)
    assert payload == ref.fqz_enc_scan(*args)
    _same(port.fqz_enc_replay(*args), ref.fqz_enc_replay(*args))
    _same(port.fqz_dec_scan(payload, len(args[0]), args[3], args[4]),
          ref.fqz_dec_scan(payload, len(args[0]), args[3], args[4]))
    np.testing.assert_array_equal(
        port.fqz_dec_scan(payload, len(args[0]), args[3], args[4])[0], args[0])


def test_fqz_stats():
    data = _fqz_case()[0]
    st = np.arange(0, 24 * 40, 40, dtype=np.int64)
    ls = np.full(24, 40, np.int64)
    d2f = (np.arange(24) & 1).astype(np.uint8)
    _same(port.fqz_stats1(data, st, ls, d2f), ref.fqz_stats1(data, st, ls, d2f))
    _same(port.fqz_stats1(data, st, ls, d2f, nrec=23),
          ref.fqz_stats1(data, st, ls, d2f, nrec=23))
    qb4 = (np.arange(24) % 4).astype(np.uint8)
    np.testing.assert_array_equal(port.fqz_stats2(data, st, ls, qb4),
                                  ref.fqz_stats2(data, st, ls, qb4))
